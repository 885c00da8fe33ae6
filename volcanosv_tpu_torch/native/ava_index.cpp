// Host half of the card's all-vs-all overlap pass (ops/overlap.py with
// csrc/ava.cu): the per-read minimizers and the occurrence-filtered index
// of one read group, exactly as ava_overlaps (ava.cpp) builds them before
// its expansion, plus chain_dp's gap costs as a table.
//
// ava.cpp is a byte-for-byte copy of the reference package's helper, so
// its sketch and index steps are repeated here rather than split out:
//   - sketch every read (threads), read-major concatenation
//   - stable sort by hash (read-major, pos-ascending within a hash)
//   - max_occ = max(10, quantile(counts, 1-2e-4)); < 50 hashes → max
// Everything that decides the overlaps depends on this order: the first
// max_hits hits of each hash run are taken before self-hits are dropped.
// The sort and the quantile take faster routes to the same result (a
// counting sort by the hash's top bits with small sorts within the
// buckets, a selection of the two order statistics), on threads.  Each
// call owns its buffers, left uninitialised so that the threads that fill
// them first touch their pages; the result points into them, and
// ava_index_free releases them.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

extern "C" {
int64_t sketch_dna(const int8_t* codes, int64_t L, int32_t k, int32_t w,
                   int64_t* out_pos, uint32_t* out_hash, int8_t* out_strand);
}

namespace {

// fn(tid) on nt threads, the calling thread among them
template <typename F>
void parallel(int nt, F fn) {
    std::vector<std::thread> ths;
    for (int tid = 1; tid < nt; ++tid) ths.emplace_back(fn, tid);
    fn(0);
    for (auto& th : ths) th.join();
}

// [lo, hi) of thread tid's share of n items
inline void share(int64_t n, int nt, int tid, int64_t& lo, int64_t& hi) {
    lo = n * tid / nt;
    hi = n * (tid + 1) / nt;
}

// grows v to hold n items
template <typename T>
T* room(std::vector<T>& v, int64_t n) {
    if ((int64_t)v.size() < n) v.resize((size_t)n);
    return v.data();
}

// n items of a call's own, uninitialised
template <typename T>
T* fresh(std::unique_ptr<T[]>& p, int64_t n) {
    p.reset(new T[(size_t)(n > 0 ? n : 1)]);
    return p.get();
}

struct ThreadBuf {
    std::vector<int64_t> pos64;      // sketch_dna's outputs for one read
    std::vector<uint32_t> hash1;
    std::vector<int8_t> strand1;
    std::vector<uint32_t> hash;      // the thread's reads, appended
    std::vector<int32_t> pos;
    std::vector<int8_t> strand;
    int64_t n = 0;
    std::vector<int64_t> runs;       // hash run lengths of its buckets
};

// an index entry on its way through the sort: (hash << 32 | position in
// the read-major order), pos, read << 1 | strand
struct Rec {
    uint64_t key;
    int32_t pos;
    int32_t read_strand;
};

// the buffers of one call; the result's arrays are among them
struct Work {
    std::vector<ThreadBuf> threads;
    std::unique_ptr<int64_t[]> read_at, read_n;   // a read's range in its
                                                  // thread
    std::unique_ptr<int64_t[]> min_off;
    std::unique_ptr<uint32_t[]> min_hash, idx_hash;
    std::unique_ptr<int32_t[]> min_pos, min_read, idx_read, idx_pos;
    std::unique_ptr<int8_t[]> min_strand, idx_strand;
    std::unique_ptr<Rec[]> rec;
    std::unique_ptr<int64_t[]> cnt, bucket, kept_before;
};

}  // namespace

extern "C" {

struct AvaIndexResult {
    int64_t n_min;          // minimizers of all reads, read-major
    int64_t* min_off;       // (n_reads + 1) offsets into the min_* arrays
    uint32_t* min_hash;
    int32_t* min_pos;
    int8_t* min_strand;
    int64_t n_idx;          // index entries kept by the occurrence filter
    uint32_t* idx_hash;     // ascending
    int32_t* idx_read;
    int32_t* idx_pos;
    int8_t* idx_strand;
    void* work;             // the call's buffers, for ava_index_free
};

AvaIndexResult* ava_index(const int8_t* codes, const int64_t* q_off,
                          int64_t n_reads, int32_t k, int32_t w,
                          int32_t n_threads)
{
    auto* W = new Work();
    int nt = n_threads > 0 ? n_threads
                           : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > (int)n_reads) nt = n_reads > 0 ? (int)n_reads : 1;

    W->threads.resize((size_t)nt);
    int64_t* read_at = fresh(W->read_at, n_reads);
    int64_t* read_n = fresh(W->read_n, n_reads);
    parallel(nt, [&](int tid) {
        ThreadBuf& b = W->threads[(size_t)tid];
        for (int64_t r = tid; r < n_reads; r += nt) {
            const int64_t L = q_off[r + 1] - q_off[r];
            const int64_t n_km = L - k + 1;
            read_at[r] = b.n;
            read_n[r] = 0;
            if (n_km < w) continue;
            const int64_t m = sketch_dna(
                codes + q_off[r], L, k, w, room(b.pos64, n_km),
                room(b.hash1, n_km), room(b.strand1, n_km));
            if (m <= 0) continue;
            uint32_t* h = room(b.hash, b.n + m) + b.n;
            int32_t* p = room(b.pos, b.n + m) + b.n;
            int8_t* s = room(b.strand, b.n + m) + b.n;
            for (int64_t i = 0; i < m; ++i) {
                h[i] = b.hash1[(size_t)i];
                p[i] = (int32_t)b.pos64[(size_t)i];
                s[i] = b.strand1[(size_t)i];
            }
            read_n[r] = m;
            b.n += m;
        }
    });
    int64_t* min_off = fresh(W->min_off, n_reads + 1);
    min_off[0] = 0;
    for (int64_t q = 0; q < n_reads; ++q)
        min_off[q + 1] = min_off[q] + read_n[q];
    const int64_t n_min = min_off[n_reads];
    uint32_t* min_hash = fresh(W->min_hash, n_min);
    int32_t* min_pos = fresh(W->min_pos, n_min);
    int8_t* min_strand = fresh(W->min_strand, n_min);
    int32_t* min_read = fresh(W->min_read, n_min);
    parallel(nt, [&](int tid) {
        const ThreadBuf& b = W->threads[(size_t)tid];
        for (int64_t q = tid; q < n_reads; q += nt) {
            const int64_t o = min_off[q], at = read_at[q];
            for (int64_t i = 0; i < read_n[q]; ++i) {
                min_hash[o + i] = b.hash[(size_t)(at + i)];
                min_pos[o + i] = b.pos[(size_t)(at + i)];
                min_strand[o + i] = b.strand[(size_t)(at + i)];
                min_read[o + i] = (int32_t)q;
            }
        }
    });
    // the stable sort by hash (ava.cpp: std::stable_sort of the read-major
    // concatenation): a counting sort into 2^16 buckets by the hash's top
    // bits, then each bucket sorted by (hash << 32 | position), keys that
    // are unique, so that equal hashes keep their read-major,
    // pos-ascending order: the same permutation
    constexpr int BITS = 16;
    constexpr int64_t NB = (int64_t)1 << BITS;
    Rec* rec = fresh(W->rec, n_min);
    int64_t* cnt = fresh(W->cnt, (int64_t)nt * NB);
    parallel(nt, [&](int tid) {
        int64_t lo, hi;
        share(n_min, nt, tid, lo, hi);
        int64_t* c = cnt + (size_t)tid * NB;
        std::fill(c, c + NB, 0);
        for (int64_t i = lo; i < hi; ++i) ++c[min_hash[i] >> (32 - BITS)];
    });
    // bucket-major, then thread-major offsets of each thread's share
    int64_t* bucket = fresh(W->bucket, NB + 1);
    int64_t run = 0;
    for (int64_t b = 0; b < NB; ++b) {
        bucket[b] = run;
        for (int t = 0; t < nt; ++t) {
            const int64_t c = cnt[(size_t)t * NB + b];
            cnt[(size_t)t * NB + b] = run;
            run += c;
        }
    }
    bucket[NB] = run;
    parallel(nt, [&](int tid) {
        int64_t lo, hi;
        share(n_min, nt, tid, lo, hi);
        int64_t* c = cnt + (size_t)tid * NB;
        for (int64_t i = lo; i < hi; ++i) {
            const uint32_t h = min_hash[i];
            rec[c[h >> (32 - BITS)]++] =
                Rec{((uint64_t)h << 32) | (uint64_t)i, min_pos[i],
                    (min_read[i] << 1) | (int32_t)min_strand[i]};
        }
    });
    // each thread's buckets sorted, and the lengths of their hash runs
    parallel(nt, [&](int tid) {
        std::vector<int64_t>& runs = W->threads[(size_t)tid].runs;
        for (int64_t b = NB * tid / nt; b < NB * (tid + 1) / nt; ++b) {
            Rec* s = rec + bucket[b];
            Rec* e = rec + bucket[b + 1];
            std::sort(s, e, [](const Rec& x, const Rec& y) {
                return x.key < y.key;
            });
            for (Rec* p = s; p < e;) {
                Rec* q = p + 1;
                while (q < e && (q->key >> 32) == (p->key >> 32)) ++q;
                runs.push_back(q - p);
                p = q;
            }
        }
    });

    // ---- occurrence filter (MinimizerIndex.build parity) ----
    int64_t max_occ = 0;
    if (n_min > 0) {
        std::vector<int64_t> sc;
        for (int t = 0; t < nt; ++t)
            sc.insert(sc.end(), W->threads[(size_t)t].runs.begin(),
                      W->threads[(size_t)t].runs.end());
        const size_t nu = sc.size();
        if (nu < 50) {
            max_occ = *std::max_element(sc.begin(), sc.end());
        } else {
            // sorted_counts[lo] and [lo + 1] of ava.cpp, by selection
            const double q = 1.0 - 2e-4;
            const double fpos = q * (double)(nu - 1);
            const size_t lo = (size_t)fpos;
            const double frac = fpos - (double)lo;
            std::nth_element(sc.begin(), sc.begin() + lo, sc.end());
            const int64_t at_lo = sc[lo];
            double val = (double)at_lo;
            if (lo + 1 < nu) {
                const int64_t at_hi =
                    *std::min_element(sc.begin() + lo + 1, sc.end());
                val += frac * (double)(at_hi - at_lo);
            }
            max_occ = (int64_t)val;
        }
        if (max_occ < 10) max_occ = 10;
    }
    int64_t* kept_before = fresh(W->kept_before, (int64_t)nt + 1);
    kept_before[0] = 0;
    parallel(nt, [&](int tid) {
        int64_t c = 0;
        for (const int64_t len : W->threads[(size_t)tid].runs)
            if (len <= max_occ) c += len;
        kept_before[tid + 1] = c;
    });
    for (int t = 0; t < nt; ++t) kept_before[t + 1] += kept_before[t];
    const int64_t n_idx = kept_before[nt];
    uint32_t* idx_hash = fresh(W->idx_hash, n_idx);
    int32_t* idx_read = fresh(W->idx_read, n_idx);
    int32_t* idx_pos = fresh(W->idx_pos, n_idx);
    int8_t* idx_strand = fresh(W->idx_strand, n_idx);
    parallel(nt, [&](int tid) {
        int64_t o = kept_before[tid];
        const Rec* p = rec + bucket[NB * tid / nt];
        for (const int64_t len : W->threads[(size_t)tid].runs) {
            if (len <= max_occ)
                for (int64_t x = 0; x < len; ++x, ++o) {
                    idx_hash[o] = (uint32_t)(p[x].key >> 32);
                    idx_read[o] = p[x].read_strand >> 1;
                    idx_pos[o] = p[x].pos;
                    idx_strand[o] = (int8_t)(p[x].read_strand & 1);
                }
            p += len;
        }
    });
    return new AvaIndexResult{n_min, min_off, min_hash, min_pos, min_strand,
                        n_idx, idx_hash, idx_read, idx_pos, idx_strand, W};
}

void ava_index_free(AvaIndexResult* r) {
    if (!r) return;
    delete static_cast<Work*>(r->work);
    delete r;
}

// chain_dp's gap cost (chain.cpp) for gaps 0..bandwidth, written with its
// expression in this library's compiler and flags, so that the card adds
// the very float the host subtracts (the card's log2f and an FMA
// contracted otherwise would move scores in the last bit).
void ava_gap_costs(float gap_scale, int64_t bandwidth, float* out) {
    for (int64_t gap = 0; gap <= bandwidth; ++gap)
        out[gap] = gap_scale * (float)gap + 0.5f * log2f((float)gap + 1.0f);
}

}  // extern "C"
