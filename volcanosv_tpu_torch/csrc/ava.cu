// All-vs-all read overlaps of one read group: the card's part of
// native/ava.cpp::ava_overlaps (anchor expansion, the sort into (target,
// strand) segments, one best chain a segment), bit for bit.
//
// Replaces no TPU kernel: the JAX package runs ava.cpp on the host.  The
// host keeps the sketch and the filtered index (native/ava_index.cpp); the
// wrapper is ops/overlap.py, whose `_ava_chunk_plain` is the plain version
// of the same steps.
//
//   ava_hits_kernel     a thread a query minimizer: lower_bound of its
//                       hash in the index, the first min(run, max_hits)
//                       entries (the cap before the self filter), the
//                       non-self hits among them
//   ava_read_sums_kernel  a block a read: its anchors (the chunk plan)
//   ava_count_kernel    a thread a query minimizer of the chunk: its
//                       anchors counted into the dense table of segments
//                       ((query - q0) * n + target) * 2 + ('+')
//   ava_scatter_kernel  the same walk: each anchor as one 64-bit key
//                       (target pos << 32 | oriented query pos) into its
//                       segment's range, at a slot taken by an atomic
//   ava_sort_kernel     a block a segment: its keys sorted (a bitonic
//                       network whose comparators all put the smaller key
//                       first, so the virtual padding past n never moves
//                       and its comparators are skipped), in shared memory
//                       up to `cap` anchors (a launch a size class), else
//                       in place in global memory
//   ava_dp_kernel       a warp a segment: chain_dp (chain.cpp) and the
//                       best chain, 8 segments a block, all at once
//
// The DP.  Lane l holds anchor j = i-1-l's (t, q, f) in registers; a step
// takes anchor i's key from the lane that loaded it, scores the lanes'
// predecessors as (f[j] + m) - cost[gap] with __fadd_rn / __fsub_rn on the
// host's table (chain_dp's own expression, compiled by the host's
// compiler), takes the warp's maximum by __reduce_max_sync on an
// order-preserving map of the float and the lowest lane holding it (the
// nearest j: chain_dp walks j down and keeps a strict >), and shifts the
// window one lane.  Each anchor's chain start and length ride along, so
// the first maximum's chain needs no walk back.  Bound: the step's
// dependent chain (the score, the reduction, the shuffles) times the
// longest segment's anchors; every segment of a chunk runs at once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned ordered(float x) {
    const unsigned u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void ava_hits_kernel(const uint32_t* __restrict__ min_hash,
                                const int32_t* __restrict__ min_read,
                                int n_min,
                                const uint32_t* __restrict__ idx_hash,
                                const int32_t* __restrict__ idx_read,
                                int n_idx, int max_hits,
                                int32_t* __restrict__ lo_out,
                                int32_t* __restrict__ cap_out,
                                int32_t* __restrict__ nh_out) {
    const int m = blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= n_min) return;
    const uint32_t h = min_hash[m];
    int lo = 0, hi = n_idx;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (idx_hash[mid] < h) lo = mid + 1;
        else hi = mid;
    }
    const int q = min_read[m];
    int cap = 0, nh = 0;
    for (int j = lo; j < n_idx && cap < max_hits && idx_hash[j] == h;
         ++j, ++cap)
        nh += idx_read[j] != q;
    lo_out[m] = lo;
    cap_out[m] = cap;
    nh_out[m] = nh;
}

// a block a read: its minimizers' anchors summed (the chunk plan's input)
__global__ void ava_read_sums_kernel(const int32_t* __restrict__ nh,
                                     const long long* __restrict__ off,
                                     long long* __restrict__ sums) {
    __shared__ long long part[32];
    const long long lo = off[blockIdx.x], hi = off[blockIdx.x + 1];
    long long s = 0;
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) s += nh[i];
    for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(FULL, s, d);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x < 32) {
        s = threadIdx.x < (blockDim.x >> 5) ? part[threadIdx.x] : 0;
        for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(FULL, s, d);
        if (threadIdx.x == 0) sums[blockIdx.x] = s;
    }
}

__global__ void ava_count_kernel(int m0, int m1, int q0, int n,
                                 const int32_t* __restrict__ min_read,
                                 const int8_t* __restrict__ min_strand,
                                 const int32_t* __restrict__ lo,
                                 const int32_t* __restrict__ cap,
                                 const int32_t* __restrict__ idx_read,
                                 const int8_t* __restrict__ idx_strand,
                                 int32_t* __restrict__ counts) {
    const int m = m0 + blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= m1) return;
    const int q = min_read[m];
    const int8_t s = min_strand[m];
    const long long base = (long long)(q - q0) * n * 2;
    const int j0 = lo[m], j1 = lo[m] + cap[m];
    for (int j = j0; j < j1; ++j) {
        const int t = idx_read[j];
        if (t == q) continue;
        atomicAdd(&counts[base + 2 * t + (idx_strand[j] == s)], 1);
    }
}

__global__ void ava_scatter_kernel(int m0, int m1, int q0, int n,
                                   const int32_t* __restrict__ min_read,
                                   const int8_t* __restrict__ min_strand,
                                   const int32_t* __restrict__ lo,
                                   const int32_t* __restrict__ cap,
                                   const int32_t* __restrict__ idx_read,
                                   const int8_t* __restrict__ idx_strand,
                                   const int32_t* __restrict__ min_pos,
                                   const int32_t* __restrict__ idx_pos,
                                   const int32_t* __restrict__ qlen, int k,
                                   unsigned long long* __restrict__ cursor,
                                   unsigned long long* __restrict__ keys) {
    const int m = m0 + blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= m1) return;
    const int q = min_read[m];
    const int8_t s = min_strand[m];
    const int pos = min_pos[m];
    const int qrc = qlen[q] - k - pos;
    const long long base = (long long)(q - q0) * n * 2;
    const int j0 = lo[m], j1 = lo[m] + cap[m];
    for (int j = j0; j < j1; ++j) {
        const int t = idx_read[j];
        if (t == q) continue;
        const int plus = idx_strand[j] == s;
        const unsigned long long slot =
            atomicAdd(&cursor[base + 2 * t + plus], 1ull);
        const unsigned qp = (unsigned)(plus ? pos : qrc);
        keys[slot] = ((unsigned long long)(unsigned)idx_pos[j] << 32) | qp;
    }
}

__device__ __forceinline__ void cmp_swap(unsigned long long* K, int a,
                                         int b) {
    const unsigned long long x = K[a], y = K[b];
    if (x > y) { K[a] = y; K[b] = x; }
}

// sorts K[0..n) ascending with the whole block
__device__ void block_sort(unsigned long long* K, int n) {
    int P = 1;
    while (P < n) P <<= 1;
    const int half_pairs = P >> 1;
    for (int size = 2; size <= P; size <<= 1) {
        const int half = size >> 1;
        for (int i = threadIdx.x; i < half_pairs; i += blockDim.x) {
            const int blk = (i / half) * size, r = i % half;
            const int a = blk + r, b = blk + size - 1 - r;
            if (b < n) cmp_swap(K, a, b);
        }
        __syncthreads();
        for (int j = half >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < half_pairs; i += blockDim.x) {
                const int a = (i / j) * 2 * j + (i % j), b = a + j;
                if (b < n) cmp_swap(K, a, b);
            }
            __syncthreads();
        }
    }
}

// a block a segment: its keys sorted in shared memory (cap > 0 anchors,
// 8 bytes each) and written back, or in place in global memory (cap == 0)
__global__ void ava_sort_kernel(const long long* __restrict__ seg_ids,
                                const long long* __restrict__ seg_off,
                                const int32_t* __restrict__ seg_n,
                                unsigned long long* __restrict__ keys,
                                int cap) {
    extern __shared__ __align__(16) unsigned char smem[];
    const long long seg = seg_ids[blockIdx.x];
    unsigned long long* G = keys + seg_off[seg];
    const int n = seg_n[seg];
    if (cap == 0) {
        block_sort(G, n);
        return;
    }
    unsigned long long* K = reinterpret_cast<unsigned long long*>(smem);
    for (int i = threadIdx.x; i < n; i += blockDim.x) K[i] = G[i];
    __syncthreads();
    block_sort(K, n);
    for (int i = threadIdx.x; i < n; i += blockDim.x) G[i] = K[i];
}

// a warp a segment (sorted): chain_dp, then ava.cpp's best chain, into
// the segment's slot w of the launch's list.  Lane l
// holds predecessor j = i-1-l: (t, q, f) and its chain's first anchor and
// length, carried forward so that no walk back is needed; the keys come
// from global memory 32 at a time, the next 32 loading meanwhile.
__global__ void ava_dp_kernel(const long long* __restrict__ seg_ids,
                              int n_segs,
                              const long long* __restrict__ seg_off,
                              const int32_t* __restrict__ seg_n,
                              const unsigned long long* __restrict__ keys,
                              const float* __restrict__ costs, int k,
                              int max_pred, int max_gap, int bandwidth,
                              float min_score, int min_anchors,
                              int8_t* __restrict__ ok,
                              float* __restrict__ score,
                              int32_t* __restrict__ qs0,
                              int32_t* __restrict__ qs1,
                              int32_t* __restrict__ ts0,
                              int32_t* __restrict__ ts1) {
    const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (w >= n_segs) return;
    const int lane = threadIdx.x & 31;
    const long long seg = seg_ids[w];
    const unsigned long long* K = keys + seg_off[seg];
    const int n = seg_n[seg];
    const float kf = (float)k;
    unsigned long long cur = lane < n ? K[lane] : 0ull;
    unsigned long long nxt = 32 + lane < n ? K[32 + lane] : 0ull;
    int tj = 0, qj = 0, sj = 0, cj = 0;
    float fj = 0.0f;
    float best_f = -INFINITY;
    int best_i = 0, best_s = 0, best_c = 0;
    for (int i = 0; i < n; ++i) {
        if ((i & 31) == 0 && i > 0) {
            cur = nxt;
            nxt = i + 32 + lane < n ? K[i + 32 + lane] : 0ull;
        }
        const unsigned long long key = __shfl_sync(FULL, cur, i & 31);
        const int ti = (int)(key >> 32), qi = (int)(unsigned)key;
        float sc = -INFINITY;
        if (lane < max_pred && lane < i) {
            const int dt = ti - tj, dq = qi - qj;
            if (dq > 0 && dt > 0 && dq <= max_gap && dt <= max_gap) {
                const int gap = dt > dq ? dt - dq : dq - dt;
                if (gap <= bandwidth) {
                    const int m = min(min(dq, dt), k);
                    sc = __fsub_rn(__fadd_rn(fj, (float)m), costs[gap]);
                }
            }
        }
        const unsigned u = ordered(sc);
        const unsigned mx = __reduce_max_sync(FULL, u);
        const int wl = __ffs(__ballot_sync(FULL, u == mx)) - 1;
        const float best = __shfl_sync(FULL, sc, wl);
        const int ws = __shfl_sync(FULL, sj, wl);
        const int wc = __shfl_sync(FULL, cj, wl);
        const bool take = best > kf;
        const float fi = take ? best : kf;
        const int si = take ? ws : i, ci = take ? wc + 1 : 1;
        if (fi > best_f) { best_f = fi; best_i = i; best_s = si; best_c = ci; }
        const int tn = __shfl_up_sync(FULL, tj, 1);
        const int qn = __shfl_up_sync(FULL, qj, 1);
        const float fn = __shfl_up_sync(FULL, fj, 1);
        const int sn = __shfl_up_sync(FULL, sj, 1);
        const int cn = __shfl_up_sync(FULL, cj, 1);
        if (lane == 0) { tj = ti; qj = qi; fj = fi; sj = si; cj = ci; }
        else { tj = tn; qj = qn; fj = fn; sj = sn; cj = cn; }
    }
    if (lane != 0) return;
    ok[w] = (best_c >= min_anchors && best_f >= min_score) ? 1 : 0;
    score[w] = best_f;
    const unsigned long long ks = K[best_s], kb = K[best_i];
    qs0[w] = (int32_t)(unsigned)ks;
    qs1[w] = (int32_t)(unsigned)kb;
    ts0[w] = (int32_t)(ks >> 32);
    ts1[w] = (int32_t)(kb >> 32);
}

inline int blocks(long long n, int t) { return (int)((n + t - 1) / t); }

}  // namespace

extern "C" const char* ava_error_string(int rc) {
    return cudaGetErrorString((cudaError_t)rc);
}

extern "C" int ava_hits_launch(const void* min_hash, const void* min_read,
                               int n_min, const void* idx_hash,
                               const void* idx_read, int n_idx, int max_hits,
                               void* lo, void* cap, void* nh, void* stream) {
    ava_hits_kernel<<<blocks(n_min, 256), 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)min_hash, (const int32_t*)min_read, n_min,
        (const uint32_t*)idx_hash, (const int32_t*)idx_read, n_idx, max_hits,
        (int32_t*)lo, (int32_t*)cap, (int32_t*)nh);
    return (int)cudaGetLastError();
}

extern "C" int ava_read_sums_launch(const void* nh, const void* off,
                                    int n_reads, void* sums, void* stream) {
    ava_read_sums_kernel<<<n_reads, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)nh, (const long long*)off, (long long*)sums);
    return (int)cudaGetLastError();
}

extern "C" int ava_count_launch(int m0, int m1, int q0, int n,
                                const void* min_read, const void* min_strand,
                                const void* lo, const void* cap,
                                const void* idx_read, const void* idx_strand,
                                void* counts, void* stream) {
    ava_count_kernel<<<blocks(m1 - m0, 256), 256, 0, (cudaStream_t)stream>>>(
        m0, m1, q0, n, (const int32_t*)min_read, (const int8_t*)min_strand,
        (const int32_t*)lo, (const int32_t*)cap, (const int32_t*)idx_read,
        (const int8_t*)idx_strand, (int32_t*)counts);
    return (int)cudaGetLastError();
}

extern "C" int ava_scatter_launch(int m0, int m1, int q0, int n,
                                  const void* min_read,
                                  const void* min_strand, const void* lo,
                                  const void* cap, const void* idx_read,
                                  const void* idx_strand,
                                  const void* min_pos, const void* idx_pos,
                                  const void* qlen, int k, void* cursor,
                                  void* keys, void* stream) {
    ava_scatter_kernel<<<blocks(m1 - m0, 256), 256, 0,
                         (cudaStream_t)stream>>>(
        m0, m1, q0, n, (const int32_t*)min_read, (const int8_t*)min_strand,
        (const int32_t*)lo, (const int32_t*)cap, (const int32_t*)idx_read,
        (const int8_t*)idx_strand, (const int32_t*)min_pos,
        (const int32_t*)idx_pos, (const int32_t*)qlen, k,
        (unsigned long long*)cursor, (unsigned long long*)keys);
    return (int)cudaGetLastError();
}

// one launch of a size class: n_segs blocks; cap > 0 anchors in shared
// memory, cap == 0 in place in global memory
extern "C" int ava_sort_launch(const void* seg_ids, int n_segs,
                               const void* seg_off, const void* seg_n,
                               void* keys, int cap, void* stream) {
    const size_t smem = (size_t)cap * 8;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            ava_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int threads = cap > 0 && cap <= 1024 ? 128 : cap > 0 && cap <= 4096
        ? 256 : 512;
    ava_sort_kernel<<<n_segs, threads, smem, (cudaStream_t)stream>>>(
        (const long long*)seg_ids, (const long long*)seg_off,
        (const int32_t*)seg_n, (unsigned long long*)keys, cap);
    return (int)cudaGetLastError();
}

// every segment of the chunk, a warp each, 8 a block
extern "C" int ava_dp_launch(const void* seg_ids, int n_segs,
                             const void* seg_off, const void* seg_n,
                             const void* keys, const void* costs, int k,
                             int max_pred, int max_gap, int bandwidth,
                             float min_score, int min_anchors, void* ok,
                             void* score, void* qs0, void* qs1, void* ts0,
                             void* ts1, void* stream) {
    if (max_pred < 1 || max_pred > 32) return (int)cudaErrorInvalidValue;
    ava_dp_kernel<<<blocks(n_segs, 8), 256, 0, (cudaStream_t)stream>>>(
        (const long long*)seg_ids, n_segs, (const long long*)seg_off,
        (const int32_t*)seg_n, (const unsigned long long*)keys,
        (const float*)costs, k, max_pred, max_gap, bandwidth, min_score,
        min_anchors, (int8_t*)ok, (float*)score, (int32_t*)qs0,
        (int32_t*)qs1, (int32_t*)ts0, (int32_t*)ts1);
    return (int)cudaGetLastError();
}
