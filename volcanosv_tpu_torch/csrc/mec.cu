// MEC phasing: alternating majority votes over random restarts, for Hopper
// (sm_90a).
//
// Replaces: volcanosv_tpu/phasing/phase.py::_mec_phase, jitted XLA (not a
// Pallas kernel; as plain torch, phasing/phase.py::_mec_phase_plain, it is
// two gathers and an index_add_ a half-step, about 250 launches a call).
//
// Computes, for each of NR restarts with initial SNP phases h0[q] (int32,
// restart 0 the chain init, the others the reference's random draws, all
// made on the host), over O observations (read r, SNP s, allele o in
// {+1, -1, 0}):
//   n_iter times:  a[r] = sign(sum over obs of r of h[s] * o)   (read vote)
//                  h[s] = sign(sum over obs of s of a[r] * o)   (SNP vote)
//   then once more the read vote; sign(v) = +1 for v >= 0, so a read or a
//   SNP without observations votes +1.  MEC[q] = the number of observations
//   with o != 0 and a[r] * h[s] * o < 0; the result is the h, a and MEC of
//   the first restart of the lowest MEC (jnp.argmin's choice).  With
//   n_iter = 0, h is h0 as given.
//
// Input: the observations as the pileup gives them (read and SNP indices
// int32 or int64, alleles int8; by read, with the SV-marker columns'
// appended at the end, an order nothing here relies on).  The launch first
// sorts the informative ones (o != 0, both ends in range; the others add
// nothing and are never counted) into two CSR orders on the card, a
// counting sort: mec_count_kernel counts each read's and each SNP's
// observations, three scan kernels turn the R + S counts into int64 row
// offsets (a tile a block, the tiles' totals, the totals added back), and
// mec_scatter_kernel writes each observation twice, s * 2 + (o < 0) into
// its read's row and r * 2 + (o < 0) into its SNP's.  The order inside a
// row follows the atomics; every sum is of integers, so the outputs equal
// the plain version's exactly all the same.  A vote is then a sum over a
// row: no atomics, no zeroing.
//
// What bounds it on the card: a half-step reads each informative
// observation once and adds one signed term a restart; that is little work,
// and the 2 * n_iter + 1 votes depend on each other.  So the bound is the
// latency of a half-step (a barrier, then the loads of a row), and at
// chromosome scale the bytes of the CSR and the state.
//
// Two designs; phasing/phase.py::mec_plan picks one from (S, R, O):
//
// mec_vote_kernel (the smem design; R + S up to about 50,000 at 4-6
// observations a read: the golden run's and asm's chromosomes): a cluster of
// C = 1 .. 16 CTAs a restart, one launch for every vote.  Every CTA keeps
// int8 copies of h and a in shared memory, and its slice of the rows of both
// CSR orders (cut at rows + entries; 32-bit row offsets, 16-bit entries
// node * 2 + sign where R and S are below 2^15, else 32-bit) beside them,
// loaded once; a slice that does not fit is read from the global CSR
// instead (a row longer than the rest put together).  A thread sums a row.
// A CTA writes its rows' new signs into its own copy, then into every other
// CTA's copy of the cluster by remote shared-memory stores (4-byte words,
// single bytes at the slice's ends); one cluster barrier ends the half-step
// (one __syncthreads at C = 1).  The MEC is read off the last read vote: a
// read row of n observations and sum v holds (n - |v|) / 2 inconsistent
// ones.  Each CTA adds its rows' count to the restart's MEC and writes its
// rows of h and a to a scratch, and the last CTA to finish (a ticket counter
// after a __threadfence) picks the first lowest MEC and copies that
// restart's rows to the outputs.  phasing/phase.py::mec_plan takes one CTA
// a restart up to 12,500 observations (the golden run's sets: there a
// cluster barrier's 0.75 us a half-step costs more than the split saves)
// and 8 above (`asm`'s set), as chip_smoke.py's timings in turns show.
//
// mec_grid_*_kernel (larger, up to whole chromosomes: 833,333 reads and
// 166,667 SNPs at 30x HiFi): h and a live in global memory, restart-minor
// (node * NR + q, so a row's NR values share a 32-byte sector: 32 MB at
// chromosome scale, inside the 50 MB L2), a thread a row for every
// restart, and a kernel boundary is the barrier between half-steps:
// 2 * n_iter + 1 vote launches (the last also counts the MEC), then the
// pick.  The first read vote reads h0 itself (restart-major).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GRID_THREADS = 256;
constexpr int GRID_BLOCKS = 132 * 8;
constexpr int GROUP = 8;                  // restarts a thread sums at once
constexpr int MAX_RESTARTS = 64;
constexpr int SCAN_THREADS = 1024;        // 32 warps: one warp scans them
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int VOTE_THREADS = 1024;       // a CTA of the smem design
constexpr int VOTE_WARPS = VOTE_THREADS / 32;
constexpr int MAX_CTAS = 16;              // a cluster's most (non-portable)
constexpr int UNROLL = 4;                 // entries a thread loads at once
constexpr int BRANCH_SMEM = 1;
constexpr int BRANCH_GRID = 2;

__device__ __forceinline__ int sgn(int v) { return v >= 0 ? 1 : -1; }

__host__ __device__ __forceinline__ size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// an observation of a CSR row: its other end and its allele
__device__ __forceinline__ int node_of(int packed) { return packed >> 1; }
__device__ __forceinline__ int allele_of(int packed) {
  return (packed & 1) ? -1 : 1;
}

// the observations as given: read and SNP indices int32 or int64 (`wide`)
struct Obs {
  const void* read;
  const void* snp;
  const int8_t* allele;
  long long n;
  int read_wide;
  int snp_wide;
};

__device__ __forceinline__ long long index_at(const void* p, int wide,
                                              long long i) {
  return wide ? static_cast<const long long*>(p)[i]
              : (long long)static_cast<const int*>(p)[i];
}

// observation i's read, SNP and sign, and whether it enters the votes: o
// != 0, 0 <= r < R and 0 <= s < S
__device__ __forceinline__ bool informative(const Obs& x, long long i, int S,
                                            int R, int& r, int& s, int& neg) {
  const int o = x.allele[i];
  const long long rr = index_at(x.read, x.read_wide, i);
  const long long ss = index_at(x.snp, x.snp_wide, i);
  r = (int)rr;
  s = (int)ss;
  neg = o < 0;
  return o != 0 && rr >= 0 && rr < R && ss >= 0 && ss < S;
}

// counts[r] and counts[R + s]: the informative observations of each read
// and each SNP
__global__ void __launch_bounds__(GRID_THREADS)
mec_count_kernel(Obs x, int S, int R, int* __restrict__ counts) {
  for (long long i = blockIdx.x * (long long)GRID_THREADS + threadIdx.x;
       i < x.n; i += (long long)gridDim.x * GRID_THREADS) {
    int r, s, neg;
    if (!informative(x, i, S, R, r, s, neg)) continue;
    atomicAdd(counts + r, 1);
    atomicAdd(counts + R + s, 1);
  }
}

// the inclusive prefix sum of v over the block (SCAN_THREADS threads), and
// the block's total in *total; every thread calls it
__device__ __forceinline__ long long block_scan(long long v,
                                                long long* warp_sum,
                                                long long* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) warp_sum[w] = v;
  __syncthreads();
  if (w == 0) {
    long long t = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t += y;
    }
    warp_sum[lane] = t;
  }
  __syncthreads();
  const long long out = v + (w > 0 ? warp_sum[w - 1] : 0);
  *total = warp_sum[31];
  __syncthreads();                        // warp_sum free for the next call
  return out;
}

// ptr[i] = the sum of counts[j] for j < i inside i's tile of SCAN_TILE,
// sums[tile] = the tile's total
__global__ void __launch_bounds__(SCAN_THREADS)
mec_scan_tile_kernel(const int* __restrict__ counts, long long n,
                     long long* __restrict__ ptr,
                     long long* __restrict__ sums) {
  __shared__ long long warp_sum[32];
  const long long base =
      blockIdx.x * (long long)SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  int c[SCAN_ITEMS];
  long long t = 0;
#pragma unroll
  for (int u = 0; u < SCAN_ITEMS; ++u) {
    c[u] = base + u < n ? counts[base + u] : 0;
    t += c[u];
  }
  long long total;
  long long run = block_scan(t, warp_sum, &total) - t;
#pragma unroll
  for (int u = 0; u < SCAN_ITEMS; ++u) {
    if (base + u < n) ptr[base + u] = run;
    run += c[u];
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// the tiles' totals to their exclusive prefix sums, in place (one block),
// and the sum of all to *end
__global__ void __launch_bounds__(SCAN_THREADS)
mec_scan_sums_kernel(long long* __restrict__ sums, long long n_tiles,
                     long long* __restrict__ end) {
  __shared__ long long warp_sum[32];
  long long carry = 0;
  for (long long b0 = 0; b0 < n_tiles; b0 += SCAN_THREADS) {
    const long long b = b0 + threadIdx.x;
    const long long v = b < n_tiles ? sums[b] : 0;
    long long total;
    const long long incl = block_scan(v, warp_sum, &total);
    if (b < n_tiles) sums[b] = carry + incl - v;
    carry += total;
  }
  if (threadIdx.x == 0) *end = carry;
}

// ptr[i] += the totals of the tiles before i's
__global__ void __launch_bounds__(GRID_THREADS)
mec_scan_add_kernel(long long* __restrict__ ptr, long long n,
                    const long long* __restrict__ sums) {
  for (long long i = blockIdx.x * (long long)GRID_THREADS + threadIdx.x;
       i < n; i += (long long)gridDim.x * GRID_THREADS)
    ptr[i] += sums[i / SCAN_TILE];
}

// each informative observation into its read's row (s * 2 + sign) and its
// SNP's (r * 2 + sign), at a slot the row's count hands out; the counts
// end at 0
template <typename E>
__global__ void __launch_bounds__(GRID_THREADS)
mec_scatter_kernel(Obs x, int S, int R, const long long* __restrict__ ptr,
                   int* __restrict__ counts, E* __restrict__ entries) {
  for (long long i = blockIdx.x * (long long)GRID_THREADS + threadIdx.x;
       i < x.n; i += (long long)gridDim.x * GRID_THREADS) {
    int r, s, neg;
    if (!informative(x, i, S, R, r, s, neg)) continue;
    entries[ptr[r] + atomicSub(counts + r, 1) - 1] = (E)(s * 2 + neg);
    entries[ptr[R + s] + atomicSub(counts + R + s, 1) - 1] = (E)(r * 2 + neg);
  }
}

// The smallest r in [0, n] with r + (p[r] - p[0]) >= t (the rows and
// entries before row r), where n + (p[n] - p[0]) >= t.
__device__ int cut_at(const long long* p, int n, long long t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (m + (p[m] - p[0]) >= t) hi = m; else lo = m + 1;
  }
  return lo;
}

// One vote over a CTA's n rows of one CSR order (offsets off, off[0] = 0),
// a thread a row: dst[row] = sign(sum over the row of src[node] * o); with
// `count`, the row's inconsistent observations, (n - |v|) / 2, into bad.
template <typename E>
__device__ __forceinline__ void walk(int n, const int* off, const E* ent,
                                     const int8_t* src, int8_t* dst,
                                     bool count, unsigned& bad) {
  for (int row = threadIdx.x; row < n; row += VOTE_THREADS) {
    const int beg = off[row], end = off[row + 1];
    int v = 0, j = beg;
    for (; j + UNROLL <= end; j += UNROLL) {
      int p[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) p[u] = (int)ent[j + u];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int x = src[node_of(p[u])];
        v += (p[u] & 1) ? -x : x;
      }
    }
    for (; j < end; ++j) {
      const int p = (int)ent[j];
      const int x = src[node_of(p)];
      v += (p & 1) ? -x : x;
    }
    dst[row] = v >= 0 ? 1 : -1;
    if (count) bad += (unsigned)((end - beg - abs(v)) >> 1);
  }
}

// This CTA's bytes [b0, b1) of arr into the same bytes of every other CTA
// of the cluster: 4-byte words, single bytes at the ends.
__device__ void broadcast(cg::cluster_group& cl, int8_t* arr, int b0,
                          int b1) {
  const int C = (int)cl.num_blocks(), me = (int)cl.block_rank();
  const int w0 = (b0 + 3) >> 2, w1 = b1 >> 2;
  int nh = b1 - b0, nw = 0, nt = 0;
  if (w0 < w1) {
    nh = 4 * w0 - b0;
    nw = w1 - w0;
    nt = b1 - 4 * w1;
  }
  const int units = nh + nw + nt;
  for (int i = threadIdx.x; i < (C - 1) * units; i += VOTE_THREADS) {
    const int k = i / units, u = i - k * units;
    int8_t* dst = cl.map_shared_rank(arr, (unsigned)(k + (k >= me)));
    if (u < nh) {
      dst[b0 + u] = arr[b0 + u];
    } else if (u < nh + nw) {
      const int wi = w0 + u - nh;
      reinterpret_cast<int*>(dst)[wi] = reinterpret_cast<const int*>(arr)[wi];
    } else {
      const int b = 4 * w1 + u - nh - nw;
      dst[b] = arr[b];
    }
  }
}

// The smem design: a cluster of C CTAs a restart (the grid is NR * C CTAs,
// clusters of C), 1 <= C <= MAX_CTAS, smem_bytes of dynamic shared memory.
// ptr: the R + S + 1 int64 row offsets (reads, then SNPs), entries: the CSR
// in E.  Writes each restart's MEC (added) and rows to mecs and rows_h /
// rows_a, and by the last CTA the best restart's to the outputs.
template <typename E>
__global__ void __launch_bounds__(VOTE_THREADS, 1)
mec_vote_kernel(const long long* __restrict__ ptr,
                const E* __restrict__ entries, const int* __restrict__ h0,
                int S, int R, int n_iter, int smem_bytes, long long* mecs,
                unsigned* ticket, int* rows_h, int* rows_a,
                int* __restrict__ h_out, int* __restrict__ a_out,
                long long* __restrict__ mec_out) {
  extern __shared__ __align__(16) unsigned char vote_smem[];
  __shared__ int bnd[4];
  __shared__ unsigned warp_bad[VOTE_WARPS];
  __shared__ int is_last;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), c = (int)cl.block_rank();
  const int q = blockIdx.x / C;
  const int tid = threadIdx.x, w = tid >> 5;
  // this CTA's read rows [bnd0, bnd1) and SNP rows [bnd2, bnd3), cut at
  // rows + entries (c / C) of each order
  if (tid < 4) {
    const bool snp = tid >= 2;
    const int n = snp ? S : R;
    const long long* p = snp ? ptr + R : ptr;
    const int k = c + (tid & 1);
    bnd[tid] = k == 0 ? 0 : k == C ? n
             : cut_at(p, n, (n + (p[n] - p[0])) * k / C);
  }
  __syncthreads();
  const int r0 = bnd[0], r1 = bnd[1], s0 = bnd[2], s1 = bnd[3];
  const int nrr = r1 - r0, nrs = s1 - s0;
  const long long er = ptr[r0], es = ptr[R + s0];
  const int ner = (int)(ptr[r1] - er), nes = (int)(ptr[R + s1] - es);
  // shared memory: h, a, the two orders' offsets, then their entries
  int8_t* hs = reinterpret_cast<int8_t*>(vote_smem);
  int8_t* as = hs + round16(S);
  int* roff = reinterpret_cast<int*>(as + round16(R));
  int* soff = roff + round16((size_t)(nrr + 1) * 4) / 4;
  E* ents = reinterpret_cast<E*>(soff + round16((size_t)(nrs + 1) * 4) / 4);
  const bool fit = reinterpret_cast<unsigned char*>(ents + ner + nes) <=
                   vote_smem + smem_bytes;
  for (int i = tid; i < S; i += VOTE_THREADS)
    hs[i] = (int8_t)h0[(size_t)q * S + i];
  for (int i = tid; i <= nrr; i += VOTE_THREADS)
    roff[i] = (int)(ptr[r0 + i] - er);
  for (int i = tid; i <= nrs; i += VOTE_THREADS)
    soff[i] = (int)(ptr[R + s0 + i] - es);
  if (fit) {
    for (int i = tid; i < ner; i += VOTE_THREADS) ents[i] = entries[er + i];
    for (int i = tid; i < nes; i += VOTE_THREADS)
      ents[ner + i] = entries[es + i];
  }
  const E* ent_r = fit ? ents : entries + er;
  const E* ent_s = fit ? ents + ner : entries + es;
  __syncthreads();
  // every CTA of the cluster loaded before any remote store
  if (C > 1) cl.sync();
  unsigned bad = 0;
  for (int it = 0;; ++it) {
    const bool last = it == n_iter;
    walk(nrr, roff, ent_r, hs, as + r0, last, bad);
    __syncthreads();
    if (last) break;
    if (C > 1) {
      broadcast(cl, as, r0, r1);
      cl.sync();
    }
    walk(nrs, soff, ent_s, as, hs + s0, false, bad);
    __syncthreads();
    if (C > 1) {
      broadcast(cl, hs, s0, s1);
      cl.sync();
    }
  }
  // no remote store follows the last cluster barrier: a CTA may leave
  bad = __reduce_add_sync(FULL, bad);
  if ((tid & 31) == 0) warp_bad[w] = bad;
  for (int s = s0 + tid; s < s1; s += VOTE_THREADS)
    rows_h[(size_t)q * S + s] = hs[s];
  for (int r = r0 + tid; r < r1; r += VOTE_THREADS)
    rows_a[(size_t)q * R + r] = as[r];
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
    for (int i = 0; i < VOTE_WARPS; ++i) total += warp_bad[i];
    atomicAdd(reinterpret_cast<unsigned long long*>(mecs) + q, total);
  }
  // every thread's rows, and thread 0's MEC, visible before the ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int nr = gridDim.x / C;
  const volatile long long* vm = mecs;
  int best = 0;
  long long lo = vm[0];
  for (int j = 1; j < nr; ++j) {
    const long long m = vm[j];
    if (m < lo) {
      lo = m;
      best = j;
    }
  }
  for (int s = tid; s < S; s += VOTE_THREADS)
    h_out[s] = __ldcg(rows_h + (size_t)best * S + s);
  for (int r = tid; r < R; r += VOTE_THREADS)
    a_out[r] = __ldcg(rows_a + (size_t)best * R + r);
  if (tid == 0) *mec_out = lo;
}

// `rounds` half-step barriers of the smem design on one cluster of C CTAs
// of VOTE_THREADS (__syncthreads, then a cluster barrier when C > 1): their
// nanoseconds and SM cycles to out[0], out[1] (the first CTA's clock).
__global__ void __launch_bounds__(VOTE_THREADS, 1)
mec_sync_chase_kernel(int rounds, long long* out) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  __syncthreads();
  if (C > 1) cl.sync();
  long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  const long long c0 = clock64();
  for (int i = 0; i < rounds; ++i) {
    __syncthreads();
    if (C > 1) cl.sync();
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = c1 - c0;
  }
}

// h or a of every restart: node n of restart q at p[n * node_stride + q *
// restart_stride] (restart-minor in the grid design's state, restart-major
// in h0)
struct Vals {
  const int* p;
  long long node_stride;
  long long restart_stride;
};

__device__ __forceinline__ int val_at(const Vals& x, int node, int q) {
  return x.p[node * x.node_stride + q * x.restart_stride];
}

// dst[row * nr + q] = sign(sum over the row of src(node, q) * o) for every
// row and restart; with `mecs` (the last read vote, src = h, dst = a), also
// mecs[q] += the row's observations with a * h * o < 0.
__global__ void __launch_bounds__(GRID_THREADS)
mec_grid_vote_kernel(const long long* __restrict__ ptr,
                     const int* __restrict__ obs, int n_rows, int nr,
                     Vals src, int* __restrict__ dst,
                     long long* __restrict__ mecs) {
  __shared__ unsigned count[MAX_RESTARTS];
  if (mecs != nullptr) {
    for (int q = threadIdx.x; q < nr; q += GRID_THREADS) count[q] = 0;
    __syncthreads();
  }
  const int stride = gridDim.x * GRID_THREADS;
  // a warp-uniform loop, so that every lane reaches the MEC's reductions
  for (int base = blockIdx.x * GRID_THREADS; base < n_rows; base += stride) {
    const int row = base + threadIdx.x;
    const bool in = row < n_rows;
    const long long beg = in ? ptr[row] : 0, end = in ? ptr[row + 1] : 0;
    for (int q0 = 0; q0 < nr; q0 += GROUP) {
      int v[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; ++u) v[u] = 0;
      for (long long j = beg; j < end; ++j) {
        const int p = obs[j];
        const int node = node_of(p), o = allele_of(p);
#pragma unroll
        for (int u = 0; u < GROUP; ++u)
          if (q0 + u < nr) v[u] += val_at(src, node, q0 + u) * o;
      }
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        v[u] = sgn(v[u]);
        if (in && q0 + u < nr) dst[(size_t)row * nr + q0 + u] = v[u];
      }
      if (mecs == nullptr) continue;
      unsigned bad[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; ++u) bad[u] = 0;
      for (long long j = beg; j < end; ++j) {
        const int p = obs[j];
        const int node = node_of(p), o = allele_of(p);
#pragma unroll
        for (int u = 0; u < GROUP; ++u)
          if (q0 + u < nr) bad[u] += v[u] * val_at(src, node, q0 + u) * o < 0;
      }
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const unsigned w = __reduce_add_sync(FULL, bad[u]);
        if ((threadIdx.x & 31) == 0 && w != 0) atomicAdd(count + q0 + u, w);
      }
    }
  }
  if (mecs == nullptr) return;
  __syncthreads();
  for (int q = threadIdx.x; q < nr; q += GRID_THREADS)
    if (count[q] != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(mecs) + q,
                (unsigned long long)count[q]);
}

// the first restart of the lowest MEC: its h, a and MEC to the outputs
__global__ void __launch_bounds__(GRID_THREADS)
mec_grid_pick_kernel(int nr, Vals h, int S, const int* __restrict__ a, int R,
                     const long long* __restrict__ mecs,
                     int* __restrict__ h_out, int* __restrict__ a_out,
                     long long* __restrict__ mec_out) {
  int best = 0;
  long long lo = mecs[0];
  for (int q = 1; q < nr; ++q) {
    if (mecs[q] < lo) {
      lo = mecs[q];
      best = q;
    }
  }
  const int stride = gridDim.x * GRID_THREADS;
  const int j0 = blockIdx.x * GRID_THREADS + threadIdx.x;
  for (int j = j0; j < S; j += stride) h_out[j] = val_at(h, j, best);
  for (int j = j0; j < R; j += stride) a_out[j] = a[(size_t)j * nr + best];
  if (j0 == 0) *mec_out = lo;
}

// the scratch, in order: the NR MECs and the ticket (zeroed), the R + S row
// counts (zeroed with them), the R + S + 1 row offsets, the scan's tile
// totals, the 2 * O CSR entries (at most), then NR x (S + R) int32 (the
// smem design's rows of each restart, or the grid design's state)
struct Layout {
  size_t head, counts, ptr, sums, entries, state, total;
  long long n_tiles;
};

Layout layout(int nr, int S, int R, long long n_obs) {
  Layout l;
  const long long n = (long long)S + R;
  l.n_tiles = n / SCAN_TILE + 1;
  l.head = 0;
  l.counts = round16((size_t)nr * 8 + 4);
  l.ptr = l.counts + round16((size_t)n * 4);
  l.sums = l.ptr + round16((size_t)(n + 1) * 8);
  l.entries = l.sums + round16((size_t)l.n_tiles * 8);
  l.state = l.entries + round16((size_t)n_obs * 2 * 4);
  l.total = l.state + (size_t)nr * n * 4;
  return l;
}

int grid_blocks(long long n) {
  const long long b = (n + GRID_THREADS - 1) / GRID_THREADS;
  return (int)(b < 1 ? 1 : b > GRID_BLOCKS ? GRID_BLOCKS : b);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Bytes of a CTA's shared memory that the smem design must hold at C CTAs
// a restart (h, a and the row offsets of its slice: a slice of an order of
// n rows holds at most ceil((n + O) / C) rows, and all n at C = 1), and
// with the entries of an even slice (phasing/phase.py::mec_smem_need is its
// twin; a slice whose entries do not fit is read from global memory).
void smem_need(int S, int R, long long O, int C, long long* fixed,
               long long* full) {
  const long long rr = std::min<long long>(R, ceil_div((long long)R + O, C));
  const long long rs = std::min<long long>(S, ceil_div((long long)S + O, C));
  const long long er = std::min<long long>(O, ceil_div((long long)R + O, C));
  const long long es = std::min<long long>(O, ceil_div((long long)S + O, C));
  const int esize = S < (1 << 15) && R < (1 << 15) ? 2 : 4;
  *fixed = (long long)round16(S) + round16(R) + round16((rr + 1) * 4) +
           round16((rs + 1) * 4);
  *full = *fixed + (long long)round16((er + es) * esize);
}

// the smem design's kernels take the device's largest dynamic shared
// memory and clusters past 8 CTAs; set once a process (0 or the error)
cudaError_t vote_attributes(int* smem) {
  static int bytes = -1;
  static cudaError_t err = cudaSuccess;
  if (bytes < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, mec_vote_kernel<int>);
    if (err == cudaSuccess) {
      bytes = (optin - (int)attr.sharedSizeBytes) / 16 * 16;
      for (int k = 0; k < 3 && err == cudaSuccess; ++k) {
        const void* f = k == 0 ? (const void*)mec_vote_kernel<int>
                      : k == 1 ? (const void*)mec_vote_kernel<uint16_t>
                               : (const void*)mec_sync_chase_kernel;
        err = cudaFuncSetAttribute(
            f, cudaFuncAttributeMaxDynamicSharedMemorySize,
            k == 2 ? 0 : bytes);
        if (err == cudaSuccess)
          err = cudaFuncSetAttribute(
              f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      }
    }
    if (err != cudaSuccess) bytes = 0;
  }
  *smem = bytes;
  return err;
}

cudaLaunchConfig_t cluster_config(int grid, int C, size_t smem,
                                  cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(VOTE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}
}  // namespace

extern "C" const char* mec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The dynamic shared memory a CTA of the smem design takes (the device's
// largest, less the kernel's static part; 0 if the device cannot be asked).
extern "C" int mec_smem_bytes(void) {
  int smem = 0;
  vote_attributes(&smem);
  return smem;
}

// `rounds` of the smem design's half-step barrier on one cluster of C CTAs
// (1 <= C <= MAX_CTAS), on `stream`: out[0] their nanoseconds, out[1] their
// SM cycles (int64).  Returns the cudaError_t of the launch.
extern "C" int mec_sync_chase(int C, int rounds, void* out, void* stream) {
  int smem = 0;
  cudaError_t err = vote_attributes(&smem);
  if (err != cudaSuccess) return (int)err;
  if (C < 1 || C > MAX_CTAS || rounds < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      C, C, 0, static_cast<cudaStream_t>(stream), &attr);
  return (int)cudaLaunchKernelEx(&cfg, mec_sync_chase_kernel, rounds,
                                 static_cast<long long*>(out));
}

// Bytes of device scratch mec_phase_launch needs for NR restarts, S SNPs, R
// reads and O observations (Layout).
extern "C" long long mec_scratch_bytes(int nr, int S, int R, long long n_obs) {
  return (long long)layout(nr, S, R, n_obs).total;
}

// The MEC phasing of O observations (obs_read, obs_snp: int32, or int64
// where *_wide; obs_allele int8) from the NR x S int32 initial phases h0, on
// `stream`: h_out (S,) int32, a_out (R,) int32, mec_out one int64.  branch
// 1: the smem design at `ctas` CTAs a restart (1 .. 16; h, a and the row
// offsets must fit a CTA's shared memory, smem_need), 2: the grid design;
// phasing/phase.py::mec_plan picks one.  Scratch as mec_scratch_bytes asks.
// 1 <= NR <= 64.  Returns the cudaError_t of the launches.
extern "C" int mec_phase_launch(const void* obs_read, int read_wide,
                                const void* obs_snp, int snp_wide,
                                const void* obs_allele, long long n_obs,
                                const void* h0, int nr, int S, int R,
                                int n_iter, int branch, int ctas,
                                void* scratch, long long scratch_bytes,
                                void* h_out, void* a_out, void* mec_out,
                                void* stream) {
  if (nr < 1 || nr > MAX_RESTARTS || S < 0 || R < 0 || n_obs < 0 ||
      n_iter < 0 || branch < BRANCH_SMEM || branch > BRANCH_GRID)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(nr, S, R, n_obs);
  if (scratch == nullptr || scratch_bytes < (long long)l.total)
    return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = vote_attributes(&smem);
  if (err != cudaSuccess) return (int)err;
  const bool narrow = S < (1 << 15) && R < (1 << 15);
  if (branch == BRANCH_SMEM) {
    long long fixed, full;
    if (ctas < 1 || ctas > MAX_CTAS) return (int)cudaErrorInvalidValue;
    smem_need(S, R, n_obs, ctas, &fixed, &full);
    if (fixed > smem) return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Obs x{obs_read, obs_snp, static_cast<const int8_t*>(obs_allele),
              n_obs, read_wide, snp_wide};
  const int* h0p = static_cast<const int*>(h0);
  int* ho = static_cast<int*>(h_out);
  int* ao = static_cast<int*>(a_out);
  long long* mo = static_cast<long long*>(mec_out);
  char* base = static_cast<char*>(scratch);
  long long* mecs = reinterpret_cast<long long*>(base);
  unsigned* ticket = reinterpret_cast<unsigned*>(base + (size_t)nr * 8);
  int* counts = reinterpret_cast<int*>(base + l.counts);
  long long* ptr = reinterpret_cast<long long*>(base + l.ptr);
  long long* sums = reinterpret_cast<long long*>(base + l.sums);
  int* entries = reinterpret_cast<int*>(base + l.entries);
  uint16_t* entries16 = reinterpret_cast<uint16_t*>(base + l.entries);
  int* ints = reinterpret_cast<int*>(base + l.state);
  const long long n = (long long)S + R;
  const bool short_entries = branch == BRANCH_SMEM && narrow;

  // the CSR: counts, their offsets, the entries
  err = cudaMemsetAsync(base, 0, l.ptr, st);
  if (err != cudaSuccess) return (int)err;
  mec_count_kernel<<<grid_blocks(n_obs), GRID_THREADS, 0, st>>>(x, S, R,
                                                                 counts);
  mec_scan_tile_kernel<<<(unsigned)l.n_tiles, SCAN_THREADS, 0, st>>>(
      counts, n, ptr, sums);
  mec_scan_sums_kernel<<<1, SCAN_THREADS, 0, st>>>(sums, l.n_tiles, ptr + n);
  mec_scan_add_kernel<<<grid_blocks(n), GRID_THREADS, 0, st>>>(ptr, n, sums);
  if (short_entries)
    mec_scatter_kernel<<<grid_blocks(n_obs), GRID_THREADS, 0, st>>>(
        x, S, R, ptr, counts, entries16);
  else
    mec_scatter_kernel<<<grid_blocks(n_obs), GRID_THREADS, 0, st>>>(
        x, S, R, ptr, counts, entries);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int* rows_h = ints;                     // NR x S
  int* rows_a = ints + (size_t)nr * S;    // NR x R
  if (branch == BRANCH_SMEM) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(nr * ctas, ctas, (size_t)smem, st, &attr);
    if (short_entries)
      err = cudaLaunchKernelEx(&cfg, mec_vote_kernel<uint16_t>,
                               (const long long*)ptr,
                               (const uint16_t*)entries16, h0p, S, R, n_iter,
                               smem, mecs, ticket, rows_h, rows_a, ho, ao,
                               mo);
    else
      err = cudaLaunchKernelEx(&cfg, mec_vote_kernel<int>,
                               (const long long*)ptr, (const int*)entries,
                               h0p, S, R, n_iter, smem, mecs, ticket, rows_h,
                               rows_a, ho, ao, mo);
    return (int)err;
  }
  const long long* rp = ptr;              // R + 1 offsets
  const long long* sp = ptr + R;          // S + 1 offsets
  int* H = rows_h;                        // S x NR
  int* A = rows_a;                        // R x NR
  Vals hv{h0p, 1, S};                     // h0: restart-major
  const Vals hs{H, nr, 1};
  for (int it = 0; it <= n_iter; ++it) {
    const bool last = it == n_iter;
    mec_grid_vote_kernel<<<grid_blocks(R), GRID_THREADS, 0, st>>>(
        rp, entries, R, nr, hv, A, last ? mecs : nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (last) break;
    mec_grid_vote_kernel<<<grid_blocks(S), GRID_THREADS, 0, st>>>(
        sp, entries, S, nr, Vals{A, nr, 1}, H, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    hv = hs;
  }
  mec_grid_pick_kernel<<<grid_blocks((long long)S > R ? S : R), GRID_THREADS,
                         0, st>>>(nr, hv, S, A, R, mecs, ho, ao, mo);
  return (int)cudaGetLastError();
}
