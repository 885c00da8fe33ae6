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
// observation once (4 bytes) and adds one signed term a restart; that is
// little work, and the 2 * n_iter + 1 votes depend on each other.  So the
// bound is the latency of a half-step (a barrier, then rows of dependent
// loads), and at chromosome scale the bytes of the CSR and the state.
//
// Two designs, chosen from R + S by mec_phase_branch:
//
// mec_block_kernel (R + S <= mec_block_max_entries(), 58,076 on an H100:
// the golden run's and asm's chromosomes): one block a restart, one launch
// for every vote.  The block holds h and a as int32 in shared memory; a
// thread a row writes the row's sign in place, and one __syncthreads()
// separates the half-steps.  Each block then counts its MEC, writes its h,
// a and MEC to a scratch, and the last block to finish (a ticket counter
// after a __threadfence) picks the first lowest MEC and copies that
// restart's rows to the outputs.
//
// mec_grid_*_kernel (larger, up to whole chromosomes: 833,333 reads and
// 166,667 SNPs at 30x HiFi): h and a live in global memory, restart-minor
// (node * NR + q, so a row's NR values share a 32-byte sector: 32 MB at
// chromosome scale, inside the 50 MB L2), a thread a row for every
// restart, and a kernel boundary is the barrier between half-steps:
// 2 * n_iter + 1 vote launches (the last also counts the MEC), then the
// pick.  The first read vote reads h0 itself (restart-major).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BLOCK_THREADS = 1024;
constexpr int BLOCK_WARPS = BLOCK_THREADS / 32;
constexpr int GRID_THREADS = 256;
constexpr int GRID_BLOCKS = 132 * 8;
constexpr int GROUP = 8;                  // restarts a thread sums at once
constexpr int MAX_RESTARTS = 64;
constexpr int SCAN_THREADS = 1024;        // 32 warps: one warp scans them
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int BRANCH_BLOCK = 1;
constexpr int BRANCH_GRID = 2;

__device__ __forceinline__ int sgn(int v) { return v >= 0 ? 1 : -1; }

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
__global__ void __launch_bounds__(GRID_THREADS)
mec_scatter_kernel(Obs x, int S, int R, const long long* __restrict__ ptr,
                   int* __restrict__ counts, int* __restrict__ entries) {
  for (long long i = blockIdx.x * (long long)GRID_THREADS + threadIdx.x;
       i < x.n; i += (long long)gridDim.x * GRID_THREADS) {
    int r, s, neg;
    if (!informative(x, i, S, R, r, s, neg)) continue;
    entries[ptr[r] + atomicSub(counts + r, 1) - 1] = s * 2 + neg;
    entries[ptr[R + s] + atomicSub(counts + R + s, 1) - 1] = r * 2 + neg;
  }
}

// sign(sum over the row of src[node] * o), one thread a row
__device__ __forceinline__ int row_vote(const long long* __restrict__ ptr,
                                        const int* __restrict__ obs, int row,
                                        const int* src) {
  const long long end = ptr[row + 1];
  int v = 0;
#pragma unroll 4
  for (long long j = ptr[row]; j < end; ++j) {
    const int p = obs[j];
    v += src[node_of(p)] * allele_of(p);
  }
  return sgn(v);
}

__global__ void __launch_bounds__(BLOCK_THREADS)
mec_block_kernel(const long long* __restrict__ read_ptr,
                 const int* __restrict__ read_obs,
                 const long long* __restrict__ snp_ptr,
                 const int* __restrict__ snp_obs,
                 const int* __restrict__ h0, int S, int R, int n_iter,
                 long long* mecs, unsigned* ticket, int* rows_h, int* rows_a,
                 int* __restrict__ h_out, int* __restrict__ a_out,
                 long long* __restrict__ mec_out) {
  extern __shared__ int smem[];
  int* hs = smem;                         // S
  int* as = smem + S;                     // R
  __shared__ unsigned warp_bad[BLOCK_WARPS];
  __shared__ int is_last;
  const int q = blockIdx.x;
  const int nr = gridDim.x;
  const int tid = threadIdx.x;
  for (int s = tid; s < S; s += BLOCK_THREADS) hs[s] = h0[(size_t)q * S + s];
  __syncthreads();
  for (int it = 0;; ++it) {
    for (int r = tid; r < R; r += BLOCK_THREADS)
      as[r] = row_vote(read_ptr, read_obs, r, hs);
    __syncthreads();
    if (it == n_iter) break;
    for (int s = tid; s < S; s += BLOCK_THREADS)
      hs[s] = row_vote(snp_ptr, snp_obs, s, as);
    __syncthreads();
  }
  unsigned bad = 0;
  for (int r = tid; r < R; r += BLOCK_THREADS) {
    const long long end = read_ptr[r + 1];
    for (long long j = read_ptr[r]; j < end; ++j) {
      const int p = read_obs[j];
      bad += as[r] * hs[node_of(p)] * allele_of(p) < 0;
    }
  }
  bad = __reduce_add_sync(FULL, bad);
  if ((tid & 31) == 0) warp_bad[tid >> 5] = bad;
  for (int s = tid; s < S; s += BLOCK_THREADS)
    rows_h[(size_t)q * S + s] = hs[s];
  for (int r = tid; r < R; r += BLOCK_THREADS)
    rows_a[(size_t)q * R + r] = as[r];
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < BLOCK_WARPS; ++w) total += warp_bad[w];
    mecs[q] = total;
  }
  // every thread's rows, and thread 0's MEC, visible before the ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == (unsigned)(nr - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
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
  for (int s = tid; s < S; s += BLOCK_THREADS)
    h_out[s] = __ldcg(rows_h + (size_t)best * S + s);
  for (int r = tid; r < R; r += BLOCK_THREADS)
    a_out[r] = __ldcg(rows_a + (size_t)best * R + r);
  if (tid == 0) *mec_out = lo;
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

size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// the scratch, in order: the NR MECs and the ticket (zeroed), the R + S row
// counts (zeroed with them), the R + S + 1 row offsets, the scan's tile
// totals, the 2 * O CSR entries (at most), then NR x (S + R) int32 (the
// block design's rows of each restart, or the grid design's state)
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

}  // namespace

extern "C" const char* mec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The largest R + S the block design holds in one block's shared memory on
// the current device (0 if the device cannot be asked).
extern "C" int mec_block_max_entries(void) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, mec_block_kernel) != cudaSuccess)
    return 0;
  return (optin - (int)attr.sharedSizeBytes) / (int)sizeof(int);
}

// The design for S SNPs and R reads: 1 (a block a restart) when R + S fits
// one block's shared memory, else 2 (a grid over the rows).
extern "C" int mec_phase_branch(int S, int R) {
  return (long long)S + R <= mec_block_max_entries() ? BRANCH_BLOCK
                                                     : BRANCH_GRID;
}

// Bytes of device scratch mec_phase_launch needs for NR restarts, S SNPs, R
// reads and O observations (Layout).
extern "C" long long mec_scratch_bytes(int nr, int S, int R, long long n_obs) {
  return (long long)layout(nr, S, R, n_obs).total;
}

// The MEC phasing of O observations (obs_read, obs_snp: int32, or int64
// where *_wide; obs_allele int8) from the NR x S int32 initial phases h0, on
// `stream`: h_out (S,) int32, a_out (R,) int32, mec_out one int64.  branch
// 0 picks the design (mec_phase_branch), 1 the block design (R + S <=
// mec_block_max_entries()), 2 the grid design; scratch as
// mec_scratch_bytes asks.  1 <= NR <= 64.  Returns the cudaError_t of the
// launches.
extern "C" int mec_phase_launch(const void* obs_read, int read_wide,
                                const void* obs_snp, int snp_wide,
                                const void* obs_allele, long long n_obs,
                                const void* h0, int nr, int S, int R,
                                int n_iter, int branch, void* scratch,
                                long long scratch_bytes, void* h_out,
                                void* a_out, void* mec_out, void* stream) {
  if (nr < 1 || nr > MAX_RESTARTS || S < 0 || R < 0 || n_obs < 0 ||
      n_iter < 0 || branch < 0 || branch > BRANCH_GRID)
    return (int)cudaErrorInvalidValue;
  if (branch == 0) branch = mec_phase_branch(S, R);
  const Layout l = layout(nr, S, R, n_obs);
  if (scratch == nullptr || scratch_bytes < (long long)l.total)
    return (int)cudaErrorInvalidValue;
  if (branch == BRANCH_BLOCK && (long long)S + R > mec_block_max_entries())
    return (int)cudaErrorInvalidValue;
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
  int* ints = reinterpret_cast<int*>(base + l.state);
  const long long n = (long long)S + R;

  // the CSR: counts, their offsets, the entries
  cudaError_t err = cudaMemsetAsync(base, 0, l.ptr, st);
  if (err != cudaSuccess) return (int)err;
  mec_count_kernel<<<grid_blocks(n_obs), GRID_THREADS, 0, st>>>(x, S, R,
                                                                 counts);
  mec_scan_tile_kernel<<<(unsigned)l.n_tiles, SCAN_THREADS, 0, st>>>(
      counts, n, ptr, sums);
  mec_scan_sums_kernel<<<1, SCAN_THREADS, 0, st>>>(sums, l.n_tiles, ptr + n);
  mec_scan_add_kernel<<<grid_blocks(n), GRID_THREADS, 0, st>>>(ptr, n, sums);
  mec_scatter_kernel<<<grid_blocks(n_obs), GRID_THREADS, 0, st>>>(
      x, S, R, ptr, counts, entries);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long* rp = ptr;              // R + 1 offsets
  const long long* sp = ptr + R;          // S + 1 offsets
  if (branch == BRANCH_BLOCK) {
    const size_t smem = (size_t)n * sizeof(int);
    err = cudaFuncSetAttribute(
        mec_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    mec_block_kernel<<<nr, BLOCK_THREADS, smem, st>>>(
        rp, entries, sp, entries, h0p, S, R, n_iter, mecs, ticket, ints,
        ints + (size_t)nr * S, ho, ao, mo);
    return (int)cudaGetLastError();
  }
  int* H = ints;                          // S x NR
  int* A = ints + (size_t)nr * S;         // R x NR
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
