// The k-mer partition's device code, for Hopper (sm_90a).
//
// Replaces: volcanosv_tpu/ops/kmer.py, jitted XLA (not Pallas kernels) —
// kmer_hashes + count_kmers_dense (the per-haplotype count tables),
// unique_mask, distinct_runs + overlap_scores (the read vote) and
// canonical_hashes.  As plain torch (ops/kmer.py::_kmer_count_plain,
// _unique_mask_plain, _kmer_vote_plain, _canonical_hashes_plain) they are a
// sort, a scatter (index_add_), gathers over (B, L - k + 1) hashes and a
// k-step loop of elementwise ops.
//
// Codes are int8, A C G T = 0 1 2 3, N = 4 (padding is N).  The hash of the
// window at w is the 2k-bit integer of codes[w .. w + k - 1] (code & 3 each,
// first code highest), k <= 15, so it lies in [0, 4^k) and the tables are
// (4^k,) int32.  A window is valid when none of its codes is N and, where
// lengths are given, w < lens[b] - k + 1.  Every kernel is integer
// arithmetic, and integer atomics give the same sums in any order: the
// outputs equal the plain versions' exactly.
//
// kmer_count_kernel: table[h] += 1 for each valid window of (B, L) codes,
// into the caller's table (accumulated in place).  Each thread walks a run
// of RUN windows: the hash rolls in a register ((h << 2 | c) & mask), and
// the position of the last N read decides validity.  Bound: the codes read
// once, then one atomic a valid window on a random 4-byte word of a 67 MB
// table (k = 12), more than the 50 MB L2: a 32-byte sector read and written
// for each distinct sector touched.  What sets its time, from three probe
// instances of this kernel (`PROBE`, chip_smoke.py phase 4b; PERF.md): the
// hashing alone (2: the atomic predicated on an impossible hash) is a
// sixth of it, and with every atomic an L2 hit (1: the hashes masked into
// the table's first 2^18 words, 1 MB) it is still 86% of it: the L2's rate
// of atomics, not DRAM sectors, sets it.  Binned counting in shared memory
// (a pass that sorts the hashes by table slice, a pass that counts a slice
// a block) measured slower at every chunk size and was not kept.
//
// unique_mask_kernel: (H, N) int32 tables -> (H, N) bool, present in exactly
// one table.  A thread a k-mer, reading its H counts (coalesced along N) and
// writing its H flags.  Bound: the tables' bytes.
//
// canonical_hashes_kernel: min(h, revcomp(h)) of N int32 hashes taken as
// uint32, k <= 16: the complement is h ^ (4^k - 1) (bits above 2k stay, as
// in the reference), and its low k 2-bit fields reversed are
// pairswap(brev(comp)) >> (32 - 2k); the unsigned minimum, stored as int32
// bits.  One fused elementwise pass (the plain version: k shift-or steps,
// each its own op).  Bound: 8 bytes an element.
//
// The read vote: (B, H) int32,
//   score[b, j] = sum over distinct valid k-mers x of read b with
//                 unique[j, x] of (count of x in read b + tables[j, x]).
// The first term is the number of read b's valid windows whose k-mer is
// unique to table j, and the second needs each distinct such x once.
// Bound: the codes, the mask lookups (H bytes a valid window) and a table
// read a distinct unique k-mer.  The lookups land at random places in the
// (H, 4^k) mask (67 MB at k 12 and H 4, more than the 50 MB L2; on the path
// it has just been written by unique_mask and is partly cold), and they
// take most of the kernel's time; what limits them on the card is not
// measured yet.
//
// kmer_vote_tile_kernel (it replaced a first design, a block a read that
// sorted its list; both designs' times are in PERF.md): a grid of (read,
// tile of TILE windows) blocks, so a chunk of 64 reads of 16384 columns is
// 512 blocks on 132 SMs; a tile hashes its windows and reads the k - 1
// codes past its end, so each window is hashed once.  A thread rolls the
// hashes of its VOTE_RUN windows first, then issues every mask load of every
// window (all H rows, HB at a time, no early exit) before it tests any:
// the loads' latencies overlap instead of adding up.  A window unique to
// table j adds one to the block's count j; its k-mer goes to the block's
// list in shared memory, then with one atomic a block to the read's list in
// the scratch, and the counts to the read's (H + 2)-int header (counts, list
// length, ticket; zeroed by the launcher).  The block that takes the read's
// last ticket (after __threadfence) counts the table term once a distinct
// k-mer: a hash set of the read's list, in shared memory up to HASH_KEYS
// entries, else in the scratch after the list; the first insert of x adds
// tables[j, x] for each j with unique[j, x].  Integer sums, so the order of
// the atomics changes nothing.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int CODE_N = 4;
constexpr int RUN = 16;                   // windows a thread walks (count)
constexpr int COUNT_THREADS = 256;
constexpr int COUNT_TILE = RUN * COUNT_THREADS;
constexpr unsigned PROBE_SLICE = (1u << 18) - 1;  // 1 MB of int32
constexpr int UNIQUE_THREADS = 256;
constexpr int VOTE_RUN = 8;               // windows a thread walks (vote)
constexpr int MAX_H = 32;
constexpr int TILE_THREADS = 256;
constexpr int TILE = TILE_THREADS * VOTE_RUN;   // windows a tile block
constexpr int HASH_SLOTS = 4096;          // the last block's set (16 KB)
constexpr int HASH_KEYS = HASH_SLOTS / 2; // the most list entries it takes
constexpr int HB = 4;                     // mask rows loaded together
constexpr int EMPTY = -1;                 // a free slot (k-mers are >= 0)

__device__ __forceinline__ uint32_t kmask(int k) {
  return (1u << (2 * k)) - 1u;
}

// The hash of the window ending at `p` rolled in from `h`; last_n is the
// position of the last N read.
__device__ __forceinline__ void roll(const int8_t* row, int p, int k,
                                     uint32_t& h, int& last_n) {
  const int c = row[p];
  h = ((h << 2) | (uint32_t)(c & 3)) & kmask(k);
  if (c == CODE_N) last_n = p;
}

// PROBE 0: the count; 1 and 2 are kmer_count_probe_launch's probes, on no
// path (1: each hash masked into the table's first 2^18 words, 2: the atomic
// predicated on an impossible hash).
template <int PROBE>
__global__ void __launch_bounds__(COUNT_THREADS)
kmer_count_kernel(const int8_t* __restrict__ codes,
                  const int* __restrict__ lens, int L, int k,
                  int tiles_per_row, int* __restrict__ table) {
  const int b = blockIdx.x / tiles_per_row;
  const int tile = blockIdx.x - b * tiles_per_row;
  int limit = L - k + 1;
  if (lens != nullptr) limit = min(limit, lens[b] - k + 1);
  const int w0 = tile * COUNT_TILE + threadIdx.x * RUN;
  const int w1 = min(w0 + RUN, limit);
  if (w0 >= w1) return;
  const int8_t* row = codes + (size_t)b * L;
  uint32_t h = 0;
  int last_n = -1;
  for (int p = w0; p < w0 + k - 1; ++p) roll(row, p, k, h, last_n);
  for (int w = w0; w < w1; ++w) {
    roll(row, w + k - 1, k, h, last_n);
    if (PROBE == 2 ? h == 0xffffffffu : last_n < w)
      atomicAdd(table + (PROBE == 1 ? h & PROBE_SLICE : h), 1);
  }
}

__global__ void __launch_bounds__(UNIQUE_THREADS)
unique_mask_kernel(const int* __restrict__ tables, int H, long long N,
                   uint8_t* __restrict__ out) {
  for (long long x = blockIdx.x * (long long)UNIQUE_THREADS + threadIdx.x;
       x < N; x += (long long)gridDim.x * UNIQUE_THREADS) {
    int n_present = 0;
    for (int j = 0; j < H; ++j) n_present += tables[j * N + x] > 0;
    for (int j = 0; j < H; ++j)
      out[j * N + x] = (uint8_t)(n_present == 1 && tables[j * N + x] > 0);
  }
}

__global__ void __launch_bounds__(UNIQUE_THREADS)
canonical_hashes_kernel(const uint32_t* __restrict__ in, long long n, int k,
                        uint32_t* __restrict__ out) {
  const uint32_t mask = k == 16 ? 0xffffffffu : (1u << (2 * k)) - 1u;
  for (long long i = blockIdx.x * (long long)UNIQUE_THREADS + threadIdx.x;
       i < n; i += (long long)gridDim.x * UNIQUE_THREADS) {
    const uint32_t h = in[i];
    // field j of comp (bits 2j, 2j+1) to bits 31-2j, 30-2j, then each pair
    // of bits back in order: field j at field 15 - j
    uint32_t c = __brev(h ^ mask);
    c = ((c >> 1) & 0x55555555u) | ((c & 0x55555555u) << 1);
    out[i] = min(h, c >> (32 - 2 * k));
  }
}

int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__device__ __forceinline__ int pow2ceil_d(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

// int32 entries of a read's row of the vote's scratch: its list (n
// windows at most), then, when a list may pass HASH_KEYS, a hash set of a
// power of two >= 2n slots
long long tile_row(int n) {
  return n + (n > HASH_KEYS ? 2LL * pow2ceil(n) : 0);
}

__global__ void __launch_bounds__(TILE_THREADS)
kmer_vote_tile_kernel(const int8_t* __restrict__ codes,
                      const int* __restrict__ lens, int B, int L, int k,
                      const int* __restrict__ tables,
                      const uint8_t* __restrict__ unique, int H, long long N,
                      int tiles, int* __restrict__ scratch, long long row,
                      int* __restrict__ out) {
  __shared__ int keys_s[HASH_SLOTS];        // the tile's list, then the set
  __shared__ int score_s[MAX_H];
  __shared__ int count_s, base_s, last_s;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int tid = threadIdx.x;
  const int limit = min(L - k + 1, lens[b] - k + 1);
  const int my_tiles = limit > 0 ? (limit + TILE - 1) / TILE : 1;
  if (tile >= my_tiles) return;             // past the read: the whole block
  int* acc = scratch + (size_t)b * (H + 2); // the read's counts
  int* list_len = acc + H;
  int* ticket = acc + H + 1;
  int* list_g = scratch + (size_t)B * (H + 2) + (size_t)b * row;
  if (tid < H) score_s[tid] = 0;
  if (tid == 0) count_s = 0;
  __syncthreads();
  // the hashes of this thread's windows, then every mask load of them
  const int w0 = tile * TILE + tid * VOTE_RUN;
  const int8_t* rowp = codes + (size_t)b * L;
  uint32_t x[VOTE_RUN];
  bool ok[VOTE_RUN];
  {
    uint32_t h = 0;
    int last_n = -1;
    if (w0 < limit)
      for (int p = w0; p < w0 + k - 1; ++p) roll(rowp, p, k, h, last_n);
#pragma unroll
    for (int i = 0; i < VOTE_RUN; ++i) {
      const int w = w0 + i;
      ok[i] = false;
      x[i] = 0;
      if (w < limit) {
        roll(rowp, w + k - 1, k, h, last_n);
        ok[i] = last_n < w;
        x[i] = h;
      }
    }
  }
  uint32_t hits[VOTE_RUN];
#pragma unroll
  for (int i = 0; i < VOTE_RUN; ++i) hits[i] = 0;
  for (int jb = 0; jb < H; jb += HB) {
    uint8_t u[VOTE_RUN][HB];
#pragma unroll
    for (int i = 0; i < VOTE_RUN; ++i)
#pragma unroll
      for (int jj = 0; jj < HB; ++jj)
        u[i][jj] = ok[i] && jb + jj < H
                       ? unique[(size_t)(jb + jj) * N + x[i]] : 0;
#pragma unroll
    for (int i = 0; i < VOTE_RUN; ++i)
#pragma unroll
      for (int jj = 0; jj < HB; ++jj)
        if (u[i][jj]) hits[i] |= 1u << (jb + jj);
  }
#pragma unroll
  for (int i = 0; i < VOTE_RUN; ++i) {
    if (!hits[i]) continue;
    for (uint32_t m = hits[i]; m; m &= m - 1)
      atomicAdd(score_s + __ffs(m) - 1, 1); // a window at a time
    keys_s[atomicAdd(&count_s, 1)] = (int)x[i];
  }
  __syncthreads();
  const int n_tile = count_s;
  if (tid == 0) base_s = n_tile ? atomicAdd(list_len, n_tile) : 0;
  if (tid < H && score_s[tid]) atomicAdd(acc + tid, score_s[tid]);
  __syncthreads();
  for (int i = tid; i < n_tile; i += TILE_THREADS)
    list_g[base_s + i] = keys_s[i];
  __threadfence();                          // the list and counts, then
  __syncthreads();                          // the ticket
  if (tid == 0) last_s = atomicAdd(ticket, 1) == my_tiles - 1;
  __syncthreads();
  if (!last_s) return;
  // the read's last block: the table term once a distinct k-mer
  __threadfence();
  const int m = *(volatile int*)list_len;
  int* set = m <= HASH_KEYS ? keys_s : list_g + (L - k + 1);
  const int slots = max(2, pow2ceil_d(2 * m));
  const int bits = 31 - __clz(slots);
  if (tid < H) score_s[tid] = 0;
  for (int i = tid; i < slots; i += TILE_THREADS) set[i] = EMPTY;
  __syncthreads();
  for (int i = tid; i < m; i += TILE_THREADS) {
    const int xk = __ldcg(list_g + i);
    uint32_t s = ((uint32_t)xk * 2654435761u) >> (32 - bits);
    while (true) {
      const int was = atomicCAS(set + s, EMPTY, xk);
      if (was == EMPTY) {                   // the first of x in the read
        for (int j = 0; j < H; ++j)
          if (unique[(size_t)j * N + xk])
            atomicAdd(score_s + j, tables[(size_t)j * N + xk]);
        break;
      }
      if (was == xk) break;
      s = (s + 1) & (slots - 1);
    }
  }
  __syncthreads();
  if (tid < H)
    out[(size_t)b * H + tid] = *(volatile int*)(acc + tid) + score_s[tid];
}

}  // namespace

extern "C" const char* kmer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

int count_launch(const void* codes, const void* lens, int B, int L, int k,
                 void* table, int probe, void* stream) {
  if (B <= 0 || k < 1 || k > 15 || L < k) return (int)cudaErrorInvalidValue;
  const int tiles = (L - k + 1 + COUNT_TILE - 1) / COUNT_TILE;
  const long long blocks = (long long)tiles * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const auto kernel = probe == 0 ? kmer_count_kernel<0>
                      : probe == 1 ? kmer_count_kernel<1>
                                   : kmer_count_kernel<2>;
  kernel<<<(int)blocks, COUNT_THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int*>(lens), L, k,
      tiles, static_cast<int*>(table));
  return (int)cudaGetLastError();
}

}  // namespace

// table[h] += 1 for each valid window of codes (B, L) int8 on `stream`;
// lens (B,) int32 or null; table (4^k,) int32, accumulated in place;
// 1 <= k <= 15, L >= k.  Returns the cudaError_t of the launch.
extern "C" int kmer_count_launch(const void* codes, const void* lens, int B,
                                 int L, int k, void* table, void* stream) {
  return count_launch(codes, lens, B, L, k, table, 0, stream);
}

// The count kernel as a probe of what sets its time (chip_smoke.py, phase
// 4b), on no path: probe 1 adds each window's hash masked into the table's
// first 2^18 words (k >= 9, so the table holds them), 2 hashes and adds
// nothing (the atomic predicated on an impossible hash), 0 is the count.
extern "C" int kmer_count_probe_launch(const void* codes, const void* lens,
                                       int B, int L, int k, void* table,
                                       int probe, void* stream) {
  if (probe < 0 || probe > 2 || (probe == 1 && k < 9))
    return (int)cudaErrorInvalidValue;
  return count_launch(codes, lens, B, L, k, table, probe, stream);
}

// out (H, N) bool (one byte each) = present in exactly one of tables (H, N)
// int32, on `stream`.  Returns the cudaError_t of the launch.
extern "C" int unique_mask_launch(const void* tables, int H, long long N,
                                  void* out, void* stream) {
  if (H <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const long long want = (N + UNIQUE_THREADS - 1) / UNIQUE_THREADS;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  unique_mask_kernel<<<blocks, UNIQUE_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tables), H, N, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// out = min(h, revcomp(h)) of n int32 hashes `in` (uint32 arithmetic),
// 1 <= k <= 16, on `stream`.  Returns the cudaError_t of the launch.
extern "C" int canonical_hashes_launch(const void* in, long long n, int k,
                                       void* out, void* stream) {
  if (n <= 0 || k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  const long long want = (n + UNIQUE_THREADS - 1) / UNIQUE_THREADS;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  canonical_hashes_kernel<<<blocks, UNIQUE_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), n, k, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// int32 entries of device scratch kmer_vote_launch needs: B headers of H +
// 2 and B rows of tile_row(n), n = L - k + 1 windows a read.
extern "C" long long kmer_vote_scratch_ints(int B, int L, int k, int H) {
  const int n = L - k + 1;
  if (B <= 0 || n <= 0) return 0;
  return (long long)B * (H + 2 + tile_row(n));
}

// The vote of B reads on `stream`: codes (B, L) int8, lens (B,) int32,
// tables (H, N = 4^k) int32, unique (H, N) bool (one byte each), out (B, H)
// int32; scratch of scratch_ints int32 entries as kmer_vote_scratch_ints
// asks; 1 <= k <= 15, L >= k, 1 <= H <= 32.  The scratch's headers are
// zeroed first (a memset on `stream`).  Returns the cudaError_t of the
// launch.
extern "C" int kmer_vote_launch(const void* codes, const void* lens, int B,
                                int L, int k, const void* tables,
                                const void* unique, int H, void* scratch,
                                long long scratch_ints, void* out,
                                void* stream) {
  if (B <= 0 || k < 1 || k > 15 || L < k || H < 1 || H > MAX_H)
    return (int)cudaErrorInvalidValue;
  const int n = L - k + 1;
  if (scratch == nullptr || scratch_ints < kmer_vote_scratch_ints(B, L, k, H))
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + TILE - 1) / TILE;
  const long long blocks = (long long)tiles * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* sc = static_cast<int*>(scratch);
  const cudaError_t rc =
      cudaMemsetAsync(sc, 0, (size_t)B * (H + 2) * sizeof(int), s);
  if (rc != cudaSuccess) return (int)rc;
  kmer_vote_tile_kernel<<<(int)blocks, TILE_THREADS, 0, s>>>(
      static_cast<const int8_t*>(codes), static_cast<const int*>(lens), B, L,
      k, static_cast<const int*>(tables), static_cast<const uint8_t*>(unique),
      H, 1LL << (2 * k), tiles, sc, tile_row(n), static_cast<int*>(out));
  return (int)cudaGetLastError();
}
