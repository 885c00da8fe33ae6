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
// for each distinct sector touched.
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
// kmer_vote_kernel: (B, H) int32,
//   score[b, j] = sum over distinct valid k-mers x of read b with
//                 unique[j, x] of (count of x in read b + tables[j, x]).
// A k-mer is unique to at most one table, so the first term is the number
// of read b's valid windows unique to table j, and the second needs each
// distinct such x once.  One block a read: the block hashes the windows
// (RUN a thread), looks each up in the H mask rows, counts it into a
// shared score, and appends x to a list (shared memory, or past SMEM_KEYS
// entries a global scratch row the wrapper allocates).  Only these windows
// are kept: in a read they are the few that span a haplotype's variants.
// The list is sorted (bitonic, padded to a power of two with INT_MAX), and
// the first entry of each run adds tables[j, x] once.  Bound: the codes and
// the mask lookups (H bytes a valid window), a table read a distinct
// unique k-mer.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int CODE_N = 4;
constexpr int RUN = 16;                   // windows a thread walks (count)
constexpr int COUNT_THREADS = 256;
constexpr int COUNT_TILE = RUN * COUNT_THREADS;
constexpr int UNIQUE_THREADS = 256;
constexpr int VOTE_RUN = 8;               // windows a thread walks (vote)
constexpr int VOTE_THREADS = 512;
constexpr int SMEM_KEYS = 8192;           // 32 KB of list a block
constexpr int MAX_H = 32;

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
    if (last_n < w) atomicAdd(table + h, 1);
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

// the table x is unique to, or -1
__device__ __forceinline__ int unique_of(const uint8_t* __restrict__ unique,
                                         int H, long long N, uint32_t x) {
  for (int j = 0; j < H; ++j)
    if (unique[j * N + x]) return j;
  return -1;
}

__global__ void __launch_bounds__(VOTE_THREADS)
kmer_vote_kernel(const int8_t* __restrict__ codes,
                 const int* __restrict__ lens, int L, int k,
                 const int* __restrict__ tables,
                 const uint8_t* __restrict__ unique, int H, long long N,
                 int cap, int* __restrict__ scratch, long long scratch_row,
                 int* __restrict__ out) {
  extern __shared__ int smem[];
  int* keys_s = smem;                     // cap entries
  int* score = smem + cap;                // H entries
  int* count = score + H;                 // 1 entry
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  int* keys_g = scratch ? scratch + b * scratch_row : nullptr;
  if (tid < H) score[tid] = 0;
  if (tid == 0) *count = 0;
  __syncthreads();
  const int limit = min(L - k + 1, lens[b] - k + 1);
  const int8_t* row = codes + (size_t)b * L;
  for (int w0 = tid * VOTE_RUN; w0 < limit; w0 += VOTE_THREADS * VOTE_RUN) {
    const int w1 = min(w0 + VOTE_RUN, limit);
    uint32_t h = 0;
    int last_n = -1;
    for (int p = w0; p < w0 + k - 1; ++p) roll(row, p, k, h, last_n);
    for (int w = w0; w < w1; ++w) {
      roll(row, w + k - 1, k, h, last_n);
      if (last_n >= w) continue;
      const int j = unique_of(unique, H, N, h);
      if (j < 0) continue;
      atomicAdd(score + j, 1);            // the run length, a window at a time
      const int slot = atomicAdd(count, 1);
      if (slot < cap) keys_s[slot] = (int)h;
      else keys_g[slot] = (int)h;         // slot < n <= scratch_row
    }
  }
  __syncthreads();
  const int m = *count;
  int* keys = keys_s;
  if (m > cap) {                          // sort the whole list in scratch
    for (int i = tid; i < cap; i += VOTE_THREADS) keys_g[i] = keys_s[i];
    keys = keys_g;
  }
  int m2 = 1;
  while (m2 < m) m2 <<= 1;
  for (int i = m + tid; i < m2; i += VOTE_THREADS) keys[i] = INT_MAX;
  __syncthreads();
  for (int size = 2; size <= m2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (m2 >> 1); i += VOTE_THREADS) {
        const int lo = 2 * stride * (i / stride) + (i % stride);
        const int hi = lo + stride;
        const int a = keys[lo], c = keys[hi];
        if ((a > c) == ((lo & size) == 0)) {
          keys[lo] = c;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < m; i += VOTE_THREADS) {
    const int x = keys[i];
    if (i > 0 && keys[i - 1] == x) continue;
    const int j = unique_of(unique, H, N, (uint32_t)x);
    atomicAdd(score + j, tables[j * N + x]);
  }
  __syncthreads();
  if (tid < H) out[b * H + tid] = score[tid];
}

int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" const char* kmer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table[h] += 1 for each valid window of codes (B, L) int8 on `stream`;
// lens (B,) int32 or null; table (4^k,) int32, accumulated in place;
// 1 <= k <= 15, L >= k.  Returns the cudaError_t of the launch.
extern "C" int kmer_count_launch(const void* codes, const void* lens, int B,
                                 int L, int k, void* table, void* stream) {
  if (B <= 0 || k < 1 || k > 15 || L < k) return (int)cudaErrorInvalidValue;
  const int tiles = (L - k + 1 + COUNT_TILE - 1) / COUNT_TILE;
  const long long blocks = (long long)tiles * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kmer_count_kernel<<<(int)blocks, COUNT_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int*>(lens), L, k,
      tiles, static_cast<int*>(table));
  return (int)cudaGetLastError();
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

// int32 entries of the global scratch kmer_vote_launch needs a read (0 when
// every read's list fits in shared memory): a power of two >= L - k + 1.
extern "C" long long kmer_vote_scratch_row(int L, int k) {
  const int n = L - k + 1;
  return n <= SMEM_KEYS ? 0 : pow2ceil(n);
}

// The vote of B reads on `stream`: codes (B, L) int8, lens (B,) int32,
// tables (H, N = 4^k) int32, unique (H, N) bool (one byte each), out (B, H)
// int32; scratch (B, scratch_row) int32 as kmer_vote_scratch_row asks (or
// null); 1 <= k <= 15, L >= k, 1 <= H <= 32.  Returns the cudaError_t of
// the launch.
extern "C" int kmer_vote_launch(const void* codes, const void* lens, int B,
                                int L, int k, const void* tables,
                                const void* unique, int H, void* scratch,
                                long long scratch_row, void* out,
                                void* stream) {
  if (B <= 0 || k < 1 || k > 15 || L < k || H < 1 || H > MAX_H)
    return (int)cudaErrorInvalidValue;
  const int n = L - k + 1;
  if (n > SMEM_KEYS && (scratch == nullptr || scratch_row < n))
    return (int)cudaErrorInvalidValue;
  const int cap = n <= SMEM_KEYS ? pow2ceil(n) : SMEM_KEYS;
  const size_t smem = (size_t)(cap + H + 1) * sizeof(int);
  kmer_vote_kernel<<<B, VOTE_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int*>(lens), L, k,
      static_cast<const int*>(tables), static_cast<const uint8_t*>(unique), H,
      1LL << (2 * k), cap, static_cast<int*>(scratch), scratch_row,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}
