// Pair-HMM Viterbi of read segments against haplotype windows, for Hopper
// (sm_90a).
//
// Replaces: volcanosv_tpu/phasing/realign.py::_viterbi_batch, the jitted XLA
// lax.scan over read rows (not a Pallas kernel; as plain torch it is a loop
// of about 19 small ops a row, phasing/realign.py::_viterbi_batch_plain).
//
// Computes, for each of B pairs, the fp32 affine-gap Viterbi score of the
// read segment segs[b, :seg_lens[b]] (R columns, int8 codes, 4 = N) against
// the window haps[b, :W] (int8 codes): states M (consume both), I (consume
// read), D (consume hap), a free start in any hap column, a free end in any
// hap column on the row where the segment is used up.  The score equals the
// plain version's bit for bit: every add and multiply is its own rounded
// operation (__fadd_rn / __fmul_rn, which nvcc never contracts into an FMA),
// in the plain version's order, on the same fp32 constants (rounded from
// float64 on the host).  A contracted multiply-add would round once where
// the plain version rounds twice and could flip an allele call.
//
// What bounds it on the card: a pair is R rows of W cells, about 16 fp32
// operations a cell, and reads R + W + 4 bytes: operations bound it (fp32
// outside the tensor cores).  Rows past the segment's end cannot change the
// score, so a pair runs seg_len rows, not R.
//
// Design: one warp per pair, lane l holding columns l*C .. l*C + C - 1 (C a
// power of two, 32*C >= W, so W <= 1024), the M, I and D rows in registers.
// The M row's diagonal shift is a register move inside a lane and one
// __shfl_up_sync across lanes.  The delete chain
//   d_new[j] = max_{j' < j} (m_new[j'] - j'*a_ext) + a_gap + (j-1)*a_ext
// is a running max of m_new - col_ext: a scan inside the lane, then a warp
// max-scan of the lanes' totals with __shfl_up_sync.  Max is exact, so the
// scan's order changes no bit.  The read bases reach the lanes 32 rows at a
// time (one coalesced load, then a __shfl_sync a row); the row max of the
// last row is a warp max-reduction.  Columns >= W are padding: they only
// feed higher columns and are left out of the row max.
//
// Windows wider than a warp's 1024 columns (W = 2 * realign_flank + 1 for
// any flank) take pairhmm_viterbi_block_kernel: a block of BLOCK_THREADS
// per pair (pairs strided over the grid), thread t holding the contiguous
// columns t*C .. t*C + C - 1 (C = ceil(W / BLOCK_THREADS)) of the M, I and
// D rows in shared memory, or, when 12 * W bytes exceed MAX_SMEM_ROWS, in
// a device scratch of 12 * W bytes a block that the wrapper allocates.
// The same arithmetic in the same order: the diagonal into a thread's
// first column is the previous row's prev_of of the last column of the
// thread below, which that thread leaves in shared memory; the delete
// chain's running max is a scan inside the thread's columns, then a block
// max-scan of the threads' totals (a warp scan, then the warps' totals).
// Max is exact, so the order of the scan changes no bit.  Two barriers a
// row.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int MAX_WARP_W = 1024;
constexpr int BLOCK_THREADS = 256;
constexpr int BLOCK_WARPS = BLOCK_THREADS / 32;
constexpr int MAX_SMEM_ROWS = 46 * 1024;  // M, I, D rows in shared memory
constexpr int SCRATCH_BLOCKS = 264;       // blocks when the rows are global

struct HmmParams {
  float log_match, log_mis, log_ins, log_quarter, a_mm, a_gap, a_ext, a_back;
};

// prev = max(max(m + a_mm, i + a_back), d + a_back): the best way into the
// next row's diagonal
__device__ __forceinline__ float prev_of(float m, float i, float d,
                                         const HmmParams& p) {
  return fmaxf(fmaxf(__fadd_rn(m, p.a_mm), __fadd_rn(i, p.a_back)),
               __fadd_rn(d, p.a_back));
}

template <int C>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
pairhmm_viterbi_kernel(const int8_t* __restrict__ segs,
                       const int* __restrict__ seg_lens,
                       const int8_t* __restrict__ haps, int B, int R, int W,
                       HmmParams p, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (pair >= B) return;                    // the whole warp leaves together
  const int len = seg_lens[pair];
  // best starts at 0 for an empty segment, else at NEG; it changes only on
  // the row where t + 1 == len, so a segment longer than R never scores
  if (len <= 0 || len > R) {
    if (lane == 0) out[pair] = len == 0 ? 0.f : NEG;
    return;
  }
  const int j0 = lane * C;
  int h[C];
  float m[C], ii[C], d[C];
  const int8_t* hp = haps + (size_t)pair * W;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = j0 + k;
    h[k] = j < W ? (int)hp[j] : 4;
    m[k] = 0.f;                             // free start in every column
    ii[k] = NEG;
    d[k] = NEG;
  }
  const int8_t* sp = segs + (size_t)pair * R;
  int chunk = 4;
  for (int t = 0; t < len; ++t) {
    if ((t & 31) == 0) chunk = t + lane < R ? (int)sp[t + lane] : 4;
    const int b = __shfl_sync(FULL, chunk, t & 31);
    // the diagonal into this lane's first column comes from the lane below
    float up = __shfl_up_sync(FULL, prev_of(m[C - 1], ii[C - 1], d[C - 1], p),
                              1);
    if (lane == 0) up = NEG;
    // columns right to left, so that column k - 1 still holds the last row
#pragma unroll
    for (int k = C - 1; k >= 0; --k) {
      const float shifted = k == 0 ? up : prev_of(m[k - 1], ii[k - 1],
                                                  d[k - 1], p);
      const float e = (b >= 4 || h[k] >= 4) ? p.log_quarter
                      : (b == h[k] ? p.log_match : p.log_mis);
      ii[k] = __fadd_rn(p.log_ins, fmaxf(__fadd_rn(m[k], p.a_gap),
                                         __fadd_rn(ii[k], p.a_ext)));
      m[k] = __fadd_rn(e, shifted);
    }
    // g = cummax(m_new - col_ext), col_ext[j] = j * a_ext; kept in d
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float x = __fsub_rn(m[k], __fmul_rn((float)(j0 + k), p.a_ext));
      d[k] = k == 0 ? x : fmaxf(d[k - 1], x);
    }
    float run = d[C - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(FULL, run, off);
      if (lane >= off) run = fmaxf(run, v);
    }
    const float below = __shfl_up_sync(FULL, run, 1);
    if (lane > 0) {
#pragma unroll
      for (int k = 0; k < C; ++k) d[k] = fmaxf(below, d[k]);
    }
    // d_new[j] = (g[j-1] + a_gap) + gap_ext[j], gap_ext[j] = (j-1) * a_ext;
    // NEG in column 0
    const float g_up = __shfl_up_sync(FULL, d[C - 1], 1);
#pragma unroll
    for (int k = C - 1; k >= 0; --k) {
      const int j = j0 + k;
      const float g = k == 0 ? g_up : d[k - 1];
      d[k] = j == 0 ? NEG
                    : __fadd_rn(__fadd_rn(g, p.a_gap),
                                __fmul_rn((float)(j - 1), p.a_ext));
    }
  }
  // the row where t + 1 == len: best = max(NEG, max_j max(m, i))
  float row = -INFINITY;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (j0 + k < W) row = fmaxf(row, fmaxf(m[k], ii[k]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    row = fmaxf(row, __shfl_xor_sync(FULL, row, off));
  if (lane == 0) out[pair] = fmaxf(NEG, row);
}

// GLOBAL: the rows in `scratch` (3 * W floats a block), else in shared
// memory
template <bool GLOBAL>
__global__ void __launch_bounds__(BLOCK_THREADS)
pairhmm_viterbi_block_kernel(const int8_t* __restrict__ segs,
                             const int* __restrict__ seg_lens,
                             const int8_t* __restrict__ haps, int B, int R,
                             int W, HmmParams p, float* __restrict__ scratch,
                             float* __restrict__ out) {
  extern __shared__ float rows_s[];
  __shared__ float edge[BLOCK_THREADS];   // prev_of of each thread's last column
  __shared__ float wtot[BLOCK_WARPS];     // the warps' running-max totals
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = (W + BLOCK_THREADS - 1) / BLOCK_THREADS;
  const int j0 = min(tid * C, W), j1 = min(j0 + C, W);
  float* M = GLOBAL ? scratch + (size_t)blockIdx.x * 3 * W : rows_s;
  float* I = M + W;
  float* D = I + W;
  for (int pair = blockIdx.x; pair < B; pair += gridDim.x) {
    const int len = seg_lens[pair];
    if (len <= 0 || len > R) {              // the same for the whole block
      if (tid == 0) out[pair] = len == 0 ? 0.f : NEG;
      continue;
    }
    const int8_t* hp = haps + (size_t)pair * W;
    const int8_t* sp = segs + (size_t)pair * R;
    for (int j = j0; j < j1; ++j) {
      M[j] = 0.f;                           // free start in every column
      I[j] = NEG;
      D[j] = NEG;
    }
    if (j0 < j1) edge[tid] = prev_of(0.f, NEG, NEG, p);
    __syncthreads();
    for (int t = 0; t < len; ++t) {
      const int b = sp[t];
      // the diagonal into column j0: the last row's column j0 - 1
      const float up = tid == 0 ? NEG : edge[tid - 1];
      float run = -INFINITY;
      if (j0 < j1) {
        // columns right to left, so that column j - 1 still holds the last
        // row
        for (int j = j1 - 1; j >= j0; --j) {
          const float shifted = j == j0 ? up : prev_of(M[j - 1], I[j - 1],
                                                       D[j - 1], p);
          const int h = hp[j];
          const float e = (b >= 4 || h >= 4) ? p.log_quarter
                          : (b == h ? p.log_match : p.log_mis);
          I[j] = __fadd_rn(p.log_ins, fmaxf(__fadd_rn(M[j], p.a_gap),
                                            __fadd_rn(I[j], p.a_ext)));
          M[j] = __fadd_rn(e, shifted);
        }
        // g = cummax(m_new - col_ext) inside the thread's columns, in D
        for (int j = j0; j < j1; ++j) {
          const float x = __fsub_rn(M[j], __fmul_rn((float)j, p.a_ext));
          run = j == j0 ? x : fmaxf(run, x);
          D[j] = run;
        }
      }
      // block max-scan of the threads' totals: inclusive within the warp,
      // then the warps below
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl = fmaxf(incl, v);
      }
      float below = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) below = -INFINITY;
      if (lane == 31) wtot[warp] = incl;
      __syncthreads();                      // wtot and edge of this row read
      for (int w = 0; w < warp; ++w) below = fmaxf(below, wtot[w]);
      // d_new[j] = (g[j-1] + a_gap) + (j-1) * a_ext, NEG in column 0; g of
      // the columns below j0 is `below`
      for (int j = j1 - 1; j >= j0; --j) {
        const float g = j == j0 ? below : fmaxf(below, D[j - 1]);
        D[j] = j == 0 ? NEG
                      : __fadd_rn(__fadd_rn(g, p.a_gap),
                                  __fmul_rn((float)(j - 1), p.a_ext));
      }
      if (j0 < j1) edge[tid] = prev_of(M[j1 - 1], I[j1 - 1], D[j1 - 1], p);
      __syncthreads();                      // the row is whole
    }
    // the row where t + 1 == len: best = max(NEG, max_j max(m, i))
    float row = -INFINITY;
    for (int j = j0; j < j1; ++j) row = fmaxf(row, fmaxf(M[j], I[j]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      row = fmaxf(row, __shfl_xor_sync(FULL, row, off));
    if (lane == 0) wtot[warp] = row;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < BLOCK_WARPS; ++w) row = fmaxf(row, wtot[w]);
      out[pair] = fmaxf(NEG, row);
    }
    __syncthreads();                        // wtot and the rows are free
  }
}

bool rows_global(int W) { return 12LL * W > MAX_SMEM_ROWS; }

template <int C>
int launch(const int8_t* segs, const int* lens, const int8_t* haps, int B,
           int R, int W, const HmmParams& p, float* out, cudaStream_t s) {
  const int blocks = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  pairhmm_viterbi_kernel<C><<<blocks, 32 * WARPS_PER_BLOCK, 0, s>>>(
      segs, lens, haps, B, R, W, p, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* pairhmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of device memory pairhmm_viterbi_launch needs as `scratch`: 0
// unless W > 1024 and the block design's rows exceed its shared memory.
extern "C" long long pairhmm_scratch_bytes(int B, int W) {
  if (W <= MAX_WARP_W || !rows_global(W)) return 0;
  return 12LL * W * (B < SCRATCH_BLOCKS ? B : SCRATCH_BLOCKS);
}

// Viterbi scores of B pairs on `stream`: segs (B, R) int8, seg_lens (B,)
// int32, haps (B, W) int8, out (B,) float32, all contiguous on the device;
// W >= 1, R >= 0; scratch as pairhmm_scratch_bytes asks (or null).  The
// eight constants are the plain version's fp32 values.  W <= 1024 takes the
// warp design, wider windows the block design.  Returns the cudaError_t of
// the launch.
extern "C" int pairhmm_viterbi_launch(
    const void* segs, const void* seg_lens, const void* haps, int B, int R,
    int W, float log_match, float log_mis, float log_ins, float log_quarter,
    float a_mm, float a_gap, float a_ext, float a_back, void* scratch,
    void* out, void* stream) {
  if (B <= 0 || R < 0 || W < 1) return (int)cudaErrorInvalidValue;
  const HmmParams p{log_match, log_mis, log_ins, log_quarter,
                    a_mm,      a_gap,   a_ext,   a_back};
  const int8_t* sg = static_cast<const int8_t*>(segs);
  const int* ln = static_cast<const int*>(seg_lens);
  const int8_t* hp = static_cast<const int8_t*>(haps);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W > MAX_WARP_W) {
    if (rows_global(W)) {
      if (scratch == nullptr) return (int)cudaErrorInvalidValue;
      const int blocks = B < SCRATCH_BLOCKS ? B : SCRATCH_BLOCKS;
      pairhmm_viterbi_block_kernel<true><<<blocks, BLOCK_THREADS, 0, s>>>(
          sg, ln, hp, B, R, W, p, static_cast<float*>(scratch), o);
    } else {
      const int blocks = B < 65535 ? B : 65535;
      pairhmm_viterbi_block_kernel<false>
          <<<blocks, BLOCK_THREADS, 12 * W, s>>>(sg, ln, hp, B, R, W, p,
                                                 nullptr, o);
    }
    return (int)cudaGetLastError();
  }
  const int per_lane = (W + 31) / 32;
  if (per_lane <= 1) return launch<1>(sg, ln, hp, B, R, W, p, o, s);
  if (per_lane <= 2) return launch<2>(sg, ln, hp, B, R, W, p, o, s);
  if (per_lane <= 4) return launch<4>(sg, ln, hp, B, R, W, p, o, s);
  if (per_lane <= 8) return launch<8>(sg, ln, hp, B, R, W, p, o, s);
  if (per_lane <= 16) return launch<16>(sg, ln, hp, B, R, W, p, o, s);
  return launch<32>(sg, ln, hp, B, R, W, p, o, s);
}
