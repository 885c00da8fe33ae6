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
// What bounds it on the card: a pair is R rows of W cells, about 15 fp32
// operations a cell, and reads R + W + 4 bytes: operations bound it (fp32
// outside the tensor cores).  Rows past the segment's end cannot change the
// score, so a pair runs seg_len rows, not R.  The rows of a pair depend on
// each other, and B = 8192 pairs of 41 columns fill the card in one wave,
// so the time is the instructions issued a cell.
//
// The group design (pairhmm_viterbi_group_kernel<G, C>, the path's, W <=
// 1024): G lanes a pair, 32 / G pairs a warp, lane l of a group holding
// columns l*C .. l*C + C - 1 (G*C >= W; realign.py::viterbi_group_shape
// picks G and C, 8 and 6 at W = 41, so 48 columns for 41), the M, I and D
// rows in registers.  Against the first design (a warp a pair, C a power
// of two; replaced, its times in PERF.md) it cuts the instructions of a
// cell:
// - few idle lanes: C follows W instead of a power of two;
// - the shuffles of a row (the read base, the diagonal, the delete chain's
//   max-scan in log2(G) steps, the scan's exclusive value) run inside the
//   group and serve 32 / G pairs at once; the exclusive value is also the
//   running max of the columns below the lane, so no shuffle fetches it
//   again;
// - what does not change from row to row is hoisted into registers once a
//   pair: col_ext[j] = j * a_ext (and so gap_ext[j] = col_ext[j - 1]), and
//   the emission folded into a key (the hap code, or one no base equals
//   where it is N) and the mismatch value (log_mis, or log_quarter where the
//   hap is N): a cell compares once and selects once; a row whose read base
//   is N in some group of the warp takes the select on b >= 4 as well;
// - prev = max(m + a_mm, max(i, d) + a_back): rounding to nearest is
//   monotone, so max(i + a_back, d + a_back) rounds to the same float.
// Max is exact, so the scan's grouping changes no bit.  A warp runs as many
// rows as its longest segment; a group whose segment has ended stays in the
// loop, its M and I updates off, so that its row max is taken after the
// loop on its own last row (its D goes on changing and is never read).  A
// warp whose pairs are all empty (len 0, the bucket's padding) leaves at
// once.  Read bases reach a group 4 * G rows at a time, four to a lane.
//
// The delete chain
//   d_new[j] = max_{j' < j} (m_new[j'] - j'*a_ext) + a_gap + (j-1)*a_ext
// is a running max of m_new - col_ext: a scan inside the lane, then a
// max-scan of the lanes' totals with __shfl_up_sync.  Columns >= W are
// padding: they only feed higher columns and are left out of the row max.
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
constexpr int MAX_GROUP_W = 1024;
constexpr int BLOCK_THREADS = 256;
constexpr int BLOCK_WARPS = BLOCK_THREADS / 32;
constexpr int MAX_SMEM_ROWS = 46 * 1024;  // M, I, D rows in shared memory
constexpr int SCRATCH_BLOCKS = 264;       // blocks when the rows are global
constexpr int PAIRS_PER_BLOCK = 8;        // group design: G / 4 warps a block
constexpr int NO_MATCH = 1000;            // a hap key no int8 base equals

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

// prev_of with the two a_back adds folded into one: max(i + a_back, d +
// a_back) and max(i, d) + a_back round to the same float (rounding to
// nearest is monotone)
__device__ __forceinline__ float prev_folded(float m, float i, float d,
                                             const HmmParams& p) {
  return fmaxf(__fadd_rn(m, p.a_mm), __fadd_rn(fmaxf(i, d), p.a_back));
}

// The M and I updates of one row of a lane's C columns, right to left so
// that column k - 1 still holds the last row.  AMB: some group of the warp
// reads an N base on this row, so every lane also tests b >= 4.
template <int C, bool AMB>
__device__ __forceinline__ void update_mi(float (&m)[C], float (&ii)[C],
                                          const float (&d)[C],
                                          const int (&hk)[C],
                                          const float (&em)[C], float up,
                                          int b, const HmmParams& p) {
#pragma unroll
  for (int k = C - 1; k >= 0; --k) {
    const float shifted = k == 0 ? up : prev_folded(m[k - 1], ii[k - 1],
                                                    d[k - 1], p);
    float e = b == hk[k] ? p.log_match : em[k];
    if (AMB && b >= 4) e = p.log_quarter;
    ii[k] = __fadd_rn(p.log_ins, fmaxf(__fadd_rn(m[k], p.a_gap),
                                       __fadd_rn(ii[k], p.a_ext)));
    m[k] = __fadd_rn(e, shifted);
  }
}

template <int G, int C>
__global__ void __launch_bounds__(PAIRS_PER_BLOCK * G)
pairhmm_viterbi_group_kernel(const int8_t* __restrict__ segs,
                             const int* __restrict__ seg_lens,
                             const int8_t* __restrict__ haps, int B, int R,
                             int W, HmmParams p, float* __restrict__ out) {
  static_assert(G >= 4 && G <= 32 && (G & (G - 1)) == 0, "G: 4 .. 32");
  constexpr bool HOIST = C <= 16;           // col_ext in registers
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);            // the lane in its group
  const int pair = blockIdx.x * PAIRS_PER_BLOCK + threadIdx.x / G;
  const bool real = pair < B;
  const int len0 = real ? seg_lens[pair] : 0;
  // rows this pair runs: 0 for an empty segment or one longer than R
  // (best stays 0 or NEG)
  const int len = len0 > 0 && len0 <= R ? len0 : 0;
  const int rows = __reduce_max_sync(FULL, len);
  if (rows == 0) {                          // the whole warp leaves together
    if (real && gl == 0) out[pair] = len0 == 0 ? 0.f : NEG;
    return;
  }
  const int j0 = gl * C;
  const int8_t* hp = haps + (size_t)(real ? pair : 0) * W;
  int hk[C];
  float em[C], ce[HOIST ? C : 1], m[C], ii[C], d[C];
  auto col_ext = [&](int k) {
    if constexpr (HOIST) return ce[k];
    else return __fmul_rn((float)(j0 + k), p.a_ext);
  };
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = j0 + k;
    const int h = real && j < W ? (int)hp[j] : 4;
    hk[k] = h >= 4 ? NO_MATCH : h;          // no read base equals NO_MATCH
    em[k] = h >= 4 ? p.log_quarter : p.log_mis;
    if constexpr (HOIST) ce[k] = __fmul_rn((float)j, p.a_ext);
    m[k] = 0.f;                             // free start in every column
    ii[k] = NEG;
    d[k] = NEG;
  }
  const float gap0 = __fmul_rn((float)(j0 - 1), p.a_ext);  // gap_ext[j0]
  const int8_t* sp = segs + (size_t)(real ? pair : 0) * R;
  unsigned chunk = 0;
  for (int t = 0; t < rows; ++t) {
    // bases t .. t + 4G - 1 of the group's segment, four to a lane
    if ((t & (4 * G - 1)) == 0) {
      chunk = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = t + 4 * gl + i;
        chunk |= (q < len ? (unsigned)(uint8_t)sp[q] : 4u) << (8 * i);
      }
    }
    const unsigned word = __shfl_sync(FULL, chunk, (t >> 2) & (G - 1), G);
    const int b = (int)(int8_t)(word >> (8 * (t & 3)));
    const bool act = t < len;
    // the diagonal into this lane's first column comes from the lane below
    float up = __shfl_up_sync(FULL, prev_folded(m[C - 1], ii[C - 1],
                                                d[C - 1], p), 1, G);
    if (gl == 0) up = NEG;
    if (__any_sync(FULL, act && b >= 4)) {
      if (act) update_mi<C, true>(m, ii, d, hk, em, up, b, p);
    } else if (act) {
      update_mi<C, false>(m, ii, d, hk, em, up, b, p);
    }
    // g = cummax(m_new - col_ext): inside the lane (kept in d), then over
    // the group's lanes (a lane below off the group's start reads itself)
    float run;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float x = __fsub_rn(m[k], col_ext(k));
      d[k] = k == 0 ? x : fmaxf(d[k - 1], x);
    }
    run = d[C - 1];
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
      run = fmaxf(run, __shfl_up_sync(FULL, run, off, G));
    // g over the columns below j0, = g[j0 - 1]
    float below = __shfl_up_sync(FULL, run, 1, G);
    if (gl == 0) below = -INFINITY;
    // d_new[j] = (g[j-1] + a_gap) + gap_ext[j]; NEG in column 0
#pragma unroll
    for (int k = C - 1; k >= 0; --k) {
      const float g = k == 0 ? below : fmaxf(below, d[k - 1]);
      d[k] = __fadd_rn(__fadd_rn(g, p.a_gap),
                      k == 0 ? gap0 : col_ext(k > 0 ? k - 1 : 0));
    }
    if (gl == 0) d[0] = NEG;
  }
  // the row where t + 1 == len: best = max(NEG, max_j max(m, i))
  float row = -INFINITY;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (j0 + k < W) row = fmaxf(row, fmaxf(m[k], ii[k]));
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    row = fmaxf(row, __shfl_xor_sync(FULL, row, off, G));
  if (real && gl == 0)
    out[pair] = len > 0 ? fmaxf(NEG, row) : (len0 == 0 ? 0.f : NEG);
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

template <int G, int C>
int launch_group(const int8_t* segs, const int* lens, const int8_t* haps,
                 int B, int R, int W, const HmmParams& p, float* out,
                 cudaStream_t s) {
  if (G * C < W) return (int)cudaErrorInvalidValue;
  const int blocks = (B + PAIRS_PER_BLOCK - 1) / PAIRS_PER_BLOCK;
  pairhmm_viterbi_group_kernel<G, C><<<blocks, PAIRS_PER_BLOCK * G, 0, s>>>(
      segs, lens, haps, B, R, W, p, out);
  return (int)cudaGetLastError();
}

// the group design's instances: G 4 at C 1-8; G 8 and 16 at C 5-8; G 32 at
// C 5-8, 12, 16, 24, 32 (realign.py::viterbi_group_shape)
int launch_group_at(int G, int C, const int8_t* segs, const int* lens,
                    const int8_t* haps, int B, int R, int W,
                    const HmmParams& p, float* out, cudaStream_t s) {
#define PAIRHMM_GROUP(GG, CC)                                               \
  if (G == GG && C == CC)                                                   \
    return launch_group<GG, CC>(segs, lens, haps, B, R, W, p, out, s);
  PAIRHMM_GROUP(4, 1) PAIRHMM_GROUP(4, 2) PAIRHMM_GROUP(4, 3)
  PAIRHMM_GROUP(4, 4) PAIRHMM_GROUP(4, 5) PAIRHMM_GROUP(4, 6)
  PAIRHMM_GROUP(4, 7) PAIRHMM_GROUP(4, 8)
  PAIRHMM_GROUP(8, 5) PAIRHMM_GROUP(8, 6) PAIRHMM_GROUP(8, 7)
  PAIRHMM_GROUP(8, 8)
  PAIRHMM_GROUP(16, 5) PAIRHMM_GROUP(16, 6) PAIRHMM_GROUP(16, 7)
  PAIRHMM_GROUP(16, 8)
  PAIRHMM_GROUP(32, 5) PAIRHMM_GROUP(32, 6) PAIRHMM_GROUP(32, 7)
  PAIRHMM_GROUP(32, 8) PAIRHMM_GROUP(32, 12) PAIRHMM_GROUP(32, 16)
  PAIRHMM_GROUP(32, 24) PAIRHMM_GROUP(32, 32)
#undef PAIRHMM_GROUP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* pairhmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of device memory pairhmm_viterbi_launch needs as `scratch`: 0
// unless W > 1024 and the block design's rows exceed its shared memory.
extern "C" long long pairhmm_scratch_bytes(int B, int W) {
  if (W <= MAX_GROUP_W || !rows_global(W)) return 0;
  return 12LL * W * (B < SCRATCH_BLOCKS ? B : SCRATCH_BLOCKS);
}

// Viterbi scores of B pairs on `stream`: segs (B, R) int8, seg_lens (B,)
// int32, haps (B, W) int8, out (B,) float32, all contiguous on the device;
// W >= 1, R >= 0; scratch as pairhmm_scratch_bytes asks (or null).  The
// eight constants are the plain version's fp32 values.  W <= 1024 takes the
// group design with G lanes a pair and C columns a lane (G * C >= W, one of
// launch_group_at's instances); W > 1024 the block design (G and C unused).
// Returns the cudaError_t of the launch.
extern "C" int pairhmm_viterbi_launch(
    int G, int C, const void* segs, const void* seg_lens, const void* haps,
    int B, int R, int W, float log_match, float log_mis, float log_ins,
    float log_quarter, float a_mm, float a_gap, float a_ext, float a_back,
    void* scratch, void* out, void* stream) {
  if (B <= 0 || R < 0 || W < 1) return (int)cudaErrorInvalidValue;
  const HmmParams p{log_match, log_mis, log_ins, log_quarter,
                    a_mm,      a_gap,   a_ext,   a_back};
  const int8_t* sg = static_cast<const int8_t*>(segs);
  const int* ln = static_cast<const int*>(seg_lens);
  const int8_t* hp = static_cast<const int8_t*>(haps);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W <= MAX_GROUP_W)
    return launch_group_at(G, C, sg, ln, hp, B, R, W, p, o, s);
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
