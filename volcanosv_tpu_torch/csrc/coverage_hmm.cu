// The coverage HMM's Viterbi and forward-backward, for Hopper (sm_90a).
//
// Replaces: volcanosv_tpu/qc/flagger.py::CoverageHMM.viterbi and
// CoverageHMM.posteriors, jitted XLA (jax.vmap over contigs of a lax.scan
// over windows; not Pallas kernels).  As plain torch
// (qc/flagger.py::_viterbi_plain, _posteriors_plain) each is a loop over the
// T windows of a few small ops a window.
//
// Inputs: emissions (T, B, S) float32 (padded windows at 0), log
// transitions logA (S, S) and log initial probabilities logpi (S,), as
// CoverageHMM._emissions makes them; S <= 8.  The launch shapes (segment
// length, segments, contigs a CTA) come from qc/flagger.py::coverage_plan
// and viterbi_plan, pure Python that the CPU tests check.
//
// What bounds them on the card: a window costs 3S^2 + 4S + 1 (Viterbi) or
// 8S^2 + 17S (forward-backward) operations and 6 or 5 + 4S bytes, so the
// bound of a whole batch is microseconds.  What sets their time is the
// chain of T dependent window steps of a contig, which both designs cut.
//
// coverage_viterbi_kernel: labels (B, T) int8.
//   delta_0[s] = logpi[s] + e_0[s]
//   delta_t[s] = max_{s'} (delta_{t-1}[s'] + logA[s', s]) + e_t[s]
// in that add order, each add rounded on its own (__fadd_rn), the max taking
// the first s' on ties (torch.max(dim) and jnp.argmax do; all-padded rows
// tie): delta's rounding depends on its value, so the forward walk stays
// one thread a contig (C contigs a CTA) and sequential in t, bit for bit
// the plain version's.  A step's argmax is a tournament whose left operand
// wins ties (the first index, in ceil(log2 S) levels); the next chunk of
// emissions (16-byte rows at S = 4) loads while this one computes; a
// window's S backpointers pack into one word of ceil(log2 S) bits a state
// (a byte at S <= 4), window-major, the C contigs of a CTA side by side, in
// shared memory (else in a device scratch the wrapper allocates).  The
// backtrace is split over Q segments of L windows: each segment composes
// its S -> S map from its last window's state to the state before its
// first window, one thread walks the Q maps from the argmax of
// delta_{T-1}, and each segment then walks its own windows, writing the
// labels over its backpointers; the CTA copies them out row by
// row.  Integers all the way: the labels equal the plain version's.
//
// coverage_posteriors_kernel: posteriors (T, B, S) float32.
//   alpha_t = lse_{s'}(alpha_{t-1}[s'] + logA[s', s]) + e_t[s]
//   beta_t  = lse_{s'}(logA[s, s'] + e_{t+1}[s'] + beta_{t+1}[s'])
//   post_t  = softmax_s(alpha_t + beta_t)
// Both recursions are products in the log semiring, so a segment of L
// windows has one matrix M_k = prod_t (logA (x) diag(e_t)) that carries
// alpha across it forward and beta back.  A CTA holds C contigs and a
// thread a segment: (1) each thread forms its M_k (S^3 exp2 a window, each
// row kept at a max of 0 with its own log scale, so that a row whose paths
// are all unlikely keeps its precision); (2) one thread a contig walks the
// P boundaries forward (alpha into each segment) and another, in another
// warp, backward (beta out of each segment); (3) each thread walks its
// segment forward from its alpha, staging the alphas in `out`, then back
// from its beta, writing the posteriors over them.  The chain falls from 2T
// window steps to about 3L + P.  Log space (not scaled linear space): a
// logA with -inf entries (stay = 1) leaves states with no path between
// them, whose ratios pass fp32's range in a few dozen windows; linear space
// then loses the state that wins later (0 x 0 at the crossing).  Every
// vector is kept at a max of 0 and the emissions at their window's max, so
// the sums round at the values' own size (the plain version's log alphas
// grow to |alpha| ~ 1e5 at chromosome scale); exp2f and log2f of values in
// log2 units, lse as torch computes it (the max m, 0 where |m| is
// infinite).  Not bit-equal to the plain version: held to a float64
// forward-backward (qc/flagger.py::posteriors_float64).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_S = 8;
constexpr float LOG2E = 1.4426950408889634f;
// the most threads a CTA of either kernel (qc/flagger.py::COVERAGE_THREADS)
constexpr int THREADS = 256;
// the most shared memory a CTA may ask for on sm_90
constexpr size_t MAX_SMEM = 227 * 1024;

// ----------------------------------------------------------------- Viterbi

// a window's S backpointers, ceil(log2 S) bits a state
template <int S>
struct Packed {
  static constexpr int BITS = S <= 2 ? 1 : (S <= 4 ? 2 : 3);
  static constexpr uint32_t MASK = (1u << BITS) - 1;
  using Word = typename std::conditional<S <= 4, uint8_t, uint32_t>::type;
};

// the largest of v[LO .. LO + N) and its first index: a tournament whose
// left operand wins ties
template <int N, int LO>
struct Tournament {
  static __device__ __forceinline__ float run(const float (&v)[MAX_S],
                                              int& arg) {
    constexpr int H = (N + 1) / 2;
    int al, ar;
    const float l = Tournament<H, LO>::run(v, al);
    const float r = Tournament<N - H, LO + H>::run(v, ar);
    const bool right = r > l;
    arg = right ? ar : al;
    return right ? r : l;
  }
};

template <int LO>
struct Tournament<1, LO> {
  static __device__ __forceinline__ float run(const float (&v)[MAX_S],
                                              int& arg) {
    arg = LO;
    return v[LO];
  }
};

// one window of the forward walk on one thread: delta_t from delta_{t-1},
// the window's S backpointers packed
template <int S>
__device__ __forceinline__ uint32_t viterbi_step(float (&delta)[MAX_S],
                                                 const float (&A)[S][S],
                                                 const float (&e)[S]) {
  float next[MAX_S];
  uint32_t code = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    // scores[s', s] = (delta[s'] + logA[s', s]) + e_t[s]
    float v[MAX_S];
#pragma unroll
    for (int r = 0; r < S; ++r)
      v[r] = __fadd_rn(__fadd_rn(delta[r], A[r][s]), e[s]);
    int arg;
    next[s] = Tournament<S, 0>::run(v, arg);
    code |= (uint32_t)arg << (Packed<S>::BITS * s);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) delta[s] = next[s];
  return code;
}

// S floats at p (16-byte pieces where S allows: the rows of (T, B, S)
// arrays and of the shared matrices are aligned to 4S bytes)
template <int S>
__device__ __forceinline__ void load_row(const float* p, float (&v)[S]) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int s = 0; s < S; s += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + s);
      v[s] = x.x;
      v[s + 1] = x.y;
      v[s + 2] = x.z;
      v[s + 3] = x.w;
    }
  } else if constexpr (S % 2 == 0) {
#pragma unroll
    for (int s = 0; s < S; s += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + s);
      v[s] = x.x;
      v[s + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = p[s];
  }
}

template <int S>
__device__ __forceinline__ void store_row(float* p, const float (&v)[S]) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int s = 0; s < S; s += 4)
      *reinterpret_cast<float4*>(p + s) =
          make_float4(v[s], v[s + 1], v[s + 2], v[s + 3]);
  } else if constexpr (S % 2 == 0) {
#pragma unroll
    for (int s = 0; s < S; s += 2)
      *reinterpret_cast<float2*>(p + s) = make_float2(v[s], v[s + 1]);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) p[s] = v[s];
  }
}

// emissions of K windows t, t + dir, ... of contig b (those inside
// [lo, hi)), loaded together
template <int S, int K>
__device__ __forceinline__ void load_windows(const float* __restrict__ emit,
                                             int B, int b, int t, int dir,
                                             int lo, int hi,
                                             float (&e)[K][S]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int u = t + dir * k;
    if (u >= lo && u < hi) load_row<S>(emit + ((size_t)u * B + b) * S, e[k]);
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS)
coverage_viterbi_kernel(const float* __restrict__ emit,
                        const float* __restrict__ logA,
                        const float* __restrict__ logpi, int B, int T,
                        int L, int Q, int C,
                        typename Packed<S>::Word* __restrict__ global_bp,
                        int8_t* __restrict__ labels) {
  using Word = typename Packed<S>::Word;
  constexpr int BITS = Packed<S>::BITS;
  constexpr uint32_t MASK = Packed<S>::MASK;
  extern __shared__ __align__(16) uint8_t smem[];
  // shared: the segments' maps (Q x C words), their end states (Q x C
  // bytes), then the backpointers (T x C words) unless in global memory
  uint32_t* maps = reinterpret_cast<uint32_t*>(smem);
  uint8_t* ends = smem + (size_t)Q * C * 4;
  const size_t head = ((size_t)Q * C * 5 + 15) / 16 * 16;
  Word* bp = global_bp != nullptr
                 ? global_bp + (size_t)blockIdx.x * T * C
                 : reinterpret_cast<Word*>(smem + head);
  const int c = threadIdx.x % C, q = threadIdx.x / C;
  const int b0 = blockIdx.x * C, b = b0 + c;
  const bool live = q < Q && b < B;

  // the forward walk, a thread a contig
  if (q == 0 && live) {
    float A[S][S];
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
      for (int j = 0; j < S; ++j) A[i][j] = logA[i * S + j];
    // e_t of the contig at row + t * stride
    const float* row = emit + (size_t)b * S;
    const size_t stride = (size_t)B * S;
    float delta[MAX_S], e0[S];
    load_row<S>(row, e0);
#pragma unroll
    for (int s = 0; s < S; ++s) delta[s] = __fadd_rn(logpi[s], e0[s]);
    constexpr int K = S <= 4 ? 8 : 4;
    float cur[K][S], nxt[K][S];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (1 + k < T) load_row<S>(row + (1 + k) * stride, cur[k]);
    int t0 = 1;
    for (; t0 + K <= T; t0 += K) {
      // the next chunk in flight while this one computes
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (t0 + K + k < T) load_row<S>(row + (t0 + K + k) * stride, nxt[k]);
#pragma unroll
      for (int k = 0; k < K; ++k)
        bp[(size_t)(t0 + k) * C + c] = (Word)viterbi_step<S>(delta, A, cur[k]);
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int s = 0; s < S; ++s) cur[k][s] = nxt[k][s];
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (t0 + k < T)
        bp[(size_t)(t0 + k) * C + c] = (Word)viterbi_step<S>(delta, A, cur[k]);
    int state;
    Tournament<S, 0>::run(delta, state);
    ends[(Q - 1) * C + c] = (uint8_t)state;
  }
  __syncthreads();
  // each segment q >= 1 composes its map: the state at its last window ->
  // the state at the window before its first
  const int t0 = q * L, t1 = min(T, t0 + L);
  if (q >= 1 && live) {
    uint32_t st[S];
#pragma unroll
    for (int s = 0; s < S; ++s) st[s] = s;
    for (int t = t1 - 1; t >= t0; --t) {
      const uint32_t w = bp[(size_t)t * C + c];
#pragma unroll
      for (int s = 0; s < S; ++s) st[s] = (w >> (BITS * st[s])) & MASK;
    }
    uint32_t m = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) m |= st[s] << (BITS * s);
    maps[q * C + c] = m;
  }
  __syncthreads();
  // the segments' end states, from the last
  if (q == 0 && live) {
    uint32_t e = ends[(Q - 1) * C + c];
    for (int k = Q - 1; k >= 1; --k) {
      e = (maps[k * C + c] >> (BITS * e)) & MASK;
      ends[(k - 1) * C + c] = (uint8_t)e;
    }
  }
  __syncthreads();
  // each segment walks its windows from its end state, the labels over
  // the backpointers
  if (live) {
    uint32_t st = ends[q * C + c];
    for (int t = t1 - 1; t >= t0; --t) {
      const uint32_t w = t > 0 ? (uint32_t)bp[(size_t)t * C + c] : 0u;
      bp[(size_t)t * C + c] = (Word)st;
      st = (w >> (BITS * st)) & MASK;
    }
  }
  __syncthreads();
  // the labels out, row by row
  const int rows = min(C, B - b0);
  for (int i = threadIdx.x; i < rows * T; i += blockDim.x) {
    const int r = i / T, t = i - r * T;
    labels[(size_t)(b0 + r) * T + t] = (int8_t)bp[(size_t)t * C + r];
  }
}

// ------------------------------------------------------ forward-backward

// log2(sum_i 2^x[i]) as torch.logsumexp computes it: the max m (0 where
// |m| is infinite), then log2(sum 2^(x - m)) + m
template <int N>
__device__ __forceinline__ float lse2(const float (&x)[N]) {
  float m = x[0];
#pragma unroll
  for (int i = 1; i < N; ++i) m = fmaxf(m, x[i]);
  if (fabsf(m) == INFINITY) m = 0.f;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) sum += exp2f(x[i] - m);
  return log2f(sum) + m;
}

// v less its max (left as it is where every entry is -inf); returns the max
template <int N>
__device__ __forceinline__ float normalise(float (&v)[N]) {
  float m = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) m = fmaxf(m, v[i]);
  if (m == -INFINITY) return m;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] -= m;
  return m;
}

// a window's emissions in log2 units less their max
template <int S>
__device__ __forceinline__ void emission2(const float (&e)[S],
                                          float (&E)[S]) {
  float m = e[0];
#pragma unroll
  for (int s = 1; s < S; ++s) m = fmaxf(m, e[s]);
#pragma unroll
  for (int s = 0; s < S; ++s) E[s] = (e[s] - m) * LOG2E;
}

template <int S>
__global__ void __launch_bounds__(THREADS)
coverage_posteriors_kernel(const float* __restrict__ emit,
                           const float* __restrict__ logA,
                           const float* __restrict__ logpi, int B, int T,
                           int L, int P, int C, float* out) {
  extern __shared__ __align__(16) float fsmem[];
  // shared: M_k (S x S) of every (segment, contig), then the alpha into
  // and the beta out of each segment (S each)
  const int n = C * P;
  float* Ms = fsmem;
  float* as = Ms + (size_t)n * S * S;
  float* bs = as + (size_t)n * S;
  const int c = threadIdx.x % C, k = threadIdx.x / C;
  const int b = blockIdx.x * C + c;
  const bool live = b < B;
  float A[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) A[i][j] = logA[i * S + j] * LOG2E;
  const int t0 = k * L, t1 = min(T, t0 + L);
  const int first = t0 > 0 ? t0 : 1;     // window 0 has no transition in
  constexpr int K = S <= 4 ? 4 : 2;

  // (1) M_k over the windows first .. t1 - 1, rows at a max of 0
  if (live && P > 1) {
    float M[S][S], scale[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      scale[i] = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) M[i][j] = i == j ? 0.f : -INFINITY;
    }
    float cur[K][S], nxt[K][S];
    load_windows<S, K>(emit, B, b, first, 1, first, t1, cur);
    for (int tc = first; tc < t1; tc += K) {
      load_windows<S, K>(emit, B, b, tc + K, 1, first, t1, nxt);
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        if (tc + kk >= t1) break;
        float E[S];
        emission2<S>(cur[kk], E);
        float N[S][S];
#pragma unroll
        for (int i = 0; i < S; ++i)
#pragma unroll
          for (int j = 0; j < S; ++j) {
            float x[S];
#pragma unroll
            for (int r = 0; r < S; ++r) x[r] = M[i][r] + A[r][j];
            N[i][j] = lse2<S>(x) + E[j];
          }
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const float m = normalise<S>(N[i]);
          if (m != -INFINITY) scale[i] += m;
#pragma unroll
          for (int j = 0; j < S; ++j) M[i][j] = N[i][j];
        }
      }
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
#pragma unroll
        for (int s = 0; s < S; ++s) cur[kk][s] = nxt[kk][s];
    }
    float* Mk = Ms + (size_t)(k * C + c) * S * S;
#pragma unroll
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int j = 0; j < S; ++j) M[i][j] += scale[i];
      store_row<S>(Mk + i * S, M[i]);
    }
  }
  __syncthreads();

  // alpha_0, at a max of 0
  auto alpha0 = [&](float (&v)[S]) {
    float e[S], E[S];
    load_row<S>(emit + (size_t)b * S, e);
    emission2<S>(e, E);
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = logpi[s] * LOG2E + E[s];
    normalise<S>(v);
  };

  // (2) the boundaries: forward by segment 0's thread, backward by a
  // thread of another warp where the CTA has one
  const int kb = (32 + C - 1) / C < P ? (32 + C - 1) / C : 1;
  if (live && P > 1 && k == 0) {
    float v[S];
    alpha0(v);
    for (int kk = 1; kk < P; ++kk) {
      const float* Mk = Ms + (size_t)((kk - 1) * C + c) * S * S;
      float M[S][S], nv[S];
#pragma unroll
      for (int i = 0; i < S; ++i) load_row<S>(Mk + i * S, M[i]);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        float x[S];
#pragma unroll
        for (int i = 0; i < S; ++i) x[i] = v[i] + M[i][j];
        nv[j] = lse2<S>(x);
      }
      normalise<S>(nv);
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = nv[s];
      store_row<S>(as + (size_t)(kk * C + c) * S, v);
    }
  } else if (live && P > 1 && k == kb) {
    float v[S];
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = 0.f;
    for (int kk = P - 1; kk >= 1; --kk) {
      const float* Mk = Ms + (size_t)(kk * C + c) * S * S;
      float nv[S];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        float x[S];
        load_row<S>(Mk + i * S, x);
#pragma unroll
        for (int j = 0; j < S; ++j) x[j] += v[j];
        nv[i] = lse2<S>(x);
      }
      normalise<S>(nv);
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = nv[s];
      store_row<S>(bs + (size_t)((kk - 1) * C + c) * S, v);
    }
  }
  __syncthreads();
  if (!live) return;

  // (3) forward over the segment, the alphas staged in out
  float al[S];
  if (k == 0) {
    alpha0(al);
    store_row<S>(out + (size_t)b * S, al);
  } else {
    load_row<S>(as + (size_t)(k * C + c) * S, al);
  }
  {
    float cur[K][S], nxt[K][S];
    load_windows<S, K>(emit, B, b, first, 1, first, t1, cur);
    for (int tc = first; tc < t1; tc += K) {
      load_windows<S, K>(emit, B, b, tc + K, 1, first, t1, nxt);
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const int t = tc + kk;
        if (t >= t1) break;
        float E[S], nv[S];
        emission2<S>(cur[kk], E);
#pragma unroll
        for (int j = 0; j < S; ++j) {
          float x[S];
#pragma unroll
          for (int i = 0; i < S; ++i) x[i] = al[i] + A[i][j];
          nv[j] = lse2<S>(x) + E[j];
        }
        normalise<S>(nv);
#pragma unroll
        for (int s = 0; s < S; ++s) al[s] = nv[s];
        store_row<S>(out + ((size_t)t * B + b) * S, al);
      }
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
#pragma unroll
        for (int s = 0; s < S; ++s) cur[kk][s] = nxt[kk][s];
    }
  }

  // backward from the segment's last window, each alpha replaced by its
  // posterior
  float be[S];
  if (k == P - 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) be[s] = 0.f;
  } else {
    load_row<S>(bs + (size_t)(k * C + c) * S, be);
  }
  auto posterior = [&](int t) {
    float* o = out + ((size_t)t * B + b) * S;
    float lp[S];
    load_row<S>(o, lp);
#pragma unroll
    for (int s = 0; s < S; ++s) lp[s] += be[s];
    normalise<S>(lp);
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      lp[s] = exp2f(lp[s]);
      sum += lp[s];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) lp[s] /= sum;
    store_row<S>(o, lp);
  };
  posterior(t1 - 1);
  {
    // the emissions of windows u = t + 1, from t1 - 1 down to t0 + 1
    float cur[K][S], nxt[K][S];
    load_windows<S, K>(emit, B, b, t1 - 1, -1, t0 + 1, t1, cur);
    for (int uc = t1 - 1; uc > t0; uc -= K) {
      load_windows<S, K>(emit, B, b, uc - K, -1, t0 + 1, t1, nxt);
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const int u = uc - kk;
        if (u <= t0) break;
        float E[S], y[S], nv[S];
        emission2<S>(cur[kk], E);
#pragma unroll
        for (int s = 0; s < S; ++s) y[s] = E[s] + be[s];
#pragma unroll
        for (int i = 0; i < S; ++i) {
          float x[S];
#pragma unroll
          for (int j = 0; j < S; ++j) x[j] = A[i][j] + y[j];
          nv[i] = lse2<S>(x);
        }
        normalise<S>(nv);
#pragma unroll
        for (int s = 0; s < S; ++s) be[s] = nv[s];
        posterior(u - 1);
      }
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
#pragma unroll
        for (int s = 0; s < S; ++s) cur[kk][s] = nxt[kk][s];
    }
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// L windows a segment, P segments, C contigs a CTA: a valid split of T
bool valid_split(int T, int L, int P, int C) {
  return L >= 1 && P >= 1 && C >= 1 && C * P <= THREADS &&
         (long long)(P - 1) * L < T && (long long)P * L >= T;
}

template <int S>
int launch_viterbi(const float* emit, const float* logA, const float* logpi,
                   int B, int T, int L, int Q, int C, void* scratch,
                   int8_t* labels, cudaStream_t s) {
  using Word = typename Packed<S>::Word;
  const size_t head = ((size_t)Q * C * 5 + 15) / 16 * 16;
  const size_t smem =
      head + (scratch != nullptr ? 0 : (size_t)T * C * sizeof(Word));
  int rc = allow_smem(coverage_viterbi_kernel<S>, smem);
  if (rc != 0) return rc;
  coverage_viterbi_kernel<S><<<(B + C - 1) / C, C * Q, smem, s>>>(
      emit, logA, logpi, B, T, L, Q, C, static_cast<Word*>(scratch), labels);
  return (int)cudaGetLastError();
}

template <int S>
int launch_posteriors(const float* emit, const float* logA,
                      const float* logpi, int B, int T, int L, int P, int C,
                      float* out, cudaStream_t s) {
  const size_t smem = (size_t)C * P * (S * S + 2 * S) * sizeof(float);
  int rc = allow_smem(coverage_posteriors_kernel<S>, smem);
  if (rc != 0) return rc;
  coverage_posteriors_kernel<S><<<(B + C - 1) / C, C * P, smem, s>>>(
      emit, logA, logpi, B, T, L, P, C, out);
  return (int)cudaGetLastError();
}

// `warps` warps of one CTA, each thread running n window steps of the
// forward walk at S = 4 on emissions in registers: the cycles and
// nanoseconds of thread 0's walk
__global__ void viterbi_step_chase_kernel(const float* __restrict__ init,
                                          int n, long long* out) {
  constexpr int S = 4, K = 8;
  float A[S][S], e[K][S], delta[MAX_S];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) A[i][j] = init[i * S + j];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int s = 0; s < S; ++s)
      e[k][s] = init[16 + (k * S + s + threadIdx.x) % 32];
#pragma unroll
  for (int s = 0; s < S; ++s) delta[s] = init[s];
  uint32_t sum = 0;
  long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  for (int t = 0; t < n; t += K) {
#pragma unroll
    for (int k = 0; k < K; ++k) sum ^= viterbi_step<S>(delta, A, e[k]);
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = g1 - g0;
    out[2] = sum + (long long)__float_as_int(delta[0]);
  }
}

}  // namespace

extern "C" const char* coverage_hmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Viterbi labels of B contigs on `stream`: emit (T, B, S) float32, logA
// (S, S), logpi (S,), labels (B, T) int8; 1 <= S <= 8, T >= 1.  The split
// (L windows a segment, Q segments, C contigs a CTA) and `scratch` (null,
// or ceil(B / C) * C * T words of the backpointers where they do not fit in
// shared memory) as qc/flagger.py::viterbi_plan gives them.  Returns the
// cudaError_t of the launch.
extern "C" int coverage_viterbi_launch(const void* emit, const void* logA,
                                       const void* logpi, int B, int T,
                                       int S, int L, int Q, int C,
                                       void* scratch, void* labels,
                                       void* stream) {
  if (B <= 0 || T <= 0 || S < 1 || S > MAX_S || !valid_split(T, L, Q, C))
    return (int)cudaErrorInvalidValue;
  const float* e = static_cast<const float*>(emit);
  const float* a = static_cast<const float*>(logA);
  const float* pi = static_cast<const float*>(logpi);
  int8_t* lab = static_cast<int8_t*>(labels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1:
      return launch_viterbi<1>(e, a, pi, B, T, L, Q, C, scratch, lab, st);
    case 2:
      return launch_viterbi<2>(e, a, pi, B, T, L, Q, C, scratch, lab, st);
    case 3:
      return launch_viterbi<3>(e, a, pi, B, T, L, Q, C, scratch, lab, st);
    case 4:
      return launch_viterbi<4>(e, a, pi, B, T, L, Q, C, scratch, lab, st);
    case 5:
      return launch_viterbi<5>(e, a, pi, B, T, L, Q, C, scratch, lab, st);
    case 6:
      return launch_viterbi<6>(e, a, pi, B, T, L, Q, C, scratch, lab, st);
    case 7:
      return launch_viterbi<7>(e, a, pi, B, T, L, Q, C, scratch, lab, st);
    default:
      return launch_viterbi<8>(e, a, pi, B, T, L, Q, C, scratch, lab, st);
  }
}

// The forward walk's step, timed: one CTA of `warps` warps (1 to 32), each
// thread n window steps (n % 8 == 0) at S = 4 from `init` (48 floats:
// logA, then emissions).  out[0] = thread 0's SM clock cycles, out[1] its
// nanoseconds (globaltimer), out[2] a checksum that keeps the steps live;
// out is three int64 in device memory; the call synchronises the stream.
extern "C" int viterbi_step_chase(const void* init, int warps, int n,
                                  void* out, void* stream) {
  if (warps < 1 || warps > 32 || n <= 0 || n % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  viterbi_step_chase_kernel<<<1, 32 * warps, 0, s>>>(
      static_cast<const float*>(init), n, static_cast<long long*>(out));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamSynchronize(s);
}

// Forward-backward posteriors of B contigs on `stream`: emit (T, B, S)
// float32, logA (S, S), logpi (S,), out (T, B, S) float32; 1 <= S <= 8,
// T >= 1; the split (L windows a segment, P segments, C contigs a CTA) as
// qc/flagger.py::coverage_plan gives it.  Returns the cudaError_t of the
// launch.
extern "C" int coverage_posteriors_launch(const void* emit, const void* logA,
                                          const void* logpi, int B, int T,
                                          int S, int L, int P, int C,
                                          void* out, void* stream) {
  if (B <= 0 || T <= 0 || S < 1 || S > MAX_S || !valid_split(T, L, P, C))
    return (int)cudaErrorInvalidValue;
  const float* e = static_cast<const float*>(emit);
  const float* a = static_cast<const float*>(logA);
  const float* pi = static_cast<const float*>(logpi);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return launch_posteriors<1>(e, a, pi, B, T, L, P, C, o, st);
    case 2: return launch_posteriors<2>(e, a, pi, B, T, L, P, C, o, st);
    case 3: return launch_posteriors<3>(e, a, pi, B, T, L, P, C, o, st);
    case 4: return launch_posteriors<4>(e, a, pi, B, T, L, P, C, o, st);
    case 5: return launch_posteriors<5>(e, a, pi, B, T, L, P, C, o, st);
    case 6: return launch_posteriors<6>(e, a, pi, B, T, L, P, C, o, st);
    case 7: return launch_posteriors<7>(e, a, pi, B, T, L, P, C, o, st);
    default: return launch_posteriors<8>(e, a, pi, B, T, L, P, C, o, st);
  }
}

