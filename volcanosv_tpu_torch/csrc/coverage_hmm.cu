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
// CoverageHMM._emissions makes them; S <= 8.
//
// coverage_viterbi_kernel: labels (B, T) int8.
//   delta_0[s] = logpi[s] + e_0[s]
//   delta_t[s] = max_{s'} (delta_{t-1}[s'] + logA[s', s]) + e_t[s]
// in that add order, each add rounded on its own (__fadd_rn), the max taking
// the first s' on ties (torch.max(dim) and jnp.argmax do; all-padded rows
// tie), the backpointers int8, then the backtrace from the first argmax of
// delta_{T-1}.  Adds and maxes on the plain version's bits: the labels are
// equal to its labels.
//
// coverage_posteriors_kernel: posteriors (T, B, S) float32.
//   alpha_t[s] = lse_{s'}(alpha_{t-1}[s'] + logA[s', s]) + e_t[s]
//   beta_t[s]  = lse_{s'}(logA[s, s'] + (e_{t+1}[s'] + beta_{t+1}[s']))
//   post_t     = softmax_s(alpha_t + beta_t)
// lse as torch computes it: the max m (0 where |m| is infinite), then
// log(sum exp(x - m)) + m, with the accurate expf / logf.  Not bit-equal to
// the plain version (its exp, log and sums round elsewhere): held to a
// float64 forward-backward (qc/flagger.py::posteriors_float64).  The alphas
// are staged in the output and overwritten by the posteriors on the way
// back.
//
// What bounds them on the card: a window costs 3S^2 + 4S + 1 (Viterbi) or
// 8S^2 + 17S (forward-backward) operations and 6 or 5 + 4S bytes, so the
// bound of a whole batch is microseconds; what the kernels cannot shorten
// is the chain of T dependent window steps of one contig.  Design: a thread
// per contig, the S-state carry and logA in registers, the chain walked
// once; neighbouring threads read neighbouring contigs' emissions of one
// window (coalesced), K windows at a time so that one load latency covers
// K steps.  The Viterbi's backpointers (T * S bytes a contig) sit in shared
// memory when they fit (MAX_SMEM_BP bytes a block), else in device memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_S = 8;
constexpr int MAX_SMEM_BP = 48 * 1024;
constexpr int THREADS = 32;

// windows whose emissions are loaded together
template <int S>
struct Chunk {
  static constexpr int K = S <= 4 ? 8 : 4;
};

template <int S>
__global__ void __launch_bounds__(THREADS)
coverage_viterbi_kernel(const float* __restrict__ emit,
                        const float* __restrict__ logA,
                        const float* __restrict__ logpi, int B, int T,
                        uint8_t* __restrict__ global_bp,
                        int8_t* __restrict__ labels) {
  extern __shared__ uint8_t smem_bp[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint8_t* bp = global_bp != nullptr
                    ? global_bp + (size_t)b * T * S
                    : smem_bp + (size_t)threadIdx.x * T * S;
  float A[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) A[i][j] = logA[i * S + j];
  float delta[S];
#pragma unroll
  for (int s = 0; s < S; ++s)
    delta[s] = __fadd_rn(logpi[s], emit[(size_t)b * S + s]);
  constexpr int K = Chunk<S>::K;
  for (int t0 = 1; t0 < T; t0 += K) {
    float e[K][S];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (t0 + k < T) {
#pragma unroll
        for (int s = 0; s < S; ++s)
          e[k][s] = emit[((size_t)(t0 + k) * B + b) * S + s];
      }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t0 + k;
      if (t >= T) break;
      float next[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        // scores[s', s] = (delta[s'] + logA[s', s]) + e_t[s]
        float best = __fadd_rn(__fadd_rn(delta[0], A[0][s]), e[k][s]);
        int arg = 0;
#pragma unroll
        for (int r = 1; r < S; ++r) {
          const float v = __fadd_rn(__fadd_rn(delta[r], A[r][s]), e[k][s]);
          if (v > best) {                    // the first s' on ties
            best = v;
            arg = r;
          }
        }
        next[s] = best;
        bp[(size_t)t * S + s] = (uint8_t)arg;
      }
#pragma unroll
      for (int s = 0; s < S; ++s) delta[s] = next[s];
    }
  }
  int state = 0;
  float best = delta[0];
#pragma unroll
  for (int s = 1; s < S; ++s)
    if (delta[s] > best) {
      best = delta[s];
      state = s;
    }
  int8_t* lab = labels + (size_t)b * T;
  lab[T - 1] = (int8_t)state;
  for (int t = T - 1; t > 0; --t) {
    state = bp[(size_t)t * S + state];
    lab[t - 1] = (int8_t)state;
  }
}

// log(sum_s exp(x[s])) as torch.logsumexp computes it
template <int S>
__device__ __forceinline__ float lse(const float (&x)[S]) {
  float m = x[0];
#pragma unroll
  for (int s = 1; s < S; ++s) m = fmaxf(m, x[s]);
  if (fabsf(m) == INFINITY) m = 0.f;
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) sum += expf(x[s] - m);
  return logf(sum) + m;
}

template <int S>
__global__ void __launch_bounds__(THREADS)
coverage_posteriors_kernel(const float* __restrict__ emit,
                           const float* __restrict__ logA,
                           const float* __restrict__ logpi, int B, int T,
                           float* out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float A[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) A[i][j] = logA[i * S + j];
  constexpr int K = Chunk<S>::K;
  // forward: the alphas go to out (T, B, S)
  float alpha[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    alpha[s] = logpi[s] + emit[(size_t)b * S + s];
    out[(size_t)b * S + s] = alpha[s];
  }
  for (int t0 = 1; t0 < T; t0 += K) {
    float e[K][S];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (t0 + k < T) {
#pragma unroll
        for (int s = 0; s < S; ++s)
          e[k][s] = emit[((size_t)(t0 + k) * B + b) * S + s];
      }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t0 + k;
      if (t >= T) break;
      float next[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float x[S];
#pragma unroll
        for (int r = 0; r < S; ++r) x[r] = alpha[r] + A[r][s];
        next[s] = lse<S>(x) + e[k][s];
      }
      float* o = out + ((size_t)t * B + b) * S;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        alpha[s] = next[s];
        o[s] = next[s];
      }
    }
  }
  // backward from beta_{T-1} = 0, each window's alphas read back and
  // replaced by its posteriors
  float beta[S];
#pragma unroll
  for (int s = 0; s < S; ++s) beta[s] = 0.f;
  for (int t1 = T - 1; t1 >= 0; t1 -= K) {
    // windows t1, t1 - 1, ...: their alphas and the emissions of t + 1
    float a[K][S], e[K][S];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t1 - k;
      if (t >= 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          a[k][s] = out[((size_t)t * B + b) * S + s];
          e[k][s] = t + 1 < T ? emit[((size_t)(t + 1) * B + b) * S + s] : 0.f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t1 - k;
      if (t < 0) break;
      if (t + 1 < T) {
        float y[S], next[S];
#pragma unroll
        for (int s = 0; s < S; ++s) y[s] = e[k][s] + beta[s];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float x[S];
#pragma unroll
          for (int r = 0; r < S; ++r) x[r] = A[s][r] + y[r];
          next[s] = lse<S>(x);
        }
#pragma unroll
        for (int s = 0; s < S; ++s) beta[s] = next[s];
      }
      // softmax over s of alpha_t + beta_t
      float lp[S];
      float m = -INFINITY;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        lp[s] = a[k][s] + beta[s];
        m = fmaxf(m, lp[s]);
      }
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        lp[s] = expf(lp[s] - m);
        sum += lp[s];
      }
      float* o = out + ((size_t)t * B + b) * S;
#pragma unroll
      for (int s = 0; s < S; ++s) o[s] = lp[s] / sum;
    }
  }
}

template <int S>
int launch_viterbi(const float* emit, const float* logA, const float* logpi,
                   int B, int T, uint8_t* scratch, int8_t* labels,
                   cudaStream_t s) {
  const size_t per_contig = (size_t)T * S;
  int threads = THREADS;
  size_t smem = 0;
  if (per_contig <= (size_t)MAX_SMEM_BP) {
    threads = (int)(MAX_SMEM_BP / per_contig);
    threads = threads > THREADS ? THREADS : threads;
    smem = per_contig * threads;
    scratch = nullptr;
  } else if (scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (B + threads - 1) / threads;
  coverage_viterbi_kernel<S><<<blocks, threads, smem, s>>>(
      emit, logA, logpi, B, T, scratch, labels);
  return (int)cudaGetLastError();
}

template <int S>
int launch_posteriors(const float* emit, const float* logA,
                      const float* logpi, int B, int T, float* out,
                      cudaStream_t s) {
  const int blocks = (B + THREADS - 1) / THREADS;
  coverage_posteriors_kernel<S><<<blocks, THREADS, 0, s>>>(emit, logA, logpi,
                                                           B, T, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* coverage_hmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of device memory coverage_viterbi_launch needs as `scratch` for the
// backpointers: 0 when a contig's T * S bytes fit in shared memory.
extern "C" long long coverage_viterbi_scratch_bytes(int B, int T, int S) {
  const long long per_contig = (long long)T * S;
  return per_contig <= MAX_SMEM_BP ? 0 : per_contig * B;
}

// Viterbi labels of B contigs on `stream`: emit (T, B, S) float32, logA
// (S, S), logpi (S,), labels (B, T) int8, scratch as
// coverage_viterbi_scratch_bytes asks (or null); 1 <= S <= 8, T >= 1.
// Returns the cudaError_t of the launch.
extern "C" int coverage_viterbi_launch(const void* emit, const void* logA,
                                       const void* logpi, int B, int T,
                                       int S, void* scratch, void* labels,
                                       void* stream) {
  if (B <= 0 || T <= 0 || S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  const float* e = static_cast<const float*>(emit);
  const float* a = static_cast<const float*>(logA);
  const float* pi = static_cast<const float*>(logpi);
  uint8_t* bp = static_cast<uint8_t*>(scratch);
  int8_t* lab = static_cast<int8_t*>(labels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
switch (S) {
    case 1: return launch_viterbi<1>(e, a, pi, B, T, bp, lab, st);
    case 2: return launch_viterbi<2>(e, a, pi, B, T, bp, lab, st);
    case 3: return launch_viterbi<3>(e, a, pi, B, T, bp, lab, st);
    case 4: return launch_viterbi<4>(e, a, pi, B, T, bp, lab, st);
    case 5: return launch_viterbi<5>(e, a, pi, B, T, bp, lab, st);
    case 6: return launch_viterbi<6>(e, a, pi, B, T, bp, lab, st);
    case 7: return launch_viterbi<7>(e, a, pi, B, T, bp, lab, st);
    default: return launch_viterbi<8>(e, a, pi, B, T, bp, lab, st);
  }
}

// Forward-backward posteriors of B contigs on `stream`: emit (T, B, S)
// float32, logA (S, S), logpi (S,), out (T, B, S) float32; 1 <= S <= 8,
// T >= 1.  Returns the cudaError_t of the launch.
extern "C" int coverage_posteriors_launch(const void* emit, const void* logA,
                                          const void* logpi, int B, int T,
                                          int S, void* out, void* stream) {
  if (B <= 0 || T <= 0 || S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  const float* e = static_cast<const float*>(emit);
  const float* a = static_cast<const float*>(logA);
  const float* pi = static_cast<const float*>(logpi);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return launch_posteriors<1>(e, a, pi, B, T, o, st);
    case 2: return launch_posteriors<2>(e, a, pi, B, T, o, st);
    case 3: return launch_posteriors<3>(e, a, pi, B, T, o, st);
    case 4: return launch_posteriors<4>(e, a, pi, B, T, o, st);
    case 5: return launch_posteriors<5>(e, a, pi, B, T, o, st);
    case 6: return launch_posteriors<6>(e, a, pi, B, T, o, st);
    case 7: return launch_posteriors<7>(e, a, pi, B, T, o, st);
    default: return launch_posteriors<8>(e, a, pi, B, T, o, st);
  }
}
