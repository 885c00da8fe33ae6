// Banded global (dual-)affine alignment DP for Hopper (sm_90a).
//
// Replaces: volcanosv_tpu/ops/pallas/banded_dp.py::_kernel (the Pallas TPU
// kernel launched by _banded_pallas_jit) and computes exactly what the scan
// oracle volcanosv_tpu/ops/banded_align.py::banded_align_scan computes, in
// the same diagonal space: lane l of query row i is target column
// j = i + d_lo + l.  Per row:
//   E  (vertical gap)   from lane l+1 of the previous row,
//   H  = max(diag + sub, E[, E2]); column -1 injected at lane -1-i-d_lo,
//   F  (horizontal gap) = exclusive max-plus prefix over lanes:
//        F[l] = max(NEG, max_{s<l} (Htmp[s] - ge*s)) + ge*l + go.
// Outputs: score and end_j per alignment; optionally a 1-byte/cell traceback
// (3-bit choice + E/F/E2/F2 open flags, the TB_* bits of ops/banded_align.py)
// in (B, M, W) layout, and the diagonal-0 row scores in (M, B) layout.
//
// Sentinel: NEG = -(10^9)/2 in int32, the scan's sentinel.  The Pallas
// kernel's int16-range NEG16 = -20000 would collide with real scores of
// edit distance at L = 16384 or of affine scoring over 8192-row windows.
//
// What bounds it on the card: integer operations.  A cell costs 5 (edit
// distance, score only) to 36 (dual-affine with traceback) int32 adds,
// maxes, compares and selects (chip_smoke.py, DP_OPS_PER_CELL), against at
// most one traceback byte written; at 132 SMs x 64 int32 lanes the
// operations outweigh the bytes four- to sevenfold.  The row
// recurrence is sequential, so each alignment walks its M rows in order and
// the latency of one row (the lane-crossing F prefix above all) has to be
// hidden behind other alignments.  Three designs; the launcher takes the
// warp design at W <= 512 and the group design above:
//
// W <= 512 (banded_dp_warp_kernel): one warp per alignment, 1 or 4 warps a
//   block (4 once B >= 512, so that small batches still spread over the
//   SMs), each thread owning L = W/32 contiguous lanes of H, E, E2 and the
//   target codes in registers.  Lane l+1 of the previous row is the
//   thread's own register k+1, or for its last lane the next thread's
//   first (__shfl_down_sync; NEG past lane W-1); the diagonal is its own
//   register.  The target window moves one lane per row as four codes to a
//   register (a funnel shift, one entering byte per row); the query code of
//   a row is one broadcast from 32 rows loaded at a time.  F is a serial
//   max over the thread's lanes, a 5-step __shfl_up_sync scan and a shift
//   by one thread.  The row loop touches no shared memory and has no
//   barrier.  DPX: __vibmax_s32 for every max whose tie flag is a
//   traceback bit (its predicate is a >= b, the >= / > rule of the bits),
//   __viaddmax_s32 for the F prefix.  A thread stores its L traceback bytes
//   of a row as one vector (1 to 16 bytes), so a warp writes each row of W
//   bytes in one coalesced pass.
// W = 1024, 2048, 4096 (banded_dp_group_kernel): K = W/512 warps per
//   alignment, one alignment a block, each warp running the warp design's
//   row code on its own 512 lanes (L = 16).  Only the K warps cross paths,
//   through a few words of shared memory and a barrier over their 32*K
//   threads (bar.sync 1, 32*K), twice a row: after each warp has published
//   its F total and the Htmp of its last lane (a warp's F prefix starts
//   from the max of the totals to its left), and after each has published
//   lane 0 of its new row (lane l+1 of the previous row for the last lane
//   of the warp to its left).  Each warp loads the query codes and the
//   target codes entering its own last lane.  With go = 0 and one gap class
//   (edit distance: Scores.edit()) E = H_up + ge exactly, since the stored
//   E never exceeds the stored H, and E opens at every cell: the EDIT
//   instance keeps no E registers.
// banded_dp_kernel (the first design, kept for timing as branch "block"):
//   one thread block per alignment, min(W, 1024) threads each owning
//   W/blockDim contiguous lanes.  The previous row's H, E and E2 live in
//   shared memory (one buffer: every read of row i happens before the
//   first barrier, every write after it), sized dynamically so W = 4096
//   fits.  The F prefix is a warp-shuffle scan plus a pass over the
//   per-warp totals; a row costs two block barriers.
// All skip rows at or past qlen (the walk never reads them; their row0
// entries are set to NEG) and read the target before column 0 or at/after
// tlen as code 4 (pad).
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int NEG = -(1000000000 / 2);
constexpr int MAXL = 4;          // lanes per thread: W <= 4 * 1024
constexpr int TB_UP = 1, TB_LEFT = 2, TB_UP2 = 3, TB_LEFT2 = 4;
constexpr int TB_E_OPEN = 8, TB_F_OPEN = 16, TB_E2_OPEN = 32, TB_F2_OPEN = 64;

struct Params {
  const int8_t* q;      // (B, M)
  const int8_t* t;      // (B, N)
  const int* qlen;      // (B,)
  const int* tlen;      // (B,)
  int B, M, N, W, d_lo;
  int match, mismatch, go, ge, go2, ge2;
  int free_t_start;
  int* score;           // (B,)
  int* end_j;           // (B,)
  uint8_t* tb;          // (B, M, W) or null
  int* row0;            // (M, B) or null
};

template <bool DUAL>
__device__ __forceinline__ int gap_score(const Params& p, int k) {
  int s = p.go + p.ge * k;
  if (DUAL) s = max(s, p.go2 + p.ge2 * k);
  return s;
}

template <bool DUAL, bool TB, bool ROW0, bool FREE_END>
__global__ void __launch_bounds__(1024)
banded_dp_kernel(Params p) {
  extern __shared__ int smem[];
  const int W = p.W;
  const int T = blockDim.x;
  const int L = W / T;
  const int tid = threadIdx.x;
  const int lane32 = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = T >> 5;
  const int b = blockIdx.x;

  int* Hs = smem;                       // W + 1 (slot W = NEG)
  int* Es = Hs + (W + 1);               // W + 1
  int* E2s = Es + (W + 1);              // W + 1 (dual only)
  int* edge = E2s + (DUAL ? (W + 1) : 0);   // T: Htmp of each thread's last lane
  int* wtot = edge + T;                 // 32
  int* wtot2 = wtot + 32;               // 32
  int* red_v = wtot2 + 32;              // 32
  int* red_l = red_v + 32;              // 32

  const int qlen = p.qlen[b];
  const int tlen = p.tlen[b];
  const int rows = min(qlen, p.M);
  const int8_t* qb = p.q + (size_t)b * p.M;
  const int8_t* tbase = p.t + (size_t)b * p.N;
  const int l0 = tid * L;

  // row -1: lane l <-> column j_init = -1 + d_lo + l
  for (int k = 0; k < L; ++k) {
    const int l = l0 + k;
    const int ji = -1 + p.d_lo + l;
    int h;
    if (p.free_t_start) {
      h = (ji >= -1 && ji < tlen) ? 0 : NEG;
    } else {
      h = (ji == -1) ? 0 : ((ji >= 0 && ji < tlen) ? gap_score<DUAL>(p, ji + 1) : NEG);
    }
    Hs[l] = h;
    Es[l] = NEG;
    if (DUAL) E2s[l] = NEG;
  }
  if (tid == 0) {
    Hs[W] = NEG;
    Es[W] = NEG;
    if (DUAL) E2s[W] = NEG;
    if (!(qlen >= 1 && qlen <= p.M)) {   // the scan never reaches a last row
      p.score[b] = NEG;
      p.end_j[b] = 0;
    }
  }
  __syncthreads();

  const int lstar = min(max(tlen - qlen - p.d_lo, 0), W - 1);

  for (int i = 0; i < rows; ++i) {
    const int qi = qb[i];
    const int lb = -1 - i - p.d_lo;
    const int boundary = gap_score<DUAL>(p, i + 1);

    int Htmp[MAXL], En[MAXL], E2n[MAXL], bits[MAXL], x[MAXL], x2[MAXL];
    bool jv[MAXL];
    int tot = INT_MIN, tot2 = INT_MIN, last_ht = NEG;
    // ---- phase A: reads of the previous row, E, diagonal, injection ----
#pragma unroll
    for (int k = 0; k < MAXL; ++k) {
      if (k < L) {
        const int l = l0 + k;
        const int j = i + p.d_lo + l;
        jv[k] = (j >= 0) && (j < tlen);
        const int tw = jv[k] ? (int)tbase[j] : 4;
        const bool is_match = (qi == tw) && (qi < 4) && (tw < 4);
        const int sub = is_match ? p.match : p.mismatch;
        const int h_up = Hs[l + 1];
        const int e_open = h_up + p.go + p.ge;
        const int e_ext = Es[l + 1] + p.ge;
        const int e = max(e_open, e_ext);
        int bt = (e_open >= e_ext) ? TB_E_OPEN : 0;
        const int hdiag = Hs[l] + sub;
        int ht = max(hdiag, e);
        int choice = (e > hdiag) ? TB_UP : 0;
        if (DUAL) {
          const int e2_open = h_up + p.go2 + p.ge2;
          const int e2_ext = E2s[l + 1] + p.ge2;
          const int e2 = max(e2_open, e2_ext);
          if (e2_open >= e2_ext) bt |= TB_E2_OPEN;
          if (e2 > ht) choice = TB_UP2;
          ht = max(ht, e2);
          E2n[k] = e2;
        }
        if (l == lb) ht = boundary;
        Htmp[k] = ht;
        last_ht = ht;
        En[k] = e;
        bits[k] = bt | choice;
        x[k] = ht - p.ge * l;
        tot = max(tot, x[k]);
        if (DUAL) {
          x2[k] = ht - p.ge2 * l;
          tot2 = max(tot2, x2[k]);
        }
      }
    }
    edge[tid] = last_ht;
    // inclusive warp scan of the per-thread maxima
    int v = tot, v2 = tot2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, v, off);
      if (lane32 >= off) v = max(v, n);
      if (DUAL) {
        const int n2 = __shfl_up_sync(0xffffffffu, v2, off);
        if (lane32 >= off) v2 = max(v2, n2);
      }
    }
    if (lane32 == 31) {
      wtot[warp] = v;
      if (DUAL) wtot2[warp] = v2;
    }
    int ex = __shfl_up_sync(0xffffffffu, v, 1);
    int ex2 = DUAL ? __shfl_up_sync(0xffffffffu, v2, 1) : INT_MIN;
    if (lane32 == 0) { ex = INT_MIN; ex2 = INT_MIN; }
    __syncthreads();

    // ---- phase B: F prefix, H, traceback byte, writes of this row ----
    for (int w = 0; w < warp; ++w) {
      ex = max(ex, wtot[w]);
      if (DUAL) ex2 = max(ex2, wtot2[w]);
    }
    int run = ex, run2 = ex2;
    int h_left = (tid > 0) ? edge[tid - 1] : NEG;
    int fb_v = INT_MIN, fb_l = 0;
#pragma unroll
    for (int k = 0; k < MAXL; ++k) {
      if (k < L) {
        const int l = l0 + k;
        const int pm = max(run, NEG);
        run = max(run, x[k]);
        const int f = pm + p.ge * l + p.go;
        int bt = bits[k];
        if ((h_left + p.go + p.ge) >= f) bt |= TB_F_OPEN;
        int h = max(Htmp[k], f);
        if (f > Htmp[k]) bt = (bt & ~7) | TB_LEFT;
        if (DUAL) {
          const int pm2 = max(run2, NEG);
          run2 = max(run2, x2[k]);
          const int f2 = pm2 + p.ge2 * l + p.go2;
          if ((h_left + p.go2 + p.ge2) >= f2) bt |= TB_F2_OPEN;
          if (f2 > h) bt = (bt & ~7) | TB_LEFT2;
          h = max(h, f2);
        }
        h_left = Htmp[k];
        const bool cv = jv[k];             // row i < qlen always holds here
        h = (cv || l == lb) ? h : NEG;
        Hs[l] = h;
        Es[l] = cv ? En[k] : NEG;
        if (DUAL) E2s[l] = cv ? E2n[k] : NEG;
        if (TB) p.tb[((size_t)b * p.M + i) * W + l] = (uint8_t)bt;
        if (ROW0 && l == -p.d_lo) p.row0[(size_t)i * p.B + b] = h;
        if (i == qlen - 1) {
          if (FREE_END) {
            const int val = jv[k] ? h : NEG;
            if (val > fb_v) { fb_v = val; fb_l = l; }
          } else if (l == lstar) {
            p.score[b] = h;
            p.end_j[b] = tlen - 1;
          }
        }
      }
    }
    if (FREE_END && i == qlen - 1) {     // block-uniform branch
      // best value on the last row, smallest lane among ties (the scan's
      // argmax); the Pallas kernel picks the largest j instead
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int ov = __shfl_down_sync(0xffffffffu, fb_v, off);
        const int ol = __shfl_down_sync(0xffffffffu, fb_l, off);
        if (ov > fb_v || (ov == fb_v && ol < fb_l)) { fb_v = ov; fb_l = ol; }
      }
      if (lane32 == 0) { red_v[warp] = fb_v; red_l[warp] = fb_l; }
      __syncthreads();
      if (tid == 0) {
        int bv = red_v[0], bl = red_l[0];
        for (int w = 1; w < n_warps; ++w) {
          if (red_v[w] > bv || (red_v[w] == bv && red_l[w] < bl)) {
            bv = red_v[w]; bl = red_l[w];
          }
        }
        p.score[b] = bv;
        p.end_j[b] = i + p.d_lo + bl;
      }
    }
    __syncthreads();
  }
  if (ROW0) {
    for (int i = rows + tid; i < p.M; i += T) p.row0[(size_t)i * p.B + b] = NEG;
  }
}

template <bool DUAL, bool TB, bool ROW0, bool FREE_END>
int launch_t(const Params& p, int threads, size_t smem, cudaStream_t stream) {
  auto kern = banded_dp_kernel<DUAL, TB, ROW0, FREE_END>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<p.B, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool DUAL, bool TB>
int launch_r(const Params& p, bool row0, bool free_end, int threads,
             size_t smem, cudaStream_t s) {
  if (row0) {
    return free_end ? launch_t<DUAL, TB, true, true>(p, threads, smem, s)
                    : launch_t<DUAL, TB, true, false>(p, threads, smem, s);
  }
  return free_end ? launch_t<DUAL, TB, false, true>(p, threads, smem, s)
                  : launch_t<DUAL, TB, false, false>(p, threads, smem, s);
}

// ---------------------------------------------------------------------------
// The row in registers: one warp per alignment (W <= 512), or K warps per
// alignment on 512 lanes each (W = 1024 ... 4096)
// ---------------------------------------------------------------------------

constexpr int WARP_W_MAX = 512;
constexpr int GROUP_L = 16;             // lanes a thread in the group design
constexpr int BRANCH_WARP = 1, BRANCH_BLOCK = 2, BRANCH_GROUP = 3;

// The design a launch takes: the warp one at every W <= 512 and the group
// one above, whatever B (each was faster than the block design at every
// batch size timed, B = 64 included).
int pick_branch(int W) {
  return W <= WARP_W_MAX ? BRANCH_WARP : BRANCH_GROUP;
}

// Warps (alignments) per block: one below B = 512, so that a small batch
// lands on as many SMs as it has alignments; four above, so that an SM can
// hold more than its 32-block limit of warps.
int warps_per_block(int B) { return B >= 512 ? 4 : 1; }

// Bit k set for the lanes k in [lo, hi) of a thread's L.
template <int L>
__device__ __forceinline__ unsigned lane_range(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, L);
  if (hi <= lo) return 0u;
  return ((1u << hi) - 1u) & ~((1u << lo) - 1u);
}

// One row's L traceback bytes of a thread as one store (dst is L-aligned).
template <int L>
__device__ __forceinline__ void store_row(uint8_t* dst,
                                          const unsigned (&w)[(L + 3) / 4]) {
  if constexpr (L == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (L == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else if constexpr (L == 4) {
    *reinterpret_cast<unsigned*>(dst) = w[0];
  } else if constexpr (L == 2) {
    *reinterpret_cast<unsigned short*>(dst) = (unsigned short)w[0];
  } else {
    *dst = (uint8_t)w[0];
  }
}

// Code of target column j, 4 outside [0, tlen).
__device__ __forceinline__ int t_code(const int8_t* t, int j, int tlen) {
  return (j >= 0 && j < tlen) ? (int)t[j] : 4;
}

// What the K warps of one alignment exchange in the group design.  Each
// field is written before a barrier and read after it; the next write comes
// after the following barrier.
template <int K>
struct GroupXchg {
  int tot[K], tot2[K];     // each warp's max of Htmp - ge*l (ge2) this row
  int edge[K];             // Htmp of each warp's last lane this row
  int h[K], e[K], e2[K];   // each warp's lane 0 after the previous row
  int bv[K], bl[K];        // free_t_end: each warp's best on the last row
};

// Barrier over the 32*K threads of one alignment.
template <int K>
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * K) : "memory");
}

// The rows of alignment b on warp w of its K warps, L lanes a thread: lane
// l = (32w + thread) * L + k.  K = 1 is the warp design; x is the K warps'
// exchange (unused at K = 1).  EDIT: go = 0 and one gap class, so that
// E = H_up + ge (see the head of the file).
template <int L, int K, bool DUAL, bool TB, bool EDIT>
__device__ __forceinline__ void dp_rows(const Params& p, const int b,
                                        const int w, const int row0_on,
                                        const int free_end,
                                        GroupXchg<K>* x) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int W = 32 * L * K;
  constexpr int NW = (L + 3) / 4;       // registers of packed target codes
  const int lane = threadIdx.x & 31;
  const int d_lo = p.d_lo;
  const int qlen = p.qlen[b];
  const int tlen = p.tlen[b];
  const int rows = min(qlen, p.M);
  const int8_t* qb = p.q + (size_t)b * p.M;
  const int8_t* tbase = p.t + (size_t)b * p.N;
  const int l0 = (32 * w + lane) * L;
  const int l_end = 32 * L * (w + 1);   // one past the warp's last lane
  const int goe = p.go + p.ge;
  const int goe2 = p.go2 + p.ge2;

  // row -1, lane l <-> column -1 + d_lo + l; the target window of row 0,
  // lane l <-> column d_lo + l, four codes to a register
  int H[L], E[L], E2[L];
  unsigned tw[NW];
#pragma unroll
  for (int n = 0; n < NW; ++n) tw[n] = 0u;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int ji = -1 + p.d_lo + l0 + k;
    if (p.free_t_start) {
      H[k] = (ji >= -1 && ji < tlen) ? 0 : NEG;
    } else {
      H[k] = (ji == -1) ? 0
           : ((ji >= 0 && ji < tlen) ? gap_score<DUAL>(p, ji + 1) : NEG);
    }
    E[k] = NEG;
    E2[k] = NEG;
    tw[k >> 2] |= (unsigned)(uint8_t)t_code(tbase, ji + 1, tlen)
                  << (8 * (k & 3));
  }
  if (w == 0 && lane == 0 && !(qlen >= 1 && qlen <= p.M)) {
    p.score[b] = NEG;                     // no last row is reached
    p.end_j[b] = 0;
  }
  const int lstar = min(max(tlen - qlen - d_lo, 0), W - 1);

  // query codes of 32 rows, and the target code entering the warp's last
  // lane after each of them, one lane per row; the next 32 are loaded a
  // group ahead
  int q_cur = (lane < p.M) ? (int)qb[lane] : 4;
  int t_cur = t_code(tbase, lane + d_lo + l_end, tlen);
  int q_nxt = (32 + lane < p.M) ? (int)qb[32 + lane] : 4;
  int t_nxt = t_code(tbase, 32 + lane + d_lo + l_end, tlen);
  if constexpr (K > 1) {
    if (lane == 0) { x->h[w] = H[0]; x->e[w] = NEG; x->e2[w] = NEG; }
    group_sync<K>();
  }

  for (int i = 0; i < rows; ++i) {
    if ((i & 31) == 0 && i > 0) {
      q_cur = q_nxt;
      t_cur = t_nxt;
      const int r = i + 32 + lane;
      q_nxt = (r < p.M) ? (int)qb[r] : 4;
      t_nxt = t_code(tbase, r + d_lo + l_end, tlen);
    }
    const int qi = __shfl_sync(FULL, q_cur, i & 31);
    const int t_in = __shfl_sync(FULL, t_cur, i & 31);
    const int qm = (qi < 4) ? qi : INT_MAX;   // a match needs qi < 4
    // lane l+1 of the previous row for the thread's last lane: the next
    // thread's first, the next warp's lane 0, or NEG past lane W-1
    int h_nx = __shfl_down_sync(FULL, H[0], 1);
    int e_nx = NEG, e2_nx = NEG;
    if constexpr (!EDIT) e_nx = __shfl_down_sync(FULL, E[0], 1);
    if constexpr (DUAL) e2_nx = __shfl_down_sync(FULL, E2[0], 1);
    const unsigned t_nx = __shfl_down_sync(FULL, tw[0], 1);
    if (lane == 31) {
      h_nx = NEG; e_nx = NEG; e2_nx = NEG;
      if constexpr (K > 1) {
        if (w + 1 < K) {
          h_nx = x->h[w + 1];
          if constexpr (!EDIT) e_nx = x->e[w + 1];
          if constexpr (DUAL) e2_nx = x->e2[w + 1];
        }
      }
    }

    const int j0 = i + d_lo + l0;             // column of the thread's k = 0
    const unsigned valid = lane_range<L>(-j0, tlen - j0);
    const int kb = -1 - j0;                   // the thread's lane of column -1
    const unsigned keep =
        valid | ((kb >= 0 && kb < L) ? (1u << kb) : 0u);

    // ---- E, E2, diagonal: H[k] becomes Htmp, E[k] the new E, in place
    // (lane k+1 still holds the previous row when lane k reads it) ----
    int bits[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int h_up = (k + 1 < L) ? H[k + 1] : h_nx;
      const int tc = (int)(int8_t)(tw[k >> 2] >> (8 * (k & 3)));
      const int sub = (tc == qm) ? p.match : p.mismatch;
      const bool jv = (valid >> k) & 1u;
      bool e_opens = true, diag_wins;
      int e = h_up + goe;
      if constexpr (!EDIT) {
        const int e_up = (k + 1 < L) ? E[k + 1] : e_nx;
        e = __vibmax_s32(h_up + goe, e_up + p.ge, &e_opens);
      }
      int ht = __vibmax_s32(H[k] + sub, e, &diag_wins);
      int bt = (e_opens ? TB_E_OPEN : 0) | (diag_wins ? 0 : TB_UP);
      if (DUAL) {
        const int e2_up = (k + 1 < L) ? E2[k + 1] : e2_nx;
        bool e2_opens, h_wins;
        const int e2 = __vibmax_s32(h_up + goe2, e2_up + p.ge2, &e2_opens);
        ht = __vibmax_s32(ht, e2, &h_wins);
        if (e2_opens) bt |= TB_E2_OPEN;
        if (!h_wins) bt = (bt & ~7) | TB_UP2;
        E2[k] = jv ? e2 : NEG;
      }
      if constexpr (!EDIT) E[k] = jv ? e : NEG;
      H[k] = ht;
      bits[k] = bt;
    }
    if (i < -d_lo) {                          // column -1 is in the band
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (k == kb) H[k] = gap_score<DUAL>(p, i + 1);
      }
    }

    // ---- F: exclusive max-plus prefix of Htmp - ge*l over the W lanes,
    // started at NEG (the scan's clamp) ----
    int tot = NEG, tot2 = NEG;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      tot = __viaddmax_s32(H[k], -p.ge * (l0 + k), tot);
      if (DUAL) tot2 = __viaddmax_s32(H[k], -p.ge2 * (l0 + k), tot2);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(FULL, tot, off);
      if (lane >= off) tot = max(tot, n);
      if (DUAL) {
        const int n2 = __shfl_up_sync(FULL, tot2, off);
        if (lane >= off) tot2 = max(tot2, n2);
      }
    }
    int run = __shfl_up_sync(FULL, tot, 1);
    int run2 = DUAL ? __shfl_up_sync(FULL, tot2, 1) : NEG;
    int h_left = __shfl_up_sync(FULL, H[L - 1], 1);   // Htmp of lane l0-1
    if (lane == 0) { run = NEG; run2 = NEG; h_left = NEG; }
    if constexpr (K > 1) {
      // the prefix starts from the totals of the warps to the left; lane 0
      // takes h_left from the last lane of the warp before
      if (lane == 31) {
        x->tot[w] = tot;
        if constexpr (DUAL) x->tot2[w] = tot2;
        x->edge[w] = H[L - 1];
      }
      group_sync<K>();
#pragma unroll
      for (int v = 0; v + 1 < K; ++v) {
        if (v < w) {
          run = max(run, x->tot[v]);
          if constexpr (DUAL) run2 = max(run2, x->tot2[v]);
        }
      }
      if (lane == 0 && w > 0) h_left = x->edge[w - 1];
    }

    // ---- H, the traceback byte, the masks ----
    unsigned tbw[NW];
#pragma unroll
    for (int n = 0; n < NW; ++n) tbw[n] = 0u;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int l = l0 + k;
      const int ht = H[k];
      const int f = run + (p.ge * l + p.go);
      run = __viaddmax_s32(ht, -p.ge * l, run);
      int bt = bits[k];
      if (h_left + goe >= f) bt |= TB_F_OPEN;
      bool h_wins;
      int h = __vibmax_s32(ht, f, &h_wins);
      if (!h_wins) bt = (bt & ~7) | TB_LEFT;
      if (DUAL) {
        const int f2 = run2 + (p.ge2 * l + p.go2);
        run2 = __viaddmax_s32(ht, -p.ge2 * l, run2);
        if (h_left + goe2 >= f2) bt |= TB_F2_OPEN;
        bool h2_wins;
        h = __vibmax_s32(h, f2, &h2_wins);
        if (!h2_wins) bt = (bt & ~7) | TB_LEFT2;
      }
      h_left = ht;
      H[k] = ((keep >> k) & 1u) ? h : NEG;
      if (TB) tbw[k >> 2] |= (unsigned)bt << (8 * (k & 3));
    }
    if constexpr (K > 1) {
      if (lane == 0) {
        x->h[w] = H[0];
        if constexpr (!EDIT) x->e[w] = E[0];
        if constexpr (DUAL) x->e2[w] = E2[0];
      }
    }
    if (TB) store_row<L>(p.tb + ((size_t)b * p.M + i) * W + l0, tbw);
    if (row0_on) {
      const int kr = -d_lo - l0;              // the thread's lane of diag 0
      if (kr >= 0 && kr < L) {
#pragma unroll
        for (int k = 0; k < L; ++k) {
          if (k == kr) p.row0[(size_t)i * p.B + b] = H[k];
        }
      }
    }
    if (i == qlen - 1) {                      // uniform over the K warps
      if (free_end) {
        // best value on the last row, smallest lane among ties (the
        // scan's argmax); the Pallas kernel picks the largest j instead
        int bv = INT_MIN, bl = 0;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          const int v = ((valid >> k) & 1u) ? H[k] : NEG;
          if (v > bv) { bv = v; bl = l0 + k; }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const int ov = __shfl_down_sync(FULL, bv, off);
          const int ol = __shfl_down_sync(FULL, bl, off);
          if (ov > bv || (ov == bv && ol < bl)) { bv = ov; bl = ol; }
        }
        if constexpr (K > 1) {
          if (lane == 0) { x->bv[w] = bv; x->bl[w] = bl; }
          group_sync<K>();
          if (w == 0 && lane == 0) {
#pragma unroll
            for (int v = 1; v < K; ++v) {
              const int ov = x->bv[v], ol = x->bl[v];
              if (ov > bv || (ov == bv && ol < bl)) { bv = ov; bl = ol; }
            }
          }
        }
        if (w == 0 && lane == 0) {
          p.score[b] = bv;
          p.end_j[b] = i + d_lo + bl;
        }
      } else {
        const int ks = lstar - l0;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          if (k == ks) {
            p.score[b] = H[k];
            p.end_j[b] = tlen - 1;
          }
        }
      }
    }

    // ---- the target window of row i+1: one lane to the left ----
    const unsigned in = (lane == 31 ? (unsigned)t_in : t_nx) & 0xffu;
    if constexpr (L % 4 == 0) {
#pragma unroll
      for (int n = 0; n + 1 < NW; ++n) {
        tw[n] = __funnelshift_r(tw[n], tw[n + 1], 8);
      }
      tw[NW - 1] = __funnelshift_r(tw[NW - 1], in, 8);
    } else {
      tw[0] = (tw[0] >> 8) | (in << (8 * (L - 1)));
    }
    if constexpr (K > 1) group_sync<K>();     // lane 0 of each warp is out
  }
  if (row0_on) {
    for (int i = max(rows, 0) + 32 * w + lane; i < p.M; i += 32 * K) {
      p.row0[(size_t)i * p.B + b] = NEG;
    }
  }
}

template <int L, bool DUAL, bool TB>
__global__ void __launch_bounds__(128)
banded_dp_warp_kernel(Params p, int row0_on, int free_end) {
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= p.B) return;                 // ragged last block: whole warps
  dp_rows<L, 1, DUAL, TB, false>(p, b, 0, row0_on, free_end, nullptr);
}

template <int K, bool DUAL, bool TB, bool EDIT>
__global__ void __launch_bounds__(32 * K)
banded_dp_group_kernel(Params p, int row0_on, int free_end) {
  __shared__ GroupXchg<K> x;
  dp_rows<GROUP_L, K, DUAL, TB, EDIT>(p, blockIdx.x, threadIdx.x >> 5,
                                      row0_on, free_end, &x);
}

template <int L, bool DUAL, bool TB>
int launch_warp_l(const Params& p, int row0, int free_end, cudaStream_t s) {
  const int wpb = warps_per_block(p.B);
  const int grid = (p.B + wpb - 1) / wpb;
  banded_dp_warp_kernel<L, DUAL, TB><<<grid, 32 * wpb, 0, s>>>(
      p, row0, free_end);
  return (int)cudaGetLastError();
}

template <bool DUAL, bool TB>
int launch_warp(const Params& p, int row0, int free_end, cudaStream_t s) {
  switch (p.W) {
    case 32: return launch_warp_l<1, DUAL, TB>(p, row0, free_end, s);
    case 64: return launch_warp_l<2, DUAL, TB>(p, row0, free_end, s);
    case 128: return launch_warp_l<4, DUAL, TB>(p, row0, free_end, s);
    case 256: return launch_warp_l<8, DUAL, TB>(p, row0, free_end, s);
    case 512: return launch_warp_l<16, DUAL, TB>(p, row0, free_end, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int K, bool DUAL, bool TB, bool EDIT>
int launch_group_k(const Params& p, int row0, int free_end, cudaStream_t s) {
  banded_dp_group_kernel<K, DUAL, TB, EDIT><<<p.B, 32 * K, 0, s>>>(
      p, row0, free_end);
  return (int)cudaGetLastError();
}

template <bool DUAL, bool TB, bool EDIT>
int launch_group(const Params& p, int row0, int free_end, cudaStream_t s) {
  switch (p.W) {
    case 1024: return launch_group_k<2, DUAL, TB, EDIT>(p, row0, free_end, s);
    case 2048: return launch_group_k<4, DUAL, TB, EDIT>(p, row0, free_end, s);
    case 4096: return launch_group_k<8, DUAL, TB, EDIT>(p, row0, free_end, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* banded_dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The design banded_dp_launch takes at band W: 1 = a warp per alignment
// (W <= 512), 3 = W/512 warps per alignment (W > 512).
extern "C" int banded_dp_branch(int W) { return pick_branch(W); }

// banded_dp_launch with the design forced: branch 0 = as banded_dp_launch
// picks it, 1 = a warp per alignment (W <= 512 only), 2 = a block per
// alignment, 3 = W/512 warps per alignment (W > 512 only).
extern "C" int banded_dp_launch_branch(
    int branch, const void* q, const void* t, const void* qlen,
    const void* tlen, int B, int M, int N, int W, int d_lo,
    int match, int mismatch, int go, int ge, int dual, int go2, int ge2,
    int with_tb, int row0, int free_t_end, int free_t_start,
    void* score, void* end_j, void* tb, void* row0_out, void* stream) {
  // W: a power of two in [32, 4096], so that blockDim = min(W, 1024) is a
  // whole number of warps and each thread owns at most MAXL lanes
  if (W < 32 || W > 1024 * MAXL || (W & (W - 1)) != 0 || B <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  if (branch == 0) branch = pick_branch(W);
  if (branch != BRANCH_WARP && branch != BRANCH_BLOCK &&
      branch != BRANCH_GROUP)
    return (int)cudaErrorInvalidValue;
  if ((branch == BRANCH_WARP && W > WARP_W_MAX) ||
      (branch == BRANCH_GROUP && W <= WARP_W_MAX))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.t = static_cast<const int8_t*>(t);
  p.qlen = static_cast<const int*>(qlen);
  p.tlen = static_cast<const int*>(tlen);
  p.B = B; p.M = M; p.N = N; p.W = W; p.d_lo = d_lo;
  p.match = match; p.mismatch = mismatch; p.go = go; p.ge = ge;
  p.go2 = go2; p.ge2 = ge2;
  p.free_t_start = free_t_start;
  p.score = static_cast<int*>(score);
  p.end_j = static_cast<int*>(end_j);
  p.tb = static_cast<uint8_t*>(tb);
  p.row0 = static_cast<int*>(row0_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (branch == BRANCH_WARP) {
    if (dual) {
      return with_tb ? launch_warp<true, true>(p, row0, free_t_end, s)
                     : launch_warp<true, false>(p, row0, free_t_end, s);
    }
    return with_tb ? launch_warp<false, true>(p, row0, free_t_end, s)
                   : launch_warp<false, false>(p, row0, free_t_end, s);
  }
  if (branch == BRANCH_GROUP) {
    if (dual) {
      return with_tb ? launch_group<true, true, false>(p, row0, free_t_end, s)
                     : launch_group<true, false, false>(p, row0, free_t_end, s);
    }
    if (go == 0) {                      // edit distance: no E registers
      return with_tb ? launch_group<false, true, true>(p, row0, free_t_end, s)
                     : launch_group<false, false, true>(p, row0, free_t_end, s);
    }
    return with_tb ? launch_group<false, true, false>(p, row0, free_t_end, s)
                   : launch_group<false, false, false>(p, row0, free_t_end, s);
  }
  const int threads = W < 1024 ? W : 1024;
  const size_t smem = sizeof(int) *
      ((size_t)(dual ? 3 : 2) * (W + 1) + threads + 4 * 32);
  if (dual) {
    return with_tb ? launch_r<true, true>(p, row0, free_t_end, threads, smem, s)
                   : launch_r<true, false>(p, row0, free_t_end, threads, smem, s);
  }
  return with_tb ? launch_r<false, true>(p, row0, free_t_end, threads, smem, s)
                 : launch_r<false, false>(p, row0, free_t_end, threads, smem, s);
}

extern "C" int banded_dp_launch(
    const void* q, const void* t, const void* qlen, const void* tlen,
    int B, int M, int N, int W, int d_lo,
    int match, int mismatch, int go, int ge, int dual, int go2, int ge2,
    int with_tb, int row0, int free_t_end, int free_t_start,
    void* score, void* end_j, void* tb, void* row0_out, void* stream) {
  return banded_dp_launch_branch(
      0, q, t, qlen, tlen, B, M, N, W, d_lo, match, mismatch, go, ge, dual,
      go2, ge2, with_tb, row0, free_t_end, free_t_start, score, end_j, tb,
      row0_out, stream);
}
