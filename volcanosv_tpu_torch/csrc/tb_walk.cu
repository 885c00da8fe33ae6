// Batched traceback walk for Hopper (sm_90a).
//
// Replaces: volcanosv_tpu/ops/banded_align.py::_walk_device, the jitted XLA
// lax.scan that turns every DP traceback into CIGAR op codes on the device
// (not a Pallas kernel, but on the path of every CIGAR; as plain torch it
// is a loop of up to 3M+W steps of dozens of small ops).
//
// Same 5-state machine (0 = H, 1 = E/up/I, 2 = F/left/D, 3 = E2, 4 = F2)
// over the (B, M, W) traceback that csrc/banded_dp.cu writes.  Emits
// n_steps op codes per alignment in reverse walk order (0 = M, 1 = I,
// 2 = D, 3 = none), packed 2 bits each, four to a byte:
// packed[(s / 4) * B + b] holds steps s..s+3 of alignment b, low bits
// first; plus the final `done` flag per alignment (false when n_steps cut
// the walk short).
//
// What bounds it on the card: a walk is a chain of dependent steps; the
// address of each traceback byte depends on the byte read before it.  The
// walk touches about qlen + tlen of the M*W cells, so neither bytes nor
// operations bound it: the latency of one step does, times the steps of
// the longest walk.
//
// Two designs:
//
// * tb_walk_warp_kernel (the default): a warp per alignment.  The rows of
//   one alignment are contiguous W-byte lines; the warp stages a tile of
//   TILE_ROWS rows below the walk's row, a window of WIN bytes of each
//   (the whole row where W <= 64), into shared memory with 16-byte
//   cp.async loads, neighbouring lanes on neighbouring addresses, and
//   double-buffers: the tile below is in flight while the current one is
//   walked.  A step is then a shared-memory load plus the state machine
//   instead of a device-memory round trip.  Inside a tile the walk runs
//   as many steps as cannot leave it (each step moves the row, the column
//   and the lane by at most one) with no test at all: it follows an
//   offset into the tile instead of (i, j), decides the move from the
//   byte and a word of the current state (three integer operations after
//   the load), and takes the next state and the op from a transition
//   table in shared memory, off the chain of loads.  All lanes walk in
//   lockstep on the same (broadcast) byte, so the state needs no
//   exchange; 32 ops collect in a register pair and lanes 0-7 store
//   their eight packed bytes.  When the walk leaves the window (a long I or
//   D run) or the prefetched tile (it left the band), the warp reloads a
//   tile at its position, the window placed ahead of the run's direction.
//   Once a walk is done the warp fills the rest of its stream with 0xFF
//   (four "none" ops) and leaves.  One warp a block below B = 512, so a
//   small batch spreads over as many SMs as it has alignments; four above.
// * tb_walk_kernel: a thread per alignment, every step a 1-byte load from
//   device memory, all n_steps steps run.  Kept so that the two designs
//   can be timed against each other; no caller takes it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB_DIAG = 0, TB_UP = 1, TB_LEFT = 2, TB_UP2 = 3, TB_LEFT2 = 4;
constexpr int TB_CHOICE = 7;
constexpr int TB_E_OPEN = 8, TB_F_OPEN = 16, TB_E2_OPEN = 32, TB_F2_OPEN = 64;

__global__ void tb_walk_kernel(const uint8_t* __restrict__ tb,
                               const int* __restrict__ qlen,
                               const int* __restrict__ tlen,
                               int B, int M, int W, int d_lo, int n_steps,
                               uint8_t* __restrict__ packed,
                               uint8_t* __restrict__ done_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* tbb = tb + (size_t)b * M * W;
  int i = qlen[b] - 1;
  int j = tlen[b] - 1;
  int state = 0;
  bool done = (i < 0) && (j < 0);
  uint8_t acc = 0;
  for (int s = 0; s < n_steps; ++s) {
    const int l = j - i - d_lo;
    const bool in_band = (l >= 0) && (l < W) && (i >= 0) && (j >= 0);
    const int ic = min(max(i, 0), M - 1);
    const int lc = min(max(l, 0), W - 1);
    const int cell = in_band ? (int)tbb[(size_t)ic * W + lc] : TB_DIAG;
    const bool i_neg = i < 0, j_neg = j < 0;
    const int choice = cell & TB_CHOICE;
    const bool s0 = state == 0;
    const bool s0_diag = s0 && choice == TB_DIAG;
    const bool s_up = state == 1 || state == 3;
    const bool s_left = state == 2 || state == 4;
    int op, di, dj;
    if (done) {
      op = 3; di = 0; dj = 0;
    } else if (i_neg) {
      op = 2; di = 0; dj = 1;
    } else if (j_neg) {
      op = 1; di = 1; dj = 0;
    } else {
      op = s0_diag ? 0 : (s_up ? 1 : (s_left ? 2 : 3));
      di = (s0_diag || s_up) ? 1 : 0;
      dj = (s0_diag || s_left) ? 1 : 0;
    }
    if (!(done || i_neg || j_neg)) {
      const bool gap_closed =
          (state == 1 && (cell & TB_E_OPEN)) || (state == 2 && (cell & TB_F_OPEN)) ||
          (state == 3 && (cell & TB_E2_OPEN)) || (state == 4 && (cell & TB_F2_OPEN));
      if (s0 && choice == TB_UP) state = 1;
      else if (s0 && choice == TB_UP2) state = 3;
      else if (s0 && choice == TB_LEFT) state = 2;
      else if (s0 && choice == TB_LEFT2) state = 4;
      else if (gap_closed) state = 0;
    }
    i -= di;
    j -= dj;
    done = done || ((i < 0) && (j < 0));
    acc |= (uint8_t)(op << (2 * (s & 3)));
    if ((s & 3) == 3) {
      packed[(size_t)(s >> 2) * B + b] = acc;
      acc = 0;
    }
  }
  done_out[b] = done ? 1 : 0;
}

// ---------------------------------------------------------------------------
// a warp per alignment, the traceback staged in shared memory
// ---------------------------------------------------------------------------

constexpr int BRANCH_WARP = 1, BRANCH_THREAD = 2;
constexpr int TILE_ROWS = 32;   // rows of one staged tile
constexpr int WIN_MAX = 64;     // window bytes of a row where W > 64

int warps_per_block(int B) { return B >= 512 ? 4 : 1; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows lo..lo+TILE_ROWS-1 (those >= 0) of one alignment's traceback, bytes
// c0..c0+WIN-1 of each, into dst: the warp's lanes copy neighbouring
// 16-byte pieces.  The caller commits the group.
template <int WIN>
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* tbb,
                                          int lo, int c0, int W, int lane) {
  constexpr int PIECES = WIN / 16;
#pragma unroll
  for (int k = lane; k < TILE_ROWS * PIECES; k += 32) {
    const int rr = k / PIECES, pc = k % PIECES;
    const int r = lo + rr;
    if (r >= 0) {
      cp_async16(dst + rr * WIN + pc * 16,
                 tbb + (size_t)r * W + c0 + pc * 16);
    }
  }
}

// The window's first byte for a walk at lane l: l in the middle of the
// window, or, when the walk left the window sideways (a D run moves left,
// an I run right), l at the end the run comes from.
template <int WIN>
__device__ __forceinline__ int window_start(int l, int dir, int W) {
  if (WIN >= W) return 0;
  int c0 = dir < 0 ? (l & ~15) - (WIN - 16)
                   : (dir > 0 ? (l & ~15) : ((l + 8 - WIN / 2) & ~15));
  return min(max(c0, 0), W - WIN);
}

// The word of a walk state, what a step inside the tile needs of it:
//   bits 0-2    the choice bits that hold the walk in place (7 in state 0,
//               where only a diagonal choice moves; 0 in a gap state,
//               which always moves)
//   bits 10-12  the state, i.e. its row of the transition table in bytes
//               (256 entries of 4 bytes)
//   bits 16-23  how far a move takes the walk's offset in the tile back
//               (a row is WIN bytes: M = WIN, I = WIN - 1, D = 1)
// An entry of the transition table is the word of the next state, with
// the op of the step in bits 30-31.
constexpr int N_STATES = 5;

template <int WIN>
__device__ __forceinline__ unsigned state_word(int st) {
  const unsigned hold = st == 0 ? 7u : 0u;
  const unsigned move = st == 0 ? WIN : ((st & 1) ? WIN - 1 : 1);
  return hold | ((unsigned)st << 10) | (move << 16);
}

__device__ __forceinline__ int state_of(unsigned word) {
  return (int)((word >> 10) & 7u);
}

// One step of the state machine from `state` on traceback byte `cell`,
// the walk inside the band with i >= 0 and j >= 0.
template <int WIN>
__device__ unsigned transition(int state, int cell) {
  const int choice = cell & TB_CHOICE;
  const bool s0 = state == 0;
  const bool s0_diag = s0 && choice == TB_DIAG;
  const bool s_up = state == 1 || state == 3;
  const bool s_left = state == 2 || state == 4;
  const int op = s0_diag ? 0 : (s_up ? 1 : (s_left ? 2 : 3));
  const bool gap_closed =
      (state == 1 && (cell & TB_E_OPEN)) || (state == 2 && (cell & TB_F_OPEN)) ||
      (state == 3 && (cell & TB_E2_OPEN)) || (state == 4 && (cell & TB_F2_OPEN));
  int next = state;
  if (s0 && choice == TB_UP) next = 1;
  else if (s0 && choice == TB_UP2) next = 3;
  else if (s0 && choice == TB_LEFT) next = 2;
  else if (s0 && choice == TB_LEFT2) next = 4;
  else if (gap_closed) next = 0;
  return state_word<WIN>(next) | ((unsigned)op << 30);
}

// Lanes 0..n-1 store bytes 0..n-1 of `ops` (32 ops, the oldest in the low
// bits) as packed bytes byte0.. of alignment b.
__device__ __forceinline__ void store_ops(uint8_t* packed, size_t byte0,
                                          int n, unsigned long long ops,
                                          int B, int b, int lane) {
  if (lane < n) {
    packed[(byte0 + lane) * B + b] = (uint8_t)(ops >> (8 * lane));
  }
}

template <int WIN>
__global__ void __launch_bounds__(128) tb_walk_warp_kernel(
    const uint8_t* __restrict__ tb, const int* __restrict__ qlen,
    const int* __restrict__ tlen, int B, int M, int W, int d_lo,
    int n_steps, uint8_t* __restrict__ packed,
    uint8_t* __restrict__ done_out) {
  constexpr int TILE = TILE_ROWS * WIN;
  __shared__ unsigned table[N_STATES * 256];
  extern __shared__ __align__(16) uint8_t smem[];
  for (int e = threadIdx.x; e < N_STATES * 256; e += blockDim.x) {
    table[e] = transition<WIN>(e >> 8, e & 255);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  uint8_t* const buf = smem + warp * 2 * TILE;
  const uint8_t* const tbb = tb + (size_t)b * M * W;
  const size_t n_bytes = (size_t)(n_steps >> 2);

  int i = qlen[b] - 1;
  int j = tlen[b] - 1;
  int state = 0;
  bool done = (i < 0) && (j < 0);
  // the current tile: rows lo..lo+TILE_ROWS-1 (those >= 0: from tlo),
  // bytes c0..c0+WIN-1, in buffer cur (lo = M: no tile yet); the
  // prefetched one in buffer cur^1
  int cur = 0, lo = M, tlo = M, c0 = 0;
  int next_lo = 0, next_c0 = 0;
  bool pending = false;
  // the ops of the current 32-step block, two bits each, shifted in from
  // the top: after 32 steps the oldest is in bits 0-1
  unsigned long long acc = 0;
  int s = 0;
  while (!done && s < n_steps) {
    const int l = j - i - d_lo;
    if (i >= 0 && j >= 0 && (unsigned)l < (unsigned)W && i < M) {
      if ((unsigned)(i - tlo) >= (unsigned)(lo + TILE_ROWS - tlo) ||
          (unsigned)(l - c0) >= (unsigned)WIN) {
        // left the tile: take the prefetched one if it holds the cell,
        // else load a tile at the walk's position; then prefetch below
        const bool in_rows = i >= tlo && i < lo + TILE_ROWS;
        const int dir = in_rows ? (l < c0 ? -1 : 1) : 0;
        bool have = false;
        if (pending) {
          cp_async_wait_all();
          __syncwarp();
          pending = false;
          if (i >= max(next_lo, 0) && i < next_lo + TILE_ROWS &&
              (unsigned)(l - next_c0) < (unsigned)WIN) {
            cur ^= 1;
            lo = next_lo;
            c0 = next_c0;
            have = true;
          }
        }
        if (!have) {
          lo = i - TILE_ROWS + 1;
          c0 = window_start<WIN>(l, dir, W);
          __syncwarp();
          load_tile<WIN>(buf + cur * TILE, tbb, lo, c0, W, lane);
          cp_async_commit();
          cp_async_wait_all();
          __syncwarp();
        }
        tlo = max(lo, 0);
        if (lo > 0) {
          next_lo = lo - TILE_ROWS;
          next_c0 = window_start<WIN>(l, 0, W);
          __syncwarp();
          load_tile<WIN>(buf + (cur ^ 1) * TILE, tbb, next_lo, next_c0, W,
                         lane);
          cp_async_commit();
          pending = true;
        }
      }
      // steps that end inside the tile (each moves i, j and the lane by
      // at most one), up to the end of the 32-step block
      int k = min(min(i - tlo, j), min(l - c0, c0 + WIN - 1 - l));
      k = min(k, min(32 - (s & 31), n_steps - s));
      const int base = cur * TILE;
      int p = base + (i - lo) * WIN + (l - c0);
      if (k > 0) {
        unsigned r = state_word<WIN>(state);
        for (int n = 0; n < k; ++n) {
          const unsigned c = buf[p];
          const int back = (c & r & 7u) ? 0 : (int)((r >> 16) & 0xFFu);
          r = *reinterpret_cast<const unsigned*>(
              reinterpret_cast<const uint8_t*>(table) +
              ((r & 0x1C00u) | (c << 2)));
          p -= back;
          acc = (acc >> 2) | ((unsigned long long)(r & 0xC0000000u) << 32);
        }
        i = lo + (p - base) / WIN;
        j = i + d_lo + c0 + (p - base) % WIN;
        s += k;
        state = state_of(r);
      } else {
        // at the tile's edge: one step that moves i and j itself
        const unsigned r = table[state * 256 + buf[p]];
        const int op = (int)(r >> 30);
        acc = (acc >> 2) | ((unsigned long long)op << 62);
        i -= (op == 0 || op == 1) ? 1 : 0;
        j -= (op == 0 || op == 2) ? 1 : 0;
        ++s;
        state = state_of(r);
      }
    } else {
      // off the staged traceback: past a sequence's start, outside the
      // band, or (qlen > M) below the last row, which the walk reads in
      // place of the rows beyond it
      int op;
      if (i < 0) {
        op = 2;
        --j;
      } else if (j < 0) {
        op = 1;
        --i;
      } else {
        const bool in_band = (unsigned)l < (unsigned)W;
        const int cell = in_band ? (int)tbb[(size_t)(M - 1) * W + l] : TB_DIAG;
        const unsigned r = table[state * 256 + cell];
        op = (int)(r >> 30);
        state = state_of(r);
        i -= (op == 0 || op == 1) ? 1 : 0;
        j -= (op == 0 || op == 2) ? 1 : 0;
      }
      acc = (acc >> 2) | ((unsigned long long)op << 62);
      ++s;
    }
    if ((s & 31) == 0) {
      store_ops(packed, (size_t)(s >> 2) - 8, 8, acc, B, b, lane);
    }
    done = (i < 0) && (j < 0);
  }
  // the ops of the last, partial block; once done, every later step is
  // "none": the rest of the block, then whole bytes of 0xFF
  const int t = s & 31;
  const size_t byte0 = (size_t)(s >> 5) * 8;
  unsigned long long ops = t ? acc >> (64 - 2 * t) : 0ull;
  if (done) {
    ops |= t ? ~0ull << (2 * t) : ~0ull;
    if (byte0 < n_bytes) {
      store_ops(packed, byte0, (int)min((size_t)8, n_bytes - byte0), ops,
                B, b, lane);
    }
    for (size_t q = byte0 + 8 + lane; q < n_bytes; q += 32) {
      packed[q * B + b] = 0xFF;
    }
  } else if (t) {
    store_ops(packed, byte0, t / 4, ops, B, b, lane);
  }
  if (lane == 0) done_out[b] = done ? 1 : 0;
  if (pending) cp_async_wait_all();
}

template <int WIN>
int launch_warp_win(const uint8_t* tb, const int* qlen, const int* tlen,
                    int B, int M, int W, int d_lo, int n_steps,
                    uint8_t* packed, uint8_t* done, cudaStream_t s) {
  const int wpb = warps_per_block(B);
  const int grid = (B + wpb - 1) / wpb;
  const size_t smem = (size_t)wpb * 2 * TILE_ROWS * WIN;
  tb_walk_warp_kernel<WIN><<<grid, 32 * wpb, smem, s>>>(
      tb, qlen, tlen, B, M, W, d_lo, n_steps, packed, done);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the load-to-use latency of shared memory: one warp chasing pointers
// ---------------------------------------------------------------------------

constexpr int CHASE_SLOTS = 1024;

__global__ void smem_chase_kernel(int n, long long* out) {
  __shared__ unsigned ring[CHASE_SLOTS];
  const unsigned base = (unsigned)__cvta_generic_to_shared(ring);
  for (int k = threadIdx.x; k < CHASE_SLOTS; k += 32) {
    // each slot holds the shared address of the slot 33 further on
    ring[k] = base + 4u * (unsigned)((k + 33) % CHASE_SLOTS);
  }
  __syncwarp();
  unsigned p = base;
  for (int k = 0; k < 64; ++k) {
    asm volatile("ld.shared.u32 %0, [%0];" : "+r"(p));
  }
  long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  for (int k = 0; k < n; k += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      asm volatile("ld.shared.u32 %0, [%0];" : "+r"(p));
    }
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = g1 - g0;
    out[2] = p;
  }
}

}  // namespace

extern "C" const char* tb_walk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The walk of B alignments on `stream`: branch 1 = a warp per alignment
// (the caller ensures W % 32 == 0 and a 16-byte aligned tb: the design
// stages 16-byte pieces of the traceback in windows of 32 (W = 32) or 64
// bytes), 2 = a thread per alignment.  Returns the cudaError_t of the
// launch.
extern "C" int tb_walk_launch_branch(int branch, const void* tb,
                                     const void* qlen, const void* tlen,
                                     int B, int M, int W, int d_lo,
                                     int n_steps, void* packed, void* done,
                                     void* stream) {
  if (B <= 0 || M <= 0 || W <= 0 || n_steps <= 0 || (n_steps & 3) != 0)
    return (int)cudaErrorInvalidValue;
  if (branch != BRANCH_WARP && branch != BRANCH_THREAD)
    return (int)cudaErrorInvalidValue;
  const uint8_t* t = static_cast<const uint8_t*>(tb);
  const int* ql = static_cast<const int*>(qlen);
  const int* tl = static_cast<const int*>(tlen);
  uint8_t* pk = static_cast<uint8_t*>(packed);
  uint8_t* dn = static_cast<uint8_t*>(done);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (branch == BRANCH_WARP) {
    return W == 32
        ? launch_warp_win<32>(t, ql, tl, B, M, W, d_lo, n_steps, pk, dn, s)
        : launch_warp_win<WIN_MAX>(t, ql, tl, B, M, W, d_lo, n_steps, pk, dn,
                                   s);
  }
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  tb_walk_kernel<<<blocks, threads, 0, s>>>(t, ql, tl, B, M, W, d_lo, n_steps,
                                            pk, dn);
  return (int)cudaGetLastError();
}

// One warp chases n (a multiple of 8) dependent shared-memory loads:
// out[0] = the SM clock cycles they took, out[1] = the nanoseconds
// (globaltimer), out[2] = the last address (keeps the chain live).  out
// is three int64 in device memory; the call synchronises the stream.
extern "C" int smem_chase(int n, void* out, void* stream) {
  if (n <= 0 || n % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  smem_chase_kernel<<<1, 32, 0, s>>>(n, static_cast<long long*>(out));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamSynchronize(s);
}
