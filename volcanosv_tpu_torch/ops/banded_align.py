"""Banded affine-gap alignment: the DP core of the whole engine.

The band is fixed in diagonal space: lane l ∈ [0, W) of query row i is
target column j = i + d_lo + l.  Vertical gaps read the previous row at lane
l+1, horizontal gaps within a row are an exact max-plus prefix over lanes
(F[l] = go + ge·l + max_{s<l}(Htmp[s] − ge·s)).  Semantics are those of the
reference's scan oracle, `volcanosv_tpu/ops/banded_align.py`.

Two kernels, each with a plain PyTorch version of the same function:

* `banded_dp`  — the DP (score, end column, optional 1-byte/cell traceback
  in (B, M, W) layout, optional diagonal-0 row scores in (M, B) layout).
  CUDA: `csrc/banded_dp.cu`; plain: `banded_dp_plain`.
* `tb_walk`    — the batched traceback walk → 2-bit packed op stream.
  CUDA: `csrc/tb_walk.cu`; plain: `tb_walk_plain`.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  Each wrapper counts its kernel
launches in `<wrapper>.launches`; `banded_dp.shapes` lists the (mode,
design, B, M, W) of each DP launch, `tb_walk.shapes` the (design, B, M, W)
of each walk.

The dispatchers below (`banded_align_cigars_dispatch`, `banded_row0_auto`,
`edit_distance_batch_auto`) take numpy batches marshalled exactly as the
reference marshals them and a torch device to run on.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

# int32 sentinel shared by the plain version and the CUDA kernel (the
# reference scan's NEG; see csrc/banded_dp.cu for why not the Pallas one)
NEG = -(10**9) // 2

# traceback encoding: bits 0-2 = H source, bits 3-6 = gap-open flags
TB_DIAG, TB_UP, TB_LEFT = 0, 1, 2
TB_UP2, TB_LEFT2 = 3, 4                      # long-gap (dual-affine) states
TB_CHOICE = 7
TB_E_OPEN = 8                                # E opened (vs extended)
TB_F_OPEN = 16                               # F opened (vs extended)
TB_E2_OPEN = 32
TB_F2_OPEN = 64


@dataclass(frozen=True)
class Scores:
    """Affine (optionally dual-affine) gap scores.

    gap_open is charged on open *in addition to* extend.  gap_open2/
    gap_extend2 enable the second (long-gap) affine class: gap cost =
    max(open+k·ext, open2+k·ext2) in score space — minimap2's -O o1,o2
    -E e1,e2 double affine."""
    match: int = 2
    mismatch: int = -4
    gap_open: int = -4
    gap_extend: int = -2
    gap_open2: int | None = None
    gap_extend2: int | None = None

    @property
    def dual(self) -> bool:
        return self.gap_open2 is not None

    @staticmethod
    def edit() -> "Scores":
        """Unit-cost scores: -score == edit distance (match=0)."""
        return Scores(match=0, mismatch=-1, gap_open=0, gap_extend=-1)


# ---------------------------------------------------------------------------
# the DP: plain version, kernel wrapper
# ---------------------------------------------------------------------------

def banded_dp_plain(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                    tlen: torch.Tensor, W: int, d_lo: int, scores: Scores,
                    with_traceback: bool = True, free_t_end: bool = False,
                    free_t_start: bool = False, row0_scores: bool = False):
    """Row loop over (B, W) int32 tensors mirroring the reference's
    `banded_align_scan` step for step.  q (B, M) and t (B, N) int8 codes
    (4 = pad/N), qlen/tlen (B,) int32.

    Returns (score (B,), end_j (B,), tb (B, M, W) uint8 | None,
    row0 (M, B) int32 | None).  With free_t_end the best cell of the last
    row wins, smallest column among ties; with free_t_start the alignment
    may start at any target column.  Rows ≥ qlen of row0 hold values no
    caller reads."""
    dev = q.device
    B, M = q.shape
    i32 = torch.int32
    lanes = torch.arange(W, dtype=i32, device=dev)
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    tl = tlen[:, None]
    go, ge = scores.gap_open, scores.gap_extend
    dual = scores.dual
    go2, ge2 = (scores.gap_open2, scores.gap_extend2) if dual else (0, 0)

    def gap_score(k):
        s = go + ge * k
        if not dual:
            return s
        return torch.maximum(s, go2 + ge2 * k) if torch.is_tensor(k) \
            else max(s, go2 + ge2 * k)

    j_init = (-1 + d_lo) + lanes
    neg = torch.tensor(NEG, dtype=i32, device=dev)
    if free_t_start:
        H = torch.where((j_init >= -1) & (j_init < tl), 0, neg)
    else:
        H = torch.where(j_init == -1, 0,
                        torch.where((j_init >= 0) & (j_init < tl),
                                    gap_score(j_init + 1), neg))
    H = H.to(i32).expand(B, W).contiguous()
    E = torch.full((B, W), NEG, dtype=i32, device=dev)
    E2 = torch.full((B, W), NEG, dtype=i32, device=dev) if dual else None
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=dev)

    # target window of row i = columns i+d_lo .. i+d_lo+W-1, read through a
    # left/right pad so slicing never clips; target cells outside [0, tlen)
    # or with a pad code, and query pad codes, take two values that no code
    # takes, so that a match is one compare
    pad_l = max(0, -d_lo)
    pad_r = max(0, M + d_lo + W - t.shape[1])
    t_pad = torch.nn.functional.pad(t.to(i32), (pad_l, pad_r), value=4)
    col = torch.arange(t_pad.shape[1], dtype=i32, device=dev) - pad_l
    col_ok = (col >= 0) & (col < tl)                             # (B, N')
    t_pad = torch.where(col_ok & (t_pad < 4), t_pad, 1000)
    q32 = torch.where(q < 4, q.to(i32), 2000)
    match = torch.tensor(scores.match, dtype=i32, device=dev)
    mismatch = torch.tensor(scores.mismatch, dtype=i32, device=dev)
    ge_l = ge * lanes
    ge2_l = ge2 * lanes
    u8 = torch.uint8
    tb = torch.empty((B, M, W), dtype=u8, device=dev) if with_traceback \
        else None
    row0 = torch.empty((M, B), dtype=i32, device=dev) if row0_scores \
        else None
    best = torch.full((B,), NEG, dtype=i32, device=dev)
    best_j = torch.zeros((B,), dtype=i32, device=dev)
    l_star = (tlen - qlen - d_lo).clamp(0, W - 1).long()[:, None]

    for i in range(M):
        win = slice(i + d_lo + pad_l, i + d_lo + pad_l + W)
        jv = col_ok[:, win]                                      # (B, W)
        is_match = q32[:, i:i + 1] == t_pad[:, win]
        sub = torch.where(is_match, match, mismatch)

        H_up = torch.cat([H[:, 1:], neg_col], 1)
        E_open = H_up + (go + ge)
        E_ext = torch.cat([E[:, 1:], neg_col], 1) + ge
        En = torch.maximum(E_open, E_ext)
        Hdiag = H + sub
        Htmp = torch.maximum(Hdiag, En)
        if with_traceback:
            bits = (E_open >= E_ext).to(u8) * TB_E_OPEN
            choice = (En > Hdiag).to(u8) * TB_UP
        if dual:
            E2_open = H_up + (go2 + ge2)
            E2_ext = torch.cat([E2[:, 1:], neg_col], 1) + ge2
            E2n = torch.maximum(E2_open, E2_ext)
            if with_traceback:
                bits |= (E2_open >= E2_ext).to(u8) * TB_E2_OPEN
                choice = torch.where(E2n > Htmp, TB_UP2, choice).to(u8)
            Htmp = torch.maximum(Htmp, E2n)

        lb = -1 - i - d_lo                       # column -1 boundary lane
        inject = 0 <= lb < W
        if inject:
            Htmp[:, lb] = gap_score(i + 1)

        pm = torch.cummax(Htmp - ge_l, 1).values
        F = torch.cat([neg_col, pm[:, :-1]], 1).clamp_min(NEG) + ge_l + go
        if with_traceback:
            H_left = torch.cat([neg_col, Htmp[:, :-1]], 1)
            bits |= ((H_left + (go + ge)) >= F).to(u8) * TB_F_OPEN
            choice = torch.where(F > Htmp, TB_LEFT, choice).to(u8)
        Hn = torch.maximum(Htmp, F)
        if dual:
            pm2 = torch.cummax(Htmp - ge2_l, 1).values
            F2 = torch.cat([neg_col, pm2[:, :-1]], 1).clamp_min(NEG) \
                + ge2_l + go2
            if with_traceback:
                bits |= ((H_left + (go2 + ge2)) >= F2).to(u8) * TB_F2_OPEN
                choice = torch.where(F2 > Hn, TB_LEFT2, choice).to(u8)
            Hn = torch.maximum(Hn, F2)

        cv = jv & (i < qlen)[:, None]
        keep = cv.clone()
        if inject:
            keep[:, lb] = True
        Hn = torch.where(keep, Hn, neg)
        En = torch.where(cv, En, neg)
        if dual:
            E2 = torch.where(cv, E2n, neg)

        last = i == qlen - 1
        if free_t_end:
            vals = torch.where(jv, Hn, neg)
            lane = vals.argmax(1)                 # first maximum: smallest j
            val = vals.gather(1, lane[:, None])[:, 0]
            best = torch.where(last, val, best)
            best_j = torch.where(last, (i + d_lo + lane).to(i32), best_j)
        else:
            val = Hn.gather(1, l_star)[:, 0]
            best = torch.where(last, val, best)
            best_j = torch.where(last, tlen - 1, best_j)
        if with_traceback:
            tb[:, i] = choice | bits
        if row0_scores:
            row0[i] = Hn[:, -d_lo]
        H, E = Hn, En
    return best, best_j, tb, row0


def _check_dp_inputs(q, t, qlen, tlen, W, branch):
    for name, x, dt in (("q", q, torch.int8), ("t", t, torch.int8),
                        ("qlen", qlen, torch.int32),
                        ("tlen", tlen, torch.int32)):
        if x.dtype != dt or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"banded_dp: {name} must be a contiguous {dt} "
                             f"tensor on {q.device}")
    if W < 32 or W > 4096 or W & (W - 1):
        raise ValueError(f"banded_dp: W={W} must be a power of two in "
                         "[32, 4096] on CUDA")
    if branch not in DP_BRANCHES or (branch == "warp" and W > 512) \
            or (branch == "group" and W <= 512):
        raise ValueError(f"banded_dp: branch {branch!r} at W={W}")


# the kernel's designs (csrc/banded_dp.cu): "warp", a warp per alignment
# (W <= 512); "group", W/512 warps per alignment (W > 512); "block", a
# thread block per alignment, kept for timing.  "auto" takes "warp" or
# "group" by W.
DP_BRANCHES = {"auto": 0, "warp": 1, "block": 2, "group": 3}


def banded_dp_branch(W: int) -> str:
    """The design the CUDA kernel takes at band W."""
    from . import cuda_build
    code = cuda_build.lib("banded_dp").banded_dp_branch(W)
    return {v: k for k, v in DP_BRANCHES.items()}[code]


def dp_mode(scores: Scores, with_traceback: bool = True,
            free_t_end: bool = False, free_t_start: bool = False,
            row0_scores: bool = False) -> str:
    """Short name of a DP launch's mode, e.g. "affine+traceback"."""
    kind = "edit" if scores == Scores.edit() else \
        ("dual-affine" if scores.dual else "affine")
    flags = [f for f, on in (("traceback", with_traceback),
                             ("row0", row0_scores),
                             ("free_t_end", free_t_end),
                             ("free_t_start", free_t_start)) if on]
    return "+".join([kind] + (flags or ["score"]))


def banded_dp(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
              tlen: torch.Tensor, W: int, d_lo: int, scores: Scores,
              with_traceback: bool = True, free_t_end: bool = False,
              free_t_start: bool = False, row0_scores: bool = False,
              *, branch: str = "auto"):
    """The DP on q's device: the CUDA kernel for CUDA tensors (launched on
    the current stream, no synchronisation), `banded_dp_plain` for CPU
    tensors.  Same arguments and returns as `banded_dp_plain`; on CUDA the
    row0 rows ≥ qlen hold NEG.  `branch` forces one of the kernel's designs
    (DP_BRANCHES; "auto" lets the launcher pick, as every caller of the
    port does).  Each launch appends (mode, design, B, M, W) to
    `banded_dp.shapes`."""
    if q.device.type == "cpu":
        return banded_dp_plain(q, t, qlen, tlen, W, d_lo, scores,
                               with_traceback, free_t_end, free_t_start,
                               row0_scores)
    if q.device.type != "cuda":
        raise ValueError(f"banded_dp: unsupported device {q.device}")
    from . import cuda_build
    _check_dp_inputs(q, t, qlen, tlen, W, branch)
    B, M = q.shape
    dev = q.device
    score = torch.empty(B, dtype=torch.int32, device=dev)
    end_j = torch.empty(B, dtype=torch.int32, device=dev)
    tb = torch.empty((B, M, W), dtype=torch.uint8, device=dev) \
        if with_traceback else None
    row0 = torch.empty((M, B), dtype=torch.int32, device=dev) \
        if row0_scores else None
    dual = scores.dual
    with torch.cuda.device(dev):        # the launch goes to q's card
        rc = cuda_build.lib("banded_dp").banded_dp_launch_branch(
            DP_BRANCHES[branch], q.data_ptr(), t.data_ptr(),
            qlen.data_ptr(), tlen.data_ptr(), B, M, t.shape[1], W, d_lo,
            scores.match, scores.mismatch, scores.gap_open,
            scores.gap_extend, int(dual),
            scores.gap_open2 if dual else 0,
            scores.gap_extend2 if dual else 0, int(with_traceback),
            int(row0_scores), int(free_t_end), int(free_t_start),
            score.data_ptr(), end_j.data_ptr(),
            tb.data_ptr() if tb is not None else None,
            row0.data_ptr() if row0 is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "banded_dp launch")
    banded_dp.launches += 1
    taken = banded_dp_branch(W) if branch == "auto" else branch
    banded_dp.shapes.append((dp_mode(scores, with_traceback, free_t_end,
                                     free_t_start, row0_scores), taken, B, M,
                             W))
    return score, end_j, tb, row0


banded_dp.launches = 0
banded_dp.shapes = []


# ---------------------------------------------------------------------------
# the traceback walk: plain version, kernel wrapper
# ---------------------------------------------------------------------------

def tb_walk_plain(tb: torch.Tensor, qlen: torch.Tensor, tlen: torch.Tensor,
                  d_lo: int, n_steps: int):
    """Step loop over (B,) tensors mirroring the reference's `_walk_device`
    (pack=True) on a (B, M, W) traceback.  Returns (packed (n_steps//4, B)
    uint8 — op codes 0=M 1=I 2=D 3=none in reverse walk order, four 2-bit
    ops per byte, low bits first — and done (B,) bool)."""
    if n_steps % 4:
        raise ValueError(f"n_steps={n_steps} must be a multiple of 4")
    B, M, W = tb.shape
    dev = tb.device
    i32 = torch.int32
    flat = tb.reshape(B, M * W)
    i = qlen.to(i32) - 1
    j = tlen.to(i32) - 1
    state = torch.zeros(B, dtype=i32, device=dev)
    done = (i < 0) & (j < 0)
    ops = torch.empty((n_steps, B), dtype=torch.uint8, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)
    for s in range(n_steps):
        l = j - i - d_lo
        in_band = (l >= 0) & (l < W) & (i >= 0) & (j >= 0)
        idx = i.clamp(0, M - 1) * W + l.clamp(0, W - 1)
        cell = flat.gather(1, idx[:, None].long())[:, 0].to(i32)
        cell = torch.where(in_band, cell, zero)
        i_neg, j_neg = i < 0, j < 0
        choice = cell & TB_CHOICE
        s0 = state == 0
        s0_diag = s0 & (choice == TB_DIAG)
        s_up = (state == 1) | (state == 3)
        s_left = (state == 2) | (state == 4)
        op = torch.where(done, 3, torch.where(i_neg, 2, torch.where(
            j_neg, 1, torch.where(s0_diag, 0, torch.where(
                s_up, 1, torch.where(s_left, 2, 3))))))
        free = ~(done | i_neg)
        di = (free & (j_neg | s0_diag | s_up)).to(i32)
        dj = (~done & (i_neg | (~j_neg & (s0_diag | s_left)))).to(i32)
        open_bit = torch.where(state == 1, TB_E_OPEN, torch.where(
            state == 2, TB_F_OPEN, torch.where(
                state == 3, TB_E2_OPEN, torch.where(state == 4, TB_F2_OPEN,
                                                    0))))
        gap_closed = (cell & open_bit) != 0
        enter = torch.where(choice == TB_UP, 1, torch.where(
            choice == TB_UP2, 3, torch.where(choice == TB_LEFT, 2, torch.where(
                choice == TB_LEFT2, 4, -1))))
        moving = free & ~j_neg
        nxt = torch.where(s0 & (enter >= 0), enter,
                          torch.where(gap_closed, 0, state))
        state = torch.where(moving, nxt, state).to(i32)
        i = i - di
        j = j - dj
        done = done | ((i < 0) & (j < 0))
        ops[s] = op.to(torch.uint8)
    o = ops.view(n_steps // 4, 4, B)
    packed = o[:, 0] | (o[:, 1] << 2) | (o[:, 2] << 4) | (o[:, 3] << 6)
    return packed, done


# the walk kernel's two designs (csrc/tb_walk.cu): "warp", a warp per
# alignment walking tiles of the traceback staged in shared memory, the
# design of every caller ("auto"); "thread", a thread per alignment reading
# the traceback in device memory, kept for timing
WALK_BRANCHES = {"auto": 1, "warp": 1, "thread": 2}


def tb_walk(tb: torch.Tensor, qlen: torch.Tensor, tlen: torch.Tensor,
            d_lo: int, n_steps: int, *, branch: str = "auto"):
    """The walk on tb's device: the CUDA kernel for CUDA tensors, launched
    on the current stream right behind the DP; `tb_walk_plain` for CPU
    tensors.  Same arguments and returns as `tb_walk_plain`.  `branch`
    forces one of the kernel's designs (WALK_BRANCHES; "auto" is the warp
    design).  On CUDA, W must be a multiple of 32 and tb 16-byte aligned,
    as every traceback banded_dp writes is.  Each launch appends (design,
    B, M, W) to `tb_walk.shapes`."""
    if branch not in WALK_BRANCHES:
        raise ValueError(f"tb_walk: unknown branch {branch!r}")
    if tb.device.type == "cpu":
        return tb_walk_plain(tb, qlen, tlen, d_lo, n_steps)
    if tb.device.type != "cuda":
        raise ValueError(f"tb_walk: unsupported device {tb.device}")
    from . import cuda_build
    if n_steps % 4 or n_steps <= 0:
        raise ValueError(f"n_steps={n_steps} must be a positive multiple "
                         "of 4")
    for name, x, dt in (("tb", tb, torch.uint8), ("qlen", qlen, torch.int32),
                        ("tlen", tlen, torch.int32)):
        if x.dtype != dt or not x.is_contiguous() or x.device != tb.device:
            raise ValueError(f"tb_walk: {name} must be a contiguous {dt} "
                             f"tensor on {tb.device}")
    B, M, W = tb.shape
    if W % 32 or tb.data_ptr() % 16:
        raise ValueError(f"tb_walk: W={W} must be a multiple of 32 and the "
                         "traceback 16-byte aligned on CUDA")
    taken = "warp" if branch == "auto" else branch
    packed = torch.empty((n_steps // 4, B), dtype=torch.uint8,
                         device=tb.device)
    done = torch.empty(B, dtype=torch.bool, device=tb.device)
    with torch.cuda.device(tb.device):  # the launch goes to tb's card
        rc = cuda_build.lib("tb_walk").tb_walk_launch_branch(
            WALK_BRANCHES[taken], tb.data_ptr(), qlen.data_ptr(),
            tlen.data_ptr(), B, M, W, d_lo, n_steps, packed.data_ptr(),
            done.data_ptr(),
            torch.cuda.current_stream(tb.device).cuda_stream)
    cuda_build.check(rc, "tb_walk launch")
    tb_walk.launches += 1
    tb_walk.shapes.append((taken, B, M, W))
    return packed, done


tb_walk.launches = 0
tb_walk.shapes = []


def reset_launch_counts() -> None:
    banded_dp.launches = 0
    banded_dp.shapes = []
    tb_walk.launches = 0
    tb_walk.shapes = []


# ---------------------------------------------------------------------------
# host-side decode of the op stream
# ---------------------------------------------------------------------------

def _unpack_ops(packed: np.ndarray) -> np.ndarray:
    """(n_steps//4, B) packed bytes → (n_steps, B) op codes 0..3."""
    shifts = np.array([0, 2, 4, 6], np.uint8)
    return ((packed[:, None, :] >> shifts[None, :, None]) & 3).reshape(
        -1, packed.shape[1])


def walk_lengths(ops: np.ndarray) -> np.ndarray:
    """(n_steps, B) op codes → the steps each walk takes before it is done
    (through its last op that is not "none")."""
    moved = ops != 3
    return np.where(moved.any(0), ops.shape[0] - np.argmax(moved[::-1], 0), 0)


def _rle_columns(ops: np.ndarray, n_cols: int) -> list[list[tuple[int, int]]]:
    """Reverse-order (steps, B) op stream → forward CIGAR [(op, len)] for
    each of the first n_cols columns, in one numpy pass over the batch."""
    steps = ops.shape[0]
    fwd = ops[::-1, :n_cols].T                      # (n_cols, steps) forward
    flat = fwd.reshape(-1)
    keep = flat != 3
    f = flat[keep]
    if len(f) == 0:
        return [[] for _ in range(n_cols)]
    col = np.repeat(np.arange(n_cols, dtype=np.int64), steps)[keep]
    brk = np.nonzero((f[1:] != f[:-1]) | (col[1:] != col[:-1]))[0] + 1
    starts = np.concatenate([[0], brk])
    stops = np.concatenate([brk, [len(f)]])
    run_op = f[starts].tolist()
    run_len = (stops - starts).tolist()
    run_col = col[starts].tolist()
    out: list[list[tuple[int, int]]] = [[] for _ in range(n_cols)]
    for o, ln, c in zip(run_op, run_len, run_col):
        out[c].append((int(o), int(ln)))
    return out


# ---------------------------------------------------------------------------
# dispatchers (numpy batches in, host results out)
# ---------------------------------------------------------------------------

def _device_batch(q, t, qlen, tlen, device) -> list[torch.Tensor]:
    """Host batch → [q, t, qlen, tlen] tensors on `device`.  The lengths
    must fit the padded widths: the kernel reads t[b, :tlen[b]] unchecked.
    CUDA copies go through pinned memory without blocking the host, so a
    dispatch does not wait for the previous dispatch's kernels."""
    if np.any(np.asarray(qlen) > q.shape[1]) or \
            np.any(np.asarray(tlen) > t.shape[1]):
        raise ValueError("sequence lengths exceed the padded batch width")
    device = torch.device(device)
    out = []
    for x, dtype in ((q, np.int8), (t, np.int8), (qlen, np.int32),
                     (tlen, np.int32)):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype))
        out.append(x.pin_memory().to(device, non_blocking=True)
                   if device.type == "cuda" else x)
    return out


def walk_steps(M: int, W: int, qlen, tlen) -> tuple[int, int]:
    """(n_steps, full) for a walk over an M-row traceback.  The walk takes
    ≤ qlen+tlen+(#gap runs) steps (each gap run costs one no-move
    state-entry step); n_steps buckets the batch's need to a multiple of
    256, `full` covers the all-alternating-gap worst case 3M+W+1."""
    full = -(-(3 * M + W + 4) // 4) * 4
    need = int(np.max(np.asarray(qlen) + np.asarray(tlen))) + 8
    return min(full, -(-need // 256) * 256), full


def _complete_fn(qlen, tlen):
    """Test of a decoded (steps, B) op stream: it must consume exactly
    qlen query and tlen target bases per row — catches walks cut by the
    bucketed step bound."""
    ql_np, tl_np = np.asarray(qlen), np.asarray(tlen)

    def complete(ops):
        cq = np.count_nonzero((ops == 0) | (ops == 1), axis=0)
        ct = np.count_nonzero((ops == 0) | (ops == 2), axis=0)
        return bool(np.all(cq == ql_np) and np.all(ct == tl_np))
    return complete


def _cigars_dispatch(devices, q, t, qlen, tlen, W: int, d_lo: int,
                     scores: Scores):
    """The batch split over `devices` in order: each device takes its 1/N
    slice of the window batch, with one DP launch and one walk launch, at
    the step bound of the whole batch.  Returns the finish() closure of
    banded_align_cigars_dispatch, whose CIGARs come back joined in batch
    order.  A walk the bucketed bound cut short (a rare gap-dense batch) is
    walked again on each device's traceback at the full bound."""
    B, M = q.shape
    n_steps, full = walk_steps(M, W, qlen, tlen)
    cut = [B * i // len(devices) for i in range(len(devices) + 1)]
    parts, packed = [], []
    for i, dev in enumerate(devices):
        sl = slice(cut[i], cut[i + 1])
        qd, td, qld, tld = _device_batch(q[sl], t[sl], qlen[sl], tlen[sl],
                                         dev)
        _s, _e, tb, _r = banded_dp(qd, td, qld, tld, W, d_lo, scores)
        parts.append((tb, qld, tld))
        packed.append(tb_walk(tb, qld, tld, d_lo, n_steps)[0])
    complete = _complete_fn(qlen, tlen)

    def fetch(streams):
        return _unpack_ops(np.concatenate([p.cpu().numpy() for p in streams],
                                          axis=1))

    def finish():
        ops = fetch(packed)
        if not complete(ops) and n_steps < full:
            ops = fetch([tb_walk(tb, qld, tld, d_lo, full)[0]
                         for tb, qld, tld in parts])
        if not complete(ops):
            raise AssertionError(
                "traceback walk unfinished at the full step bound")
        return _rle_columns(ops, B)

    return finish


def _sharded_cigars_dispatch(mesh, q, t, qlen, tlen, W: int, d_lo: int,
                             scores: Scores):
    """The batch split over the mesh's devices (the pipeline's
    data-parallel axis), one DP and one walk launch a device."""
    return _cigars_dispatch(mesh.flat(), q, t, qlen, tlen, W, d_lo, scores)


def banded_align_cigars_dispatch(q, t, qlen, tlen, W: int = 256,
                                 d_lo: int = -64, scores: Scores = Scores(),
                                 device=DEFAULT_DEVICE):
    """Launch the DP and the traceback walk for a batch without waiting,
    and return a finish() closure that fetches the packed op stream (the
    one device→host copy) and decodes it to one CIGAR [(op, len)] per row
    (op 0=M, 1=I, 2=D).  Callers dispatch several batches, then finish
    them in order, so the device works while the host decodes.

    With an active pipeline mesh (parallel.mesh.set_active_mesh) of more
    than one device of `device`'s type whose count divides the batch, the
    batch is split over the mesh's devices instead of running on `device`
    alone; a call for another device type never reaches the mesh."""
    from ..parallel.mesh import active_mesh
    device = resolve_device(device)
    mesh = active_mesh()
    if (mesh is not None and mesh.size > 1
            and mesh.flat()[0].type == device.type
            and q.shape[0] % mesh.size == 0):
        return _sharded_cigars_dispatch(mesh, q, t, qlen, tlen, W, d_lo,
                                        scores)
    return _cigars_dispatch([device], q, t, qlen, tlen, W, d_lo, scores)


def banded_align_cigars(q, t, qlen, tlen, W: int = 256, d_lo: int = -64,
                        scores: Scores = Scores(),
                        device=DEFAULT_DEVICE) -> list:
    """Batched global banded alignment → exact CIGARs, one per row."""
    return banded_align_cigars_dispatch(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                        scores=scores, device=device)()


def banded_align_auto(q, t, qlen, tlen, W: int = 256, d_lo: int = -64,
                      scores: Scores = Scores(), device=DEFAULT_DEVICE):
    """The traceback DP of a batch on `device`.  Returns (score (B,),
    tb_get: b -> (M, W) uint8 traceback of row b, end_j (B,)), as numpy;
    rows beyond each alignment's qlen are unused."""
    device = resolve_device(device)
    s, e, tb, _r = banded_dp(*_device_batch(q, t, qlen, tlen, device), W,
                             d_lo, scores)
    tb_np = tb.cpu().numpy()
    return s.cpu().numpy(), (lambda b: tb_np[b]), e.cpu().numpy()


def banded_row0_auto(q, t, qlen, tlen, W: int = 128, d_lo: int = -64,
                     scores: Scores = Scores(),
                     device=DEFAULT_DEVICE) -> np.ndarray:
    """Diagonal-0 score profile (M, B) for the split-DP breakpoint search.
    Only rows < qlen of each column are meaningful."""
    device = resolve_device(device)
    _s, _e, _tb, row0 = banded_dp(
        *_device_batch(q, t, qlen, tlen, device), W, d_lo, scores,
        with_traceback=False, row0_scores=True)
    return row0.cpu().numpy()


def edit_distance_batch_auto(q, t, qlen, tlen, W: int = 128,
                             d_lo: int | None = None, device=DEFAULT_DEVICE):
    """Batched banded edit distance (replaces edlib): -score with unit
    costs, (B,) int32 (band-limited, so an upper bound of the distance)."""
    device = resolve_device(device)
    if d_lo is None:
        d_lo = -(W // 2)
    score, _e, _tb, _r = banded_dp(
        *_device_batch(q, t, qlen, tlen, device), W, d_lo, Scores.edit(),
        with_traceback=False)
    return -score.cpu().numpy()


def traceback_cigar(tb: np.ndarray, qlen: int, tlen: int, d_lo: int,
                    end_j: int | None = None,
                    free_t_start: bool = False) -> list[tuple[int, int]]:
    """Walk one (M, W) traceback on the host → CIGAR [(op, len)] with op in
    {0:M, 1:I, 2:D}.  With free_t_start the walk stops once the query is
    consumed (the leading target skip is not part of the alignment)."""
    ops: list[tuple[int, int]] = []
    i = qlen - 1
    j = (tlen - 1) if end_j is None else int(end_j)
    W = tb.shape[-1]

    def push(op):
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))

    state = 0  # 0=H, 1=E(up/I), 2=F(left/D), 3=E2, 4=F2
    open_bit = {1: TB_E_OPEN, 2: TB_F_OPEN, 3: TB_E2_OPEN, 4: TB_F2_OPEN}
    # each gap run costs one no-move state-entry iteration on top of the
    # qlen+tlen moves, so bound by qlen+tlen+min(qlen,tlen) (+band slack)
    guard = qlen + tlen + min(qlen, tlen) + 2 * W + 10
    while (i >= 0 or j >= 0) and guard > 0:
        guard -= 1
        if i < 0:
            if free_t_start:
                break
            push(2); j -= 1; continue
        if j < 0:
            push(1); i -= 1; continue
        l = j - i - d_lo
        cell = int(tb[i, l]) if 0 <= l < W else TB_DIAG
        if state == 0:
            choice = cell & TB_CHOICE
            if choice == TB_DIAG:
                push(0); i -= 1; j -= 1
            elif choice == TB_UP:
                state = 1
            elif choice == TB_UP2:
                state = 3
            elif choice == TB_LEFT:
                state = 2
            else:
                state = 4
        elif state in (1, 3):
            push(1)
            opened = bool(cell & open_bit[state])
            i -= 1
            if opened:
                state = 0
        else:
            push(2)
            opened = bool(cell & open_bit[state])
            j -= 1
            if opened:
                state = 0
    ops.reverse()
    return ops


# ---------------------------------------------------------------------------
# host-side exact full DP (tiny inputs, unit tests only)
# ---------------------------------------------------------------------------

def full_affine_score_np(q: np.ndarray, t: np.ndarray, s: Scores = Scores()) -> int:
    """O(mn) full-matrix (dual-)affine global alignment score (test oracle)."""
    m, n = len(q), len(t)
    NEGI = -(10**9) // 2
    H = np.full(n + 1, NEGI, np.int64)
    E = np.full(n + 1, NEGI, np.int64)
    E2 = np.full(n + 1, NEGI, np.int64)
    go2 = s.gap_open2 if s.dual else None
    ge2 = s.gap_extend2 if s.dual else None

    def gap(k):
        v = s.gap_open + s.gap_extend * k
        return max(v, go2 + ge2 * k) if s.dual else v

    H[0] = 0
    for j in range(1, n + 1):
        H[j] = gap(j)
    for i in range(1, m + 1):
        diag = H.copy()
        H[0] = gap(i)
        F = NEGI
        F2 = NEGI
        for j in range(1, n + 1):
            E[j] = max(diag[j] + s.gap_open + s.gap_extend, E[j] + s.gap_extend)
            F = max(H[j - 1] + s.gap_open + s.gap_extend, F + s.gap_extend)
            sub = s.match if (q[i - 1] == t[j - 1] and q[i - 1] < 4) else s.mismatch
            best = max(diag[j - 1] + sub, E[j], F)
            if s.dual:
                E2[j] = max(diag[j] + go2 + ge2, E2[j] + ge2)
                F2 = max(H[j - 1] + go2 + ge2, F2 + ge2)
                best = max(best, E2[j], F2)
            H[j] = best
    return int(H[n])


def pad_batch_pow2(q, t, qlen, tlen, min_b: int = 64):
    """Pad the batch dim to a power of two (≥ min_b) so batches are
    composed exactly as the reference composes them.  Padding rows get
    qlen=tlen=1 (trivially in-band).  Returns (q, t, qlen, tlen,
    original_B)."""
    B = q.shape[0]
    Bp = max(min_b, 1 << max(0, (B - 1).bit_length()))
    if Bp == B:
        return q, t, qlen, tlen, B
    pb = Bp - B
    q = np.concatenate([q, np.full((pb, q.shape[1]), 4, q.dtype)])
    t = np.concatenate([t, np.full((pb, t.shape[1]), 4, t.dtype)])
    qlen = np.concatenate([qlen, np.ones(pb, qlen.dtype)])
    tlen = np.concatenate([tlen, np.ones(pb, tlen.dtype)])
    return q, t, qlen, tlen, B
