"""Pair-HMM realignment of SNP-candidate observations near indels.

longshot is a pair-HMM *realigner* (its whole point — the reference invokes
it at volcanosv-asm.py:75-80): instead of trusting the aligner's CIGAR
columns, each read is re-scored against the two candidate local haplotypes
(REF window vs ALT window) and the allele is read off the likelihood
ratio.  Raw mismatch pileups systematically miscall candidates adjacent to
indels in noisy reads — the aligner places the indel arbitrarily within a
homopolymer and the mismatch column shifts.

Device design: all (site × covering-read) pairs are padded to fixed
(B, R) read-segment / (B, W) haplotype-window batches and scored by one
affine-gap Viterbi in fp32 log space on the caller's torch device.  Free
start/end gaps on the haplotype side (the window flanks are arbitrary),
read segment fully consumed.  `_viterbi_batch` dispatches on the tensors'
device: on the CPU `_viterbi_batch_plain`, a loop over read rows with the
delete-chain linear recurrence solved by a running prefix-max (`cummax`)
instead of a sequential column loop, so every row is a few elementwise ops
over the whole batch; on the card the hand-written kernel
`csrc/pairhmm.cu` (up to W = 1024 a group of G lanes per pair, 32 / G
pairs a warp, `viterbi_group_shape`; a block per pair above), or it
raises.

Rounding: every product and sum is its own operation, in the order of the
reference's jnp code, on fp32 operands (the constants are fp32 scalars,
as jit makes them): one torch op each in the plain version, __fadd_rn /
__fmul_rn in the kernel.  Nothing is fused, so the CPU, the card and the
reference give bit-equal scores; a fused multiply-add would round once
where the reference rounds twice and could flip an allele call
(|Δ| > margin).

The allele decision is sign(V_ref − V_alt) gated at `margin` nats;
|Δ| < margin → uninformative (allele 0), matching how longshot drops
ambiguous observations rather than guessing.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

NEG = -1e9


def _viterbi_batch_plain(segs: torch.Tensor, seg_lens: torch.Tensor,
                         haps: torch.Tensor, *, W: int, log_match, log_mis,
                         log_ins, a_mm, a_gap, a_ext, a_back) -> torch.Tensor:
    """(B, R) read segments vs (B, W) hap windows → (B,) fp32 Viterbi
    scores, as torch ops on the inputs' device.

    States: M (consume both), I (consume read), D (consume hap).  Start
    free in any hap column; end free at any hap column on the row where
    the segment length is reached."""
    B, R = segs.shape
    dev = segs.device
    f32 = torch.float32

    def c(x):                           # an fp32 scalar on the device
        return torch.tensor(x, dtype=f32, device=dev)

    log_match, log_mis, log_ins = c(log_match), c(log_mis), c(log_ins)
    a_mm, a_gap, a_ext, a_back = c(a_mm), c(a_gap), c(a_ext), c(a_back)
    log_quarter = c(np.log(0.25))
    neg_col = torch.full((B, 1), NEG, dtype=f32, device=dev)
    haps_amb = haps >= 4
    segs = segs.to(torch.int32)
    haps = haps.to(torch.int32)
    cols = torch.arange(W, dtype=f32, device=dev)
    col_ext = cols[None, :] * a_ext                      # cols · a_ext
    gap_ext = (cols[None, 1:] - 1) * a_ext               # (cols − 1) · a_ext

    m = torch.zeros((B, W), dtype=f32, device=dev)       # free start
    i_ = torch.full((B, W), NEG, dtype=f32, device=dev)
    d = torch.full((B, W), NEG, dtype=f32, device=dev)
    best = torch.where(seg_lens == 0, c(0.0), c(NEG))
    for t in range(R):
        b = segs[:, t:t + 1]            # read base column (B, 1)
        amb = (b >= 4) | haps_amb
        e = torch.where(amb, log_quarter,
                        torch.where(b == haps, log_match, log_mis))
        prev = torch.maximum(torch.maximum(m + a_mm, i_ + a_back), d + a_back)
        m_new = e + torch.cat([neg_col, prev[:, :-1]], dim=1)
        i_new = log_ins + torch.maximum(m + a_gap, i_ + a_ext)
        # delete chain: d_new[j] = max_{j'<j} m_new[j'] + a_gap + (j-j'-1)·a_ext
        g = torch.cummax(m_new - col_ext, dim=1).values
        d_new = torch.cat([neg_col, g[:, :-1] + a_gap + gap_ext], dim=1)
        done = (t + 1) == seg_lens
        rowmax = torch.maximum(m_new, i_new).max(dim=1).values
        best = torch.where(done, torch.maximum(best, rowmax), best)
        m, i_, d = m_new, i_new, d_new
    return best


# the group design's column counts at G = 32 (csrc/pairhmm.cu instances)
_GROUP32_COLUMNS = (5, 6, 7, 8, 12, 16, 24, 32)


def viterbi_group_shape(W: int) -> tuple[int, int]:
    """(G, C) of the group design at window width W (1..1024): G lanes a
    pair, the least of 4, 8, 16 and 32 with 8 * G >= W (W = 41 → 8), and C
    = ceil(W / G) columns a lane, at G = 32 rounded up to one of
    _GROUP32_COLUMNS.  G * C >= W, with at most 3/8 of the columns idle
    from W = 5 on (7 of 48 at W = 41)."""
    if not 1 <= W <= 1024:
        raise ValueError(f"viterbi_group_shape: W={W} outside 1..1024")
    G = 4
    while 8 * G < W and G < 32:
        G *= 2
    C = -(-W // G)
    if G == 32:
        C = next(c for c in _GROUP32_COLUMNS if c >= C)
    return G, C


def _viterbi_batch(segs: torch.Tensor, seg_lens: torch.Tensor,
                   haps: torch.Tensor, *, W: int, log_match, log_mis,
                   log_ins, a_mm, a_gap, a_ext, a_back) -> torch.Tensor:
    """(B, R) int8 read segments, (B,) int32 lengths and (B, W) int8 hap
    windows → (B,) fp32 Viterbi scores on the inputs' device: the CUDA
    kernel for CUDA tensors (launched on the current stream, no
    synchronisation), `_viterbi_batch_plain` for CPU tensors; the two are
    bit-equal.  On CUDA the inputs must be contiguous, W >= 1, any R: the
    group design up to W = 1024 (`viterbi_group_shape`), the block design
    above.  Each launch appends (B, R, W) to `_viterbi_batch.shapes`."""
    consts = dict(log_match=log_match, log_mis=log_mis, log_ins=log_ins,
                  a_mm=a_mm, a_gap=a_gap, a_ext=a_ext, a_back=a_back)
    if segs.device.type == "cpu":
        return _viterbi_batch_plain(segs, seg_lens, haps, W=W, **consts)
    if segs.device.type != "cuda":
        raise ValueError(f"_viterbi_batch: unsupported device {segs.device}")
    from ..ops import cuda_build
    if segs.dim() != 2 or seg_lens.shape != segs.shape[:1] or \
            haps.shape != (segs.shape[0], W):
        raise ValueError(f"_viterbi_batch: shapes {tuple(segs.shape)}, "
                         f"{tuple(seg_lens.shape)}, {tuple(haps.shape)} are "
                         f"not (B, R), (B,), (B, W={W})")
    for name, x, dt in (("segs", segs, torch.int8),
                        ("seg_lens", seg_lens, torch.int32),
                        ("haps", haps, torch.int8)):
        if x.dtype != dt or not x.is_contiguous() or x.device != segs.device:
            raise ValueError(f"_viterbi_batch: {name} must be a contiguous "
                             f"{dt} tensor on {segs.device}")
    if W < 1:
        raise ValueError(f"_viterbi_batch: W={W} < 1")
    G, C = viterbi_group_shape(W) if W <= 1024 else (0, 0)
    B, R = segs.shape
    out = torch.empty(B, dtype=torch.float32, device=segs.device)
    if B == 0:
        return out
    lib = cuda_build.lib("pairhmm")
    n = lib.pairhmm_scratch_bytes(B, W)
    scratch = torch.empty(n, dtype=torch.uint8, device=segs.device) \
        if n else None
    # the fp32 constants of the plain version (float64 rounded once)
    f32 = [float(np.float32(x)) for x in (
        log_match, log_mis, log_ins, np.log(0.25), a_mm, a_gap, a_ext,
        a_back)]
    with torch.cuda.device(segs.device):     # the launch goes to segs' card
        rc = lib.pairhmm_viterbi_launch(
            G, C, segs.data_ptr(), seg_lens.data_ptr(), haps.data_ptr(), B,
            R, W, *f32,
            scratch.data_ptr() if scratch is not None else None,
            out.data_ptr(),
            torch.cuda.current_stream(segs.device).cuda_stream)
    cuda_build.check(rc, "pairhmm_viterbi launch", "pairhmm")
    _viterbi_batch.launches += 1
    _viterbi_batch.shapes.append((B, R, W))
    return out


_viterbi_batch.launches = 0
_viterbi_batch.shapes = []


class PairHmmParams:
    def __init__(self, error_rate: float):
        e = max(min(error_rate, 0.3), 1e-4)
        gap = max(e / 2, 1e-4)
        self.log_match = float(np.log1p(-e))
        self.log_mis = float(np.log(e / 3))
        self.log_ins = float(np.log(0.25))
        self.a_mm = float(np.log1p(-2 * gap))
        self.a_gap = float(np.log(gap))
        self.a_ext = float(np.log(0.3))
        self.a_back = float(np.log(0.7))


_BUCKET = 4096


def _bucket(read_segs: np.ndarray, seg_lens: np.ndarray, hap_ref: np.ndarray,
            hap_alt: np.ndarray, lo: int):
    """The pairs of `pairhmm_alleles`' bucket at `lo`, as one kernel launch
    takes them: (2 * _BUCKET, R) segments, (2 * _BUCKET,) int32 lengths and
    (2 * _BUCKET, W) windows, the REF half then the ALT half, each padded to
    _BUCKET with empty pairs (codes 4, length 0)."""
    hi = min(lo + _BUCKET, len(seg_lens))
    pad = _BUCKET - (hi - lo)
    segs = np.pad(read_segs[lo:hi], ((0, pad), (0, 0)), constant_values=4)
    lens = np.pad(seg_lens[lo:hi], (0, pad))
    haps = np.concatenate([np.pad(h[lo:hi], ((0, pad), (0, 0)),
                                  constant_values=4)
                           for h in (hap_ref, hap_alt)])
    return (np.concatenate([segs, segs]),
            np.concatenate([lens, lens]).astype(np.int32), haps)


def pairhmm_alleles(read_segs: np.ndarray, seg_lens: np.ndarray,
                    hap_ref: np.ndarray, hap_alt: np.ndarray,
                    error_rate: float, margin: float = 1.0,
                    device=DEFAULT_DEVICE) -> np.ndarray:
    """Per-pair allele from the REF-vs-ALT Viterbi log-likelihood ratio,
    scored on `device`.

    read_segs (N, R) int8 codes (4 = pad/N), seg_lens (N,), hap_ref/hap_alt
    (N, W).  Returns (N,) int8: +1 ref, -1 alt, 0 uninformative."""
    device = resolve_device(device)
    N, R = read_segs.shape
    W = hap_ref.shape[1]
    p = PairHmmParams(error_rate)
    out = np.zeros(N, np.int8)
    for lo in range(0, N, _BUCKET):
        hi = min(lo + _BUCKET, N)
        both_s, both_l, both_h = _bucket(read_segs, seg_lens, hap_ref,
                                         hap_alt, lo)
        v = _viterbi_batch(
            torch.from_numpy(both_s).to(device),
            torch.from_numpy(both_l).to(device),
            torch.from_numpy(both_h).to(device), W=W,
            log_match=p.log_match, log_mis=p.log_mis, log_ins=p.log_ins,
            a_mm=p.a_mm, a_gap=p.a_gap, a_ext=p.a_ext,
            a_back=p.a_back).cpu().numpy()
        delta = v[:_BUCKET] - v[_BUCKET:]
        a = np.where(delta > margin, 1, np.where(delta < -margin, -1, 0))
        out[lo:hi] = a[:hi - lo].astype(np.int8)
    return out
