"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked `cuda` and skips where CUDA is absent.
The file imports neither jax nor the JAX package, so it runs on a GPU host
without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Band widths cover the path's range (32 … 4096), every DP mode, each of the
kernel's designs that takes the band (a warp per alignment at W <= 512,
W/512 warps per alignment above, a block per alignment at every W), "auto",
batches of 1 to 517 alignments (half of them unrelated pairs at W > 512),
and the walk; integer outputs
and the traceback bytes of rows < qlen must be bit-equal (tolerance 0).
The walk's two designs (a warp per alignment over tiles staged in shared
memory, or a thread per alignment) are held to the plain walk on DP
tracebacks with long gaps and on random tracebacks, at the bucketed, the
full and a cut step bound: packed streams and done flags bit-equal.

The pair-HMM Viterbi kernel (csrc/pairhmm.cu) is held to its plain
version on the card over batches of 1 to 8192 pairs, W 1 to 1024 (the
group design, G lanes a pair, on both sides of every (G, C) switch
point) and 1025 to 4096 (a block
a pair, the rows in shared memory or, at 4096, in a device scratch),
warps that mix empty, full and short segments and N bases, and three
error rates: fp32 scores bit-equal (tolerance 0).  The coverage
HMM's kernels (csrc/coverage_hmm.cu) are held to theirs over S 3-5 at T
1, 2, 4970 and the segment edges of their plans, on ragged, tie-rich
batches of 9 contigs, and of 1 and 190; at S 2 and 8 on emissions built
directly; with -inf transitions (stay = 1); and on contigs of 205,000
windows (the Viterbi's backpointers in a device scratch): labels equal;
posteriors no further from a float64 forward-backward than 1e-5 or twice
the CPU plain version's distance (float32 sums of thousands of windows
round at |alpha| x 6e-8, and the card's exp and log round differently).

The k-mer kernels (csrc/kmer.cu: count, unique mask, vote) are held to
their plain versions at k 6 and 12 on tests/torch_inputs.py's cases: a
stream counted chunk by chunk across the seams, rows with lengths (the
count also on poly-A and poly-T chunks, all-N rows and N runs at block
seams, into tables that hold counts), vote
chunks with empty, all-N, homopolymer and N-run rows, two zero tables,
a 120 kb read in a 2^17-column chunk, and rows across the vote's tile
seams (a unique k-mer's run across two seams, one k-mer in two tiles,
partial and one-window tiles): integers, equal exactly.

The MEC votes' kernels (csrc/mec.cu) are held to their plain version on
tests/torch_inputs.py's MEC edge cases, at `asm`'s shape with n_iter 0, 3
and 30, with tied restarts, a SNP row longer than a warp's span, rows
without observations, S or R at 2^15 and above (32-bit entries), a slice
too large for a CTA's shared memory, and at R just inside and just past
the smem design's reach, in its designs (a cluster of 1, 2 or 16 CTAs a
restart with the CSR in shared memory; a grid of a thread a row), with
more than one block of the CSR scan's tiles, and with int64 indices: (h,
a, mec) equal exactly; the barrier probe; the wrappers' refusals of bad
inputs.
canonical_hashes' kernel (csrc/kmer.cu) equals its plain version at k 1,
12 and 16 on random int32 hashes.

The k-mer ops the kernels replaced run the same ops on the card as on
the CPU: their outputs on the card equal the CPU's.

The all-vs-all overlap pass (csrc/ava.cu, wrapped by ops/overlap.py) is
held to native/ava.cpp's ava_overlaps, its eight columns bit for bit, on
a 250 kb haplotype at 14x with 13.5 kb reads at HiFi, CLR and ONT error,
on a repeat-rich group (the 64-hit cap and the occurrence filter), on a
tandem array whose segments pass shared memory's reach, across query
chunks and on a one-read group; `.launches` counts each pass, and a `run`
on the card counts its read groups in `overlap_device_groups` and equals
the CPU's `run`."""
import numpy as np
import pytest
import torch

from volcanosv_tpu_torch.ops import banded_align as ba
from volcanosv_tpu_torch.ops import kmer, overlap
from volcanosv_tpu_torch.phasing import phase, realign
from volcanosv_tpu_torch.qc import flagger
from torch_inputs import (MEC_EDGES, VITERBI_EDGES, ava_group,
                          hmm_tie_case, kmer_count_case, kmer_tile_case,
                          kmer_vote_case, mec_case, mec_edge_case,
                          mec_restart_mecs, viterbi_edge_case,
                          viterbi_mixed_case, viterbi_pairs)

DUAL = ba.Scores(match=2, mismatch=-4, gap_open=-4, gap_extend=-2,
                 gap_open2=-24, gap_extend2=-1)
MODES = {
    "traceback": ({}, ba.Scores()),
    "dual_affine": ({}, DUAL),
    "row0": (dict(with_traceback=False, row0_scores=True), ba.Scores()),
    "edit": (dict(with_traceback=False), ba.Scores.edit()),
    "edit_traceback": ({}, ba.Scores.edit()),
    "free_t_end": (dict(free_t_end=True), ba.Scores()),
    "free_t_start": (dict(free_t_start=True), ba.Scores()),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _pairs(rng, B, M, W, d_lo):
    """Targets = queries with substitutions and 1-base indels, lengths
    inside the band; padding is code 4."""
    q = rng.integers(0, 4, (B, M), dtype=np.int8)
    t = np.full((B, M + W), 4, np.int8)
    qlen = rng.integers(max(1, M // 2), M + 1, B).astype(np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        seq = q[b, :qlen[b]].copy()
        sub = rng.random(len(seq)) < 0.05
        seq[sub] = rng.integers(0, 4, int(sub.sum()))
        seq = seq[rng.random(len(seq)) > 0.01]
        at = rng.integers(0, len(seq) + 1, max(1, len(seq) // 100))
        seq = np.insert(seq, at, 2)
        tl = int(np.clip(len(seq), max(1, qlen[b] + d_lo + 1),
                         qlen[b] + d_lo + W - 1))
        seq = np.concatenate([seq, np.zeros(max(0, tl - len(seq)), np.int8)])
        t[b, :tl] = seq[:tl]
        q[b, qlen[b]:] = 4
        tlen[b] = tl
    return q, t, qlen, tlen


def _check_against_plain(cuda, args, M, W, d_lo, kw, sc):
    """Every design that takes W against the plain version (DP flags kw,
    scores sc): scores, end columns, row0 and traceback bytes of rows <
    qlen; then the walk over the kernel's traceback against the plain walk
    over the plain one."""
    p = ba.banded_dp_plain(*args, W, d_lo, sc, **kw)
    rows = torch.arange(M, device=cuda)[None, :] < args[2][:, None]   # (B, M)
    taken = "warp" if W <= 512 else "group"
    branches = ["auto", taken, "block"]
    ba.reset_launch_counts()
    for br in branches:
        k = ba.banded_dp(*args, W, d_lo, sc, **kw, branch=br)
        torch.cuda.synchronize()
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]), br
        if k[3] is not None:
            assert torch.equal(k[3][rows.T], p[3][rows.T]), br
        if k[2] is not None:
            assert torch.equal(k[2][rows], p[2][rows]), br
        if br == "auto":
            auto = k
    assert ba.banded_dp.launches == len(branches) == len(ba.banded_dp.shapes)
    assert ba.banded_dp_branch(W) == taken
    assert ba.banded_dp.shapes == [
        (ba.dp_mode(sc, **kw), br, args[0].shape[0], M, W)
        for br in [taken] + branches[1:]]
    if auto[2] is not None and not kw.get("free_t_start"):
        qlen, tlen = args[2].cpu().numpy(), args[3].cpu().numpy()
        n_steps, full = ba.walk_steps(M, W, qlen, tlen)
        for steps in (n_steps, full):
            pk, dk = ba.tb_walk(auto[2], args[2], args[3], d_lo, steps)
            pp, dp = ba.tb_walk_plain(p[2], args[2], args[3], d_lo, steps)
            assert torch.equal(pk, pp) and torch.equal(dk, dp)
        assert bool(dk.all()) and ba.tb_walk.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 64])
@pytest.mark.parametrize("W", [32, 64, 128, 256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("mode", list(MODES))
def test_banded_dp_kernel_matches_plain(cuda, W, mode, B):
    d_lo, M = -(W // 2), 192
    q, t, qlen, tlen = _pairs(np.random.default_rng(W + B), B, M, W, d_lo)
    args = [torch.from_numpy(x).to(cuda) for x in (q, t, qlen, tlen)]
    _check_against_plain(cuda, args, M, W, d_lo, *MODES[mode])


@pytest.mark.cuda
@pytest.mark.parametrize("W", [32, 128, 512, 1024])
@pytest.mark.parametrize("mode", list(MODES))
def test_banded_dp_edges_match_plain(cuda, W, mode):
    """qlen 0, 1 and M; tlen at both edges of the band (the global end on
    lane 0 and on lane W-1) and inside it; B = 517 is not a multiple of
    the warps per block."""
    d_lo, M, B = -(W // 2), 96, 517
    rng = np.random.default_rng(W)
    q, t, qlen, tlen = _pairs(rng, B, M, W, d_lo)
    t[t == 4] = rng.integers(0, 4, int((t == 4).sum())).astype(np.int8)
    for b in range(B):
        ql = (0, 1, M, int(qlen[b]))[b % 4]
        lo, hi = max(0, ql + d_lo), ql + d_lo + W - 1
        qlen[b] = ql
        tlen[b] = (lo, hi, (lo + hi) // 2)[(b // 4) % 3]
    args = [torch.from_numpy(x).to(cuda) for x in (q, t, qlen, tlen)]
    _check_against_plain(cuda, args, M, W, d_lo, *MODES[mode])


# the score-only modes a wide band (W > 512) serves
WIDE_MODES = {
    "edit": (dict(with_traceback=False), ba.Scores.edit()),
    "affine": (dict(with_traceback=False), ba.Scores()),
    "dual_affine": (dict(with_traceback=False), DUAL),
    "free_t_end": (dict(with_traceback=False, free_t_end=True), ba.Scores()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 64, 517])
@pytest.mark.parametrize("W", [1024, 2048, 4096])
@pytest.mark.parametrize("mode", list(WIDE_MODES))
def test_banded_dp_wide_bands_match_plain(cuda, W, mode, B):
    """The group design (W/512 warps per alignment), "auto" and the block
    design at the wide bands: half the pairs unrelated sequences of lengths
    within 2x of each other (scores far below zero, as edit_sim_batch sends
    them), qlen 0, 1 and M, tlen at both edges of the band and inside it."""
    d_lo, M = -(W // 2), 640
    rng = np.random.default_rng(W + B + 1)
    q, t, qlen, tlen = _pairs(rng, B, M, W, d_lo)
    for b in range(B):
        ql = (int(qlen[b]), 0, 1, M)[b % 4]
        lo, hi = max(0, ql + d_lo), ql + d_lo + W - 1
        if b % 2 == 0 and ql > 1:                 # unrelated, within 2x
            tl = int(rng.integers(max(lo, ql // 2), min(hi, 2 * ql) + 1))
            t[b] = rng.integers(0, 4, t.shape[1])
        else:
            tl = (lo, hi, (lo + hi) // 2, int(tlen[b]))[(b // 4) % 4]
            tl = min(max(tl, lo), hi)
            pad = t[b] == 4
            t[b, pad] = rng.integers(0, 4, int(pad.sum()))
        t[b, tl:] = 4
        q[b, ql:] = 4
        qlen[b], tlen[b] = ql, tl
    args = [torch.from_numpy(x).to(cuda) for x in (q, t, qlen, tlen)]
    _check_against_plain(cuda, args, M, W, d_lo, *WIDE_MODES[mode])


@pytest.mark.cuda
def test_dispatch_cigars_match_cpu(cuda):
    """The dispatcher on the card (pinned async copies, DP + walk, one
    fetch) gives the CPU path's CIGARs, row-0 profiles and distances."""
    W, d_lo, M, B = 256, -128, 512, 100
    q, t, qlen, tlen = _pairs(np.random.default_rng(7), B, M, W, d_lo)
    q, t, qlen, tlen, _ = ba.pad_batch_pow2(q, t, qlen, tlen)
    fin = [ba.banded_align_cigars_dispatch(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                           device=dev)
           for dev in (cuda, "cpu")]
    assert fin[0]() == fin[1]()
    rows = np.arange(M)[:, None] < qlen[None, :]
    r0 = [ba.banded_row0_auto(q, t, qlen, tlen, W=128, d_lo=-64, device=dev)
          for dev in (cuda, "cpu")]
    np.testing.assert_array_equal(r0[0][rows], r0[1][rows])
    np.testing.assert_array_equal(
        ba.edit_distance_batch_auto(q, t, qlen, tlen, W=W, device=cuda),
        ba.edit_distance_batch_auto(q, t, qlen, tlen, W=W, device="cpu"))


def _gappy_pairs(rng, B, M, W, d_lo, max_gap):
    """Like _pairs, plus one long gap (up to max_gap bases, an insertion or
    a deletion) in most pairs, and the edge rows: qlen 0, tlen 0, the
    padding rows of pad_batch_pow2 (qlen = tlen = 1, code 4) and qlen 1."""
    q, t, qlen, tlen = _pairs(rng, B, M, W, d_lo)
    for b in range(B):
        kind = (b + 4) % 8                     # row 0 has the long gap
        if kind == 0:
            qlen[b], tlen[b] = 0, int(rng.integers(0, W // 2))
        elif kind == 1:
            qlen[b], tlen[b] = int(rng.integers(1, M + 1)), 0
        elif kind == 2:
            q[b], t[b] = 4, 4
            qlen[b] = tlen[b] = 1
        elif kind == 3:
            qlen[b], tlen[b] = 1, int(rng.integers(1, W // 2 + 1))
        else:
            ql = int(qlen[b])
            seq = q[b, :ql].copy()
            k = int(rng.integers(2 * max_gap // 3, max_gap + 1))
            at = int(rng.integers(0, max(1, ql - k)))
            if b % 2:
                seq = np.delete(seq, np.arange(at, min(ql, at + k)))
            else:
                seq = np.insert(seq, at, rng.integers(0, 4, k).astype(np.int8))
            tl = int(np.clip(len(seq), max(1, ql + d_lo + 1),
                             ql + d_lo + W - 1))
            seq = np.concatenate([seq, np.zeros(max(0, tl - len(seq)),
                                                np.int8)])
            t[b] = 4
            t[b, :tl] = seq[:tl]
            tlen[b] = tl
        q[b, qlen[b]:] = 4
    return q, t, qlen, tlen


def _walk_lengths(packed):
    """Steps each walk took until done."""
    return ba.walk_lengths(ba._unpack_ops(packed.cpu().numpy()))


def _check_walk(tb, qlen, tlen, d_lo, step_bounds):
    """Both designs and "auto" against the plain walk at each step bound:
    packed streams and done flags bit-equal; "auto" takes the warp design
    on every traceback of this file."""
    for n_steps in step_bounds:
        pp, dp = ba.tb_walk_plain(tb, qlen, tlen, d_lo, n_steps)
        for br in ("auto", "warp", "thread"):
            ba.reset_launch_counts()
            pk, dk = ba.tb_walk(tb, qlen, tlen, d_lo, n_steps, branch=br)
            torch.cuda.synchronize()
            assert torch.equal(pk, pp), (br, n_steps)
            assert torch.equal(dk, dp), (br, n_steps)
            want = "warp" if br == "auto" else br
            assert ba.tb_walk.shapes == [(want, *tb.shape)]
    return pp, dp


def _cut(lengths):
    """A step bound that cuts about half the walks short."""
    return max(4, int(np.median(lengths)) // 4 * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("scores,B,M,W", [
    ("affine", 4096, 256, 256), ("affine", 517, 1024, 128),
    ("affine", 37, 512, 64), ("dual", 64, 2048, 512),
    ("dual", 1, 8192, 256), ("affine", 64, 8192, 256),
])
def test_tb_walk_matches_plain_on_dp_tracebacks(cuda, scores, B, M, W):
    """Walks over the DP kernel's tracebacks of pairs with one long gap
    (longer than the warp design's 64-byte window where W >= 128; with
    dual-affine scores the long-gap states 3 and 4), walks longer than
    one 32-row tile, and the edge rows of _gappy_pairs."""
    d_lo = -(W // 2)
    rng = np.random.default_rng(B + M + W)
    max_gap = W // 2 - 8
    q, t, qlen, tlen = _gappy_pairs(rng, B, M, W, d_lo, max_gap)
    args = [torch.from_numpy(x).to(cuda) for x in (q, t, qlen, tlen)]
    sc = DUAL if scores == "dual" else ba.Scores()
    tb = ba.banded_dp(*args, W, d_lo, sc)[2]
    n_steps, full = ba.walk_steps(M, W, qlen, tlen)
    pp, dp = _check_walk(tb, args[2], args[3], d_lo, [n_steps])
    assert bool(dp.all())
    _, dcut = _check_walk(tb, args[2], args[3], d_lo,
                          [_cut(_walk_lengths(pp))])
    assert B == 1 or not bool(dcut.all())
    if M <= 2048:
        _check_walk(tb, args[2], args[3], d_lo, [full])
    # the implanted gaps come out as long I/D runs (W = 256, 512: longer
    # than the window)
    runs = ba._rle_columns(ba._unpack_ops(pp.cpu().numpy()), B)
    assert max(n for r in runs for o, n in r if o) >= 2 * max_gap // 3 - 4


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,W,p_gap,p_open,stuck", [
    (37, 1024, 512, 0.02, 0.01, False),
    (517, 512, 128, 0.05, 0.03, True),
    (64, 4096, 64, 0.03, 0.05, False),
    (1, 2048, 256, 0.01, 0.005, False),
    (4096, 128, 256, 0.02, 0.02, True),
])
def test_tb_walk_matches_plain_on_random_tracebacks(cuda, B, M, W, p_gap,
                                                    p_open, stuck):
    """Random traceback bytes: each gap choice (1-4) with probability
    p_gap, each open flag with p_open, so that gap runs average 1/p_open
    steps (runs far longer than the window, walks that leave the band);
    with `stuck`, a few cells carry a choice 5-7, on which the walk stops
    moving and never finishes.  Lengths anywhere in [0, M] and in the
    band's target range."""
    g = torch.Generator(device=cuda).manual_seed(B * M + W)
    u = torch.rand((B, M, W), generator=g, device=cuda)
    choice = torch.zeros((B, M, W), dtype=torch.int32, device=cuda)
    for c in range(1, 5):
        choice[(u >= 1 - c * p_gap) & (u < 1 - (c - 1) * p_gap)] = c
    if stuck:
        choice[u < 2e-4] = (5 + (u[u < 2e-4] * 1e6).long() % 3).int()
    flags = torch.zeros_like(choice)
    for bit in (8, 16, 32, 64):
        flags |= (torch.rand((B, M, W), generator=g, device=cuda)
                  < p_open).int() * bit
    tb = (choice | flags).to(torch.uint8)
    rng = np.random.default_rng(W)
    d_lo = -(W // 2)
    qlen = rng.integers(0, M + 1, B).astype(np.int32)
    tlen = np.clip(qlen + d_lo + rng.integers(-8, W + 8, B), 0,
                   None).astype(np.int32)
    qlen[:4], tlen[:4] = (0, 0, 1, M)[:B], (0, 1, 1, M + d_lo)[:B]
    ql, tl = (torch.from_numpy(x).to(cuda) for x in (qlen, tlen))
    n_steps, full = ba.walk_steps(M, W, qlen, tlen)
    pp, _ = _check_walk(tb, ql, tl, d_lo, [n_steps, full])
    _check_walk(tb, ql, tl, d_lo, [_cut(_walk_lengths(pp))])


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda):
    q = torch.zeros((2, 8), dtype=torch.int8, device=cuda)
    ln = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ba.banded_dp(q, q, ln, ln, 96, -48, ba.Scores())       # W not 2^k
    with pytest.raises(ValueError):
        ba.banded_dp(q, q, ln.long(), ln, 64, -32, ba.Scores())
    with pytest.raises(ValueError):                          # warp: W <= 512
        ba.banded_dp(q, q, ln, ln, 1024, -512, ba.Scores(), branch="warp")
    for W in (32, 512):                                      # group: W > 512
        with pytest.raises(ValueError):
            ba.banded_dp(q, q, ln, ln, W, -(W // 2), ba.Scores.edit(),
                         branch="group")
    with pytest.raises(ValueError):
        ba.tb_walk(torch.zeros((2, 8, 64), dtype=torch.uint8, device=cuda),
                   ln, ln, -32, 6)                               # not 4k steps
    for br in ("auto", "warp", "thread"):                     # W % 32
        with pytest.raises(ValueError):
            ba.tb_walk(torch.zeros((2, 8, 40), dtype=torch.uint8,
                                   device=cuda), ln, ln, -20, 64, branch=br)
    with pytest.raises(ValueError):                          # misaligned tb
        ba.tb_walk(torch.zeros((2 * 8 * 64 + 1,), dtype=torch.uint8,
                               device=cuda)[1:].view(2, 8, 64),
                   ln, ln, -32, 64)
    with pytest.raises(ValueError):
        ba.tb_walk(torch.zeros((2, 8, 64), dtype=torch.uint8, device=cuda),
                   ln, ln, -32, 64, branch="block")


@pytest.mark.cuda
@pytest.mark.parametrize("err", [0.002, 0.1])
def test_viterbi_batch_card_equals_cpu(cuda, err):
    """8192 pairs at the path's window (R = 57, W = 41): fp32 scores
    bit-equal, and so the allele calls."""
    segs, lens, haps = viterbi_pairs(np.random.default_rng(int(err * 1e3)),
                                     8192, 57, 41, err)
    p = realign.PairHmmParams(err)
    kw = dict(W=41, log_match=p.log_match, log_mis=p.log_mis,
              log_ins=p.log_ins, a_mm=p.a_mm, a_gap=p.a_gap, a_ext=p.a_ext,
              a_back=p.a_back)
    got, want = (realign._viterbi_batch(
        *(torch.from_numpy(x).to(dev) for x in (segs, lens, haps)), **kw)
        .cpu().numpy() for dev in (cuda, "cpu"))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    alt = haps.copy()
    alt[:, 20] = (alt[:, 20] + 1) % 4
    np.testing.assert_array_equal(
        realign.pairhmm_alleles(segs[:5000], lens[:5000], haps[:5000],
                                alt[:5000], err, device=cuda),
        realign.pairhmm_alleles(segs[:5000], lens[:5000], haps[:5000],
                                alt[:5000], err, device="cpu"))


def _viterbi_kw(err, W):
    p = realign.PairHmmParams(err)
    return dict(W=W, log_match=p.log_match, log_mis=p.log_mis,
                log_ins=p.log_ins, a_mm=p.a_mm, a_gap=p.a_gap,
                a_ext=p.a_ext, a_back=p.a_back)


def _check_viterbi_kernel(cuda, segs, lens, haps, err, W):
    """The kernel against the plain version on the card: bit-equal scores,
    one launch of shape (B, R, W)."""
    args = [torch.from_numpy(x).to(cuda) for x in (segs, lens, haps)]
    kw = _viterbi_kw(err, W)
    realign._viterbi_batch.launches = 0
    realign._viterbi_batch.shapes = []
    got = realign._viterbi_batch(*args, **kw)
    torch.cuda.synchronize()
    want = realign._viterbi_batch_plain(*args, **kw)
    assert got.dtype == want.dtype == torch.float32
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                  want.cpu().numpy().view(np.int32))
    assert realign._viterbi_batch.launches == 1
    assert realign._viterbi_batch.shapes == [segs.shape + (W,)]


def _group_widths():
    """W on both sides of every switch of the group design's (G, C), and
    1, 9, 41, 64, 200 and 1024 (pure Python: no card involved)."""
    shape = {W: realign.viterbi_group_shape(W) for W in range(1, 1025)}
    switch = [W for W in range(2, 1025) if shape[W] != shape[W - 1]]
    return sorted({w for W in switch for w in (W - 1, W)}
                  | {1, 9, 41, 64, 200, 1024})


@pytest.mark.cuda
@pytest.mark.parametrize("W", _group_widths())
def test_pairhmm_group_design_at_every_switch(cuda, W):
    """Batches of 1, 3 and 37 pairs (a part of a warp's groups) at each
    width: the group design bit-equal to the plain version."""
    for B in (1, 3, 37):
        segs, lens, haps = viterbi_pairs(np.random.default_rng(W * 64 + B),
                                         B, W + 16, W, 0.1)
        _check_viterbi_kernel(cuda, segs, lens, haps, 0.1, W)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [9, 41, 64, 100])
def test_pairhmm_group_design_mixed_warps(cuda, W):
    """Warps whose groups hold empty, full and short segments, N bases in
    segments and an all-N segment: each group's score on its own last
    row, bit-equal to the plain version."""
    _check_viterbi_kernel(cuda, *viterbi_mixed_case(W))


@pytest.mark.cuda
@pytest.mark.parametrize("err", [0.002, 0.1, 0.3])
@pytest.mark.parametrize("W", [9, 41, 64, 200])
@pytest.mark.parametrize("B", [1, 37, 8192])
def test_pairhmm_kernel_matches_plain(cuda, B, W, err):
    segs, lens, haps = viterbi_pairs(np.random.default_rng(B + W), B,
                                     W + 16, W, err)
    _check_viterbi_kernel(cuda, segs, lens, haps, err, W)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(VITERBI_EDGES) + ["W1", "W1024",
                                                        "R0"])
def test_pairhmm_kernel_edge_batches(cuda, case):
    """Empty and full segments, all-N windows, the narrowest and widest
    windows the kernel takes, segments of no columns."""
    if case in VITERBI_EDGES:
        _check_viterbi_kernel(cuda, *viterbi_edge_case(case))
        return
    W = {"W1": 1, "W1024": 1024, "R0": 41}[case]
    R = 0 if case == "R0" else W + 16
    rng = np.random.default_rng(W)
    segs, lens, haps = viterbi_pairs(rng, 64, R, W, 0.1)
    _check_viterbi_kernel(cuda, segs, lens, haps, 0.1, W)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,W", [(37, 1041, 1025), (16, 2064, 2048),
                                   (300, 64, 4096), (4, 4112, 4096)])
def test_pairhmm_block_design_matches_plain(cuda, B, R, W):
    """Windows past the group design's 1024 columns: a block a pair, the
    rows in shared memory (1025, 2048) or in a device scratch (4096; 300
    pairs stride over the scratch's blocks)."""
    segs, lens, haps = viterbi_pairs(np.random.default_rng(W + B), B, R, W,
                                     0.1)
    _check_viterbi_kernel(cuda, segs, lens, haps, 0.1, W)


def _check_coverage_kernels(on_card, on_cpu, exact):
    """Both coverage kernels on (emit, logA, logpi) against their plain
    versions: `on_card` and `on_cpu` the inputs as each device built them.
    The Viterbi labels equal the plain version's on the card and on the
    CPU; the posteriors within 1e-5 or twice the CPU plain version's
    distance of `exact`, a float64 forward-backward (T, B, S); one launch
    each."""
    T, B, S = on_cpu[0].shape
    for fn in (flagger.coverage_viterbi, flagger.coverage_posteriors):
        fn.launches = 0
    labels = flagger.coverage_viterbi(*on_card).cpu()
    assert labels.dtype == torch.int8 and labels.shape == (B, T)
    assert torch.equal(labels, flagger._viterbi_plain(*on_card).cpu())
    assert torch.equal(labels, flagger._viterbi_plain(*on_cpu))
    got = flagger.coverage_posteriors(*on_card).cpu().numpy()
    cpu = flagger._posteriors_plain(*on_cpu).numpy()
    assert got.dtype == np.float32 and got.shape == (T, B, S)
    cpu_err = float(np.abs(cpu - exact).max())
    assert float(np.abs(got - exact).max()) <= max(1e-5, 2 * cpu_err)
    assert flagger.coverage_viterbi.launches == 1
    assert flagger.coverage_posteriors.launches == 1


def _hmm_case(cuda, means, tau, cov, valid, stay=flagger.STAY):
    """The emissions as qc builds them, on the card and on the CPU, and the
    float64 posteriors: `_check_coverage_kernels`'s arguments."""
    hmm = flagger.CoverageHMM(means=means, tau=tau, stay=stay)
    return (hmm._emissions(cov, valid, torch.device(cuda)),
            hmm._emissions(cov, valid, torch.device("cpu")),
            flagger.posteriors_float64(hmm, cov, valid).transpose(1, 0, 2))


# T at the plans' segment edges (qc/flagger.py::coverage_plan, viterbi_plan
# at B = 9): 241 leaves a last segment of one window (both), 4913 one
# window short of full, 4914 full and 4915 of one window (forward-backward),
# 4927 one short and 4928 full (Viterbi)
COVERAGE_T = [1, 2, 241, 4913, 4914, 4915, 4927, 4928, 4970]


@pytest.mark.cuda
@pytest.mark.parametrize("T", COVERAGE_T)
@pytest.mark.parametrize("n_states", [3, 4, 5])
def test_coverage_kernels_match_plain(cuda, n_states, T):
    """Ragged, tie-rich batches (an all-padded row, two states of one
    mean): the Viterbi kernel's labels equal the plain version's on the
    card and on the CPU; the posteriors kernel within 1e-5 or twice the
    CPU's distance of a float64 forward-backward."""
    _check_coverage_kernels(*_hmm_case(cuda, *hmm_tie_case(
        np.random.default_rng(n_states * 10 + T), n_states, 9, T)))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 190])
def test_coverage_kernels_batch_sizes(cuda, B):
    """One contig, and the chromosome-scale batch's 190 (two contigs a CTA
    in the forward-backward, 24 CTAs of 8 in the Viterbi)."""
    _check_coverage_kernels(*_hmm_case(cuda, *hmm_tie_case(
        np.random.default_rng(B), 4, B, 4970)))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 75, 4915])
@pytest.mark.parametrize("S", [2, 8])
def test_coverage_kernels_template_ends(cuda, S, T):
    """The smallest and largest templates (S 2 and 8: 1 and 3 bits a
    backpointer, a byte and a word a window), emissions built directly
    with a padded tail, random transitions."""
    rng = np.random.default_rng(S * 100 + T)
    emit = (rng.standard_normal((T, 9, S)) * 4).astype(np.float32)
    emit[T // 2:, 1] = 0
    logA = np.log(rng.dirichlet(np.ones(S), S)).astype(np.float32)
    logpi = np.log(np.full(S, 1.0 / S)).astype(np.float32)
    on_cpu = [torch.from_numpy(x) for x in (emit, logA, logpi)]
    _check_coverage_kernels([x.to(cuda) for x in on_cpu], on_cpu,
                            flagger.forward_backward_float64(emit, logA,
                                                             logpi))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [160, 4915])
def test_coverage_kernels_inf_transitions(cuda, T):
    """logA with -inf entries (CoverageHMM(stay=1.0)): no path changes
    state.  A contig at haploid coverage, then at twice it (the collapsed
    state wins every window), beside ragged rows and an all-padded one."""
    means, tau, cov, valid = hmm_tie_case(np.random.default_rng(T), 4, 6, T)
    means[3] = 2 * means[2]
    cov[0] = np.where(np.arange(T) < 60, means[2], means[3])
    _check_coverage_kernels(*_hmm_case(cuda, means, tau, cov, valid, 1.0))


@pytest.mark.cuda
def test_coverage_kernels_long_contigs(cuda):
    """Contigs of 205,000 windows: the Viterbi's backpointers pass its
    shared memory and go to a device scratch; the forward-backward takes
    segments of 1602 windows."""
    T = 205_000
    assert flagger.viterbi_plan(3, T, 4).scratch > 0
    _check_coverage_kernels(*_hmm_case(cuda, *hmm_tie_case(
        np.random.default_rng(5), 4, 3, T)))


@pytest.mark.cuda
def test_scan_kernel_wrappers_reject_bad_inputs(cuda):
    segs = torch.zeros((4, 20), dtype=torch.int8, device=cuda)
    lens = torch.full((4,), 10, dtype=torch.int32, device=cuda)
    haps = torch.zeros((4, 9), dtype=torch.int8, device=cuda)
    kw = _viterbi_kw(0.1, 9)
    bad = [(segs.int(), lens, haps, kw), (segs, lens.long(), haps, kw),
           (segs, lens, haps[:, :8], kw),                   # W mismatch
           (segs.T.contiguous().T, lens, haps, kw),          # strided
           (segs, lens[:3], haps, kw),
           (segs, lens, torch.zeros((4, 0), dtype=torch.int8,
                                    device=cuda), _viterbi_kw(0.1, 0))]
    for s, ln, h, k in bad:
        with pytest.raises(ValueError):
            realign._viterbi_batch(s, ln, h, **k)
    emit = torch.zeros((5, 3, 4), device=cuda)
    logA = torch.zeros((4, 4), device=cuda)
    logpi = torch.zeros(4, device=cuda)
    for fn in (flagger.coverage_viterbi, flagger.coverage_posteriors):
        for e, a, p in ((emit.double(), logA, logpi),
                        (emit, logA[:3, :3], logpi),
                        (emit.transpose(0, 1).contiguous().transpose(0, 1),
                         logA, logpi),
                        (torch.zeros((5, 3, 9), device=cuda),
                         torch.zeros((9, 9), device=cuda),
                         torch.zeros(9, device=cuda)),
                        (emit, logA, logpi.cpu())):
            with pytest.raises(ValueError):
                fn(e, a, p)


@pytest.mark.cuda
@pytest.mark.parametrize("n_iter", [0, 3, 30])
def test_mec_phase_card_equals_cpu(cuda, n_iter):
    """8 restarts over noisy observations: (h, a, mec) equal."""
    rng = np.random.default_rng(n_iter)
    n_reads, S, n_obs = 3000, 1200, 60000
    truth_h = rng.choice([-1, 1], S)
    truth_a = rng.choice([-1, 1], n_reads)
    obs_read = rng.integers(0, n_reads, n_obs).astype(np.int64)
    obs_snp = rng.integers(0, S, n_obs).astype(np.int32)
    o = truth_a[obs_read] * truth_h[obs_snp]
    o[rng.random(n_obs) < 0.15] *= -1
    o[rng.random(n_obs) < 0.05] = 0
    obs_allele = o.astype(np.int8)
    h0 = phase.restart_inits(
        phase.chain_init(obs_read, obs_snp, obs_allele, S), n_iter, 8)
    got, want = (phase._mec_phase(
        *(torch.from_numpy(x).to(dev)
          for x in (obs_read, obs_snp, obs_allele, h0)),
        n_reads=n_reads, n_iter=n_iter) for dev in (cuda, "cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def _mec_on_card(cuda, r, s, o, h0, n_reads, n_iter, branch, ctas=None):
    """The kernel (one launch of the wrapper) against `_mec_phase_plain` on
    the same card tensors: (h, a, mec) equal, dtypes and shapes too."""
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
            for x in (r, s, o, h0)]
    n = phase._mec_phase.launches
    got = phase._mec_phase(*args, n_reads=n_reads, n_iter=n_iter,
                           branch=branch, ctas=ctas)
    torch.cuda.synchronize()
    assert phase._mec_phase.launches == n + 1
    want = phase._mec_phase_plain(*args, n_reads=n_reads, n_iter=n_iter)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    return got


def _h0(r, s, o, S, h_init=None, seed=0):
    if h_init is None:
        h_init = phase.chain_init(r, s, o, S)
    return phase.restart_inits(h_init, seed, 8)


# the MEC kernel's designs: the smem design at one CTA and at clusters of 2
# and 16 CTAs a restart, and the grid design
MEC_DESIGNS = [("smem", 1), ("smem", 2), ("smem", 16), ("grid", None)]


@pytest.mark.cuda
@pytest.mark.parametrize("branch,ctas", MEC_DESIGNS)
@pytest.mark.parametrize("case", MEC_EDGES)
def test_mec_kernel_edges_match_plain(cuda, case, branch, ctas):
    r, s, o, S, n_reads, n_iter, h_init, seed = mec_edge_case(case)
    _mec_on_card(cuda, r, s, o, _h0(r, s, o, S, h_init, seed), n_reads,
                 n_iter, branch, ctas)


@pytest.mark.cuda
@pytest.mark.parametrize("n_iter", [0, 3, 30])
@pytest.mark.parametrize("branch,ctas", [("auto", None)] + MEC_DESIGNS)
def test_mec_kernel_matches_plain(cuda, branch, ctas, n_iter):
    """`asm`'s shape: 6677 reads, 941 SNPs, about 33k observations."""
    rng = np.random.default_rng(n_iter)
    r, s, o = mec_case(rng, 6677, 941, 5)
    _mec_on_card(cuda, r, s, o, _h0(r, s, o, 941, seed=n_iter), 6677,
                 n_iter, branch, ctas)


@pytest.mark.cuda
@pytest.mark.parametrize("branch,ctas", MEC_DESIGNS)
def test_mec_kernel_picks_first_of_tied_restarts(cuda, branch, ctas):
    """Restarts 3 and 5 start from the chain init, the others from random
    phases: with no iteration 3 and 5 tie on the lowest MEC, and 3 wins."""
    rng = np.random.default_rng(7)
    r, s, o = mec_case(rng, 300, 120, 6, flip=0.05)
    h0 = rng.choice([-1, 1], (8, 120)).astype(np.int32)
    h0[3] = h0[5] = phase.chain_init(r, s, o, 120)
    mecs = mec_restart_mecs(r, s, o, h0, 300)
    assert min(mecs) == mecs[3] == mecs[5] < min(mecs[:3])
    got = _mec_on_card(cuda, r, s, o, h0, 300, 0, branch, ctas)
    assert torch.equal(got[0].cpu(), torch.from_numpy(h0[3]))


@pytest.mark.cuda
@pytest.mark.parametrize("ctas", [1, 2, 16])
def test_mec_kernel_long_and_empty_rows(cuda, ctas):
    """SNP 7 observed by 5000 of 6000 reads (one thread's row of 5000
    entries, at 16 CTAs longer than a CTA's even slice: read from global
    memory), reads and SNPs without observations at both ends and between
    the others: equal."""
    rng = np.random.default_rng(ctas)
    r, s, o = mec_case(rng, 3000, 400, 5)
    long_r = np.sort(rng.choice(6000, 5000, replace=False)).astype(np.int32)
    r = np.concatenate([r * 2 + 3, long_r])
    s = np.concatenate([s + 20, np.full(5000, 7, np.int32)])
    o = np.concatenate([o, rng.choice([-1, 1], 5000).astype(np.int8)])
    S, n_reads = 450, 6010
    _mec_on_card(cuda, r, s, o, _h0(r, s, o, S), n_reads, 5, "smem", ctas)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", ["snps", "reads"])
def test_mec_kernel_wide_entries(cuda, wide):
    """S or R at 2^15 and above: the smem design's entries are 32-bit;
    equal at one CTA and at a cluster."""
    rng = np.random.default_rng(5)
    n_reads, S = (4000, 2**15 + 3) if wide == "snps" else (2**15 + 40, 900)
    r, s, o = mec_case(rng, min(n_reads, 4000), min(S, 900), 5)
    if wide == "snps":
        s = (s.astype(np.int64) * 37 % S).astype(np.int32)
    else:
        r = (r.astype(np.int64) * 9 % n_reads).astype(np.int32)
    h0 = _h0(r, s, o, S)
    for ctas in (1, 4):
        _mec_on_card(cuda, r, s, o, h0, n_reads, 3, "smem", ctas)


def _mec_threshold(S, O):
    """The most reads R that mec_design still gives the smem design for S
    SNPs and O observations."""
    lo, hi = 1, 1 << 20
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if phase.mec_design(S, mid, O)[0] == "smem":
            lo = mid
        else:
            hi = mid
    return lo


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["inside", "past"])
def test_mec_kernel_at_the_shared_memory_threshold(cuda, side):
    """R at the smem design's largest for these S and O, and one more:
    "auto" takes the smem design inside and the grid design past it; equal
    to the grid design on both sides.  The smem design refuses an R whose
    h, a and row offsets do not fit."""
    S = 9000
    rng = np.random.default_rng(1)
    r, s, o = mec_case(rng, 20000, S, 6)
    top = _mec_threshold(S, len(r))
    assert top > 20000
    n_reads = top + (side == "past")
    h0 = _h0(r, s, o, S)
    design = phase.mec_design(S, n_reads, len(r))
    assert design[0] == ("smem" if side == "inside" else "grid")
    auto = _mec_on_card(cuda, r, s, o, h0, n_reads, 5, "auto")
    grid = _mec_on_card(cuda, r, s, o, h0, n_reads, 5, "grid")
    assert all(torch.equal(x, y) for x, y in zip(auto, grid))
    with pytest.raises(ValueError):
        phase._mec_phase(*(torch.from_numpy(x).to(cuda)
                           for x in (r, s, o, h0)),
                         n_reads=300_000, n_iter=5, branch="smem", ctas=16)


@pytest.mark.cuda
def test_mec_kernel_slice_past_shared_memory(cuda):
    """SNP 0 observed by all of 120,000 reads (32-bit entries): at 16 CTAs
    the CTA holding its row cannot keep its 480 KB of entries in shared
    memory and reads them from global memory; equal."""
    rng = np.random.default_rng(12)
    n_reads, S = 120_000, 64
    r, s, o = mec_case(rng, 2000, S, 4)
    r = np.concatenate([r * 60, np.arange(n_reads, dtype=np.int32)])
    s = np.concatenate([s, np.zeros(n_reads, np.int32)])
    o = np.concatenate([o, rng.choice([-1, 1], n_reads).astype(np.int8)])
    _mec_on_card(cuda, r, s, o, _h0(r, s, o, S), n_reads, 4, "smem", 16)


@pytest.mark.cuda
def test_mec_kernel_scans_many_tiles(cuda):
    """R + S past 1024 of the CSR scan's 4096-row tiles (its totals scanned
    in more than one pass), few observations, int64 indices: equal."""
    rng = np.random.default_rng(11)
    n_reads, S = 4_300_000, 700
    r, s, o = mec_case(rng, 3000, S, 5)
    r = (r.astype(np.int64) * 1433) % n_reads
    _mec_on_card(cuda, r, s.astype(np.int64), o, _h0(r, s, o, S), n_reads,
                 3, "auto")


@pytest.mark.cuda
def test_mec_sync_chase_and_limits(cuda):
    """The barrier probe runs at 1, 2 and 16 CTAs, and a CTA of the smem
    design takes more than 200,000 bytes of shared memory."""
    from volcanosv_tpu_torch.ops import cuda_build
    lib = cuda_build.lib("mec")
    assert phase.mec_smem_bytes(lib) > 200_000
    out = torch.zeros(2, dtype=torch.int64, device=cuda)
    for ctas in (1, 2, 16):
        cuda_build.check(lib.mec_sync_chase(
            ctas, 1000, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "chase", "mec")
        torch.cuda.synchronize()
        assert int(out[0]) > 0 and int(out[1]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 12, 16])
def test_canonical_hashes_kernel_matches_plain(cuda, k):
    """Random int32 hashes over the whole range (negative values, bits
    above 2k): the kernel equals the plain version on the card and on the
    CPU."""
    rng = np.random.default_rng(k)
    h = rng.integers(-2**31, 2**31, (513, 4099)).astype(np.int32)
    x = torch.from_numpy(h).to(cuda)
    got = _launched(kmer.canonical_hashes,
                    lambda: kmer.canonical_hashes(x, k))
    assert got.dtype == torch.int32 and got.shape == x.shape
    assert torch.equal(got, kmer._canonical_hashes_plain(x, k))
    assert torch.equal(got.cpu(), kmer.canonical_hashes(x.cpu(), k))


@pytest.mark.cuda
def test_mec_and_canonical_wrappers_reject_bad_inputs(cuda):
    r, s, o, S, n_reads, _n_iter, _h, _seed = mec_edge_case("n_iter_1")
    h0 = _h0(r, s, o, S)
    r, s, o, h0 = (torch.from_numpy(x).to(cuda) for x in (r, s, o, h0))
    for args in ((r, s, o.int(), h0), (r.float(), s, o, h0),
                 (r, s, o, h0.long()), (r, s.cpu(), o, h0),
                 (r, s, o, h0.cpu()), (r, s, o, h0[0]),
                 (r, s, o, h0.T.contiguous().T), (r[:-1], s, o, h0)):
        with pytest.raises(ValueError):
            phase._mec_phase(*args, n_reads=n_reads, n_iter=1)
    for kw in (dict(n_iter=-1), dict(n_iter=1, branch="warp")):
        with pytest.raises(ValueError):
            phase._mec_phase(r, s, o, h0, n_reads=n_reads, **kw)
    x = torch.zeros(64, dtype=torch.int32, device=cuda)
    for args in ((x, 0), (x, 17), (x.long(), 12), (x[::2], 12)):
        with pytest.raises(ValueError):
            kmer.canonical_hashes(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 12])
def test_kmer_ops_card_equal_cpu(cuda, k):
    """Every ops/kmer.py function on (64, 4096) codes with N runs and
    padding, and on four count tables at 4^k: equal outputs."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (64, 4096)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.01] = 4
    for b in range(64):
        codes[b, int(rng.integers(2048, 4097)):] = 4
    out = {}
    for dev in (cuda, "cpu"):
        c = torch.from_numpy(codes).to(dev)
        h, v = kmer.kmer_hashes(c, k)
        tabs = torch.stack([kmer.count_kmers_dense(h[i::4], v[i::4], k)
                            for i in range(4)])
        u = kmer.unique_mask(tabs)
        s, first, runlen = kmer.distinct_runs(h, v)
        out[str(dev)] = [x.cpu() for x in (
            h, v, kmer.canonical_hashes(h, k), tabs, u, s, first, runlen,
            kmer.overlap_scores(s, first, runlen, tabs, u))]
    for g, w in zip(out[str(cuda)], out["cpu"]):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


def _launched(fn, call):
    n = fn.launches
    out = call()
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("k", [6, 12])
def test_kmer_count_kernel_matches_plain(cuda, k):
    """A stream counted chunk by chunk across the seams into one table
    (one launch a chunk) = the plain count of the whole stream; rows with
    lengths added to a table that already holds counts = the plain
    version's."""
    stream, chunks = kmer_count_case(k, k)
    table = torch.zeros(4**k, dtype=torch.int32, device=cuda)
    for c in chunks:
        _launched(kmer.kmer_count_into, lambda: kmer.kmer_count_into(
            table, torch.from_numpy(c).to(cuda)[None], k))
    want = kmer._kmer_count_plain(torch.zeros(4**k, dtype=torch.int32),
                                  torch.from_numpy(stream)[None], k)
    assert torch.equal(table.cpu(), want)
    codes, lens, _ = kmer_vote_case(k + 1, k)
    lens[3] = k - 1
    base = torch.from_numpy(
        np.random.default_rng(k).integers(0, 3, 4**k).astype(np.int32))
    c, ln = torch.from_numpy(codes).to(cuda), torch.from_numpy(lens).to(cuda)
    got = _launched(kmer.kmer_count_into, lambda: kmer.kmer_count_into(
        base.to(cuda), c, k, ln))
    assert torch.equal(got.cpu(), kmer._kmer_count_plain(
        base.clone(), c.cpu(), k, ln.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [6, 12])
def test_kmer_count_kernel_edge_chunks(cuda, k):
    """A 2^17-code chunk of one repeated k-mer (poly-A: hash 0, all its
    atomics on one word), one of poly-T (hash 4^k - 1, the table's last
    word), an all-N row and random rows with N runs across thread and
    block seams, each added to a table that already holds counts: equal
    to the plain version."""
    rng = np.random.default_rng(k + 40)
    L = 1 << 17
    codes = rng.integers(0, 4, (4, L)).astype(np.int8)
    codes[0] = 0
    codes[1] = 3
    codes[2] = 4
    codes[3, 8190:8200] = 4
    codes[3, 16380:16384] = 4
    base = torch.from_numpy(rng.integers(0, 5, 4**k).astype(np.int32))
    for rows in ([0], [1], [2], [0, 1, 2, 3]):
        c = torch.from_numpy(codes[rows]).to(cuda)
        got = _launched(kmer.kmer_count_into, lambda: kmer.kmer_count_into(
            base.to(cuda), c, k))
        want = kmer._kmer_count_plain(base.clone(), c.cpu(), k)
        assert torch.equal(got.cpu(), want)
    assert int(want[0]) >= L - k + 1 and int(want[4**k - 1]) >= L - k + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edge_rows", "zero_tables", "long_row"])
@pytest.mark.parametrize("k", [6, 12])
def test_kmer_unique_mask_and_vote_kernels_match_plain(cuda, k, case):
    """The unique mask of four tables and the vote of 16 reads with the
    edge rows, of the single-block layout (two zero tables), and of a
    2^17-column chunk whose 120 kb read (at k 12) overflows the vote's
    shared memory: equal to the plain versions on the card and on the
    CPU."""
    codes, lens, tables = kmer_vote_case(
        k, k, long_row=case == "long_row", zero_tables=case == "zero_tables")
    c, ln, t = (torch.from_numpy(x).to(cuda) for x in (codes, lens, tables))
    u = _launched(kmer.unique_mask, lambda: kmer.unique_mask(t))
    assert u.dtype == torch.bool
    assert torch.equal(u, kmer._unique_mask_plain(t))
    got = _launched(kmer.kmer_vote, lambda: kmer.kmer_vote(c, ln, k, t, u))
    assert got.dtype == torch.int32 and got.shape == (16, 4)
    assert torch.equal(got, kmer._kmer_vote_plain(c, ln, k, t, u))
    assert torch.equal(got.cpu(), kmer.kmer_vote(
        *(x.cpu() for x in (c, ln)), k, t.cpu(), u.cpu()))
    if case == "long_row" and k == 12:
        h, v = kmer._valid_windows(c[:1], k, ln[:1])
        assert u[:, h[v].long()].any(dim=0).sum() > 8192


@pytest.mark.cuda
@pytest.mark.parametrize("k", [6, 12])
def test_kmer_vote_tile_seams(cuda, k):
    """The vote's tile design across its seams (torch_inputs.py::
    kmer_tile_case: a unique k-mer's run across two seams, one unique
    k-mer in two tiles of a read, reads shorter than k, empty and all-N
    rows, partial, full and one-window last tiles): equal to the plain
    version on the card and on the CPU."""
    codes, lens, tables = kmer_tile_case(k + 7, k)
    c, ln, t = (torch.from_numpy(x).to(cuda) for x in (codes, lens, tables))
    u = kmer.unique_mask(t)
    got = _launched(kmer.kmer_vote, lambda: kmer.kmer_vote(c, ln, k, t, u))
    assert torch.equal(got, kmer._kmer_vote_plain(c, ln, k, t, u))
    assert torch.equal(got.cpu(), kmer.kmer_vote(
        *(x.cpu() for x in (c, ln)), k, t.cpu(), u.cpu()))
    # the homopolymer k-mer's table count (7) enters row 1 once
    runs = 3000 - k + 1
    assert int(got[1, 0]) >= runs + 7


@pytest.mark.cuda
def test_kmer_kernel_wrappers_reject_bad_inputs(cuda):
    codes, lens, tables = kmer_vote_case(4, 6)
    c, ln, t = (torch.from_numpy(x).to(cuda) for x in (codes, lens, tables))
    u = kmer.unique_mask(t)
    table = torch.zeros(4**6, dtype=torch.int32, device=cuda)
    for args in ((table.cpu(), c, 6, None), (table, c, 6, ln.cpu()),
                 (table, c.int(), 6, None), (table, c.T.contiguous().T, 6,
                                             None),
                 (table, c, 16, None), (table[:-1], c, 6, None)):
        with pytest.raises(ValueError):
            kmer.kmer_count_into(*args)
    for bad in (t.long(), t.T.contiguous().T):
        with pytest.raises(ValueError):
            kmer.unique_mask(bad)
    for args in ((c, ln, 6, t, u.cpu()), (c, ln, 6, t.cpu(), u),
                 (c, ln.long(), 6, t, u), (c, ln, 0, t, u),
                 (c, ln, 6, t, u.to(torch.uint8)), (c, ln[:3], 6, t, u)):
        with pytest.raises(ValueError):
            kmer.kmer_vote(*args)


@pytest.mark.cuda
def test_complex_svs_card_equals_cpu(cuda):
    """call_complex_svs on tests/test_complex_sv.py's inv_case (80 kb, 4 INV
    and 3 DUP, HiFi reads at 16x; simulated by the port's `sim`), on the
    card and on the CPU from the same alignments: equal records and
    consumed INS ids, and the pairing's edit distances launched at
    W = 128."""
    from volcanosv_tpu_torch import sim
    from volcanosv_tpu_torch.aligner import Aligner
    from volcanosv_tpu_torch.config import AlignConfig, PipelineConfig
    from volcanosv_tpu_torch.vc.complex_sv import call_complex_svs
    from volcanosv_tpu_torch.vc.large_indel import call_chromosome
    rng = np.random.default_rng(11)
    ref = sim.random_genome(rng, 80_000)
    hap1, hap2, _truth = sim.implant_svs(
        rng, ref, n_del=0, n_ins=0, n_inv=4, n_dup=3,
        min_len=300, max_len=1_200, min_gap=4_000)
    contigs = sim.contigs_from_haplotypes(hap1, hap2, block_size=40_000)
    reads = {n: s for n, s, *_ in sim.simulate_reads(
        rng, {1: hap1, 2: hap2}, coverage=16.0, read_len=9_000,
        read_len_sd=1_000, sub_rate=0.001, indel_rate=0.0003)}

    def by_chrom(seqs, preset):
        al = Aligner(ref, AlignConfig.preset(preset), device=cuda)
        return {"chr1": al.to_bam_records(al.align(list(seqs.items())),
                                          seqs)}
    ctg, rds = by_chrom(contigs, "asm10"), by_chrom(reads, "map-hifi")
    cfg = PipelineConfig.for_dtype("Hifi")
    ins = [r for r in call_chromosome("chr1", ctg["chr1"], ref["chr1"],
                                      contigs, cfg, device=cuda)
           if r.svtype == "INS"]
    out = {}
    for dev in (cuda, "cpu"):
        consumed = set()
        ba.reset_launch_counts()
        recs = call_complex_svs(ctg, ref, cfg, ins_records=ins,
                                reads_by_chrom=rds, consumed_ins=consumed,
                                device=dev)
        out[str(dev)] = ([(r.chrom, r.pos, r.id, r.ref, r.alt, r.gt,
                           list(r.info.items())) for r in recs], consumed)
        if dev == cuda:
            shapes = list(ba.banded_dp.shapes)
    assert out[str(cuda)] == out["cpu"]
    assert {"INV", "DUP"} <= {dict(r[6]).get("SVTYPE")
                              for r in out["cpu"][0]}
    assert any(m == ba.dp_mode(ba.Scores.edit(), with_traceback=False)
               and W == 128 for m, _br, _B, _M, W in shapes), shapes


@pytest.mark.cuda
@pytest.mark.parametrize("M", [512, 1024])
def test_pairing_edit_distances_match_plain(cuda, M):
    """The complex-SV pairing's batches on the golden run: EDIT score-only
    at W = 128 (clip_to = 10), 21 pairs padded to B = 64, in the length
    buckets 512 and 1024; scores equal to banded_dp_plain's for every
    design.  Then edit_distance_pairs(clip_to=10) on 21 haplotype-like
    pairs (0-40 edits apart) in that bucket: card = CPU."""
    from volcanosv_tpu_torch.vc.redundancy import edit_distance_pairs
    W, d_lo, B = 128, -64, 64
    rng = np.random.default_rng(M)
    q, t, qlen, tlen = _pairs(rng, B, M, W, d_lo)
    args = [torch.from_numpy(x).to(cuda) for x in (q, t, qlen, tlen)]
    _check_against_plain(cuda, args, M, W, d_lo, *MODES["edit"])
    bases = np.array(list("ACGT"))
    pairs = []
    for i in range(21):
        a = rng.choice(bases, int(rng.integers(M // 2 + 1, M - 40)))
        b = a.copy()
        for _ in range(2 * i):
            k = int(rng.integers(0, len(b)))
            b = np.delete(b, k) if i % 2 else np.insert(b, k, "A")
        pairs.append(("".join(a), "".join(b)))
    ba.reset_launch_counts()
    got = edit_distance_pairs(pairs, clip_to=10, device=cuda)
    assert ba.banded_dp.shapes == [("edit+score", "warp", B, M, W)]
    want = edit_distance_pairs(pairs, clip_to=10, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert (got <= 10).any() and (got > 10).any()


AVA_GROUP = dict(hap_len=250_000, coverage=14.0, read_len=13_500,
                 read_sd=3_000)
# (seed, ava_group arguments, the pass's budgets)
AVA_CASES = {
    "hifi_250kb": (41, dict(AVA_GROUP, err=0.002), {}),
    "clr": (42, dict(AVA_GROUP, err=0.1), {}),
    "ont": (43, dict(AVA_GROUP, err=0.05), {}),
    "repeats": (44, dict(AVA_GROUP, err=0.002, repeats=30), {}),
    "tandem": (45, dict(hap_len=60_000, coverage=6.0, read_len=12_000,
                        read_sd=500, tandem=20), {}),
    "chunked": (46, dict(AVA_GROUP, err=0.002),
                dict(max_anchors=2_000_000, max_segments=60 * 259 * 2)),
    "one_read": (47, dict(hap_len=20_000, coverage=1.0, read_len=4_000,
                          read_sd=10), {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(AVA_CASES))
def test_ava_kernel_matches_ava_cpp(cuda, name):
    from volcanosv_tpu_torch import native
    from volcanosv_tpu_torch.config import AlignConfig
    seed, args, budgets = AVA_CASES[name]
    reads = ava_group(seed, **args)
    if name == "one_read":
        reads = reads[:1]
    acfg = AlignConfig.preset("ava")
    want = native.ava_overlaps_np(native.get_lib(), reads, acfg)
    before = overlap.ava_overlaps.launches
    got = overlap.ava_overlaps(reads, acfg, cuda, **budgets)
    torch.cuda.synchronize()
    assert overlap.ava_overlaps.launches == before + 1
    n_reads, _n_min, n_anchors, chunks, past_smem = \
        overlap.ava_overlaps.shapes[-1]
    assert n_reads == len(reads)
    for col, g, w in zip(overlap._COLS, got, want):
        assert g.dtype == w.dtype, col
        np.testing.assert_array_equal(g, w, err_msg=col)
    if name == "one_read":
        assert len(want[0]) == 0
    else:
        assert len(want[0]) > 300 and n_anchors > 10**5
    assert (chunks > 1) == (name == "chunked")
    assert (past_smem > 0) == (name == "tandem")


@pytest.mark.cuda
def test_ava_pass_without_minimizers_launches_nothing(cuda):
    """A group whose reads are all shorter than k + w has no minimizers:
    the pass gives no overlaps and launches no kernel, so `.launches`
    stays where it was."""
    from volcanosv_tpu_torch import native
    from volcanosv_tpu_torch.config import AlignConfig
    acfg = AlignConfig.preset("ava")
    rng = np.random.default_rng(48)
    reads = [rng.integers(0, 4, L).astype(np.int8) for L in (0, 10, 18, 18)]
    want = native.ava_overlaps_np(native.get_lib(), reads, acfg)
    before = overlap.ava_overlaps.launches
    got = overlap.ava_overlaps(reads, acfg, cuda)
    torch.cuda.synchronize()
    assert overlap.ava_overlaps.launches == before
    assert overlap.ava_overlaps.shapes[-1][:3] == (len(reads), 0, 0)
    for col, g, w in zip(overlap._COLS, got, want):
        assert g.dtype == w.dtype and len(g) == len(w) == 0, col


@pytest.mark.cuda
def test_run_counts_device_overlap_groups(cuda, tmp_path):
    """`run --device cuda` on a two-chromosome sim finds its read groups'
    overlaps on the card (`overlap_device_groups` and the pass's launches
    move; neither moves on the CPU), and writes the CPU run's bytes."""
    from volcanosv_tpu_torch.cli import main
    from volcanosv_tpu_torch.utils.logging import COUNTS
    sim = ["--length", "50000", "--chroms", "2", "--n_del", "2", "--n_ins",
           "2", "--n_small", "4", "--min_len", "300", "--max_len", "1000",
           "--coverage", "20", "--read_len", "7000", "--seed", "3"]
    assert main(["sim", "-o", str(tmp_path / "sim")] + sim) == 0
    out = {}
    for dev in ("cuda", "cpu"):
        groups = COUNTS["overlap_device_groups"]
        launches = overlap.ava_overlaps.launches
        assert main(["run", "--ref", str(tmp_path / "sim" / "ref.fa"),
                     "--fastq", str(tmp_path / "sim" / "reads.fastq"),
                     "-o", str(tmp_path / dev), "--device", dev]) == 0
        moved = (COUNTS["overlap_device_groups"] - groups,
                 overlap.ava_overlaps.launches - launches)
        if dev == "cuda":
            assert moved[0] >= 2 and moved[0] == moved[1], moved
        else:
            assert moved == (0, 0)
        out[dev] = {name: (tmp_path / dev / name).read_bytes()
                    for name in ("volcanosv_variants.vcf",
                                 "final_contigs.fa")}
    assert out["cuda"] == out["cpu"]
