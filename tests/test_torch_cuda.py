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

The `asm` path's torch-op device functions (the pair-HMM Viterbi, the MEC
votes, the k-mer ops) run the same ops on the card as on the CPU: their
outputs on the card equal the CPU's, the Viterbi's fp32 scores bit for
bit."""
import numpy as np
import pytest
import torch

from volcanosv_tpu_torch.ops import banded_align as ba
from volcanosv_tpu_torch.ops import kmer
from volcanosv_tpu_torch.phasing import phase, realign
from torch_inputs import viterbi_pairs

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
