"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked `cuda` and skips where CUDA is absent.
The file imports neither jax nor the JAX package, so it runs on a GPU host
without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Band widths cover the path's range (32 … 4096), every DP mode, both of the
kernel's designs where both take the band (W <= 512: a warp per alignment,
or a block), batches of 1 to 517 alignments, and the walk; integer outputs
and the traceback bytes of rows < qlen must be bit-equal (tolerance 0)."""
import numpy as np
import pytest
import torch

from volcanosv_tpu_torch.ops import banded_align as ba

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


def _check_against_plain(cuda, args, M, W, d_lo, mode):
    """Every design that takes W against the plain version: scores, end
    columns, row0 and traceback bytes of rows < qlen; then the walk over
    the kernel's traceback against the plain walk over the plain one."""
    kw, sc = MODES[mode]
    p = ba.banded_dp_plain(*args, W, d_lo, sc, **kw)
    rows = torch.arange(M, device=cuda)[None, :] < args[2][:, None]   # (B, M)
    branches = ["auto", "warp", "block"] if W <= 512 else ["auto", "block"]
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
    assert ba.banded_dp.shapes[0] == (
        ba.dp_mode(sc, **kw), args[0].shape[0], M, W)
    if auto[2] is not None and mode != "free_t_start":
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
    _check_against_plain(cuda, args, M, W, d_lo, mode)


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
    _check_against_plain(cuda, args, M, W, d_lo, mode)


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
    with pytest.raises(ValueError):
        ba.tb_walk(torch.zeros((2, 8, 64), dtype=torch.uint8, device=cuda),
                   ln, ln, -32, 6)                               # not 4k steps
