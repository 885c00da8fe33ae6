"""The port's banded DP and traceback walk (volcanosv_tpu_torch.ops.
banded_align) against the JAX package: the lax.scan oracle, the Pallas
kernel in interpret mode, and the jitted device walk.  Integer outputs must
be exactly equal (tolerance 0); tracebacks are compared through the CIGARs
they decode to."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_pallas_dp import _case
from volcanosv_tpu.ops import banded_align as ref
from volcanosv_tpu.ops.pallas import banded_align_pallas
from volcanosv_tpu_torch.ops import banded_align as port

DUAL = dict(match=2, mismatch=-4, gap_open=-4, gap_extend=-2,
            gap_open2=-24, gap_extend2=-1)
GAPPY = dict(match=2, mismatch=-4, gap_open=0, gap_extend=-1)


def _t(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x, dtype))


def _port_dp(q, t, qlen, tlen, W, d_lo, scores: dict, **kw):
    return port.banded_dp(_t(q, np.int8), _t(t, np.int8), _t(qlen, np.int32),
                          _t(tlen, np.int32), W, d_lo, port.Scores(**scores),
                          **kw)


def _host_cigars(tb_scan, qlen, tlen, d_lo):
    return [ref.traceback_cigar(tb_scan[:, b], int(qlen[b]), int(tlen[b]),
                                d_lo) for b in range(len(qlen))]


# mode → (DP flags, scores); "free_t_start" exists in the scan only
MODES = {
    "traceback": ({}, {}),
    "dual_affine": ({}, DUAL),
    "row0": (dict(with_traceback=False, row0_scores=True), {}),
    "edit": (dict(with_traceback=False),
             dict(match=0, mismatch=-1, gap_open=0, gap_extend=-1)),
    "free_t_end": (dict(with_traceback=False, free_t_end=True), {}),
    "free_t_start": (dict(free_t_start=True), {}),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_dp_matches_scan_and_pallas(mode):
    kw, sc = MODES[mode]
    W, d_lo, M, B = 128, -64, 128, 3
    rng = np.random.default_rng(21)
    q, t, qlen, tlen = _case(rng, B, M, W, d_lo)
    s_ref, tb_ref, ej_ref, r0_ref = ref.banded_align_scan(
        q, t, qlen, tlen, W=W, d_lo=d_lo, scores=ref.Scores(**sc),
        row0_scores=True, **{k: v for k, v in kw.items()
                              if k != "row0_scores"})
    s, ej, tb, r0 = _port_dp(q, t, qlen, tlen, W, d_lo, sc, **kw)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(ej.numpy(), np.asarray(ej_ref))
    if r0 is not None:
        for b in range(B):
            np.testing.assert_array_equal(r0.numpy()[:qlen[b], b],
                                          np.asarray(r0_ref)[:qlen[b], b])
    if tb is not None and mode != "free_t_start":
        got = port.banded_align_cigars(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                       scores=port.Scores(**sc),
                                       device="cpu")
        assert got == _host_cigars(np.asarray(tb_ref), qlen, tlen, d_lo)
    if tb is not None:
        # on inputs padded with code 4 the traceback bytes agree too, and
        # the host walks decode them identically (free_t_start: to end_j)
        np.testing.assert_array_equal(
            tb.numpy(), np.asarray(tb_ref).transpose(1, 0, 2))
        fts = mode == "free_t_start"
        for b in range(B):
            end = int(ej[b]) if fts else None
            assert port.traceback_cigar(
                tb.numpy()[b], int(qlen[b]), int(tlen[b]), d_lo, end_j=end,
                free_t_start=fts) == ref.traceback_cigar(
                np.asarray(tb_ref)[:, b], int(qlen[b]), int(tlen[b]), d_lo,
                end_j=end, free_t_start=fts)
    if mode == "free_t_start":
        return
    out = banded_align_pallas(q, t, qlen, tlen, W=W, d_lo=d_lo,
                              scores=ref.Scores(**sc), interpret=True,
                              **{k: v for k, v in kw.items()
                                 if k != "free_t_start"})
    np.testing.assert_array_equal(s.numpy(), np.asarray(out[0]))
    if not kw.get("free_t_end"):
        np.testing.assert_array_equal(ej.numpy(), np.asarray(out[2]))
    if r0 is not None:
        # rows whose diagonal-0 cell lies past tlen hold each backend's
        # sentinel (NEG vs the Pallas NEG16); compare the real cells
        r0_pl = np.asarray(out[3])
        for b in range(B):
            n = min(qlen[b], tlen[b])
            np.testing.assert_array_equal(r0.numpy()[:n, b], r0_pl[:n, b])
    if tb is not None:
        tb_pl = np.asarray(out[1])
        want = [ref.traceback_cigar(tb_pl[:, :, b], int(qlen[b]),
                                    int(tlen[b]), d_lo) for b in range(B)]
        assert port.banded_align_cigars(
            q, t, qlen, tlen, W=W, d_lo=d_lo, scores=port.Scores(**sc),
            device="cpu") == want


def test_free_t_end_tie_follows_scan():
    """Row 0: q = A, t = CA; ending at column 0 (mismatch, -4) and at
    column 1 (deletion + match, -4) tie.  The port follows the scan (the
    smallest column); the Pallas kernel picks the largest."""
    W, d_lo, M, B = 128, -64, 8, 2
    rng = np.random.default_rng(2)
    q, t, qlen, tlen = _case(rng, B, M, W, d_lo)
    q[0], t[0] = 4, 4
    q[0, 0], t[0, :2] = 0, (1, 0)
    qlen[0], tlen[0] = 1, 2
    s_ref, _, ej_ref = ref.banded_align_scan(
        q, t, qlen, tlen, W=W, d_lo=d_lo, free_t_end=True,
        with_traceback=False)
    s, ej, _, _ = _port_dp(q, t, qlen, tlen, W, d_lo, {},
                           with_traceback=False, free_t_end=True)
    assert int(s[0]) == -4 and int(ej[0]) == 0
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(ej.numpy(), np.asarray(ej_ref))
    s_pl, _, ej_pl = banded_align_pallas(
        q, t, qlen, tlen, W=W, d_lo=d_lo, free_t_end=True,
        with_traceback=False, interpret=True)
    assert int(s_pl[0]) == -4 and int(ej_pl[0]) == 1


@pytest.mark.parametrize("scores", [{}, DUAL], ids=["affine", "dual"])
def test_plain_dp_matches_full_dp(scores):
    rng = np.random.default_rng(9)
    W, d_lo, M, B = 64, -32, 40, 4
    q, t, qlen, tlen = _case(rng, B, M + 64, W, d_lo)
    q, qlen = q[:, :M].copy(), np.minimum(qlen, M)
    tlen = np.minimum(tlen, M + d_lo + W - 1)
    s, _, _, _ = _port_dp(q, t, qlen, tlen, W, d_lo, scores,
                          with_traceback=False)
    for b in range(B):
        qb, tb = q[b, :qlen[b]], t[b, :tlen[b]]
        want = ref.full_affine_score_np(qb, tb, ref.Scores(**scores))
        assert port.full_affine_score_np(qb, tb, port.Scores(**scores)) \
            == want
        assert int(s[b]) == want, b


def _scan_tb(q, t, qlen, tlen, W, d_lo, sc):
    _s, tb, _e = ref.banded_align_scan(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                       scores=ref.Scores(**sc))
    return np.asarray(tb)                       # (M, B, W)


@pytest.mark.parametrize("scores", [{}, DUAL], ids=["affine", "dual"])
def test_walk_plain_matches_walk_device(scores):
    W, d_lo, M, B = 64, -32, 128, 12
    q, t, qlen, tlen = _case(np.random.default_rng(5), B, M, W, d_lo,
                             indel_rate=0.06)
    tb = _scan_tb(q, t, qlen, tlen, W, d_lo, scores)
    n_steps, _full = port.walk_steps(M, W, qlen, tlen)
    want, want_done = ref._walk_device(
        jnp.asarray(tb.transpose(0, 2, 1)), jnp.asarray(qlen),
        jnp.asarray(tlen), d_lo, n_steps, pack=True)
    got, done = port.tb_walk_plain(_t(tb.transpose(1, 0, 2), np.uint8),
                                   _t(qlen, np.int32), _t(tlen, np.int32),
                                   d_lo, n_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(done.numpy(), np.asarray(want_done))
    assert bool(done.all())


def test_gap_dense_walk_takes_full_bound():
    """Unrelated pairs under zero-open gaps align as gaps only, and every
    gap base is a run of its own (the open flag wins the tie), costing two
    walk steps: the bucketed step bound leaves the walks unfinished, the
    dispatcher re-walks at the full bound, and the CIGARs equal the host
    walk's.  The packed streams at both bounds are bit-equal to the JAX
    device walk."""
    W, d_lo, M, B = 64, -32, 128, 4
    L = 100
    q = np.full((B, M), 4, np.int8)
    t = np.full((B, M + W), 4, np.int8)
    q[:, :L] = 0
    t[:, :L] = 1
    qlen = np.full(B, L, np.int32)
    tlen = np.full(B, L, np.int32)
    tb = _scan_tb(q, t, qlen, tlen, W, d_lo, GAPPY)
    n_steps, full = port.walk_steps(M, W, qlen, tlen)
    assert n_steps < full
    tb_port = _t(tb.transpose(1, 0, 2), np.uint8)
    for steps, finished in ((n_steps, False), (full, True)):
        got, done = port.tb_walk_plain(tb_port, _t(qlen, np.int32),
                                       _t(tlen, np.int32), d_lo, steps)
        want, want_done = ref._walk_device(
            jnp.asarray(tb.transpose(0, 2, 1)), jnp.asarray(qlen),
            jnp.asarray(tlen), d_lo, steps, pack=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(done.numpy(), np.asarray(want_done))
        assert bool(done.all()) is finished
    cigs = port.banded_align_cigars(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                    scores=port.Scores(**GAPPY), device="cpu")
    assert cigs == _host_cigars(tb, qlen, tlen, d_lo)


def _long_gap_case(rng, B, M, W, d_lo):
    """_case pairs, most with one implanted gap of W/4 .. W/2-8 bases (an
    insertion or a deletion), lengths kept in the band."""
    q, t, qlen, tlen = _case(rng, B, M, W, d_lo)
    for b in range(B):
        ql = int(qlen[b])
        k = int(rng.integers(W // 4, W // 2 - 7))
        at = int(rng.integers(0, ql - k))
        seq = q[b, :ql].copy()
        seq = np.delete(seq, np.arange(at, at + k)) if b % 2 else \
            np.insert(seq, at, rng.integers(0, 4, k).astype(np.int8))
        tl = int(np.clip(len(seq), ql + d_lo + 1, ql + d_lo + W - 1))
        seq = np.concatenate([seq, np.zeros(max(0, tl - len(seq)), np.int8)])
        t[b] = 4
        t[b, :tl] = seq[:tl]
        tlen[b] = tl
    return q, t, qlen, tlen


def _random_tb(rng, B, M, W, stuck):
    """(M, B, W) random traceback bytes: gap choices (1-4) 5% each, open
    flags 3% each, so that gap runs average ~30 steps; with `stuck`, a few
    cells carry a choice 5-7 (the walk stops moving there) and bit 7, which
    the walk ignores."""
    u = rng.random((M, B, W))
    choice = np.zeros((M, B, W), np.uint8)
    for c in range(1, 5):
        choice[(u >= 1 - c * 0.05) & (u < 1 - (c - 1) * 0.05)] = c
    if stuck:
        choice[u < 3e-3] = 5 + (rng.random(int((u < 3e-3).sum())) * 3
                                ).astype(np.uint8)
    flags = sum((rng.random((M, B, W)) < 0.03).astype(np.uint8) * bit
                for bit in (8, 16, 32, 64))
    tb = choice | flags.astype(np.uint8)
    if stuck:
        tb |= (rng.random((M, B, W)) < 0.1).astype(np.uint8) * 128
    return tb


@pytest.mark.parametrize("cut", [False, True], ids=["full", "cut"])
@pytest.mark.parametrize("source", ["dp_affine", "dp_dual", "random",
                                    "random_stuck"])
def test_walk_plain_matches_walk_device_on_hard_walks(source, cut):
    """The walks the CUDA kernel's tiles find hardest, against the JAX
    device walk: long I/D runs (DP tracebacks of pairs with a long gap;
    dual-affine ones walk states 3 and 4), random tracebacks (runs that
    leave the band, stuck walks, lengths 0 and 1 and past the band), at
    the full step bound and at a bound that cuts about half the walks
    short (done = false, the same stream)."""
    W, d_lo, M, B = 64, -32, 96, 8
    rng = np.random.default_rng(["dp_affine", "dp_dual", "random",
                                 "random_stuck"].index(source))
    if source.startswith("dp"):
        sc = DUAL if source == "dp_dual" else {}
        q, t, qlen, tlen = _long_gap_case(rng, B, M, W, d_lo)
        tb = _scan_tb(q, t, qlen, tlen, W, d_lo, sc)
    else:
        tb = _random_tb(rng, B, M, W, source == "random_stuck")
        qlen = rng.integers(0, M + 1, B).astype(np.int32)
        tlen = np.clip(qlen + d_lo + rng.integers(-8, W + 8, B), 0,
                       None).astype(np.int32)
        qlen[:3], tlen[:3] = (0, 1, 0), (0, 1, 5)
    _n, full = port.walk_steps(M, W, qlen, tlen)
    tb_port = _t(tb.transpose(1, 0, 2), np.uint8)
    steps = full
    if cut:
        ops = port._unpack_ops(port.tb_walk_plain(
            tb_port, _t(qlen, np.int32), _t(tlen, np.int32), d_lo,
            full)[0].numpy())
        lengths = port.walk_lengths(ops)
        steps = max(4, int(np.median(lengths)) // 4 * 4)
    got, done = port.tb_walk_plain(tb_port, _t(qlen, np.int32),
                                   _t(tlen, np.int32), d_lo, steps)
    want, want_done = ref._walk_device(
        jnp.asarray(tb.transpose(0, 2, 1)), jnp.asarray(qlen),
        jnp.asarray(tlen), d_lo, steps, pack=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(done.numpy(), np.asarray(want_done))
    if cut:
        assert not bool(done.all())
    elif source.startswith("dp"):
        assert bool(done.all())
        runs = port._rle_columns(port._unpack_ops(got.numpy()), B)
        assert max(n for r in runs for o, n in r if o) >= W // 4 - 2


def test_walk_branch_names_on_cpu():
    """On the CPU every design name runs the plain walk; others raise."""
    tb = _t(_random_tb(np.random.default_rng(3), 2, 16, 32, False)
            .transpose(1, 0, 2), np.uint8)
    ln = _t(np.array([16, 9]), np.int32)
    want = port.tb_walk_plain(tb, ln, ln, -16, 64)
    for br in port.WALK_BRANCHES:
        got = port.tb_walk(tb, ln, ln, -16, 64, branch=br)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        port.tb_walk(tb, ln, ln, -16, 64, branch="block")


def test_dispatchers_match_reference_on_cpu():
    """Padded batches as the aligner and redundancy removal build them."""
    rng = np.random.default_rng(17)
    W, d_lo, M, B = 128, -64, 256, 5
    q, t, qlen, tlen = _case(rng, B, M, W, d_lo)
    q, t, qlen, tlen, _ = port.pad_batch_pow2(q, t, qlen, tlen)
    np.testing.assert_array_equal(
        port.banded_row0_auto(q, t, qlen, tlen, W=W, d_lo=d_lo,
                              device="cpu")[:, :B]
        * (np.arange(M)[:, None] < qlen[None, :B]),
        np.asarray(ref.banded_row0_auto(q, t, qlen, tlen, W=W, d_lo=d_lo))
        [:, :B] * (np.arange(M)[:, None] < qlen[None, :B]))
    np.testing.assert_array_equal(
        port.edit_distance_batch_auto(q, t, qlen, tlen, W=W, device="cpu"),
        np.asarray(ref.edit_distance_batch_auto(q, t, qlen, tlen, W=W)))


def test_banded_align_auto_matches_reference_on_cpu():
    """Scores, end columns and each row's traceback CIGAR."""
    rng = np.random.default_rng(23)
    W, d_lo = 128, -64
    q, t, qlen, tlen = _case(rng, 6, 192, W, d_lo, indel_rate=0.06)
    s, tb_get, ej = port.banded_align_auto(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                           device="cpu")
    rs, rtb_get, rej = ref.banded_align_auto(q, t, qlen, tlen, W=W,
                                             d_lo=d_lo)
    np.testing.assert_array_equal(s, np.asarray(rs))
    np.testing.assert_array_equal(ej, np.asarray(rej))
    for b in range(len(q)):
        assert port.traceback_cigar(tb_get(b), int(qlen[b]), int(tlen[b]),
                                    d_lo) == \
            ref.traceback_cigar(rtb_get(b), int(qlen[b]), int(tlen[b]),
                                d_lo=d_lo)


def test_cpu_path_counts_no_launches():
    port.reset_launch_counts()
    q, t, qlen, tlen = _case(np.random.default_rng(1), 2, 64, 64, -32)
    port.banded_align_cigars(q, t, qlen, tlen, W=64, d_lo=-32, device="cpu")
    assert port.banded_dp.launches == 0 and port.tb_walk.launches == 0
    assert port.banded_dp.shapes == []


def test_wrappers_refuse_other_devices():
    q = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    ln = torch.ones(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        port.banded_dp(q, q, ln, ln, 64, -32, port.Scores())
    with pytest.raises(ValueError):
        port.tb_walk(torch.zeros((2, 8, 64), dtype=torch.uint8,
                                 device="meta"), ln, ln, -32, 64)

