"""The coverage kernels' designs (csrc/coverage_hmm.cu) checked on the CPU,
where no kernel runs: their splits (`flagger.coverage_plan`,
`flagger.viterbi_plan`) and numpy models of their algebra, held to the plain
versions and to the JAX package.

- The forward-backward model walks the kernel's steps in float32 and log2
  units: each segment's transfer matrix (rows kept at a max of 0 with their
  own scale), the boundary walks, each segment's own windows.  It is held
  to a float64 forward-backward and to the JAX package's posteriors within
  tests/test_torch_qc.py's tolerance (1e-5, or twice the JAX package's own
  distance from float64).
- The Viterbi model packs each window's backpointers in ceil(log2 S) bits a
  state, composes each backtrace segment's map of states, walks the maps
  from the last window's argmax, then each segment's windows: labels equal
  to `_viterbi_plain`'s and to the JAX package's.

Both run on ragged, tie-rich batches (tests/torch_inputs.py::hmm_tie_case)
at T around the plans' segment lengths, and with a transition matrix of
-inf entries (stay = 1), where a scaled linear-space forward-backward (the
other design the kernel could take) loses the posteriors."""
import numpy as np
import pytest
import torch

from torch_inputs import hmm_tie_case
from volcanosv_tpu.qc import flagger as ref
from volcanosv_tpu_torch.qc import flagger as port

ATOL = 1e-5
LOG2E = np.float32(1.4426950408889634)
F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lse2(x: np.ndarray, axis: int) -> np.ndarray:
    """log2(sum 2^x) over `axis` as the kernel takes it: the max m (0 where
    |m| is infinite), then log2(sum 2^(x - m)) + m, in float32."""
    m = x.max(axis, keepdims=True)
    m = np.where(np.isinf(m), F32(0), m)
    with np.errstate(divide="ignore"):
        return (np.log2(np.exp2(x - m).sum(axis, keepdims=True)) + m
                ).squeeze(axis)


def _normalise(v: np.ndarray) -> np.ndarray:
    """v less its max over the last axis (left where every entry is -inf)."""
    m = v.max(-1, keepdims=True)
    return v - np.where(m == -np.inf, F32(0), m)


def _emission2(e: np.ndarray) -> np.ndarray:
    return (e - e.max(-1, keepdims=True)) * LOG2E


def segmented_posteriors(emit, logA, logpi, plan) -> np.ndarray:
    """The forward-backward kernel's algebra on (T, B, S) float32 arrays:
    segments of plan.seg windows."""
    emit = np.asarray(emit, F32)
    T, B, S = emit.shape
    L, P = plan.seg, plan.segs
    A = np.asarray(logA, F32) * LOG2E
    alpha0 = _normalise(np.asarray(logpi, F32) * LOG2E + _emission2(emit[0]))
    span = [(max(k * L, 1), min(T, (k + 1) * L)) for k in range(P)]
    # (1) each segment's transfer matrix, rows at a max of 0 and a scale
    Ms = []
    for lo, hi in span:
        M = np.where(np.eye(S, dtype=bool), F32(0), F32(-np.inf))
        M = np.broadcast_to(M, (B, S, S)).copy()
        scale = np.zeros((B, S), F32)
        for t in range(lo, hi):
            N = _lse2(M[:, :, :, None] + A[None, None], 2) \
                + _emission2(emit[t])[:, None, :]
            m = N.max(2)
            scale += np.where(m == -np.inf, F32(0), m)
            M = _normalise(N)
        Ms.append(M + scale[:, :, None])
    # (2) the boundaries: alpha into and beta out of each segment
    a = [alpha0] + [None] * (P - 1)
    for k in range(1, P):
        a[k] = _normalise(_lse2(a[k - 1][:, :, None] + Ms[k - 1], 1))
    b = [None] * (P - 1) + [np.zeros((B, S), F32)]
    for k in range(P - 1, 0, -1):
        b[k - 1] = _normalise(_lse2(Ms[k] + b[k][:, None, :], 2))
    # (3) each segment's windows
    out = np.zeros((T, B, S), F32)
    for k, (lo, hi) in enumerate(span):
        al = a[k]
        if k == 0:
            out[0] = al
        for t in range(lo, hi):
            al = _normalise(_lse2(al[:, :, None] + A, 1) + _emission2(emit[t]))
            out[t] = al
        be = b[k]
        start = k * L
        for t in range(hi - 1, start - 1, -1):
            if t < hi - 1:
                y = _emission2(emit[t + 1]) + be
                be = _normalise(_lse2(A[None] + y[:, None, :], 2))
            p = np.exp2(_normalise(out[t] + be))
            out[t] = p / p.sum(-1, keepdims=True)
    return out


def linear_posteriors(emit, logA, logpi) -> np.ndarray:
    """Rabiner's scaled forward-backward in float32 linear space, each
    vector scaled to a sum of 1 and each window's emissions to a max of 1."""
    emit = np.asarray(emit, F32)
    T, B, S = emit.shape
    A = np.exp(np.asarray(logA, F32))
    E = np.exp(emit - emit.max(-1, keepdims=True))
    alpha = np.zeros((T, B, S), F32)
    a = np.exp(np.asarray(logpi, F32)) * E[0]
    alpha[0] = a / a.sum(-1, keepdims=True)
    for t in range(1, T):
        a = (alpha[t - 1] @ A) * E[t]
        alpha[t] = a / a.sum(-1, keepdims=True)
    out = np.zeros_like(alpha)
    be = np.ones((B, S), F32)
    for t in range(T - 1, -1, -1):
        if t < T - 1:
            be = (E[t + 1] * be) @ A.T
            be = be / be.sum(-1, keepdims=True)
        p = alpha[t] * be
        out[t] = p / p.sum(-1, keepdims=True)
    return out


def segmented_viterbi(emit, logA, logpi, plan) -> np.ndarray:
    """The Viterbi kernel's algebra: the forward walk in float32 with the
    plain version's add order, backpointers packed ceil(log2 S) bits a
    state, the backtrace over plan.segs segments of plan.seg windows.
    Returns (B, T) int8."""
    emit = np.asarray(emit, F32)
    T, B, S = emit.shape
    bits = 1 if S <= 2 else 2 if S <= 4 else 3
    mask = (1 << bits) - 1
    shift = bits * np.arange(S, dtype=np.int64)
    delta = np.asarray(logpi, F32) + emit[0]
    words = np.zeros((T, B), np.int64)
    for t in range(1, T):
        v = (delta[:, :, None] + np.asarray(logA, F32)) + emit[t][:, None, :]
        arg = v.argmax(1)                          # the first on ties
        delta = v.max(1)
        words[t] = (arg << shift).sum(1)
    L, Q = plan.seg, plan.segs
    rows = np.arange(B)

    def back(w, st):                    # the state at t - 1 from t's word
        return (w >> (bits * st)) & mask

    maps = [None] * Q
    for q in range(1, Q):
        st = np.broadcast_to(np.arange(S), (B, S)).copy()
        for t in range(min(T, (q + 1) * L) - 1, q * L - 1, -1):
            st = back(words[t][:, None], st)
        maps[q] = st
    ends = [None] * (Q - 1) + [delta.argmax(1)]
    for q in range(Q - 1, 0, -1):
        ends[q - 1] = maps[q][rows, ends[q]]
    labels = np.zeros((B, T), np.int8)
    for q in range(Q):
        st = ends[q]
        for t in range(min(T, (q + 1) * L) - 1, q * L - 1, -1):
            labels[:, t] = st
            st = back(words[t], st)
    return labels


def _segment_edges(plan_fn, S: int, B: int, near: int) -> list[int]:
    """T at the segment edges of its own plan (the segment length follows
    T): 1; the most windows in one segment (L); the first two segments
    (L + 1); the first last segment of one window; and from `near` on, the
    first T whose last segment is full (PL), one window short (PL - 1)
    and of one window."""
    plans = {T: plan_fn(B, T, S) for T in range(1, 8 * near)}
    last = {T: (p.segs, p.seg, T - (p.segs - 1) * p.seg)
            for T, p in plans.items()}
    edges = {1, max(T for T, (P, _, _) in last.items() if P == 1),
             min(T for T, (P, _, _) in last.items() if P == 2),
             min(T for T, (P, _, n) in last.items() if P > 1 and n == 1)}
    for want in (lambda L: L, lambda L: L - 1, lambda L: 1):
        edges.add(min(T for T, (P, L, n) in last.items()
                      if T >= near and P > 1 and L > 1 and n == want(L)))
    return sorted(edges)


def test_segment_edges_found():
    """The edges the model tests run at, for each plan at S = 4."""
    assert _segment_edges(port.coverage_plan, 4, 5, 150) == \
        [1, 2, 150, 151]
    assert _segment_edges(port.viterbi_plan, 4, 5, 150) == \
        [1, 16, 17, 150, 159, 241]


def _inputs(means, tau, cov, valid, stay=port.STAY):
    hmm = port.CoverageHMM(means=np.asarray(means), tau=tau, stay=stay)
    emit, logA, logpi = (x.numpy() for x in hmm._emissions(
        cov, valid, torch.device("cpu")))
    return hmm, emit, logA, logpi


def _check_posteriors(means, tau, cov, valid, stay=port.STAY):
    hmm, emit, logA, logpi = _inputs(means, tau, cov, valid, stay)
    T, B, S = emit.shape
    got = segmented_posteriors(emit, logA, logpi, port.coverage_plan(B, T, S))
    exact = port.posteriors_float64(hmm, cov, valid).transpose(1, 0, 2)
    want = ref.CoverageHMM(means=np.asarray(means), tau=tau,
                           stay=stay).posteriors(cov, valid)
    ref_err = float(np.abs(want.transpose(1, 0, 2) - exact).max())
    tol = max(ATOL, 2 * ref_err)
    assert np.isfinite(got).all()
    assert float(np.abs(got - exact).max()) <= tol
    np.testing.assert_allclose(got.transpose(1, 0, 2), want, rtol=0,
                               atol=tol)


def _check_viterbi(means, tau, cov, valid, stay=port.STAY):
    hmm, emit, logA, logpi = _inputs(means, tau, cov, valid, stay)
    T, B, S = emit.shape
    got = segmented_viterbi(emit, logA, logpi, port.viterbi_plan(B, T, S))
    plain = port._viterbi_plain(*(torch.from_numpy(x)
                                  for x in (emit, logA, logpi))).numpy()
    want = ref.CoverageHMM(means=np.asarray(means), tau=tau,
                           stay=stay).viterbi(cov, valid)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,T,S,want", [
    # qc's launch shape and the chromosome-scale batch (chip_smoke phase 6)
    (28, 877, 4, (7, 126, 1)), (190, 4970, 4, (39, 128, 2)),
    # T = 1, and L - 1, L, L + 1 and 2L + 1 of the chromosome's L = 39
    (1, 1, 4, (1, 1, 1)), (9, 38, 3, (1, 38, 1)), (9, 39, 3, (1, 39, 1)),
    (9, 40, 3, (1, 40, 1)), (9, 79, 3, (1, 79, 1)),
    (500, 40, 4, (1, 40, 4)), (3, 205_000, 8, (1602, 128, 1))])
def test_coverage_plan(B, T, S, want):
    """The forward-backward's split: at most COVERAGE_SEGS segments a
    contig, covering T exactly; contigs packed only where B outnumbers the
    SMs; the shared memory a CTA."""
    p = port.coverage_plan(B, T, S)
    assert (p.seg, p.segs, p.contigs) == want
    assert (p.segs - 1) * p.seg < T <= p.segs * p.seg
    assert p.segs <= port.COVERAGE_SEGS
    assert p.threads == p.contigs * p.segs <= port.COVERAGE_THREADS
    assert p.ctas * p.contigs >= B > (p.ctas - 1) * p.contigs
    assert p.smem == p.threads * (S * S + 2 * S) * 4 <= 227 * 1024
    assert p.scratch == 0


@pytest.mark.parametrize("B,T,S,want", [
    (28, 877, 4, (28, 32, 8, 8296, 0)),
    (190, 4970, 4, (156, 32, 8, 41040, 0)),
    (9, 4970, 8, (156, 32, 8, 160320, 0)),
    (1, 1, 2, (1, 1, 1, 17, 0)), (2, 33, 5, (11, 3, 2, 296, 0)),
    (9, 31, 3, (16, 2, 8, 328, 0)), (9, 32, 3, (16, 2, 8, 336, 0)),
    (9, 65, 3, (13, 5, 8, 728, 0)),
    # past VITERBI_SMEM for one contig: the backpointers in a scratch
    (3, 205_000, 4, (2412, 85, 3, 1280, 615_000))])
def test_viterbi_plan(B, T, S, want):
    """The Viterbi's split: VITERBI_CONTIGS contigs a CTA while their
    backpointers fit, the backtrace over segments of at least
    VITERBI_MIN_SEG windows covering T exactly."""
    p = port.viterbi_plan(B, T, S)
    assert (p.seg, p.segs, p.contigs, p.smem, p.scratch) == want
    assert (p.segs - 1) * p.seg < T <= p.segs * p.seg
    assert p.threads == p.contigs * p.segs <= port.COVERAGE_THREADS
    assert p.smem <= 227 * 1024


@pytest.mark.parametrize("n_states", [3, 4, 5])
@pytest.mark.parametrize("which", ["posteriors", "viterbi"])
def test_segment_edges_on_ties(which, n_states):
    """Both models on tie-rich, ragged batches (an all-padded row, two
    states of one mean) at each plan's segment edges (`_segment_edges`:
    one segment, two, a last segment of one window, full, one short) and
    at 150 windows."""
    rng = np.random.default_rng(40 + n_states)
    plan_fn, check = {"posteriors": (port.coverage_plan, _check_posteriors),
                      "viterbi": (port.viterbi_plan, _check_viterbi)}[which]
    for T in _segment_edges(plan_fn, n_states, 5, 150) + [150]:
        check(*hmm_tie_case(rng, n_states, 5, T))


@pytest.mark.parametrize("T,seg", [(877, 7), (4915, 39)])
@pytest.mark.parametrize("which", ["posteriors", "viterbi"])
def test_models_at_real_plans(which, T, seg):
    """Both models at the split a real shape takes, so that each segment
    carries its scale (or composes its map) over many windows: qc's T of
    877 (the forward-backward's L 7) and a chromosome contig's 4915 (L 39),
    three tie-rich contigs."""
    plan_fn, check = {"posteriors": (port.coverage_plan, _check_posteriors),
                      "viterbi": (port.viterbi_plan, _check_viterbi)}[which]
    assert port.coverage_plan(3, T, 4).seg == seg
    assert plan_fn(3, T, 4).seg >= 7
    check(*hmm_tie_case(np.random.default_rng(T), 4, 3, T))


def _regime_change(lam=30.0, first=60, second=100):
    """One contig of `first` windows at haploid coverage, then `second` at
    twice it: with stay = 1 no path changes state, so every window's
    posterior is the whole contig's best state (collapsed here), which the
    first windows weigh against by 550 log units."""
    cov = np.concatenate([np.full(first, lam), np.full(second, 2 * lam)])
    return port.state_mults(4) * lam, 1.0, cov[None], np.ones((1, first
                                                               + second),
                                                              bool)


@pytest.mark.parametrize("which", ["posteriors", "viterbi"])
def test_transitions_with_inf_entries(which):
    """logA with -inf entries (CoverageHMM(stay=1.0)): the regime-change
    contig and tie-rich batches at two segment lengths."""
    check = _check_posteriors if which == "posteriors" else _check_viterbi
    check(*_regime_change(), stay=1.0)
    rng = np.random.default_rng(7)
    for T in (40, 97):
        check(*hmm_tie_case(rng, 4, 4, T), stay=1.0)


def test_linear_space_loses_states_without_transitions():
    """Why the kernel works in log space: on the regime-change contig with
    stay = 1 a scaled linear-space forward-backward underflows the state
    that wins later, and its posteriors are lost, while the segmented
    log-space model gives the float64 answer (collapsed everywhere)."""
    means, tau, cov, valid = _regime_change()
    hmm, emit, logA, logpi = _inputs(means, tau, cov, valid, 1.0)
    exact = port.posteriors_float64(hmm, cov, valid).transpose(1, 0, 2)
    assert np.allclose(exact[..., 3], 1.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        lin = linear_posteriors(emit, logA, logpi)
    assert not (np.abs(lin - exact) <= 0.5).all()
    got = segmented_posteriors(emit, logA, logpi,
                               port.coverage_plan(1, cov.shape[1], 4))
    assert float(np.abs(got - exact).max()) <= ATOL


@pytest.mark.parametrize("S", [2, 8])
def test_models_at_template_ends(S):
    """The smallest and largest templates (S 2 and 8, emissions built
    directly): the forward-backward model within 1e-5 of float64 or twice
    the plain version's distance, the Viterbi model's labels equal the
    plain version's."""
    rng = np.random.default_rng(S)
    T, B = 75, 4
    emit = (rng.standard_normal((T, B, S)) * 4).astype(F32)
    emit[40:, 1] = 0                                   # a padded tail
    logA = np.log(rng.dirichlet(np.ones(S), S)).astype(F32)
    logpi = np.log(np.full(S, 1.0 / S)).astype(F32)
    exact = port.forward_backward_float64(emit, logA, logpi)
    plain = port._posteriors_plain(*(torch.from_numpy(x) for x in
                                     (emit, logA, logpi))).numpy()
    got = segmented_posteriors(emit, logA, logpi, port.coverage_plan(B, T, S))
    tol = max(ATOL, 2 * float(np.abs(plain - exact).max()))
    assert float(np.abs(got - exact).max()) <= tol
    labels = port._viterbi_plain(*(torch.from_numpy(x) for x in
                                   (emit, logA, logpi))).numpy()
    np.testing.assert_array_equal(
        segmented_viterbi(emit, logA, logpi, port.viterbi_plan(B, T, S)),
        labels)
