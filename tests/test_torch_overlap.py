"""The all-vs-all overlap pass of the port (ops/overlap.py): its plain
PyTorch version, the host half it shares with the card's kernels
(native/ava_index.cpp) and its routing, against native/ava.cpp's
ava_overlaps, on the CPU.

The eight columns (a, b, strand, score, q_start, q_end, t_start, t_end)
must equal ava.cpp's bit for bit, dtypes included, on read groups at 0.2%
and 10% error, a repeat-rich group whose hash runs pass the 64-hit cap
and the occurrence filter, reads shorter than k + w, a one-read group and
a pass cut into several query chunks.  The gap-cost table the host fills
for the card equals chain_dp's cost at every gap 0..2000, read back from
chain_dp's own scores.  The card's kernels are held to ava.cpp in
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from torch_inputs import ava_group
from volcanosv_tpu_torch import native
from volcanosv_tpu_torch.assembly import olc
from volcanosv_tpu_torch.config import AlignConfig, AssemblyConfig
from volcanosv_tpu_torch.ops import overlap
from volcanosv_tpu_torch.utils.logging import COUNTS

ACFG = AlignConfig.preset("ava")
GROUP = dict(hap_len=40_000, coverage=8.0, read_len=5_000, read_sd=1_500)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain version is many small tensor ops; beside the suite's other
    workers one intra-op thread is faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib():
    return native.get_lib()


def _case(name):
    """(reads, max_anchors, max_segments) of a named case."""
    big = (overlap.MAX_ANCHORS, overlap.MAX_SEGMENTS)
    if name == "hifi":
        return ava_group(1, **GROUP), *big
    if name == "noisy":
        return ava_group(2, **GROUP, err=0.1), *big
    if name == "repeats":
        return ava_group(3, **GROUP, repeats=6), *big
    if name == "short_reads":
        reads = ava_group(4, **GROUP)
        rng = np.random.default_rng(4)
        for L in (0, 1, 14, 15, 18, 19, 20):   # k + w - 1 = 19
            reads.insert(int(rng.integers(0, len(reads))),
                         rng.integers(0, 4, L).astype(np.int8))
        return reads, *big
    if name == "one_read":
        return ava_group(5, **GROUP)[:1], *big
    if name == "chunked":
        return ava_group(6, **GROUP), 250_000, 18 * 64 * 2
    raise KeyError(name)


def _assert_equal_columns(got, want):
    assert len(got) == len(want) == 8
    for name, g, w in zip(overlap._COLS, got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("name", ["hifi", "noisy", "repeats", "short_reads",
                                  "one_read", "chunked"])
def test_plain_pass_equals_ava_cpp(lib, name):
    reads, max_anchors, max_segments = _case(name)
    want = native.ava_overlaps_np(lib, reads, ACFG)
    got = overlap.ava_overlaps(reads, ACFG, "cpu", max_anchors=max_anchors,
                               max_segments=max_segments)
    _assert_equal_columns(got, want)
    if name in ("hifi", "noisy", "repeats", "chunked"):
        assert len(want[0]) > 100
        assert set(np.unique(want[2])) == {-1, 1}
    if name == "one_read":
        assert len(want[0]) == 0


def test_chunked_case_takes_several_chunks(lib):
    """The chunked case's budgets cut its queries into chunks on both
    limits, each chunk within them unless a query alone passes one."""
    reads, max_anchors, max_segments = _case("chunked")
    with native.ava_index_views(lib, reads, ACFG.k, ACFG.w) as ix:
        T = overlap._upload(ix, np.array([len(r) for r in reads], np.int32),
                            np.zeros(1, np.float32), torch.device("cpu"))
        moff = ix["min_off"].copy()
    per_query = overlap._hits_plain(T, overlap._params(ACFG), moff)[2]
    n = len(reads)
    chunks = overlap.plan_chunks(per_query, n, max_anchors, max_segments)
    assert len(chunks) > 2
    assert [c[0] for c in chunks[1:]] == [c[1] for c in chunks[:-1]]
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    for q0, q1 in chunks:
        if q1 - q0 > 1:
            assert per_query[q0:q1].sum() <= max_anchors
            assert (q1 - q0) * n * 2 <= max_segments
    assert any(per_query[q0:q1].sum() > 0.6 * max_anchors
               for q0, q1 in chunks)


def test_plan_chunks_budgets():
    per_query = np.array([5, 5, 20, 1, 1, 1, 0, 9])
    assert overlap.plan_chunks(per_query, 8, 10, 10**6) == \
        [(0, 2), (2, 3), (3, 7), (7, 8)]
    # segment counters: 8 reads x 2 a query, 40 allowed → 2 queries a chunk
    assert overlap.plan_chunks(per_query, 8, 10**6, 40) == \
        [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert overlap.plan_chunks(np.zeros(0, np.int64), 0, 10, 10) == []


def test_repeat_case_passes_cap_and_filter(lib):
    """The repeat-rich group exercises what decides the anchors there: the
    occurrence filter drops the short unit's hashes, and runs longer than
    the 64-hit cap stay in the index."""
    reads, _a, _s = _case("repeats")
    with native.ava_index_views(lib, reads, ACFG.k, ACFG.w) as ix:
        idx_hash, n_min = ix["idx_hash"].copy(), len(ix["min_hash"])
    _h, kept = np.unique(idx_hash, return_counts=True)
    assert len(idx_hash) < n_min                            # filtered
    assert (kept > overlap.MAX_HITS).sum() >= 5             # capped runs
    assert np.all(np.diff(idx_hash.astype(np.int64)) >= 0)


def test_gap_costs_equal_chain_dp(lib):
    """For each gap g in 0..2000, chain_dp scores an anchor that extends a
    colinear chain of j anchors (f = 15 j) by (d + g, d) as (15 j + d) -
    cost(g), in float32.  The sum A = 15 j + d is the smallest integer that
    still extends the chain (A - cost in (15, 16]), so the score is as small
    as chain_dp allows: wherever cost(g) is 8 or more (g >= 95) the
    subtraction is exact and A - f reads chain_dp's own cost back bit for
    bit, which must be the table's entry; below that the score holds the
    cost to 2^-20."""
    bw, k = ACFG.chain_bandwidth, ACFG.k
    costs = native.ava_gap_costs_np(lib, overlap.GAP_SCALE, bw)
    assert costs.dtype == np.float32 and len(costs) == bw + 1 == 2001
    read_back = 0
    for g in range(bw + 1):
        A = int(np.floor(costs[g])) + 16
        j, d = (A - 1) // k, (A - 1) % k + 1
        q = np.arange(j + 1, dtype=np.int64) * k
        t = q.copy()
        q[-1] = q[-2] + d + g
        t[-1] = t[-2] + d
        f = np.zeros(j + 1, np.float32)
        pre = np.zeros(j + 1, np.int32)
        lib.chain_dp(q, t, j + 1, k, overlap.MAX_PRED, ACFG.max_anchor_gap,
                     bw, overlap.GAP_SCALE, f, pre)
        assert f[-2] == k * j and pre[-1] == j - 1, g
        assert f[-1] == np.float32(A) - costs[g], (g, f[-1], costs[g])
        if costs[g] >= 8:
            assert np.float32(A) - f[-1] == costs[g], g
            read_back += 1
    assert read_back == bw + 1 - 95


def test_cpu_route_is_ava_cpp(monkeypatch):
    """On the CPU the farm's overlaps come from ava.cpp: the card's pass is
    never called and `overlap_device_groups` does not move."""
    def refuse(*_a, **_kw):
        raise AssertionError("the CPU route reached the card's pass")
    monkeypatch.setattr(overlap, "ava_overlaps", refuse)
    seqs = ["".join("ACGT"[c] for c in r) for r in ava_group(7, **GROUP)]
    before = COUNTS["overlap_device_groups"]
    ovs = olc._find_overlaps(seqs, AssemblyConfig(), ACFG, device="cpu")
    assert ovs and COUNTS["overlap_device_groups"] == before


def test_cuda_route_takes_the_pass_and_raises(monkeypatch):
    """On a CUDA device every group goes to the card's pass (here its plain
    version stands in for the kernels) and counts in
    `overlap_device_groups`; the overlaps equal the CPU route's; a failure
    of the pass raises, with no turn to the host."""
    cpu = torch.device("cpu")
    calls = []
    plain = overlap.ava_overlaps

    def stand_in(codes, acfg, device, **kw):
        assert device.type == "cuda"
        calls.append(len(codes))
        return plain(codes, acfg, cpu, **kw)
    monkeypatch.setattr(olc, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(overlap, "ava_overlaps", stand_in)
    reads = ava_group(8, **GROUP)
    seqs = ["".join("ACGT"[c] for c in r) for r in reads]
    group_of = np.arange(len(seqs)) % 2
    before = COUNTS["overlap_device_groups"]
    got = olc._find_overlaps(seqs, AssemblyConfig(), ACFG,
                             group_of=group_of, device="cuda")
    assert calls == [int((group_of == 0).sum()), int((group_of == 1).sum())]
    assert COUNTS["overlap_device_groups"] == before + 2
    monkeypatch.setattr(olc, "resolve_device", lambda d: cpu)
    want = olc._find_overlaps(seqs, AssemblyConfig(), ACFG,
                              group_of=group_of, device="cpu")
    assert got == want and got

    def fail(*_a, **_kw):
        raise RuntimeError("ava_chain launch: CUDA error 1")
    monkeypatch.setattr(olc, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(overlap, "ava_overlaps", fail)
    with pytest.raises(RuntimeError, match="ava_chain"):
        olc._find_overlaps(seqs[:20], AssemblyConfig(), ACFG, device="cuda")


def test_cpu_pass_never_loads_kernels(monkeypatch):
    from volcanosv_tpu_torch.ops import cuda_build

    def refuse(*_a):
        raise AssertionError("a CPU call reached cuda_build")
    monkeypatch.setattr(cuda_build, "load_all", refuse)
    monkeypatch.setattr(cuda_build, "lib", refuse)
    reads = ava_group(9, hap_len=15_000, coverage=6.0, read_len=3_000,
                      read_sd=500)
    before = overlap.ava_overlaps.launches
    out = overlap.ava_overlaps(reads, ACFG, "cpu")
    assert len(out[0]) > 0 and overlap.ava_overlaps.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        overlap.ava_overlaps(reads, ACFG, "meta")
