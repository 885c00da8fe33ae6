"""The port's MEC votes (phasing/phase.py::_mec_phase) and canonical k-mer
hashes (ops/kmer.py::canonical_hashes) against the JAX package, on the CPU,
where the wrappers run their plain versions: (h, a, mec) and the hashes are
integers, required equal (tolerance 0).  The MEC cases are
tests/torch_inputs.py's MEC_EDGES (the card tests run the same cases
through the kernel); restarts 1-7 are the reference's `jax.random` draws
(utils/threefry.py).  The card's kernels read read and SNP indices as
int32 or int64; the wrapper takes both, checked here on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcanosv_tpu.ops import kmer as ref_kmer
from volcanosv_tpu.phasing import phase as ref_phase
from volcanosv_tpu_torch.ops import kmer
from volcanosv_tpu_torch.phasing import phase
from torch_inputs import MEC_EDGES, mec_edge_case, mec_restart_mecs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops a call; beside the suite's other busy workers
    torch's intra-op pool makes each wait on every thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_inputs(name):
    r, s, o, S, n_reads, n_iter, h_init, seed = mec_edge_case(name)
    if h_init is None:
        h_init = phase.chain_init(r, s, o, S)
    h0 = phase.restart_inits(h_init, seed, 8)
    return r, s, o, S, n_reads, n_iter, h_init, seed, h0


@pytest.mark.parametrize("case", MEC_EDGES)
def test_mec_phase_edges_match(case):
    """(h, a, mec) of the best of 8 restarts: the JAX package's `_mec_phase`
    (h_init and PRNGKey(seed)) against the port's on CPU tensors (h0 from
    restart_inits), equal."""
    r, s, o, S, n_reads, n_iter, h_init, seed, h0 = _port_inputs(case)
    if case != "tie":                 # the port's chain init is the JAX one
        np.testing.assert_array_equal(h_init,
                                      ref_phase.chain_init(r, s, o, S))
    want = ref_phase._mec_phase(
        jnp.asarray(r), jnp.asarray(s), jnp.asarray(o), jnp.asarray(h_init),
        jax.random.PRNGKey(seed), n_reads=n_reads, n_snps=S, n_iter=n_iter,
        n_restarts=8)
    got = phase._mec_phase(*(torch.from_numpy(x) for x in (r, s, o, h0)),
                           n_reads=n_reads, n_iter=n_iter)
    assert got[0].dtype == got[1].dtype == torch.int32
    assert got[2].dtype == torch.int64 and got[2].dim() == 0
    assert got[0].shape == (S,) and got[1].shape == (n_reads,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if n_iter == 0:                   # h is the first lowest restart's h0
        mecs = mec_restart_mecs(r, s, o, h0, n_reads)
        lo = min(mecs)
        np.testing.assert_array_equal(got[0].numpy(), h0[mecs.index(lo)])
        assert int(got[2]) == lo
        if case == "tie":
            assert mecs.count(lo) >= 2 and mecs[0] > lo


@pytest.mark.parametrize("case", ["n_iter_1", "uncovered", "duplicates",
                                  "unsorted", "all_zero", "no_obs"])
def test_mec_phase_int64_indices_match(case):
    """Read and SNP indices as int64 tensors (as the pileup's reads may
    come): the port's (h, a, mec) equal the JAX package's on int32."""
    r, s, o, S, n_reads, n_iter, h_init, seed, h0 = _port_inputs(case)
    want = ref_phase._mec_phase(
        jnp.asarray(r), jnp.asarray(s), jnp.asarray(o), jnp.asarray(h_init),
        jax.random.PRNGKey(seed), n_reads=n_reads, n_snps=S, n_iter=n_iter,
        n_restarts=8)
    got = phase._mec_phase(
        torch.from_numpy(r.astype(np.int64)),
        torch.from_numpy(s.astype(np.int64)), torch.from_numpy(o),
        torch.from_numpy(h0), n_reads=n_reads, n_iter=n_iter)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [1, 6, 12, 15, 16])
def test_canonical_hashes_match(k):
    """Random int32 hashes over the whole range (negative values, bits above
    2k set) and a 2-d shape: the port's equal the JAX package's."""
    rng = np.random.default_rng(k)
    h = rng.integers(-2**31, 2**31, (37, 129), dtype=np.int64)
    h[0, :8] = [0, -1, 2**31 - 1, -2**31, (1 << (2 * k)) - 1, 1, 2, 3]
    h = h.astype(np.int32)
    got = kmer.canonical_hashes(torch.from_numpy(h), k)
    want = np.asarray(ref_kmer.canonical_hashes(jnp.asarray(h), k))
    assert got.dtype == torch.int32 and got.shape == h.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrappers_refuse_bad_inputs():
    """The checks of both wrappers hold on the CPU too: dtypes, ranks, k,
    the number of restarts, the branch name."""
    r, s, o, _S, n_reads, _n_iter, _h, _seed, h0 = _port_inputs("n_iter_1")
    r, s, o, h0 = (torch.from_numpy(x) for x in (r, s, o, h0))
    for args in ((r, s, o.to(torch.int32), h0), (r.float(), s, o, h0),
                 (r, s, o, h0.long()), (r, s, o, h0[0]), (r, s[:-1], o, h0),
                 (r, s, o, h0[:0])):
        with pytest.raises(ValueError):
            phase._mec_phase(*args, n_reads=n_reads, n_iter=1)
    with pytest.raises(ValueError):
        phase._mec_phase(r, s, o, h0, n_reads=n_reads, n_iter=-1)
    with pytest.raises(ValueError):
        phase._mec_phase(r, s, o, h0, n_reads=n_reads, n_iter=1,
                         branch="warp")
    x = torch.zeros(5, dtype=torch.int32)
    for bad_k in (0, 17):
        with pytest.raises(ValueError):
            kmer.canonical_hashes(x, bad_k)
    with pytest.raises(ValueError):
        kmer.canonical_hashes(x.long(), 12)


def test_mec_smem_need_counts_bytes():
    """`asm`'s set at one CTA: int8 h and a, the 32-bit offsets of every
    row and 16-bit entries; at 8 CTAs the slices' bound; 32-bit entries at
    S or R of 2^15."""
    assert phase.mec_smem_need(941, 6677, 27876, 1) == (
        944 + 6688 + 26720 + 3776, 944 + 6688 + 26720 + 3776 + 111504)
    fixed, full = phase.mec_smem_need(941, 6677, 27876, 8)
    assert fixed == 944 + 6688 + 17296 + 3776     # 4320 + 1 read offsets
    assert full == fixed + 15856                  # 4320 + 3603 entries
    assert phase.mec_smem_need(2**15, 100, 1000, 1)[1] - \
        phase.mec_smem_need(2**15, 100, 1000, 1)[0] == 8000
    assert phase.mec_smem_need(2**15 - 1, 100, 1000, 1)[1] - \
        phase.mec_smem_need(2**15 - 1, 100, 1000, 1)[0] == 4000


@pytest.mark.parametrize("S,R,O,want", [
    (941, 6677, 27876, ("smem", 8)),          # asm's set
    (155, 1193, 4865, ("smem", 1)),           # the golden run's largest
    (9000, 20000, 120000, ("smem", 8)),
    (9000, 20000, 200000, ("grid", 0)),       # past 8 CTAs' slices
    (166_667, 833_333, 5_003_438, ("grid", 0)),   # a chromosome
    (0, 0, 0, ("smem", 1)),
    (100, 40000, 9000, ("smem", 8)),          # one CTA's offsets too large
])
def test_mec_plan_picks_the_design(S, R, O, want):
    """One CTA a restart up to MEC_ONE_CTA_MAX_OBS observations, else 8,
    where a CTA holds its whole slice (H100: 232,288 bytes a CTA); else the
    grid design."""
    assert phase.mec_plan(S, R, O, 232_288) == want


def test_mec_plan_one_cta_up_to_the_limit():
    """The cluster size changes one observation past MEC_ONE_CTA_MAX_OBS,
    and a CTA's shared memory too small for 8 CTAs' slices gives the grid
    design at any O."""
    top = phase.MEC_ONE_CTA_MAX_OBS
    assert phase.mec_plan(150, 1200, top, 232_288) == ("smem", 1)
    assert phase.mec_plan(150, 1200, top + 1, 232_288) == \
        ("smem", phase.MEC_CLUSTER_CTAS)
    assert phase.mec_plan(150, 1200, top, 1000) == ("grid", 0)
    assert phase.mec_plan(150, 1200, top + 1, 1000) == ("grid", 0)


def test_mec_phase_refuses_bad_cluster_sizes():
    r, s, o, _S, n_reads, _n_iter, _h, _seed, h0 = _port_inputs("n_iter_1")
    args = [torch.from_numpy(x) for x in (r, s, o, h0)]
    for ctas in (0, 17):
        with pytest.raises(ValueError):
            phase._mec_phase(*args, n_reads=n_reads, n_iter=1,
                             branch="smem", ctas=ctas)
