"""The port's coverage-HMM QC and SD recovery (volcanosv_tpu_torch.qc,
volcanosv_tpu_torch.pipeline.sd) against the JAX package's on the CPU:
Viterbi labels identical, forward-backward posteriors within tolerance,
the EM fit's λ, τ and means within rtol 1e-5, evaluate_assembly's states
and collapsed list identical, sd_recover's contigs identical, and the
`qc` BED and `asm --sd` contigs of both CLIs byte-identical.

Posterior tolerance: 1e-5, or twice the distance of the JAX package's own
float32 posteriors from a float64 forward-backward where that is larger.
Both packages sum log-likelihoods of hundreds of windows in float32, whose
last bit is then worth |α| × 6e-8 (about 1e-3 at |α| = 2e4), and their
logsumexp (XLA's and torch's exp and log) round differently."""
import dataclasses

import numpy as np
import pytest
import torch

from torch_inputs import ensure_reference_native_lib, hmm_tie_case
from volcanosv_tpu.config import PipelineConfig as RefPipelineConfig
from volcanosv_tpu.config import QCConfig as RefQCConfig
from volcanosv_tpu.io.bam import BamRecord as RefBamRecord
from volcanosv_tpu.qc import flagger as ref
from volcanosv_tpu_torch.config import PipelineConfig, QCConfig
from volcanosv_tpu_torch.io.bam import BamRecord
from volcanosv_tpu_torch.qc import flagger as port

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_hmm(means, tau, cov, valid):
    """Both packages' Viterbi and posteriors on one batch."""
    h_ref = ref.CoverageHMM(means=np.asarray(means), tau=tau)
    h_port = port.CoverageHMM(means=np.asarray(means), tau=tau)
    np.testing.assert_array_equal(h_port.viterbi(cov, valid, device="cpu"),
                                  h_ref.viterbi(cov, valid))
    want = h_ref.posteriors(cov, valid)
    got = h_port.posteriors(cov, valid, device="cpu")
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    ref_err = float(np.abs(
        want - port.posteriors_float64(h_ref, cov, valid)).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=max(ATOL, 2 * ref_err))
    return float(np.abs(got - want).max())


def _qc_case(name):
    """tests/test_qc.py's inputs: (means, tau, cov)."""
    if name == "collapsed_block":
        rng = np.random.default_rng(0)
        truth = np.array([2] * 40 + [3] * 20 + [2] * 40)
        cov = rng.poisson(20.0 * ref.STATE_MULT[truth]).astype(float)[None]
        return ref.STATE_MULT * 20.0, 1.0, cov
    if name == "sum_to_one":
        cov = np.random.default_rng(1).poisson(15.0, (2, 30)).astype(float)
        return ref.STATE_MULT * 15.0, 1.0, cov
    if name == "skewed":
        rng = np.random.default_rng(3)
        truth = np.array([2] * 100 + [3] * 60 + [0] * 20)
        mult = np.array([0.05, 0.5, 1.0, 1.4])[truth]
        cov = rng.poisson(24.0 * mult).astype(float)[None]
        return ref.STATE_MULT * float(np.median(cov[cov > 0.5])), 1.0, cov
    rng = np.random.default_rng(4)                      # overdispersed
    truth = np.array([2] * 200 + [3] * 60 + [2] * 40)
    g = rng.gamma(6.0, 1 / 6.0, 300)
    cov = rng.poisson(30.0 * ref.STATE_MULT[truth] * g).astype(float)[None]
    return ref.STATE_MULT * float(np.median(cov[cov > 0.5])), 1.0, cov


@pytest.mark.parametrize("name", ["collapsed_block", "sum_to_one", "skewed",
                                  "overdispersed"])
def test_hmm_matches_on_qc_inputs(name):
    means, tau, cov = _qc_case(name)
    assert _check_hmm(means, tau, cov, np.ones_like(cov, bool)) <= ATOL


def _ragged(rng, n_states, B, T):
    lam = rng.uniform(5, 40)
    cov = rng.poisson(lam * rng.choice(ref.state_mults(n_states),
                                       (B, T))).astype(float)
    lens = rng.integers(1, T + 1, B)
    lens[0] = T
    valid = np.arange(T)[None] < lens[:, None]
    cov[~valid] = 0
    return ref.state_mults(n_states) * lam, float(rng.uniform(1, 3)), cov, \
        valid


@pytest.mark.parametrize("n_states", [3, 4, 5])
def test_hmm_matches_on_ragged_batches(n_states):
    rng = np.random.default_rng(10 + n_states)
    for B, T in ((1, 1), (3, 2), (5, 60), (4, 150)):
        _check_hmm(*_ragged(rng, n_states, B, T))


@pytest.mark.parametrize("n_states", [3, 4, 5])
def test_hmm_labels_match_on_ties(n_states):
    """Tie-rich batches (an all-padded row, two states with one mean) at
    T 1 and 2 and longer: the plain labels equal the JAX package's, which
    takes the first state on ties, as the kernel does."""
    rng = np.random.default_rng(20 + n_states)
    for B, T in ((3, 1), (3, 2), (4, 40)):
        means, tau, cov, valid = hmm_tie_case(rng, n_states, B, T)
        _check_hmm(means, tau, cov, valid)
        emit = port.CoverageHMM(means=means, tau=tau)._emissions(
            cov, valid, torch.device("cpu"))
        assert port._viterbi_plain(*emit)[1].eq(0).all()  # ties: the first


@pytest.mark.parametrize("name,n_states", [
    ("skewed", 4), ("overdispersed", 4), ("ladder", 3), ("ladder", 4),
    ("ladder", 5), ("ragged", 4)])
def test_fit_matches(name, n_states):
    if name == "ladder":                       # tests/test_qc.py's ladder
        cov = np.random.default_rng(5).poisson(20.0, (1, 60)).astype(float)
        valid = np.ones_like(cov, bool)
    elif name == "ragged":
        _m, _t, cov, valid = _ragged(np.random.default_rng(6), 4, 4, 120)
    else:
        _m, _t, cov = _qc_case(name)
        valid = np.ones_like(cov, bool)
    want = ref.fit_coverage_hmm(cov, valid, dataclasses.replace(
        RefQCConfig(), n_states=n_states))
    got = port.fit_coverage_hmm(cov, valid, dataclasses.replace(
        QCConfig(), n_states=n_states), device="cpu")
    assert len(got.means) == n_states
    np.testing.assert_allclose(got.means, want.means, rtol=1e-5)
    np.testing.assert_allclose(got.lam, want.lam, rtol=1e-5)
    np.testing.assert_allclose(got.tau, want.tau, rtol=1e-5)
    assert got.stay == want.stay


def test_host_helpers_match():
    for n in (3, 4, 5):
        np.testing.assert_array_equal(port.state_mults(n),
                                      ref.state_mults(n))
        assert port.state_names(n) == ref.state_names(n)
    cov = np.array([0.0, 0.2, 3.0, 7.5, 9.0])
    assert port.estimate_haploid_coverage(cov) == \
        ref.estimate_haploid_coverage(cov)
    assert port.estimate_haploid_coverage(np.zeros(3)) == 1.0
    s = np.array([2, 2, 3, 3, 3, 2, 0, 3], np.int8)
    a = port.FlaggerResult({"c": s}, [], 1.0, 1000)
    b = ref.FlaggerResult({"c": s}, [], 1.0, 1000)
    for st in range(4):
        assert a.blocks("c", st) == b.blocks("c", st)


def _reads(cls, spans):
    return [cls(name=f"r{i}", flag=0, ref_id=c, pos=p, mapq=60,
                cigar=np.array([[0, n]], np.int64), seq="A" * 4)
            for i, (c, p, n) in enumerate(spans)]


def test_coverage_windows_match():
    lens = {"a": 2_500, "b": 4_000, "c": 999}
    spans = [(0, 0, 2_500), (0, 700, 900), (1, 100, 3_000), (2, 10, 2_000),
             (1, 3_500, 900)]
    want = ref.contig_coverage_windows(_reads(RefBamRecord, spans), lens,
                                       list(lens), window=1_000)
    got = port.contig_coverage_windows(_reads(BamRecord, spans), lens,
                                       list(lens), window=1_000)
    assert list(got) == list(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])


def test_evaluate_assembly_matches():
    """tests/test_qc.py's case: one contig with a doubled middle."""
    contigs = {"PS1_1_30000_hp1_0": "A" * 30_000,
               "PS2_1_30000_hp2_0": "A" * 30_000}
    spans = [(0, s, 5_000) for s in range(0, 28_000, 500)] \
        + [(1, s, 5_000) for s in range(0, 28_000, 500)] \
        + [(1, s, 5_000) for s in range(10_000, 18_000, 250)]
    want = ref.evaluate_assembly(contigs, _reads(RefBamRecord, spans),
                                 list(contigs), RefQCConfig())
    got = port.evaluate_assembly(contigs, _reads(BamRecord, spans),
                                 list(contigs), QCConfig(), device="cpu")
    assert got.collapsed == want.collapsed == ["PS2_1_30000_hp2_0"]
    assert list(got.states) == list(want.states)
    for c in want.states:
        np.testing.assert_array_equal(got.states[c], want.states[c])
    np.testing.assert_allclose(got.lam, want.lam, rtol=1e-5)
    assert got.window == want.window


def test_sd_recover_matches():
    """tests/test_sd_recovery.py's recipe: the hp2 contig's doubled
    coverage is flagged, its hap re-assembled and swapped in."""
    from volcanosv_tpu.pipeline.sd import sd_recover as ref_sd
    from volcanosv_tpu.sim import random_genome, simulate_reads
    from volcanosv_tpu_torch.pipeline.sd import hap_of_contig, sd_recover
    ensure_reference_native_lib()
    rng = np.random.default_rng(5)
    seq = random_genome(rng, 20_000)["chr1"]
    reads = simulate_reads(rng, {1: {"chr1": seq}}, coverage=14.0,
                           read_len=4_000, read_len_sd=300, sub_rate=0.001,
                           indel_rate=0.0)
    groups = {h: [s for _n, s, *_ in reads]
              for h in ("PS1_1_20000_hp1", "PS1_1_20000_hp2")}
    contigs = {"PS1_1_20000_hp1_0": seq, "PS1_1_20000_hp2_0": seq}
    spans = [(c, s, 3_000) for s in range(0, 18_000, 400) for c in (0, 1)] \
        + [(1, s, 3_000) for s in range(6_000, 12_000, 200)]
    want, want_qc = ref_sd(contigs, groups, _reads(RefBamRecord, spans),
                           RefPipelineConfig.for_dtype("Hifi"))
    got, got_qc = sd_recover(contigs, groups, _reads(BamRecord, spans),
                             PipelineConfig.for_dtype("Hifi"), device="cpu")
    assert got_qc.collapsed == want_qc.collapsed == ["PS1_1_20000_hp2_0"]
    assert got == want
    assert got["PS1_1_20000_hp1_0"] == seq
    assert got["PS1_1_20000_hp2_0"] != seq         # the re-assembled hap
    assert hap_of_contig("PS17_17_5000_hp2_3") == "PS17_17_5000_hp2"


# a 40 kb chromosome with two ~97%-identity segdup pairs: the assembly
# collapses one, QC flags it and `asm --sd` swaps re-assembled contigs in
SD_SIM = ["--length", "40000", "--n_segdup", "2", "--coverage", "20",
          "--read_len", "5000", "--seed", "4"]


@pytest.fixture(scope="module")
def sd_runs(tmp_path_factory):
    """`qc` on the sim's true contigs and `asm --sd`, by both CLIs."""
    from volcanosv_tpu.cli import main as ref_main
    from volcanosv_tpu_torch.cli import main as port_main
    ensure_reference_native_lib()
    d = tmp_path_factory.mktemp("sd")
    assert port_main(["sim", "-o", str(d / "sim")] + SD_SIM) == 0
    common = ["--ref", str(d / "sim" / "ref.fa"),
              "--fastq", str(d / "sim" / "reads.fastq")]
    qc = ["qc", *common, "--contig", str(d / "sim" / "true_contigs.fa")]
    assert ref_main([*qc, "-o", str(d / "jax_qc")]) == 0
    assert port_main([*qc, "-o", str(d / "port_qc"), "--device", "cpu"]) == 0
    swaps = []
    from volcanosv_tpu_torch.pipeline import sd
    fn = sd.sd_recover

    def recover(contigs, *a, **kw):
        out, qc = fn(contigs, *a, **kw)
        swaps.extend(c for c in out if out[c] != contigs.get(c))
        return out, qc
    sd.sd_recover = recover
    try:
        assert port_main(["asm", *common, "--sd", "-o", str(d / "port_asm"),
                          "--device", "cpu"]) == 0
    finally:
        sd.sd_recover = fn
    assert ref_main(["asm", *common, "--sd", "-o", str(d / "jax_asm")]) == 0
    return d, swaps


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_qc_bed_byte_identical(sd_runs):
    d, _ = sd_runs
    want = _read(d / "jax_qc" / "flagger_blocks.bed")
    assert _read(d / "port_qc" / "flagger_blocks.bed") == want
    assert b"\tcollapsed\n" in want


def test_asm_sd_contigs_byte_identical(sd_runs):
    d, swaps = sd_runs
    want = _read(d / "jax_asm" / "final_contigs.fa")
    assert _read(d / "port_asm" / "final_contigs.fa") == want and want
    assert _read(d / "port_asm" / "phased_snps.vcf") == \
        _read(d / "jax_asm" / "phased_snps.vcf")
    assert len(swaps) >= 1        # re-assembled contigs swapped in
