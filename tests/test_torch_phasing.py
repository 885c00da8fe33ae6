"""Phasing in the port against the JAX package, on the CPU: the numpy
threefry against `jax.random`, the pair-HMM Viterbi (fp32 scores bit-equal),
the MEC votes, `pileup_chromosome` (every PileupResult array),
`phase_chromosome` (every PhaseResult field) and the SNP VCF bytes, for HiFi
and for CLR (pair-HMM realignment at every site), on the inputs of
tests/test_phasing.py and tests/test_realign.py.  Every output here is an
integer, a byte or an fp32 score required to be bit-equal: the tolerance is
0."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcanosv_tpu import sim
from volcanosv_tpu.aligner import Aligner
from volcanosv_tpu.config import AlignConfig
from volcanosv_tpu.config import PhasingConfig as RefPhasingConfig
from volcanosv_tpu.io.vcf import make_header as ref_make_header
from volcanosv_tpu.io.vcf import write_vcf as ref_write_vcf
from volcanosv_tpu.ops.pack import encode_seq
from volcanosv_tpu.phasing import phase as ref_phase
from volcanosv_tpu.phasing import pileup as ref_pileup
from volcanosv_tpu.phasing import realign as ref_realign
from volcanosv_tpu.phasing import snp_vcf as ref_snp_vcf
from volcanosv_tpu_torch.config import PhasingConfig
from volcanosv_tpu_torch.io.vcf import make_header, write_vcf
from volcanosv_tpu_torch.phasing import phase, pileup, realign, snp_vcf
from volcanosv_tpu_torch.utils import threefry
from tests.test_realign import _mk_ref, _reads
from torch_inputs import (VITERBI_EDGES, ensure_reference_native_lib,
                          viterbi_edge_case, viterbi_mixed_case,
                          viterbi_pairs)


@pytest.fixture(scope="module", autouse=True)
def _reference_native_lib():
    """The JAX package's native library loaded whole before its first use
    (torch_inputs.ensure_reference_native_lib)."""
    ensure_reference_native_lib()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops a Viterbi row; beside the suite's other busy
    workers torch's intra-op pool makes each wait on every thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_threefry_matches_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(threefry.prng_key(seed), np.asarray(key))
    keys = threefry.split(threefry.prng_key(seed), 8)
    ref_keys = jax.random.split(key, 8)
    np.testing.assert_array_equal(keys, np.asarray(ref_keys))
    for i in range(8):
        for n in (1, 999, 1000):
            np.testing.assert_array_equal(
                threefry.bits(keys[i], n),
                np.asarray(jax.random.bits(ref_keys[i], (n,), jnp.uint32)))
            np.testing.assert_array_equal(
                threefry.rademacher(keys[i], n),
                np.asarray(jax.random.rademacher(ref_keys[i], (n,),
                                                 jnp.int32)))


@pytest.mark.parametrize("err", [0.001, 0.1])
def test_viterbi_batch_bit_equal(err):
    """fp32 scores bit-equal at the path's window (W = 41, R = 57)."""
    segs, lens, haps = viterbi_pairs(np.random.default_rng(int(err * 1e3)),
                                     1024, 57, 41, err)
    p = ref_realign.PairHmmParams(err)
    kw = dict(W=41, log_match=p.log_match, log_mis=p.log_mis,
              log_ins=p.log_ins, a_mm=p.a_mm, a_gap=p.a_gap, a_ext=p.a_ext,
              a_back=p.a_back)
    want = np.asarray(ref_realign._viterbi_batch(
        jnp.asarray(segs), jnp.asarray(lens), jnp.asarray(haps), **kw))
    got = realign._viterbi_batch(torch.from_numpy(segs),
                                 torch.from_numpy(lens),
                                 torch.from_numpy(haps), **kw).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    alt = haps.copy()
    alt[:, 20] = (alt[:, 20] + 1) % 4
    np.testing.assert_array_equal(
        realign.pairhmm_alleles(segs, lens, haps, alt, err, device="cpu"),
        ref_realign.pairhmm_alleles(segs, lens, haps, alt, err))


@pytest.mark.parametrize("case", list(VITERBI_EDGES))
def test_viterbi_plain_bit_equal_on_edge_batches(case):
    """The plain version (the CPU path of `_viterbi_batch`) against the
    JAX package's jitted scan on the edge batches the card is checked at:
    one pair, 37 pairs, empty and full segments, all-N windows, W 9 and
    200: fp32 scores bit-equal."""
    segs, lens, haps, err, W = viterbi_edge_case(case)
    p = ref_realign.PairHmmParams(err)
    kw = dict(W=W, log_match=p.log_match, log_mis=p.log_mis,
              log_ins=p.log_ins, a_mm=p.a_mm, a_gap=p.a_gap, a_ext=p.a_ext,
              a_back=p.a_back)
    want = np.asarray(ref_realign._viterbi_batch(
        jnp.asarray(segs), jnp.asarray(lens), jnp.asarray(haps), **kw))
    args = [torch.from_numpy(x) for x in (segs, lens, haps)]
    got = realign._viterbi_batch_plain(*args, **kw).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        realign._viterbi_batch(*args, **kw).numpy().view(np.int32),
        got.view(np.int32))


@pytest.mark.parametrize("W", [9, 41, 64])
def test_viterbi_plain_bit_equal_on_mixed_warps(W):
    """The plain version against the JAX package on the batches whose
    group-design warps mix empty, full and short segments and read N bases
    (torch_inputs.py::viterbi_mixed_case, held on the card too): fp32
    scores bit-equal."""
    segs, lens, haps, err, W = viterbi_mixed_case(W)
    p = ref_realign.PairHmmParams(err)
    kw = dict(W=W, log_match=p.log_match, log_mis=p.log_mis,
              log_ins=p.log_ins, a_mm=p.a_mm, a_gap=p.a_gap, a_ext=p.a_ext,
              a_back=p.a_back)
    want = np.asarray(ref_realign._viterbi_batch(
        jnp.asarray(segs), jnp.asarray(lens), jnp.asarray(haps), **kw))
    got = realign._viterbi_batch(
        *(torch.from_numpy(x) for x in (segs, lens, haps)), **kw).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_viterbi_group_shape():
    """The group design's (G, C) at every W it takes: G lanes a pair (4,
    8, 16 or 32, the least with 8 G >= W), C columns a lane with G * C >=
    W, one of the kernel's instances, 8 and 6 at the path's W = 41."""
    instances = {(4, c) for c in range(1, 9)} | \
        {(g, c) for g in (8, 16) for c in range(5, 9)} | \
        {(32, c) for c in (5, 6, 7, 8, 12, 16, 24, 32)}
    seen = set()
    for W in range(1, 1025):
        G, C = realign.viterbi_group_shape(W)
        assert G == min(g for g in (4, 8, 16, 32) if 8 * g >= W or g == 32)
        assert G * C >= W and (G, C) in instances
        assert G == 32 and C > 8 or C == -(-W // G)
        seen.add((G, C))
    assert seen == instances
    assert realign.viterbi_group_shape(41) == (8, 6)
    for W in (0, 1025):
        with pytest.raises(ValueError):
            realign.viterbi_group_shape(W)


def test_bucket_is_one_launch_of_ref_then_alt():
    """`_bucket`, the pairs of one kernel launch of `pairhmm_alleles`:
    the bucket's segments and lengths twice, its REF windows then its ALT
    windows, each half padded to _BUCKET with empty pairs (codes 4,
    length 0); a bucket at 4096 holds the pairs from 4096 on."""
    rng = np.random.default_rng(3)
    N, R, W = realign._BUCKET + 5, 12, 7
    segs = rng.integers(0, 5, (N, R)).astype(np.int8)
    lens = rng.integers(0, R + 1, N).astype(np.int64)
    ref, alt = (rng.integers(0, 5, (N, W)).astype(np.int8) for _ in "ra")
    n = realign._BUCKET
    for lo, real in ((0, n), (n, 5)):
        s, ln, h = realign._bucket(segs, lens, ref, alt, lo)
        assert s.shape == (2 * n, R) and h.shape == (2 * n, W)
        assert ln.dtype == np.int32 and ln.shape == (2 * n,)
        for half, hap in ((0, ref), (n, alt)):
            np.testing.assert_array_equal(s[half:half + real],
                                          segs[lo:lo + real])
            np.testing.assert_array_equal(ln[half:half + real],
                                          lens[lo:lo + real])
            np.testing.assert_array_equal(h[half:half + real],
                                          hap[lo:lo + real])
            assert (s[half + real:half + n] == 4).all()
            assert (h[half + real:half + n] == 4).all()
            assert (ln[half + real:half + n] == 0).all()


def test_pairhmm_alleles_match_at_flank_600(monkeypatch):
    """`PhasingConfig(realign_flank=600)`'s window, W = 1201 (past the
    card's group design, which takes W <= 1024): 200 read segments of up to
    96 bases over the window's centre, from the REF or the ALT haplotype
    (the centre base changed) with 5% substitutions; the allele calls equal
    the JAX package's.  Both packages score in buckets of 128 pairs here
    (4096 on the path) so that the CPU run takes seconds."""
    monkeypatch.setattr(realign, "_BUCKET", 128)
    monkeypatch.setattr(ref_realign, "_BUCKET", 128)
    rng = np.random.default_rng(600)
    N, R, W, mid = 200, 96, 1201, 600
    haps = rng.integers(0, 4, (N, W)).astype(np.int8)
    alt = haps.copy()
    alt[:, mid] = (alt[:, mid] + 1) % 4
    segs = np.full((N, R), 4, np.int8)
    lens = rng.integers(0, R + 1, N).astype(np.int32)
    for i in range(N):
        s0 = mid - lens[i] // 2 + int(rng.integers(-3, 4))
        seg = (haps if i % 2 else alt)[i, s0:s0 + lens[i]].copy()
        mut = rng.random(len(seg)) < 0.05
        seg[mut] = rng.integers(0, 4, int(mut.sum()))
        segs[i, :len(seg)] = seg
    got = realign.pairhmm_alleles(segs, lens, haps, alt, 0.05, device="cpu")
    want = ref_realign.pairhmm_alleles(segs, lens, haps, alt, 0.05)
    np.testing.assert_array_equal(got, want)
    assert {-1, 1} <= set(got.tolist())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mec_phase_matches(seed):
    """(h, a, mec) of the best of 8 restarts, restarts 1-7 drawn through
    the numpy threefry: random observations with noise, so restarts differ
    and ties among them occur."""
    rng = np.random.default_rng(seed)
    n_reads, S, n_obs = 300, 120, 4000
    truth_h = rng.choice([-1, 1], S)
    truth_a = rng.choice([-1, 1], n_reads)
    obs_read = rng.integers(0, n_reads, n_obs).astype(np.int32)
    obs_snp = rng.integers(0, S, n_obs).astype(np.int32)
    o = truth_a[obs_read] * truth_h[obs_snp]
    o[rng.random(n_obs) < 0.15] *= -1
    o[rng.random(n_obs) < 0.05] = 0
    obs_allele = o.astype(np.int8)
    h_init = ref_phase.chain_init(obs_read, obs_snp, obs_allele, S)
    for n_iter in (0, 3, 30):
        want = ref_phase._mec_phase(
            jnp.asarray(obs_read), jnp.asarray(obs_snp),
            jnp.asarray(obs_allele), jnp.asarray(h_init),
            jax.random.PRNGKey(seed), n_reads=n_reads, n_snps=S,
            n_iter=n_iter, n_restarts=8)
        h0 = phase.restart_inits(phase.chain_init(obs_read, obs_snp,
                                                  obs_allele, S), seed, 8)
        got = phase._mec_phase(
            torch.from_numpy(obs_read), torch.from_numpy(obs_snp),
            torch.from_numpy(obs_allele), torch.from_numpy(h0),
            n_reads=n_reads, n_iter=n_iter)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _check_pileup_and_phase(recs, ref_codes, ref_cfg):
    """Port vs JAX package: every PileupResult array, every PhaseResult
    field and the SNP VCF bytes."""
    cfg = PhasingConfig(**dataclasses.asdict(ref_cfg))
    want = ref_pileup.pileup_chromosome(recs, ref_codes, ref_cfg)
    got = pileup.pileup_chromosome(recs, ref_codes, cfg, device="cpu")
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    ph_want = ref_phase.phase_chromosome(want, ref_cfg)
    ph_got = phase.phase_chromosome(got, cfg, device="cpu")
    for f in dataclasses.fields(ph_want):
        a, b = getattr(ph_got, f.name), getattr(ph_want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert ph_got.blocks() == ph_want.blocks()
    return want, ph_want, ph_got


def _vcf_bytes(tmp_path, name, chrom, L, records, writer, header):
    path = str(tmp_path / name)
    writer(path, header({chrom: L}), records)
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def snp_case_records():
    """tests/test_phasing.py's case: 60 het SNPs on a 60 kb diploid genome,
    HiFi-like reads at 24x, aligned by the JAX package's aligner."""
    rng = np.random.default_rng(3)
    ref = sim.random_genome(rng, 60_000)
    seq = ref["chr1"]
    pos = np.sort(rng.choice(np.arange(500, len(seq) - 500), 60,
                             replace=False))
    bases = "ACGT"
    hap2 = list(seq)
    for p in pos:
        alt = bases[(bases.index(seq[p]) + 1 + int(rng.integers(3))) % 4]
        if alt == seq[p]:
            alt = bases[(bases.index(seq[p]) + 1) % 4]
        hap2[p] = alt
    haps = {1: {"chr1": seq}, 2: {"chr1": "".join(hap2)}}
    reads = sim.simulate_reads(rng, haps, coverage=24.0, read_len=6_000,
                               read_len_sd=800, sub_rate=0.002,
                               indel_rate=0.0005)
    aligner = Aligner(ref, AlignConfig.preset("map-hifi"))
    seqs = {n: s for n, s, *_ in reads}
    recs = aligner.to_bam_records(aligner.align(list(seqs.items())), seqs)
    return seq, recs


@pytest.mark.parametrize("dtype", ["default", "Hifi", "CLR"])
def test_pileup_and_phase_match_on_snp_case(snp_case_records, dtype,
                                            tmp_path):
    """The default config (the assembler's consensus pileup), HiFi, and
    CLR, where every candidate site goes through the pair-HMM."""
    seq, recs = snp_case_records
    ref_cfg = RefPhasingConfig() if dtype == "default" \
        else RefPhasingConfig.for_dtype(dtype)
    pile, ph_want, ph_got = _check_pileup_and_phase(
        recs, encode_seq(seq), ref_cfg)
    assert len(ph_want.snp_pos) >= 40
    want = _vcf_bytes(tmp_path, "ref.vcf", "chr1", len(seq),
                      ref_snp_vcf.snp_vcf_records("chr1", ph_want),
                      ref_write_vcf, ref_make_header)
    got = _vcf_bytes(tmp_path, "port.vcf", "chr1", len(seq),
                     snp_vcf.snp_vcf_records("chr1", ph_got), write_vcf,
                     make_header)
    assert got == want and want.count(b"\n") > 40


@pytest.mark.parametrize("realign_on", [False, True])
def test_pileup_and_phase_match_on_realign_case(realign_on):
    """tests/test_realign.py's homopolymer-deletion case at the CLR error
    rate (pair-HMM at every site), with the realignment off and on."""
    rng = np.random.default_rng(5)
    ref = _mk_ref(rng)
    recs, snp = _reads(ref, rng)
    ref_cfg = dataclasses.replace(RefPhasingConfig.for_dtype("CLR"),
                                  realign=realign_on, min_depth=5)
    pile, _ph, _ = _check_pileup_and_phase(recs, encode_seq(ref), ref_cfg)
    if realign_on:
        assert list(pile.snp_pos) == [snp]


def test_pileup_and_phase_match_on_clean_site():
    """tests/test_realign.py's clean-site case, CLR, realignment on."""
    from volcanosv_tpu.io.bam import BamRecord
    rng = np.random.default_rng(9)
    ref = "".join(rng.choice(list("ACGT"), 160))
    hap1 = ref[:80] + ("T" if ref[80] != "T" else "A") + ref[81:]
    recs = []
    for i in range(16):
        for name, s in ((f"a{i}", ref), (f"b{i}", hap1)):
            recs.append(BamRecord(name=name, pos=0, mapq=60, seq=s,
                                  cigar=np.array([[0, len(s)]], np.int64)))
    ref_cfg = dataclasses.replace(RefPhasingConfig.for_dtype("CLR"),
                                  min_depth=5)
    pile, _ph, _ = _check_pileup_and_phase(recs, encode_seq(ref), ref_cfg)
    assert list(pile.snp_pos) == [80]
