"""The complex-SV caller of the port (volcanosv_tpu_torch/vc/complex_sv.py)
against the JAX package's, with device="cpu": tests/test_complex_sv.py's
inv_case (80 kb, 4 INV and 3 DUP of 300-1200 bp, HiFi reads at 16x), its
interspersed-DUP contig and its cross-chromosome contig.  Candidates,
pairing clusters, the pairing's edit distances (clip_to = 10, band
W = 128), DUP recovery with its consumed INS ids, and the records must be
equal; `vc-complex-sv` through both CLIs, with and without --large_vcf,
must write byte-identical VCFs."""
import dataclasses

import numpy as np
import pytest
import torch

from torch_inputs import ensure_reference_native_lib
from volcanosv_tpu import sim as ref_sim
from volcanosv_tpu.aligner import Aligner as RefAligner
from volcanosv_tpu.cli import main as ref_main
from volcanosv_tpu.config import AlignConfig as RefAlignConfig
from volcanosv_tpu.config import PipelineConfig as RefPipelineConfig
from volcanosv_tpu.io.fasta import write_fasta
from volcanosv_tpu.io.fastq import write_fastq
from volcanosv_tpu.io.vcf import make_header, write_vcf
from volcanosv_tpu.vc import complex_sv as ref_cx
from volcanosv_tpu.vc.large_indel import call_chromosome as ref_call_chrom
from volcanosv_tpu_torch.aligner import Aligner
from volcanosv_tpu_torch.cli import main as port_main
from volcanosv_tpu_torch.config import AlignConfig, PipelineConfig
from volcanosv_tpu_torch.vc import complex_sv as port_cx
from volcanosv_tpu_torch.vc.large_indel import call_chromosome

VCF = "volcanosv_complex_sv.vcf"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's aligner and edit distances run the plain DP on the CPU,
    many small tensor ops; beside the suite's other workers one intra-op
    thread is faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _reference_native_lib():
    ensure_reference_native_lib()


def rec_key(r):
    """A VcfRecord's fields in order, INFO as its ordered items."""
    return (r.chrom, r.pos, r.id, r.ref, r.alt, r.qual, r.filter,
            list(r.info.items()), r.gt, r.ps)


def cand_key(c):
    return dataclasses.astuple(c)


def _by_chrom(aligner, seqs):
    recs = aligner.to_bam_records(aligner.align(list(seqs.items())), seqs)
    out = {c: [] for c in aligner.names}
    for r in recs:
        out[aligner.names[r.ref_id]].append(r)
    return out


def _both(ref, seqs, preset):
    """(JAX records, port records) by chromosome."""
    return (_by_chrom(RefAligner(ref, RefAlignConfig.preset(preset)), seqs),
            _by_chrom(Aligner(ref, AlignConfig.preset(preset),
                              device="cpu"), seqs))


@pytest.fixture(scope="module")
def inv_case(tmp_path_factory):
    """tests/test_complex_sv.py::inv_case, aligned by both packages, with
    the INS calls of each package's large-indel caller."""
    rng = np.random.default_rng(11)
    ref = ref_sim.random_genome(rng, 80_000)
    hap1, hap2, truth = ref_sim.implant_svs(
        rng, ref, n_del=0, n_ins=0, n_inv=4, n_dup=3,
        min_len=300, max_len=1_200, min_gap=4_000)
    contigs = ref_sim.contigs_from_haplotypes(hap1, hap2, block_size=40_000)
    reads = ref_sim.simulate_reads(
        rng, {1: hap1, 2: hap2}, coverage=16.0, read_len=9_000,
        read_len_sd=1_000, sub_rate=0.001, indel_rate=0.0003)
    read_seqs = {n: s for n, s, *_ in reads}
    ctg_j, ctg_p = _both(ref, contigs, "asm10")
    reads_j, reads_p = _both(ref, read_seqs, "map-hifi")
    ins_j = [r for r in ref_call_chrom(
        "chr1", ctg_j["chr1"], ref["chr1"], contigs,
        RefPipelineConfig.for_dtype("Hifi")) if r.svtype == "INS"]
    ins_p = [r for r in call_chromosome(
        "chr1", ctg_p["chr1"], ref["chr1"], contigs,
        PipelineConfig.for_dtype("Hifi"), device="cpu")
        if r.svtype == "INS"]
    d = tmp_path_factory.mktemp("cx")
    write_fasta(str(d / "ref.fa"), ref)
    write_fasta(str(d / "contigs.fa"), contigs)
    write_fastq(str(d / "reads.fq"), ((n, s, None) for n, s, *_ in reads))
    write_vcf(str(d / "large.vcf"),
              make_header({c: len(s) for c, s in ref.items()}), ins_j)
    return dict(ref=ref, truth=truth, contigs=contigs, ctg_j=ctg_j,
                ctg_p=ctg_p, reads_j=reads_j, reads_p=reads_p, ins_j=ins_j,
                ins_p=ins_p, dir=d)


def _cands(mod, by_chrom, cfg):
    return (mod.segment_candidates(by_chrom, 1, cfg)
            + mod.segment_candidates(by_chrom, 2, cfg))


def test_inputs_equal(inv_case):
    for j, p in ((inv_case["ctg_j"], inv_case["ctg_p"]),
                 (inv_case["reads_j"], inv_case["reads_p"])):
        assert [(r.name, r.flag, r.pos, r.mapq, r.cigar.tolist())
                for r in p["chr1"]] == \
            [(r.name, r.flag, r.pos, r.mapq, r.cigar.tolist())
             for r in j["chr1"]]
    assert [rec_key(r) for r in inv_case["ins_p"]] == \
        [rec_key(r) for r in inv_case["ins_j"]]
    assert len(inv_case["ins_j"]) >= 1


@pytest.mark.parametrize("hap", [1, 2])
def test_segment_candidates_match(inv_case, hap):
    got = port_cx.segment_candidates(
        inv_case["ctg_p"], hap, PipelineConfig.for_dtype("Hifi").complex_sv)
    want = ref_cx.segment_candidates(
        inv_case["ctg_j"], hap,
        RefPipelineConfig.for_dtype("Hifi").complex_sv)
    assert [cand_key(c) for c in got] == [cand_key(c) for c in want]
    assert any(c.svtype == "INV" for c in got)


def _spy_edit_distances(monkeypatch):
    """Record each package's edit_distance_pairs batch: (pairs, clip_to,
    distances) by package."""
    seen = {}
    for name, mod in (("port", port_cx), ("jax", ref_cx)):
        def spy(pairs, _fn=mod.edit_distance_pairs, _name=name, **kw):
            d = _fn(pairs, **kw)
            seen[_name] = (list(pairs), kw.get("clip_to"), d)
            return d
        monkeypatch.setattr(mod, "edit_distance_pairs", spy)
    return seen


def _pairing_match(cands, rcands, ref, seen):
    """Both packages' pair_candidates_by_sequence: the same clusters, and
    the same edit distances of the same reconstructed haplotype pairs (one
    edit_distance_pairs batch with clip_to = 10)."""
    got = port_cx.pair_candidates_by_sequence(
        cands, ref, PipelineConfig.for_dtype("Hifi").complex_sv,
        device="cpu")
    want = ref_cx.pair_candidates_by_sequence(
        rcands, ref, RefPipelineConfig.for_dtype("Hifi").complex_sv)
    assert [[cand_key(c) for c in cl] for cl in got] == \
        [[cand_key(c) for c in cl] for cl in want]
    pairs, clip, dist = seen["port"]
    assert (pairs, clip) == seen["jax"][:2] and clip == 10
    np.testing.assert_array_equal(dist, seen["jax"][2])
    return got, dist


def test_pairing_inv_case_match(inv_case, monkeypatch):
    """The pairing of inv_case's deduplicated INV candidates."""
    seen = _spy_edit_distances(monkeypatch)
    cfg = PipelineConfig.for_dtype("Hifi").complex_sv
    rcfg = RefPipelineConfig.for_dtype("Hifi").complex_sv
    cands = port_cx._dedup_same_hap(
        [c for c in _cands(port_cx, inv_case["ctg_p"], cfg)
         if c.svtype == "INV"])
    rcands = ref_cx._dedup_same_hap(
        [c for c in _cands(ref_cx, inv_case["ctg_j"], rcfg)
         if c.svtype == "INV"])
    _got, dist = _pairing_match(cands, rcands, inv_case["ref"], seen)
    assert len(dist) >= 2 and (dist <= 10).any()


# candidate sets of tests/test_complex_sv.py's pairing tests:
# (svtype, pos, end, svlen, hap, qname)
PAIRING_SETS = {
    "inv_same": [("INV", 10_000, 11_000, 1_000, 1, "a"),
                 ("INV", 10_000, 11_000, 1_000, 2, "b")],
    "inv_different": [("INV", 10_000, 10_700, 700, 1, "a"),
                      ("INV", 10_400, 13_000, 2_600, 2, "b")],
    "inv_slack": [("INV", 10_000, 11_000, 1_000, 1, "a"),
                  ("INV", 10_050, 11_050, 1_000, 2, "b")],
    "inv_jitter": [("INV", 10_000, 11_000, 1_000, 1, "a"),
                   ("INV", 10_001, 11_001, 1_000, 2, "b")],
    "dup_same_and_different": [("DUP", 5_000, 6_000, 1_000, 1, "a"),
                               ("DUP", 5_000, 6_000, 1_000, 2, "b"),
                               ("DUP", 5_100, 5_400, 300, 2, "c"),
                               ("DUP", 5_020, 6_010, 990, 1, "d")],
}


@pytest.mark.parametrize("name", list(PAIRING_SETS))
def test_pairing_sets_match(name, monkeypatch):
    seen = _spy_edit_distances(monkeypatch)
    ref = ref_sim.random_genome(np.random.default_rng(11), 30_000)
    sets = [[mod.Candidate(t, "chr1", *rest) for t, *rest in
             PAIRING_SETS[name]] for mod in (port_cx, ref_cx)]
    got, dist = _pairing_match(*sets, ref, seen)
    assert len(dist) >= 1
    if name in ("inv_same", "inv_jitter"):
        assert len(got) == 1 and dist[0] <= 10
    if name in ("inv_different", "inv_slack"):
        assert len(got) == 2 and dist[0] > 10


def test_edit_distance_pairs_clip10_match():
    """edit_distance_pairs(clip_to=10) on pairs shaped like the pairing's
    reconstructed haplotypes (0.3-2.5 kb, 0-40 edits apart: distances on
    both sides of the cut)."""
    from volcanosv_tpu.vc.redundancy import edit_distance_pairs as ref_edp
    from volcanosv_tpu_torch.vc.redundancy import edit_distance_pairs
    rng = np.random.default_rng(12)
    bases = np.array(list("ACGT"))
    pairs = []
    for n_edits in (0, 1, 4, 9, 10, 11, 25, 40):
        n = int(rng.integers(300, 2_500))
        a = rng.choice(bases, n)
        b = a.copy()
        for _ in range(n_edits):
            k = int(rng.integers(0, len(b)))
            op = rng.integers(0, 3)
            if op == 0:
                b[k] = rng.choice(bases)
            elif op == 1:
                b = np.delete(b, k)
            else:
                b = np.insert(b, k, rng.choice(bases))
        pairs.append(("".join(a), "".join(b)))
    got = edit_distance_pairs(pairs, clip_to=10, device="cpu")
    np.testing.assert_array_equal(got, ref_edp(pairs, clip_to=10))
    assert (got <= 10).sum() >= 4 and (got > 10).sum() >= 2


def test_complete_linkage_match():
    rng = np.random.default_rng(13)
    for n in (1, 2, 5, 9):
        d = rng.integers(0, 30, (n, n)).astype(float)
        d = np.minimum(d, d.T)
        np.fill_diagonal(d, 0.0)
        d[rng.random((n, n)) < 0.2] = 1e9
        d = np.minimum(d, d.T)
        assert port_cx._complete_linkage(d, 10) == \
            ref_cx._complete_linkage(d, 10)


def test_recover_dups_from_ins_match(inv_case):
    cfg = PipelineConfig.for_dtype("Hifi").complex_sv
    rcfg = RefPipelineConfig.for_dtype("Hifi").complex_sv
    got = port_cx.recover_dups_from_ins(inv_case["ins_p"], inv_case["ref"],
                                        cfg, device="cpu")
    want = ref_cx.recover_dups_from_ins(inv_case["ins_j"], inv_case["ref"],
                                        rcfg)
    assert [rec_key(r) for r in got[0]] == [rec_key(r) for r in want[0]]
    assert got[1] == want[1]


@pytest.mark.parametrize("with_reads", [True, False])
def test_call_complex_svs_match(inv_case, with_reads):
    """The whole caller on inv_case, with the INS calls for DUP recovery,
    with and without the reads (INV read support and genotype)."""
    got_consumed, want_consumed = set(), set()
    got = port_cx.call_complex_svs(
        inv_case["ctg_p"], inv_case["ref"], PipelineConfig.for_dtype("Hifi"),
        ins_records=inv_case["ins_p"],
        reads_by_chrom=inv_case["reads_p"] if with_reads else None,
        consumed_ins=got_consumed, device="cpu")
    want = ref_cx.call_complex_svs(
        inv_case["ctg_j"], inv_case["ref"],
        RefPipelineConfig.for_dtype("Hifi"), ins_records=inv_case["ins_j"],
        reads_by_chrom=inv_case["reads_j"] if with_reads else None,
        consumed_ins=want_consumed)
    assert [rec_key(r) for r in got] == [rec_key(r) for r in want]
    assert got_consumed == want_consumed
    assert {"INV", "DUP"} <= {r.svtype for r in got}


def _fusion_case(rng, ref, contigs, cfg_changes=None):
    """Both packages' call_complex_svs on contigs aligned with asm10."""
    j, p = _both(ref, contigs, "asm10")
    cfg = PipelineConfig.for_dtype("Hifi")
    rcfg = RefPipelineConfig.for_dtype("Hifi")
    if cfg_changes:
        cfg = dataclasses.replace(cfg, complex_sv=dataclasses.replace(
            cfg.complex_sv, **cfg_changes))
        rcfg = dataclasses.replace(rcfg, complex_sv=dataclasses.replace(
            rcfg.complex_sv, **cfg_changes))
    cands = _cands(port_cx, p, cfg.complex_sv)
    assert [cand_key(c) for c in cands] == \
        [cand_key(c) for c in _cands(ref_cx, j, rcfg.complex_sv)]
    got = port_cx.call_complex_svs(p, ref, cfg, device="cpu")
    want = ref_cx.call_complex_svs(j, ref, rcfg)
    assert [rec_key(r) for r in got] == [rec_key(r) for r in want]
    return cands, got


def test_interspersed_dup_match():
    """tests/test_complex_sv.py's DUP:INT contig (a 3 kb copy from 40 kb
    spliced in at 10 kb, max_sv_size 5000): the junction-pair DUP and the
    same-chromosome breakends."""
    rng = np.random.default_rng(7)
    ref = ref_sim.random_genome(rng, 60_000)
    src, src_len, dest = 40_000, 3_000, 10_000
    copy = ref["chr1"][src:src + src_len]
    hap = ref["chr1"][:dest] + copy + ref["chr1"][dest:30_000]
    cands, got = _fusion_case(
        rng, ref, {"PS1_1_60000_hp1_0": hap, "PS1_1_60000_hp2_0": hap},
        dict(max_sv_size=5_000))
    assert any(c.svtype == "DUP" and abs(c.pos - src) <= 50 for c in cands)
    assert any(r.svtype == "DUP" for r in got)


def test_cross_chrom_bnd_match():
    """tests/test_complex_sv.py's fusion of two chromosomes on both haps:
    one reciprocal BND pair."""
    rng = np.random.default_rng(5)
    ref = ref_sim.random_genome(rng, 40_000, n_chroms=2)
    fusion = ref["chr1"][:20_000] + ref["chr2"][21_000:]
    _cands, got = _fusion_case(rng, ref, {"PS1_1_40000_hp1_0": fusion,
                                          "PS1_1_40000_hp2_0": fusion})
    assert sum(r.svtype == "BND" for r in got) == 2


@pytest.mark.parametrize("large_vcf", [False, True])
def test_cli_vcf_byte_identical(inv_case, large_vcf):
    """`vc-complex-sv` through both CLIs: INS calls from the inline
    large-indel caller, or from --large_vcf."""
    d = inv_case["dir"]
    tag = "lv" if large_vcf else "inline"
    args = ["vc-complex-sv", "--ref", str(d / "ref.fa"),
            "--contig", str(d / "contigs.fa"), "--fastq", str(d / "reads.fq")]
    if large_vcf:
        args += ["--large_vcf", str(d / "large.vcf")]
    assert ref_main(args + ["-o", str(d / f"jax_{tag}")]) == 0
    assert port_main(args + ["-o", str(d / f"port_{tag}"),
                             "--device", "cpu"]) == 0
    want = open(d / f"jax_{tag}" / VCF, "rb").read()
    assert open(d / f"port_{tag}" / VCF, "rb").read() == want
    assert b"<INV>" in want and b"<DUP>" in want
