"""The small-indel caller of the port (volcanosv_tpu_torch/vc/small_indel.py)
against the JAX package's, on tests/test_small_indel.py's 60 kb case (16
indels of 3-45 bp, SNPs, 40 kb phase-block contigs, HiFi reads at 36x):
each package aligns the contigs (asm20) and the reads (map-hifi) with its
own aligner, the port on the CPU, and the records, per-hap variants, k-mer
filter and aligned pairs must be equal; `vc-small-indel` through both CLIs
must write byte-identical VCFs."""
import dataclasses
import inspect

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
from volcanosv_tpu.io.vcf import VcfRecord as RefVcfRecord
from volcanosv_tpu.vc import small_indel as ref_si
from volcanosv_tpu_torch.aligner import Aligner
from volcanosv_tpu_torch.cli import main as port_main
from volcanosv_tpu_torch.config import AlignConfig, PipelineConfig
from volcanosv_tpu_torch.io.vcf import VcfRecord
from volcanosv_tpu_torch.vc import small_indel as port_si

VCF = "volcanosv_small_indel.vcf"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's aligner runs the plain DP on the CPU, many small tensor
    ops; beside the suite's other workers one intra-op thread is faster."""
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


def _align(aligner_cls, cfg_cls, ref, seqs, preset, **kw):
    al = aligner_cls(ref, cfg_cls.preset(preset), **kw)
    return al.to_bam_records(al.align(list(seqs.items())), seqs)


def _bam_key(r):
    return (r.name, r.flag, r.pos, r.mapq, r.seq, r.cigar.tolist())


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """tests/test_small_indel.py::small_indel_case, aligned by both
    packages; the files of the CLI run under a temporary directory."""
    rng = np.random.default_rng(7)
    ref = ref_sim.random_genome(rng, 60_000)
    hap1, hap2, truth = ref_sim.implant_svs(
        rng, ref, n_del=8, n_ins=8, min_len=3, max_len=45, min_gap=1_500)
    hap1, hap2, _ = ref_sim.implant_snps(rng, hap1, hap2, rate=1 / 2000)
    contigs = ref_sim.contigs_from_haplotypes(hap1, hap2, block_size=40_000)
    reads = ref_sim.simulate_reads(
        rng, {1: hap1, 2: hap2}, coverage=36.0, read_len=8_000,
        read_len_sd=800, sub_rate=0.001, indel_rate=0.0003)
    read_seqs = {n: s for n, s, *_ in reads}
    out = {"ref": ref, "truth": truth, "contigs": contigs,
           "read_seqs": read_seqs}
    for name, cls, cfg_cls, kw in (
            ("jax", RefAligner, RefAlignConfig, {}),
            ("port", Aligner, AlignConfig, {"device": "cpu"})):
        out[name] = (_align(cls, cfg_cls, ref, contigs, "asm20", **kw),
                     _align(cls, cfg_cls, ref, read_seqs, "map-hifi", **kw))
    # read → (haplotype, block): the true haplotype of each read (sim names
    # read_h<hap>_<n>), two blocks, so both sides of the phase-aware
    # downgrade see carriers
    out["read_hp"] = {n: (int(n.split("_")[1][1]), i % 2)
                      for i, n in enumerate(read_seqs)}
    d = tmp_path_factory.mktemp("si")
    write_fasta(str(d / "ref.fa"), ref)
    write_fasta(str(d / "contigs.fa"), contigs)
    write_fastq(str(d / "reads.fq"), ((n, s, None) for n, s, *_ in reads))
    out["dir"] = d
    return out


def test_alignments_equal(case):
    for j, p in zip(case["jax"], case["port"]):
        assert [_bam_key(r) for r in p] == [_bam_key(r) for r in j]
        assert len(p) > 0


@pytest.mark.parametrize("hap", ["hp1", "hp2"])
def test_extract_hap_variants_match(case, hap):
    cfg = PipelineConfig.for_dtype("Hifi").small_indel
    rcfg = RefPipelineConfig.for_dtype("Hifi").small_indel
    got = port_si.extract_hap_variants(case["port"][0], case["ref"]["chr1"],
                                       hap, cfg)
    want = ref_si.extract_hap_variants(case["jax"][0], case["ref"]["chr1"],
                                       hap, rcfg)
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert list(g) == list(w)
        assert [dataclasses.astuple(v) for v in g.values()] == \
            [dataclasses.astuple(v) for v in w.values()]
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[0]) >= 8


@pytest.mark.parametrize("with_reads,read_hp,keep_snps", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, True, True)])
def test_call_small_indels_match(case, with_reads, read_hp, keep_snps):
    kw = dict(keep_snps=keep_snps,
              read_hp=case["read_hp"] if read_hp else None)
    got = port_si.call_small_indels(
        "chr1", case["port"][0], case["ref"]["chr1"],
        PipelineConfig.for_dtype("Hifi"),
        reads_records=case["port"][1] if with_reads else None, **kw)
    want = ref_si.call_small_indels(
        "chr1", case["jax"][0], case["ref"]["chr1"],
        RefPipelineConfig.for_dtype("Hifi"),
        reads_records=case["jax"][1] if with_reads else None, **kw)
    assert [rec_key(r) for r in got] == [rec_key(r) for r in want]
    assert len(got) >= 12
    assert any(r.svtype == "SNP" or "SVTYPE" not in r.info
               for r in got) == keep_snps


def test_kmer_support_filter_match(case):
    """The real calls plus one with a fabricated CONTEXT that no read
    supports: the same records survive, the fabricated one does not."""
    calls = ref_si.call_small_indels(
        "chr1", case["jax"][0], case["ref"]["chr1"],
        RefPipelineConfig.for_dtype("Hifi"))
    fake = dict(chrom="chr1", pos=30_000, id="fake", ref="A",
                alt="ACGTACGTACGTCCCGGGA", gt="1|0",
                info={"CONTEXT": "TTTTTTTTGGGGGGGGCCCCCCCCAAAAAAAATTTT"})
    want = ref_si.kmer_support_filter(
        calls + [RefVcfRecord(**fake)], case["jax"][1],
        RefPipelineConfig.for_dtype("Hifi").small_indel)
    got = port_si.kmer_support_filter(
        [VcfRecord(**dataclasses.asdict(r)) for r in calls]
        + [VcfRecord(**fake)], case["port"][1],
        PipelineConfig.for_dtype("Hifi").small_indel)
    assert [rec_key(r) for r in got] == [rec_key(r) for r in want]
    assert "fake" not in [r.id for r in got]


def test_aligned_pairs_match(case):
    for p, j in zip(case["port"][1], case["jax"][1]):
        for a, b in zip(port_si._aligned_pairs_np(p),
                        ref_si._aligned_pairs_np(j)):
            np.testing.assert_array_equal(a, b)


def test_caller_takes_no_device():
    """The small-indel caller is host code (numpy over CIGARs and the numpy
    k-mer hash): no torch device to take."""
    for fn in (port_si.call_small_indels, port_si.extract_hap_variants,
               port_si.kmer_support_filter):
        assert "device" not in inspect.signature(fn).parameters


def test_cli_vcf_byte_identical(case):
    d = case["dir"]
    args = ["vc-small-indel", "--ref", str(d / "ref.fa"),
            "--contig", str(d / "contigs.fa"), "--fastq", str(d / "reads.fq")]
    assert ref_main(args + ["-o", str(d / "jax")]) == 0
    assert port_main(args + ["-o", str(d / "port"), "--device", "cpu"]) == 0
    want = open(d / "jax" / VCF, "rb").read()
    assert open(d / "port" / VCF, "rb").read() == want
    assert want.count(b"\nchr1\t") >= 12
