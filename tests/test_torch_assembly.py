"""The assembly half of `asm` in the port against the JAX package, on the
CPU: `run_assembly` contigs, `assemble_chromosome` (contigs, phasing and
read partition) on tests/test_pipeline_e2e.py's case with and without a
hybrid BED, and the `asm` CLI of both packages on a small simulation with
--hybrid_bed and --emit_fastqs, whose output files must be byte-identical
(final_contigs.fa, phased_snps.vcf, phased.bam, the checkpoints with
read_hp_<chrom>.tsv, fastq_by_hap/), then a --resume rerun."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_inputs import ensure_reference_native_lib
from volcanosv_tpu import sim
from volcanosv_tpu.aligner import Aligner
from volcanosv_tpu.assembly import run_assembly as ref_run_assembly
from volcanosv_tpu.cli import main as ref_main
from volcanosv_tpu.config import AlignConfig
from volcanosv_tpu.config import AssemblyConfig as RefAssemblyConfig
from volcanosv_tpu.config import PipelineConfig as RefPipelineConfig
from volcanosv_tpu.io.fasta import write_fasta
from volcanosv_tpu.io.fastq import write_fastq
from volcanosv_tpu.ops.pack import encode_seq
from volcanosv_tpu.pipeline import assemble_chromosome as ref_assemble
from volcanosv_tpu_torch.assembly import run_assembly
from volcanosv_tpu_torch.cli import main as port_main
from volcanosv_tpu_torch.config import AssemblyConfig, PipelineConfig
from volcanosv_tpu_torch.pipeline import assemble_chromosome


@pytest.fixture(scope="module", autouse=True)
def _reference_native_lib():
    """The JAX package's native library loaded whole before its first use
    (torch_inputs.ensure_reference_native_lib)."""
    ensure_reference_native_lib()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain DP is many small tensor ops a row; beside the suite's
    other busy workers torch's intra-op pool makes each wait on every
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("err", [0.004, 0.06])
def test_single_draft_consensus_matches(err):
    """The single-draft helpers beside the farm's batched polish
    (tests/test_consensus_poa.py's case, cut to 3 kb at 20x): the windowed
    POA, the pileup-driven edit consensus, the column vote and `polish`
    give the JAX package's strings."""
    from volcanosv_tpu.assembly import olc as ref_olc
    from volcanosv_tpu_torch.assembly import olc
    from volcanosv_tpu_torch.config import AlignConfig as PortAlignConfig
    from tests.test_consensus_poa import _align_reads, _make_case
    _truth, draft, read_seqs = _make_case(err, L=3000, cov=20.0)
    recs = _align_reads(draft, read_seqs)
    assert olc._consensus_poa(draft, recs, "cpu") == \
        ref_olc._consensus_poa(draft, recs)
    assert olc._consensus_edit(draft, recs, "cpu") == \
        ref_olc._consensus_edit(draft, recs)
    subs = [s[100:400] for s in read_seqs[:12]]
    assert olc._column_vote(draft[100:400], subs, "cpu") == \
        ref_olc._column_vote(draft[100:400], subs)
    assert olc.polish(draft, read_seqs, PortAlignConfig.preset("map-pb"),
                      device="cpu") == \
        ref_olc.polish(draft, read_seqs, AlignConfig.preset("map-pb"))


def test_run_assembly_contigs():
    """Two haplotype groups of a 30 kb block at 12x (a quarter of the reads
    at the double-assigned weight 0.25, three reads duplicated), a one-read
    group and an empty one, with the duplicate-aware hybrid profile (two
    polish rounds; test_assemble_chromosome_matches runs the default)."""
    rng = np.random.default_rng(101)
    ref = sim.random_genome(rng, 30_000)
    hap1, hap2, _ = sim.implant_svs(rng, ref, n_del=1, n_ins=1, min_len=80,
                                    max_len=500)
    groups, weights = {}, {}
    for name, hap in (("PS1_1_30000_hp1", hap1), ("PS1_1_30000_hp2", hap2)):
        reads = sim.simulate_reads(rng, {1: hap}, coverage=12.0,
                                   read_len=6000, sub_rate=0.002,
                                   indel_rate=0.001)
        groups[name] = [s for _n, s, *_ in reads]
        weights[name] = [0.25 if i % 4 == 0 else 1.0
                         for i in range(len(groups[name]))]
    groups["PS1_1_30000_hp2"] += groups["PS1_1_30000_hp2"][:3]  # duplicates
    groups["PS9_1_100_hp1"] = [groups["PS1_1_30000_hp1"][0]]
    groups["PS9_1_100_hp2"] = []
    ref_cfg = dataclasses.replace(RefAssemblyConfig(), dedup_reads=True,
                                  consensus_rounds=2)
    want = ref_run_assembly(groups, ref_cfg, weights=weights)
    got = run_assembly(groups, AssemblyConfig(**dataclasses.asdict(ref_cfg)),
                       weights=weights, device="cpu")
    assert got == want
    assert len(want[0]) >= 2 and "PS9_1_100_hp2" in want[1]


@pytest.fixture(scope="module")
def e2e_case():
    """tests/test_pipeline_e2e.py's case: 80 kb, 3 DEL + 3 INS, het SNPs,
    reads at 24x, aligned by the JAX package's aligner."""
    rng = np.random.default_rng(21)
    ref = sim.random_genome(rng, 80_000)
    hap1, hap2, _truth = sim.implant_svs(rng, ref, n_del=3, n_ins=3,
                                         min_len=60, max_len=250,
                                         min_gap=4_000)
    hap1, hap2, _ = sim.implant_snps(rng, hap1, hap2, rate=1 / 1200)
    reads = sim.simulate_reads(rng, {1: hap1, 2: hap2}, coverage=24.0,
                               read_len=7_000, read_len_sd=900,
                               sub_rate=0.001, indel_rate=0.0005)
    read_seqs = {n: s for n, s, *_ in reads}
    al = Aligner(ref, AlignConfig.preset("map-hifi"))
    recs = al.to_bam_records(al.align(list(read_seqs.items())), read_seqs)
    return ref, read_seqs, recs


@pytest.mark.parametrize("hybrid_bed", [None, [(0, 40_000)]])
def test_assemble_chromosome_matches(e2e_case, hybrid_bed):
    ref, read_seqs, recs = e2e_case
    codes = encode_seq(ref["chr1"])
    want = ref_assemble(recs, codes, read_seqs,
                        RefPipelineConfig.for_dtype("Hifi"),
                        hybrid_bed=hybrid_bed)
    got = assemble_chromosome(recs, codes, read_seqs,
                              PipelineConfig.for_dtype("Hifi"),
                              hybrid_bed=hybrid_bed, device="cpu")
    assert got[0] == want[0]
    assert sum(map(len, want[0].values())) >= 1.2 * len(ref["chr1"])
    for f in dataclasses.fields(want[1]):
        a, b = getattr(got[1], f.name), getattr(want[1], f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert vars(got[2]) == vars(want[2])


def _files(d):
    out = {}
    for root, _dirs, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            if n == "stage_times.json":
                continue
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def test_asm_cli_byte_identical(tmp_path):
    """A 50 kb simulation (2 DEL, 2 INS, het and hom SNPs) at 20x: every
    output file of `asm --hybrid_bed --emit_fastqs` equal byte for byte;
    then `--resume` reuses the checkpoints and rewrites the same contigs
    and SNP VCF."""
    rng = np.random.default_rng(33)
    ref = sim.random_genome(rng, 50_000)
    hap1, hap2, truth = sim.implant_svs(rng, ref, n_del=2, n_ins=2,
                                        min_len=60, max_len=400,
                                        min_gap=4_000)
    hap1, hap2, _ = sim.implant_snps_ref(rng, ref, hap1, hap2, truth)
    reads = sim.simulate_reads(rng, {1: hap1, 2: hap2}, coverage=20.0,
                               read_len=6_000)
    write_fasta(str(tmp_path / "ref.fa"), ref)
    write_fastq(str(tmp_path / "reads.fq"),
                ((n, s, None) for n, s, *_ in reads))
    with open(tmp_path / "hybrid.bed", "w") as fh:
        fh.write("chr1\t0\t20000\n")
    args = ["asm", "--ref", str(tmp_path / "ref.fa"), "--fastq",
            str(tmp_path / "reads.fq"), "--hybrid_bed",
            str(tmp_path / "hybrid.bed"), "--emit_fastqs"]
    assert ref_main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert port_main(args + ["-o", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    for name in ("final_contigs.fa", "phased_snps.vcf", "phased.bam",
                 "checkpoints/read_hp_chr1.tsv"):
        assert len(want[name]) > 100, name
    assert any(n.startswith("fastq_by_hap/") for n in want)
    os.remove(tmp_path / "port" / "final_contigs.fa")
    assert port_main(args + ["-o", str(tmp_path / "port"), "--device", "cpu",
                             "--resume"]) == 0
    again = _files(tmp_path / "port")
    for name in ("final_contigs.fa", "phased_snps.vcf"):
        assert again[name] == want[name], name
