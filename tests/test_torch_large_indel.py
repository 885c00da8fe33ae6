"""`vc-large-indel` and `eval` through both CLIs — volcanosv_tpu.cli and
volcanosv_tpu_torch.cli --device cpu — on one small simulated case with
phase-block contigs and HiFi reads: the VCFs must be byte-identical and the
eval summaries equal.  Also the contigs-only whole-haplotype ('otherasm-2hap')
naming case, and the edit-distance batches of redundancy removal and eval,
which run the DP."""
import json
import os

import numpy as np
import pytest
import torch

from torch_inputs import ensure_reference_native_lib
from volcanosv_tpu import sim
from volcanosv_tpu.cli import main as ref_main
from volcanosv_tpu.io.fasta import write_fasta
from volcanosv_tpu.io.fastq import write_fastq
from volcanosv_tpu.io.vcf import VcfRecord, make_header, read_vcf, write_vcf
from volcanosv_tpu.vc import redundancy as ref_red
from volcanosv_tpu_torch.cli import main as port_main
from volcanosv_tpu_torch.vc import redundancy as port_red


@pytest.fixture(scope="module", autouse=True)
def _reference_native_lib():
    """The JAX package's native library loaded whole before its first use
    (torch_inputs.ensure_reference_native_lib)."""
    ensure_reference_native_lib()

VCF = "volcanosv_large_indel.vcf"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path is many small tensor ops a DP row; beside other
    busy processes (the suite's parallel workers) torch's intra-op thread
    pool makes each op wait on every thread, so these tests take one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _truth_vcf(path, ref, truth):
    recs = [VcfRecord(
        chrom=t.chrom, pos=t.pos + 1, id=f"truth-{i}", ref="N",
        alt=f"<{t.svtype}>",
        gt="1|1" if t.gt == (1, 1) else ("1|0" if t.gt[0] else "0|1"),
        info={"SVTYPE": t.svtype, "SVLEN": t.svlen,
              "END": t.pos + 1 + t.svlen}) for i, t in enumerate(truth)]
    write_vcf(path, make_header({c: len(s) for c, s in ref.items()}), recs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("li")
    rng = np.random.default_rng(5)
    ref = sim.random_genome(rng, 60_000)
    hap1, hap2, truth = sim.implant_svs(rng, ref, n_del=4, n_ins=4,
                                        min_len=50, max_len=600,
                                        min_gap=3_000)
    contigs = sim.contigs_from_haplotypes(hap1, hap2, block_size=30_000,
                                          overlap=5_000)
    reads = sim.simulate_reads(rng, {1: hap1, 2: hap2}, coverage=10.0,
                               read_len=8_000, read_len_sd=1_500)
    write_fasta(str(d / "ref.fa"), ref)
    write_fasta(str(d / "contigs.fa"), contigs)
    write_fastq(str(d / "reads.fq"), ((n, s, None) for n, s, *_ in reads))
    _truth_vcf(str(d / "truth.vcf"), ref, truth)
    args = ["vc-large-indel", "--ref", str(d / "ref.fa"),
            "--contig", str(d / "contigs.fa"), "--fastq", str(d / "reads.fq")]
    assert ref_main(args + ["-o", str(d / "jax")]) == 0
    assert port_main(args + ["-o", str(d / "port"), "--device", "cpu"]) == 0
    return d


def test_vcf_byte_identical(runs):
    want = open(runs / "jax" / VCF, "rb").read()
    got = open(runs / "port" / VCF, "rb").read()
    assert got == want
    _h, recs = read_vcf(str(runs / "port" / VCF))
    assert len(recs) >= 6 and any("SUPPORT" in r.info for r in recs)
    assert sorted(os.listdir(runs / "port" / "checkpoints")) == \
        sorted(os.listdir(runs / "jax" / "checkpoints"))


def test_eval_summaries_equal(runs, capsys):
    base = ["eval", "--base", str(runs / "truth.vcf"), "--comp"]
    assert ref_main(base + [str(runs / "jax" / VCF)]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_main(base + [str(runs / "port" / VCF), "--device",
                             "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and got["recall"] >= 0.85 and got["precision"] >= 0.85


def test_otherasm_2hap_contigs_only(tmp_path):
    """Whole-haplotype contigs named hp1_/hp2_ only (no PS<pb>_ prefix):
    identical VCFs, phased GTs, no PS field."""
    rng = np.random.default_rng(11)
    ref = sim.random_genome(rng, 40_000, n_chroms=1)
    hap1, hap2, _truth = sim.implant_svs(rng, ref, n_del=3, n_ins=3,
                                         min_len=60, max_len=400)
    write_fasta(str(tmp_path / "ref.fa"), ref)
    write_fasta(str(tmp_path / "contigs.fa"),
                {f"hp1_{c}": s for c, s in hap1.items()}
                | {f"hp2_{c}": s for c, s in hap2.items()})
    args = ["vc-large-indel", "--ref", str(tmp_path / "ref.fa"),
            "--contig", str(tmp_path / "contigs.fa")]
    assert ref_main(args + ["-o", str(tmp_path / "jax")]) == 0
    assert port_main(args + ["-o", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    got = open(tmp_path / "port" / VCF, "rb").read()
    assert got == open(tmp_path / "jax" / VCF, "rb").read()
    _h, calls = read_vcf(str(tmp_path / "port" / VCF))
    assert len(calls) >= 5
    for r in calls:
        assert r.gt in ("1|0", "0|1", "1|1") and "PS" not in r.info


def test_edit_distance_batches_match():
    """Redundancy removal's and eval's edit-distance batches: several
    length buckets (band widths 128 to 1024), with and without clip_to."""
    rng = np.random.default_rng(7)
    bases = np.array(list("ACGT"))
    pairs = []
    for n in (20, 90, 300, 700):
        for _ in range(3):
            a = rng.choice(bases, n)
            b = a.copy()
            b[rng.random(n) < 0.1] = rng.choice(bases)
            b = np.delete(b, rng.integers(0, n, n // 20))
            pairs.append(("".join(a), "".join(b)))
    pairs.append(("ACGT" * 50, "TTTT" * 30))
    for clip in (None, 40):
        np.testing.assert_array_equal(
            port_red.edit_distance_pairs(pairs, clip_to=clip, device="cpu"),
            ref_red.edit_distance_pairs(pairs, clip_to=clip))
    np.testing.assert_array_equal(port_red.edit_sim_batch(pairs,
                                                          device="cpu"),
                                  ref_red.edit_sim_batch(pairs))


def test_edit_distance_wide_bands_match():
    """The length buckets L = 1024 and 2048 (band widths 1024 and 2048):
    similar pairs, and unrelated random pairs whose lengths are within 2x
    of each other."""
    rng = np.random.default_rng(8)
    bases = np.array(list("ACGT"))
    pairs = []
    for n in (600, 1000, 1300, 2000):
        a = rng.choice(bases, n)
        b = a.copy()
        b[rng.random(n) < 0.05] = rng.choice(bases)
        b = np.delete(b, rng.integers(0, n, n // 50))
        pairs.append(("".join(a), "".join(b)))
        m = int(rng.integers(n // 2 + 1, n + 1))
        pairs.append(("".join(rng.choice(bases, n)),
                      "".join(rng.choice(bases, m))))
    np.testing.assert_array_equal(
        port_red.edit_distance_pairs(pairs, device="cpu"),
        ref_red.edit_distance_pairs(pairs))
    np.testing.assert_array_equal(port_red.edit_sim_batch(pairs,
                                                          device="cpu"),
                                  ref_red.edit_sim_batch(pairs))

