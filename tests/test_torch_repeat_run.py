"""`run` on a repeat-rich reference through the port on the CPU, held to
the JAX package's pinned bytes (tests/torch_repeat_run.py,
tools/pin_repeat_run.py).

tests/test_repeat_rich.py's sim implants tandem arrays, ~97%-identity
segdup pairs and homopolymer runs in the reference: the input of the INS →
DUP recovery, the segment back-jump typing and the noisy-contig gates, and
of the DP's ties inside tandem arrays, the k-mer count's many hits on one
hash, the vote's dedup of reads that repeat a few k-mers thousands of
times, the unique mask's segdup k-mers and the pair-HMM's homopolymer
candidates.  The port's `sim`, its BamWriter of the reads as an unaligned
BAM and its `run --fastq` give the pin's bytes, and the run meets that
test's floors through the port's eval.  The port's `_load_reads` of the
unaligned BAM is the FASTQ's dict, order included, so `run --bam
reads.bam` is the FASTQ run (the pin holds both runs' equal bytes); on the
run's coordinate-sorted, HP-tagged phased.bam both packages' `_load_reads`
give one dict in one order.  tests/test_torch_repeat_run_bam.py runs the
port on that phased.bam."""
import argparse
import os
import subprocess
import sys

import pytest

from torch_inputs import ensure_reference_native_lib
from torch_repeat_run import (FLOORS, SIM, SIM_FILES, assert_pinned, digest,
                              pin, port_run, write_reads_bam)


@pytest.fixture(scope="module")
def repeat(tmp_path_factory):
    """The port's sim, its reads.bam and its `run --fastq` (CPU)."""
    from volcanosv_tpu_torch.cli import main as port_main
    from volcanosv_tpu_torch.io import bam
    from volcanosv_tpu_torch.io.fastq import read_fastq
    ensure_reference_native_lib()
    d = tmp_path_factory.mktemp("repeat")
    sim = d / "sim"
    assert port_main(["sim", "-o", str(sim)] + SIM) == 0
    n = write_reads_bam(str(sim / "reads.bam"),
                        read_fastq(str(sim / "reads.fastq")), bam)
    port_run(["--fastq", str(sim / "reads.fastq")], str(sim / "ref.fa"),
             str(d / "fastq"))
    return d, n


def test_pin_is_the_recipe():
    p = pin()
    assert p["sim_args"] == SIM
    assert set(p["runs"]) == {"fastq", "bam", "phased_bam"}
    # the unaligned BAM holds the FASTQ's reads in order: the same run
    assert p["runs"]["bam"]["run"] == p["runs"]["fastq"]["run"]
    assert p["runs"]["phased_bam"]["run"] != p["runs"]["fastq"]["run"]


@pytest.mark.parametrize("name", SIM_FILES)
def test_sim_is_pinned(repeat, name):
    d, _ = repeat
    assert digest(d / "sim" / name) == pin()["sim"][name]


def test_reads_bam_is_pinned(repeat):
    d, n = repeat
    assert n == pin()["n_reads"]
    assert digest(d / "sim" / "reads.bam") == pin()["sim"]["reads.bam"]


def test_fastq_run_is_pinned(repeat):
    d, _ = repeat
    want = pin()["runs"]["fastq"]
    assert_pinned(d / "fastq", {**want["run"],
                                "phased.bam": want["phased.bam"]})


def test_fastq_run_meets_the_floors(repeat):
    """tests/test_repeat_rich.py's floors, through the port's eval: recall
    and precision, and a <DUP> among the complex-SV calls (segment
    back-jump typing or the INS → DUP recovery)."""
    from volcanosv_tpu_torch.eval import evaluate_files
    from volcanosv_tpu_torch.io.vcf import read_vcf
    d, _ = repeat
    res = evaluate_files(str(d / "sim" / "truth.vcf"),
                         str(d / "fastq" / "volcanosv_variants.vcf"),
                         device="cpu")
    assert res.recall >= FLOORS["recall"], res.summary()
    assert res.precision >= FLOORS["precision"], res.summary()
    _h, truth = read_vcf(str(d / "sim" / "truth.vcf"))
    assert sum(r.svtype == "DUP" for r in truth) >= 2
    _h, calls = read_vcf(str(d / "fastq" / "volcanosv_complex_sv.vcf"))
    assert any(str(r.svtype).startswith("DUP") for r in calls)


def test_unaligned_bam_reads_are_the_fastq(repeat):
    """`_load_reads` of reads.bam is the FASTQ's dict in the FASTQ's order
    (in both packages), so `run --bam reads.bam` is the FASTQ run."""
    from volcanosv_tpu import cli as ref_cli
    from volcanosv_tpu_torch import cli as port_cli
    d, n = repeat
    fq = port_cli._load_reads(argparse.Namespace(
        fastq=str(d / "sim" / "reads.fastq"), bam=None))
    args = argparse.Namespace(fastq=None, bam=str(d / "sim" / "reads.bam"))
    got = port_cli._load_reads(args)
    assert len(fq) == n
    assert list(got.items()) == list(fq.items())
    assert list(ref_cli._load_reads(args).items()) == list(fq.items())


def test_phased_bam_reads_equal_in_both_packages(repeat):
    """On the run's phased.bam (aligned, coordinate-sorted, HP/PS tagged,
    reverse-strand reads stored reverse-complemented) both packages'
    `_load_reads` give one dict in one order: the FASTQ's names, in
    another order."""
    from volcanosv_tpu import cli as ref_cli
    from volcanosv_tpu_torch import cli as port_cli
    d, _ = repeat
    args = argparse.Namespace(fastq=None,
                              bam=str(d / "fastq" / "phased.bam"))
    got = port_cli._load_reads(args)
    assert list(got.items()) == list(ref_cli._load_reads(args).items())
    fq = port_cli._load_reads(argparse.Namespace(
        fastq=str(d / "sim" / "reads.fastq"), bam=None))
    assert set(got) <= set(fq) and len(got) > 0.9 * len(fq)
    assert list(got) != [n for n in fq if n in got]


def test_chip_smoke_phase10_imports_no_jax_and_needs_a_card():
    """chip_smoke.py's phase 10 takes the recipe and `write_reads_bam` from
    tools/pin_repeat_run.py without loading jax or the JAX package, and
    `chip_smoke.py --repeat` on a host without CUDA exits non-zero and
    prints nothing on its standard output."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import chip_smoke\n"
            "tool = chip_smoke._repeat_tool()\n"
            "assert tool.SIM and tool.RUNS and tool.FLOORS\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'volcanosv_tpu')]\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    r = subprocess.run([sys.executable, "chip_smoke.py", "--repeat"],
                       cwd=repo, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == "", r.stdout + r.stderr
