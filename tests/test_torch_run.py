"""`sim`, `run` and `merge-vcf` through both CLIs — volcanosv_tpu.cli and
volcanosv_tpu_torch.cli --device cpu.  `run` goes reads → asm → the three
callers → merged VCF on a small two-chromosome recipe with an INV, a DUP,
a translocation and small indels, so every caller writes records: the six
outputs must be byte-identical, again after `run --resume` from the asm
checkpoint.  The golden sim's run (tests/test_golden_e2e.py's SIM_ARGS) is
the `slow` test: the JAX package's run alone takes minutes on the CPU."""
import os
import shutil

import pytest
import torch

from torch_inputs import ensure_reference_native_lib
from volcanosv_tpu.cli import main as ref_main
from volcanosv_tpu_torch.cli import main as port_main

SIM = ["--length", "50000", "--chroms", "2", "--n_del", "2", "--n_ins", "2",
       "--n_inv", "1", "--n_dup", "1", "--n_small", "4", "--n_tra", "1",
       "--min_len", "300", "--max_len", "1000", "--coverage", "20",
       "--read_len", "7000", "--seed", "3"]
SIM_OUT = ["ref.fa", "reads.fastq", "truth.vcf", "truth_snps.vcf",
           "true_contigs.fa"]
RUN_OUT = ["volcanosv_variants.vcf", "volcanosv_large_indel.vcf",
           "volcanosv_small_indel.vcf", "volcanosv_complex_sv.vcf",
           "final_contigs.fa", "phased_snps.vcf"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path is many small tensor ops; beside the suite's
    other workers one intra-op thread is faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _reference_native_lib():
    ensure_reference_native_lib()


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _run(main, d, out, *extra):
    assert main(["run", "--ref", str(d / "sim_jax" / "ref.fa"),
                 "--fastq", str(d / "sim_jax" / "reads.fastq"),
                 "-o", str(d / out), *extra]) == 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sims from one seed, then `run` by both packages on the JAX
    sim's files; counts the port's phase-aware GT calls."""
    from volcanosv_tpu_torch.vc import gt_correction
    d = tmp_path_factory.mktemp("run")
    assert ref_main(["sim", "-o", str(d / "sim_jax")] + SIM) == 0
    assert port_main(["sim", "-o", str(d / "sim_port")] + SIM) == 0
    _run(ref_main, d, "jax")
    calls = []
    fn = gt_correction.phase_aware_gt
    gt_correction.phase_aware_gt = \
        lambda *a, **kw: calls.append(1) or fn(*a, **kw)
    try:
        _run(port_main, d, "port", "--device", "cpu")
    finally:
        gt_correction.phase_aware_gt = fn
    return d, len(calls)


@pytest.mark.parametrize("name", SIM_OUT)
def test_sim_byte_identical(runs, name):
    d, _ = runs
    assert _read(d / "sim_port" / name) == _read(d / "sim_jax" / name)


def test_sim_repeats_byte_identical(tmp_path):
    """The reference-repeat, clustered and nested options, with their
    repeats.bed."""
    args = ["--length", "30000", "--chroms", "2", "--n_tandem", "1",
            "--n_segdup", "1", "--n_homopoly", "1", "--n_clustered", "1",
            "--n_nested", "1", "--n_small", "2", "--coverage", "3",
            "--seed", "9"]
    assert ref_main(["sim", "-o", str(tmp_path / "j")] + args) == 0
    assert port_main(["sim", "-o", str(tmp_path / "p")] + args) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p"))
    assert "repeats.bed" in names
    for name in names:
        assert _read(tmp_path / "p" / name) == _read(tmp_path / "j" / name)


@pytest.mark.parametrize("name", RUN_OUT + ["phased.bam"])
def test_run_outputs_byte_identical(runs, name):
    d, _ = runs
    want = _read(d / "jax" / name)
    assert _read(d / "port" / name) == want and want


def test_run_reaches_every_caller(runs):
    """Records from all three callers, and the large-indel finaliser's
    phase-aware GT downgrade reached through read_hp."""
    d, n_phase_aware = runs
    merged = _read(d / "port" / "volcanosv_variants.vcf")
    for tag in (b"<INV>", b"<DUP>", b"SVTYPE=BND", b"-INS-", b"-DEL-",
                b"volcano.chr"):
        assert tag in merged, tag
    assert n_phase_aware == 2          # one per chromosome


def test_snp_eval_matches(runs):
    """The SNP scoring (recall, precision, zygosity, switch error) of the
    run's phased SNPs against the sim's truth SNPs."""
    from volcanosv_tpu.eval import evaluate_snp_files as ref_eval
    from volcanosv_tpu_torch.eval import evaluate_snp_files
    d, _ = runs
    files = (str(d / "sim_jax" / "truth_snps.vcf"),
             str(d / "port" / "phased_snps.vcf"))
    got = evaluate_snp_files(*files)
    assert got == ref_eval(*files)
    assert got["snp_tp"] > 0 and got["switch_pairs"] > 0


def test_run_resume_from_asm_checkpoint(runs, monkeypatch):
    """`run --resume` in a directory holding only the asm checkpoint of the
    port's run: the assembly is not redone, and the six outputs are the JAX
    package's bytes again."""
    from volcanosv_tpu_torch.pipeline import asm
    d, _ = runs
    ck = d / "resume" / "checkpoints"
    ck.mkdir(parents=True)
    for name in os.listdir(d / "port" / "checkpoints"):
        if name.startswith(("asm_", "snps_", "read_hp_")):
            shutil.copy(d / "port" / "checkpoints" / name, ck / name)

    def no_assembly(*a, **kw):
        raise AssertionError("resume assembled a chromosome again")
    monkeypatch.setattr(asm, "assemble_chromosome", no_assembly)
    _run(port_main, d, "resume", "--resume", "--device", "cpu")
    for name in RUN_OUT:
        assert _read(d / "resume" / name) == _read(d / "jax" / name), name


def test_merge_vcf_byte_identical(runs):
    d, _ = runs
    parts = [str(d / "jax" / n) for n in reversed(RUN_OUT[1:4])]
    assert ref_main(["merge-vcf", "--out_vcf", str(d / "m_jax.vcf")]
                    + parts) == 0
    assert port_main(["merge-vcf", "--out_vcf", str(d / "m_port.vcf")]
                     + parts) == 0
    want = _read(d / "m_jax.vcf")
    assert _read(d / "m_port.vcf") == want
    assert want.count(b"\n") > len(RUN_OUT)


@pytest.mark.slow
def test_golden_run_byte_identical(tmp_path):
    """The round's north-star check: `sim` + `run` with the golden gate's
    SIM_ARGS (4 x 250 kb, 30x HiFi at 9 kb, every SV type, a translocation,
    small indels) by both packages, the port on the CPU: the merged VCFs
    are byte-identical, and the port's sim is the pinned truth."""
    from test_golden_e2e import _FIXTURE, SIM_ARGS
    for name, main, extra in (("jax", ref_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        sim_dir = tmp_path / f"sim_{name}"
        assert main(["sim", "-o", str(sim_dir)] + SIM_ARGS) == 0
        assert main(["run", "--ref", str(sim_dir / "ref.fa"),
                     "--fastq", str(sim_dir / "reads.fastq"),
                     "-o", str(tmp_path / name)] + extra) == 0
    assert _read(tmp_path / "sim_port" / "truth.vcf") == _read(_FIXTURE)
    for name in RUN_OUT:
        assert _read(tmp_path / "port" / name) == \
            _read(tmp_path / "jax" / name), name
