"""`run --bam phased.bam` through the port on the CPU, on the repeat-rich
sim (tests/torch_repeat_run.py): the input is the phased.bam of a `run`
on that sim's FASTQ, aligned, coordinate-sorted and HP/PS tagged, the
reference pipeline's own input form.  Its reads come in another order,
and on the reverse strand, so the run's six outputs differ from the FASTQ
run's; they must be the JAX package's pinned bytes
(tools/pin_repeat_run.py).  The phased.bam is made by the JAX package's
`sim` and `run`, held to the pin first; tests/test_torch_repeat_run.py
holds the port's own FASTQ run to the same phased.bam bytes."""
import pytest

from torch_inputs import ensure_reference_native_lib
from torch_repeat_run import SIM, assert_pinned, digest, pin, port_run


@pytest.fixture(scope="module")
def phased_run(tmp_path_factory):
    from volcanosv_tpu.cli import main as ref_main
    ensure_reference_native_lib()
    d = tmp_path_factory.mktemp("repeat_bam")
    sim = d / "sim"
    assert ref_main(["sim", "-o", str(sim)] + SIM) == 0
    assert ref_main(["run", "--ref", str(sim / "ref.fa"), "--fastq",
                     str(sim / "reads.fastq"), "-o", str(d / "fastq")]) == 0
    port_run(["--bam", str(d / "fastq" / "phased.bam")], str(sim / "ref.fa"),
             str(d / "phased_bam"))
    return d


def test_input_is_the_pinned_phased_bam(phased_run):
    assert digest(phased_run / "fastq" / "phased.bam") == \
        pin()["runs"]["fastq"]["phased.bam"]


@pytest.mark.parametrize("name", sorted(pin()["runs"]["phased_bam"]["run"]))
def test_phased_bam_run_is_pinned(phased_run, name):
    want = pin()["runs"]["phased_bam"]["run"][name]
    assert_pinned(phased_run / "phased_bam", {name: want})
