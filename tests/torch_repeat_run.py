"""The repeat-rich `run`'s pin and helpers, shared by
tests/test_torch_repeat_run.py and tests/test_torch_repeat_run_bam.py.

tools/pin_repeat_run.py made tests/data/repeat_run_sha256.json from the
JAX package alone: tests/test_repeat_rich.py's sim, then `run` on its
FASTQ, on the same reads as an unaligned BAM, and on the FASTQ run's
phased.bam.  Imports neither jax nor the JAX package."""
import hashlib
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from pin_repeat_run import (FLOORS, PIN, RUN_OUT, SIM,  # noqa: E402,F401
                            SIM_FILES, write_reads_bam)


def pin() -> dict:
    with open(PIN) as fh:
        return json.load(fh)


def digest(path) -> dict:
    with open(path, "rb") as fh:
        data = fh.read()
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}


def port_run(reads: list, ref: str, out: str) -> None:
    """The port's `run --device cpu` with `reads` (["--fastq", path] or
    ["--bam", path]) on one torch thread: the plain versions' many small
    ops otherwise wait on every pool thread while the suite's other
    workers hold the cores."""
    from volcanosv_tpu_torch.cli import main as port_main
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert port_main(["run", "--ref", ref, *reads, "-o", out,
                          "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(n)


def assert_pinned(out, want: dict) -> None:
    """Each named output of `out` has its pinned sha256 and size."""
    bad = {n: digest(os.path.join(out, n)) for n, w in want.items()
           if digest(os.path.join(out, n)) != w}
    assert not bad, bad
