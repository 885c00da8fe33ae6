"""Pin the JAX package's mid-size `tools/scale_run.py` bytes → tests/data/.

Runs tools/scale_run.py, unchanged, at SCALE_ARGS (its own 5 Mb row: one
5 Mb chromosome at 24x, seed 11, 9 kb HiFi reads at err 0.002, 30 truth
SVs) on the CPU, with its report inside the work directory, and writes the
arguments, the sha256 and byte size of the sim's ref.fa, reads.fastq and
truth.vcf and of the run's six outputs to tests/data/scale_run_sha256.json,
with a copy of the merged VCF as tests/data/scale_run_variants.vcf (so
that a mismatch can be diffed).  The port's scale checks
(tests/test_torch_scale_run.py's slow test, phase 9 of chip_smoke.py) run
tools/scale_run_torch.py at the same arguments and hold their bytes to this
pin; it is made from the JAX package alone, never from the port's output.

    env JAX_PLATFORMS=cpu python tools/pin_scale_run.py --work /tmp/scale5
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from pin_golden_run import DATA, RUN_OUT, SIM_FILES, digest  # noqa: E402

PIN = os.path.join(DATA, "scale_run_sha256.json")
# every argument of the sim's recipe, spelled out (the values are
# tools/scale_run.py's defaults but for --mb and --coverage)
SCALE_ARGS = ["--mb", "5", "--coverage", "24", "--read_len", "9000",
              "--seed", "11", "--dtype", "Hifi", "--err", "0.002"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", required=True,
                    help="scratch directory for the sim, the run and the "
                         "tool's report")
    args = ap.parse_args(argv)
    import jax
    from scale_run import main as scale_main
    from torch_inputs import ensure_reference_native_lib
    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu")
    ensure_reference_native_lib()     # never the package's Python fallback
    sim_dir = os.path.join(args.work, "sim")
    out_dir = os.path.join(args.work, "out")
    report_path = os.path.join(args.work, "scale.json")
    t0 = time.perf_counter()
    if scale_main(SCALE_ARGS + ["--work", args.work,
                                "--out", report_path]) != 0:
        raise SystemExit("tools/scale_run.py failed")
    with open(report_path) as fh:
        report = json.load(fh)
    pin = {"made_by": "tools/pin_scale_run.py (tools/scale_run.py, "
                      "volcanosv_tpu on the CPU)",
           "scale_args": SCALE_ARGS,
           "accuracy": report["accuracy"],
           "n_reads": report["n_reads"],
           "sim": {n: digest(os.path.join(sim_dir, n)) for n in SIM_FILES},
           "run": {n: digest(os.path.join(out_dir, n)) for n in RUN_OUT}}
    with open(PIN, "w") as fh:
        json.dump(pin, fh, indent=1)
        fh.write("\n")
    shutil.copy(os.path.join(out_dir, "volcanosv_variants.vcf"),
                os.path.join(DATA, "scale_run_variants.vcf"))
    print(f"pinned in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(pin['run'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
