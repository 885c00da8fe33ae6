"""Pin the JAX package's golden `sim` + `run` bytes → tests/data/.

Runs `volcanosv_tpu.cli sim` with tests/test_golden_e2e.py's SIM_ARGS and
then `volcanosv_tpu.cli run` on its reads, on the CPU, and writes the
sha256 and byte size of the sim's ref.fa, reads.fastq and truth.vcf and of
the run's six outputs to tests/data/golden_run_sha256.json, with a copy of
the merged VCF as tests/data/golden_variants.vcf (so that a mismatch can be
diffed).  The port's golden byte checks (tests/test_torch_run.py, phase 5
of chip_smoke.py) hold their outputs to this pin; it is made from the JAX
package alone, never from the port's output.

    env JAX_PLATFORMS=cpu python tools/pin_golden_run.py --work /tmp/golden
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

DATA = os.path.join(REPO, "tests", "data")
SIM_FILES = ["ref.fa", "reads.fastq", "truth.vcf"]
RUN_OUT = ["volcanosv_variants.vcf", "volcanosv_large_indel.vcf",
           "volcanosv_small_indel.vcf", "volcanosv_complex_sv.vcf",
           "final_contigs.fa", "phased_snps.vcf"]


def digest(path: str) -> dict:
    with open(path, "rb") as fh:
        data = fh.read()
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", required=True,
                    help="scratch directory for the sim and the run")
    args = ap.parse_args(argv)
    import jax
    from test_golden_e2e import SIM_ARGS
    from torch_inputs import ensure_reference_native_lib
    from volcanosv_tpu.cli import main as ref_main
    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu")
    ensure_reference_native_lib()     # never the package's Python fallback
    sim_dir = os.path.join(args.work, "sim")
    out_dir = os.path.join(args.work, "out")
    t0 = time.perf_counter()
    if ref_main(["sim", "-o", sim_dir] + SIM_ARGS) != 0:
        raise SystemExit("sim failed")
    if ref_main(["run", "--ref", os.path.join(sim_dir, "ref.fa"),
                 "--fastq", os.path.join(sim_dir, "reads.fastq"),
                 "-o", out_dir]) != 0:
        raise SystemExit("run failed")
    pin = {"made_by": "tools/pin_golden_run.py (volcanosv_tpu on the CPU)",
           "sim_args": SIM_ARGS,
           "sim": {n: digest(os.path.join(sim_dir, n)) for n in SIM_FILES},
           "run": {n: digest(os.path.join(out_dir, n)) for n in RUN_OUT}}
    with open(os.path.join(DATA, "golden_run_sha256.json"), "w") as fh:
        json.dump(pin, fh, indent=1)
        fh.write("\n")
    shutil.copy(os.path.join(out_dir, "volcanosv_variants.vcf"),
                os.path.join(DATA, "golden_variants.vcf"))
    print(f"pinned in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(pin['run'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
