"""Pin the JAX package's repeat-rich `sim` + three `run`s → tests/data/.

On the CPU, with the JAX package alone:

1. `volcanosv_tpu.cli sim` with SIM, tests/test_repeat_rich.py's recipe
   spelled out here (300 kb, tandem arrays, ~97%-identity segdup pairs and
   homopolymer runs implanted in the reference, every SV type, 30x HiFi);
2. `run --fastq reads.fastq`;
3. reads.bam: the same reads as an unaligned BAM (flag 4, no @SQ, in the
   FASTQ's order; `write_reads_bam` with the JAX package's BamWriter);
4. `run --bam reads.bam`;
5. `run --bam <2's phased.bam>`: aligned, coordinate-sorted and HP/PS
   tagged, the reference pipeline's own input form.

Writes the arguments, the sha256 and byte size of the sim's files and of
reads.bam, of each run's six outputs (and of the FASTQ run's phased.bam),
and the eval of the FASTQ run (recall, precision, GT) to
tests/data/repeat_run_sha256.json, with the merged VCFs of the FASTQ run
and of the phased.bam run as tests/data/repeat_run_variants.vcf and
tests/data/repeat_run_bam_variants.vcf (so that a mismatch can be diffed).
The port's checks (tests/test_torch_repeat_run.py,
tests/test_torch_repeat_run_bam.py, phase 10 of chip_smoke.py) hold their
bytes to this pin; it is made from the JAX package alone, never from the
port's output.  This module imports neither jax nor a package at import
time: the port's checks take SIM, the file lists and `write_reads_bam`
from it.

    env JAX_PLATFORMS=cpu python tools/pin_repeat_run.py --work /tmp/repeat
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
sys.path.insert(0, os.path.join(REPO, "tools"))

from pin_golden_run import DATA, RUN_OUT, digest  # noqa: E402

PIN = os.path.join(DATA, "repeat_run_sha256.json")
VARIANTS = {"fastq": os.path.join(DATA, "repeat_run_variants.vcf"),
            "phased_bam": os.path.join(DATA, "repeat_run_bam_variants.vcf")}
# tests/test_repeat_rich.py's SIM
SIM = ["--length", "300000", "--chroms", "1",
       "--n_tandem", "5", "--n_segdup", "2", "--n_homopoly", "6",
       "--n_del", "6", "--n_ins", "6", "--n_dup", "4", "--n_inv", "2",
       "--n_small", "4", "--coverage", "30", "--read_len", "9000",
       "--seed", "31"]
SIM_FILES = ["ref.fa", "reads.fastq", "truth.vcf", "truth_snps.vcf",
             "repeats.bed"]
# tests/test_repeat_rich.py's floors on the FASTQ run's merged VCF
FLOORS = {"recall": 0.85, "precision": 0.90}
# the three runs: name → the reads argument, relative to the work dir
RUNS = {"fastq": ["--fastq", "sim/reads.fastq"],
        "bam": ["--bam", "sim/reads.bam"],
        "phased_bam": ["--bam", "fastq/phased.bam"]}
UNALIGNED_HEADER = "@HD\tVN:1.6\tSO:unknown\n"


def write_reads_bam(path: str, reads, bam) -> int:
    """(name, seq, qual) reads → an unaligned BAM at `path`, in their
    order: flag 4, no reference, the FASTQ's phred qualities.  `bam` is
    either package's io.bam module.  Returns the number of records."""
    import numpy as np
    n = 0
    with bam.BamWriter(path, [], [], header_text=UNALIGNED_HEADER) as w:
        for name, seq, qual in reads:
            w.write(bam.BamRecord(
                name=name, flag=bam.FUNMAP, seq=seq,
                qual=np.frombuffer(qual.encode(), np.uint8) - 33))
            n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", required=True,
                    help="scratch directory for the sim and the runs")
    args = ap.parse_args(argv)
    import jax
    from torch_inputs import ensure_reference_native_lib
    from volcanosv_tpu.cli import main as ref_main
    from volcanosv_tpu.eval import evaluate_files
    from volcanosv_tpu.io import bam
    from volcanosv_tpu.io.fastq import read_fastq
    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu")
    ensure_reference_native_lib()     # never the package's Python fallback
    w = args.work
    sim_dir = os.path.join(w, "sim")
    t0 = time.perf_counter()
    if ref_main(["sim", "-o", sim_dir] + SIM) != 0:
        raise SystemExit("sim failed")
    n_reads = write_reads_bam(os.path.join(sim_dir, "reads.bam"),
                              read_fastq(os.path.join(sim_dir,
                                                      "reads.fastq")), bam)
    pin = {"made_by": "tools/pin_repeat_run.py (volcanosv_tpu on the CPU)",
           "sim_args": SIM, "n_reads": n_reads,
           "sim": {n: digest(os.path.join(sim_dir, n))
                   for n in SIM_FILES + ["reads.bam"]},
           "runs": {}}
    for run, reads in RUNS.items():
        t1 = time.perf_counter()
        out = os.path.join(w, run)
        if ref_main(["run", "--ref", os.path.join(sim_dir, "ref.fa"),
                     reads[0], os.path.join(w, reads[1]), "-o", out]) != 0:
            raise SystemExit(f"run {run} failed")
        pin["runs"][run] = {
            "reads": reads,
            "run": {n: digest(os.path.join(out, n)) for n in RUN_OUT}}
        if run == "fastq":
            pin["runs"][run]["phased.bam"] = digest(
                os.path.join(out, "phased.bam"))
            res = evaluate_files(os.path.join(sim_dir, "truth.vcf"),
                                 os.path.join(out, "volcanosv_variants.vcf"))
            pin["accuracy"] = {"recall": round(res.recall, 4),
                               "precision": round(res.precision, 4),
                               "gt_concordance": round(res.gt_concordance,
                                                       4)}
        if run in VARIANTS:
            shutil.copy(os.path.join(out, "volcanosv_variants.vcf"),
                        VARIANTS[run])
        print(f"{run} pinned in {time.perf_counter() - t1:.1f} s: "
              f"{json.dumps(pin['runs'][run]['run'])}")
    with open(PIN, "w") as fh:
        json.dump(pin, fh, indent=1)
        fh.write("\n")
    print(f"pinned in {time.perf_counter() - t0:.1f} s; accuracy "
          f"{json.dumps(pin['accuracy'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
