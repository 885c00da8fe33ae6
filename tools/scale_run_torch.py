"""Chromosome-scale `run` of the PyTorch/CUDA port → build/scale_torch.json.

The port's twin of tools/scale_run.py, with the same recipe: a one-
chromosome sim of --mb Mb at --coverage (6 SVs a Mb: a third DEL, a third
INS, a sixth INV, a sixth DUP), then `run --profile --resume` on its reads,
then the port's `eval` of the merged VCF against the sim's truth.  The same
arguments give the same sim bytes as tools/scale_run.py.  The report keeps
that tool's keys (wall time, Mb of reads a second, peak RSS, the stage
table, SV accuracy) and adds the device's: its `nvidia-smi` name and power
limit, the peak device memory allocated and reserved, each kernel
wrapper's launches and largest launch shape, the MEC design of each launch
and the k-mer tables the partition built against its cap.  It imports
nothing of JAX or of the JAX package.

    python3 tools/scale_run_torch.py --mb 10 --coverage 24 --work build/scale10

`--device` is cuda by default and raises on a host without CUDA; the CPU
(the kernels' plain versions) only when asked for with `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import threading
import time

# runnable as `python tools/scale_run_torch.py` from anywhere: sys.path[0]
# is tools/, so put the repo root ahead of it
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _peak_rss_gb() -> float:
    # ru_maxrss is KB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def sim_args(mb: float, coverage: float, read_len: int, err: float,
             seed: int) -> list[str]:
    """tools/scale_run.py's sim recipe: one chromosome of `mb` Mb, SVs at
    6 a Mb (at least 4)."""
    n = max(4, int(mb * 6))
    return ["--length", str(int(mb * 1e6)), "--chroms", "1",
            "--n_del", str(n // 3), "--n_ins", str(n // 3),
            "--n_inv", str(n // 6), "--n_dup", str(n // 6),
            "--coverage", str(coverage), "--read_len", str(read_len),
            "--err", str(err), "--seed", str(seed)]


def wrappers() -> dict:
    """Every kernel wrapper of the port by its kernels-line name."""
    from volcanosv_tpu_torch.ops import banded_align as ba
    from volcanosv_tpu_torch.ops import kmer, overlap
    from volcanosv_tpu_torch.phasing import phase, realign
    from volcanosv_tpu_torch.qc import flagger
    return dict(banded_dp=ba.banded_dp, tb_walk=ba.tb_walk,
                pairhmm_viterbi=realign._viterbi_batch,
                coverage_viterbi=flagger.coverage_viterbi,
                coverage_posteriors=flagger.coverage_posteriors,
                kmer_count=kmer.kmer_count_into,
                unique_mask=kmer.unique_mask, kmer_vote=kmer.kmer_vote,
                mec_phase=phase._mec_phase,
                canonical_hashes=kmer.canonical_hashes,
                ava_overlaps=overlap.ava_overlaps)


def reset_counts() -> None:
    """Every wrapper's launch count to 0 and its shapes emptied."""
    for fn in wrappers().values():
        fn.launches = 0
        fn.shapes = []


def _size(shape) -> int:
    n = 1
    for v in shape:
        if isinstance(v, int):
            n *= max(v, 1)
    return n


def kernel_report(on_card: bool) -> dict:
    """Each wrapper's launches and its largest launch shape (the most
    elements over the shape's integer fields); for the MEC, the design
    `mec_plan` takes at each launch (on the card only: it asks the
    device)."""
    out = {}
    for name, fn in wrappers().items():
        out[name] = dict(launches=fn.launches, largest_shape=list(
            max(fn.shapes, key=_size)) if fn.shapes else None)
    mec = wrappers()["mec_phase"].shapes
    if on_card and mec:
        from volcanosv_tpu_torch.phasing import phase
        designs: dict[str, int] = {}
        for O, _nr, S, R in mec:
            branch, ctas = phase.mec_design(S, R, O)
            key = f"{branch}:{ctas}" if branch == "smem" else branch
            designs[key] = designs.get(key, 0) + 1
        out["mec_phase"]["designs"] = designs
    return out


def _watch_tables(built: list):
    """Wrap partition.build_hap_tables where partition_reads calls it:
    `built` receives each table's haplotype name.  Returns the undo."""
    from volcanosv_tpu_torch.partition import partition
    fn = partition.build_hap_tables

    def wrapper(hap_reads, *a, **kw):
        built.extend(hap_reads)
        return fn(hap_reads, *a, **kw)
    partition.build_hap_tables = wrapper
    return lambda: setattr(partition, "build_hap_tables", fn)


def card_name() -> str | None:
    """`nvidia-smi`'s name and power limit of the first card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mb", type=float, default=50.0,
                    help="genome size in Mb (single chromosome)")
    ap.add_argument("--coverage", type=float, default=24.0)
    ap.add_argument("--read_len", type=int, default=9000)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--dtype", default="Hifi")
    ap.add_argument("--err", type=float, default=0.002)
    ap.add_argument("--work", required=True)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "scale_torch.json"))
    ap.add_argument("--keep", action="store_true",
                    help="keep the work dir (default: leave it; we never rm)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    import torch

    from volcanosv_tpu_torch.cli import main as cli_main
    from volcanosv_tpu_torch.device import resolve_device
    from volcanosv_tpu_torch.eval import evaluate_files
    from volcanosv_tpu_torch.partition import partition
    from volcanosv_tpu_torch.utils.logging import STAGE_TIMES

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    L = int(args.mb * 1e6)
    sim_dir = os.path.join(args.work, "sim")
    out_dir = os.path.join(args.work, "out")
    rss_samples: list[float] = []
    stop = threading.Event()

    def _sampler():
        while not stop.is_set():
            rss_samples.append(_peak_rss_gb())
            stop.wait(2.0)

    t = threading.Thread(target=_sampler, daemon=True)
    t.start()

    t0 = time.time()
    if not os.path.exists(os.path.join(sim_dir, "reads.fastq")):
        rc = cli_main(["sim", "-o", sim_dir]
                      + sim_args(args.mb, args.coverage, args.read_len,
                                 args.err, args.seed))
        if rc != 0:
            return rc
    t_sim = time.time() - t0

    reset_counts()
    STAGE_TIMES.clear()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    built: list[str] = []
    undo = _watch_tables(built)
    t1 = time.time()
    try:
        rc = cli_main(["run", "--ref", os.path.join(sim_dir, "ref.fa"),
                       "--fastq", os.path.join(sim_dir, "reads.fastq"),
                       "-o", out_dir, "--dtype", args.dtype, "--profile",
                       "--resume", "--device", args.device])
        if on_card:
            torch.cuda.synchronize()
    finally:
        undo()
    wall = time.time() - t1
    stop.set()
    if rc != 0:
        return rc
    kernels = kernel_report(on_card)

    res = evaluate_files(os.path.join(sim_dir, "truth.vcf"),
                         os.path.join(out_dir, "volcanosv_variants.vcf"),
                         device=args.device)
    n_reads = sum(1 for _ in open(os.path.join(sim_dir, "reads.fastq"))) // 4
    total_bp = args.coverage * L
    peak = {k: round(f() / 1e9, 3) if on_card else None for k, f in (
        ("device_max_allocated_gb", torch.cuda.max_memory_allocated),
        ("device_max_reserved_gb", torch.cuda.max_memory_reserved))}
    report = {
        "genome_mb": args.mb,
        "coverage": args.coverage,
        "n_reads": n_reads,
        "total_read_gbp": round(total_bp / 1e9, 3),
        "sim_s": round(t_sim, 1),
        "pipeline_wall_s": round(wall, 1),
        "pipeline_mbp_per_s": round(total_bp / 1e6 / wall, 2),
        "peak_rss_gb": round(max(rss_samples + [_peak_rss_gb()]), 2),
        "accuracy": res.summary(),
        "stages": {k: {"total_s": round(v[0], 1), "calls": v[1]}
                   for k, v in sorted(STAGE_TIMES.items(),
                                      key=lambda kv: -kv[1][0])},
        "device": dev.type,
        "card": card_name() if on_card else None,
        "s_per_mb": round(wall / args.mb, 2),
        **peak,
        "kernels": kernels,
        "partition_tables": {"built": len(built),
                             "distinct": len(set(built)),
                             "cap": partition.MAX_TABLES},
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
        fh.write("\n")
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
