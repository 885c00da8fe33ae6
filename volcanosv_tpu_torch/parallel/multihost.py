"""N ranks of one `torch.distributed` group on this host, driving the
port's multi-process path end to end:

  * `init_multihost`          — every rank joins the group (a free
                                localhost port; the backend rule of
                                parallel/mesh.py)
  * `host_chromosome_shard`   — each rank owns a disjoint chromosome share
                                (the '22 SLURM jobs' replacement)
  * `gather_across_processes` + `wgs_global_median` — the WGS coverage
    median from PER-RANK-DISTINCT vectors, checked against the union's
  * `build_sharded_align_step` — one step over the ranks, each with a
    1 × STEP_DATA in-process mesh of its device, against the same step in
    one process on an (N, STEP_DATA) mesh of the parent's device
  * the `vc-large-indel`, `vc-small-indel` and `vc-complex-sv` drivers
    (and with `--full` the `run` subcommand) with every rank writing into one
    shared out_dir: query-sharded alignment, shared-FS record exchange,
    the global-median collective, per-rank part VCFs, rank-0 merge.  Their
    outputs must be byte-identical to one process's.

    python -m volcanosv_tpu_torch.parallel.multihost [--n 2] [--device cuda]
        [--work DIR] [--sim_dir DIR] [--full [--run_sim_dir DIR]
        [--run_reference DIR]] [--out PATH]

The parent simulates the data (unless --sim_dir names it), makes the
one-process runs (unless --run_reference holds `run`'s), starts the ranks,
stops them all as soon as one fails, and writes a JSON file (default
<work>/multihost.json) with each rank's device, backend, owned chromosomes,
times and kernel launches, and the byte-identity verdicts; exit 0 when
every verdict holds.  The ranks use one torch thread each.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# tools/multihost.py's recipe: 2 x 50 kb, 3 DEL + 3 INS, 24x, 6 kb reads
SIM = ["--length", "50000", "--chroms", "2", "--n_del", "3", "--n_ins", "3",
       "--coverage", "24", "--read_len", "6000", "--seed", "11"]
VC = (("vc-large-indel", "multi", "volcanosv_large_indel.vcf"),
      ("vc-small-indel", "multi_small", "volcanosv_small_indel.vcf"),
      ("vc-complex-sv", "multi_cx", "volcanosv_complex_sv.vcf"))
RUN_OUT = ("volcanosv_variants.vcf", "volcanosv_large_indel.vcf",
           "volcanosv_small_indel.vcf", "volcanosv_complex_sv.vcf",
           "final_contigs.fa", "phased_snps.vcf")
STEP = dict(W=64, d_lo=-32, k=6)
STEP_DATA = 4               # devices of each rank's mesh in the step
GENOME_CHROMS = [f"chr{i}" for i in range(1, 23)]


def step_inputs(n: int, seed: int = 7):
    """The step's global batch: 4 windows a device of an (n, STEP_DATA)
    mesh, M = 128 against 192-column targets, tlen = M + 8."""
    rng = np.random.default_rng(seed)
    B, M = 4 * n * STEP_DATA, 128
    q = rng.integers(0, 4, (B, M), dtype=np.int8)
    t = rng.integers(0, 4, (B, M + 64), dtype=np.int8)
    return q, t, np.full((B,), M, np.int32), np.full((B,), M + 8, np.int32)


def _vc_args(cmd: str, sim_dir: str, out: str, device: str,
             large_vcf: str | None) -> list[str]:
    args = [cmd, "--ref", f"{sim_dir}/ref.fa",
            "--contig", f"{sim_dir}/true_contigs.fa",
            "--fastq", f"{sim_dir}/reads.fastq", "-o", out,
            "--device", device]
    return args + (["--large_vcf", large_vcf] if large_vcf else [])


def _run_args(sim_dir: str, out: str, device: str) -> list[str]:
    return ["run", "--ref", f"{sim_dir}/ref.fa",
            "--fastq", f"{sim_dir}/reads.fastq", "-o", out,
            "--device", device]


def _vc_all(main, sim_dir: str, work: str, prefix: str, device: str):
    """The three vc drivers into <work>/<prefix><dir>; the complex-SV one
    reads the large-indel VCF of the same prefix."""
    secs = {}
    for cmd, sub, _name in VC:
        large = os.path.join(work, prefix + "multi",
                             "volcanosv_large_indel.vcf") \
            if cmd == "vc-complex-sv" else None
        t0 = time.perf_counter()
        if main(_vc_args(cmd, sim_dir, os.path.join(work, prefix + sub),
                         device, large)) != 0:
            raise RuntimeError(f"{cmd} failed in {prefix or 'ranks'}")
        secs[cmd] = time.perf_counter() - t0
    return secs


def _counted(fn, name: str, calls: dict):
    """fn, adding one to calls[name] at each call."""
    def wrapper(*args, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kw)
    return wrapper


def worker(rank: int, n: int, port: int, work: str,
           sim_dir: str, device: str, run_sim_dir: str | None) -> None:
    import torch
    import torch.distributed as dist

    from ..cli import main
    from ..device import resolve_device
    from ..io.fasta import read_fasta
    from ..ops import banded_align as ba
    from . import multiproc
    from .mesh import host_chromosome_shard, init_multihost, make_mesh
    from .step import build_sharded_align_step
    from .wgs import wgs_global_median
    torch.set_num_threads(1)
    t_start = time.perf_counter()
    if not init_multihost(f"127.0.0.1:{port}", n, rank):
        raise RuntimeError("process group init failed")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    # every rank contributes DIFFERENT vectors (the per-rank chromosome
    # shards carry distinct data in a real run); the union median must
    # equal the median of all ranks' values concatenated
    def rank_vals(p: int) -> np.ndarray:
        r = np.random.default_rng(100 + p)
        return r.uniform(0, 4, 11 + 7 * p).astype(np.float32)

    glob = multiproc.gather_across_processes(rank_vals(rank))
    want_all = np.concatenate([rank_vals(p) for p in range(n)])
    if not np.array_equal(np.sort(glob), np.sort(want_all)):
        raise AssertionError("gather_across_processes: wrong union")
    med = wgs_global_median([glob], None)
    if abs(med - float(np.median(want_all))) >= 1e-5:
        raise AssertionError(f"median {med} != {np.median(want_all)}")

    q, t, ql, tl = step_inputs(n)
    per = len(q) // n
    mine = slice(rank * per, (rank + 1) * per)
    step = build_sharded_align_step(make_mesh(devices=[dev] * STEP_DATA,
                                              genome_shards=1), **STEP)
    step_s = []
    for _ in range(2):          # the second call is the warm step's time
        dist.barrier()
        t0 = time.perf_counter()
        score, table, gathered = step(q[mine], t[mine], ql[mine], tl[mine])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    np.savez(os.path.join(work, f"step_rank{rank}.npz"),
             score=score.cpu().numpy(), table=table.cpu().numpy(),
             gathered=gathered.cpu().numpy())

    ba.reset_launch_counts()
    secs = _vc_all(main, sim_dir, work, "", device)
    launches = {"vc": {"banded_dp": ba.banded_dp.launches,
                       "tb_walk": ba.tb_walk.launches}}
    row = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
           "own_chroms": host_chromosome_shard(GENOME_CHROMS),
           "own_sim_chroms": host_chromosome_shard(
               list(read_fasta(f"{sim_dir}/ref.fa"))),
           "median_ok": True, "median": med, "step_s": step_s}
    if run_sim_dir:
        calls = {}
        wrapped = {name: getattr(multiproc, name) for name in (
            "gather_across_processes", "barrier", "exchange_by_chrom",
            "broadcast_from_rank0")}
        for name, fn in wrapped.items():
            setattr(multiproc, name, _counted(fn, name, calls))
        ba.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rc = main(_run_args(run_sim_dir, os.path.join(work, "multi_run"),
                                device))
        finally:
            for name, fn in wrapped.items():
                setattr(multiproc, name, fn)
        if rc != 0:
            raise RuntimeError("run failed")
        secs["run"] = time.perf_counter() - t0
        launches["run"] = {"banded_dp": ba.banded_dp.launches,
                           "tb_walk": ba.tb_walk.launches}
        # (mode, design, B, M, W) of each DP launch, (design, B, M, W) of
        # each walk
        row["run_shapes"] = {"banded_dp": ba.banded_dp.shapes,
                             "tb_walk": ba.tb_walk.shapes}
        row["run_collectives"] = calls
        row["own_run_chroms"] = host_chromosome_shard(
            list(read_fasta(f"{run_sim_dir}/ref.fa")))
    row.update(seconds=secs, launches=launches,
               wall_s=time.perf_counter() - t_start)
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(row))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _same(a: str, b: str) -> bool:
    try:
        x, y = _read(a), _read(b)
    except OSError as e:
        print(f"missing output: {e}", file=sys.stderr)
        return False
    return x == y and len(x) > 0


def _spawn(args, work: str, port: int) -> list[subprocess.Popen]:
    procs = []
    for rank in range(args.n):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [PKG_PARENT] + [p for p in [env.get("PYTHONPATH")] if p])
        env.update(OMP_NUM_THREADS="1", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(args.n))
        cmd = [sys.executable, "-m", "volcanosv_tpu_torch.parallel.multihost",
               "--worker", str(rank), "--n", str(args.n), "--port",
               str(port), "--work", work,
               "--sim_dir", args.sim_dir, "--device", args.device]
        if args.full:
            cmd += ["--full", "--run_sim_dir", args.run_sim_dir]
        with open(os.path.join(work, f"rank{rank}.out"), "w") as out, \
                open(os.path.join(work, f"rank{rank}.err"), "w") as err:
            procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                          stderr=err, cwd=PKG_PARENT))
    return procs


def _wait(procs: list[subprocess.Popen], timeout: float) -> bool:
    """Wait for every rank; stop them all at the first failure or the
    deadline (a rank whose peer died would wait at a barrier).  True when
    all exited 0."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                return False
            time.sleep(0.2)
        return all(p.returncode == 0 for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def parent(args) -> int:
    import torch

    from ..cli import main
    from .mesh import make_mesh
    from .step import build_sharded_align_step
    torch.set_num_threads(1)
    work = os.path.abspath(args.work or tempfile.mkdtemp(
        prefix="volcanosv_torch_multihost_"))
    os.makedirs(work, exist_ok=True)
    if args.sim_dir is None:
        args.sim_dir = os.path.join(work, "sim")
        if main(["sim", "-o", args.sim_dir] + SIM) != 0:
            raise RuntimeError("sim failed")
    args.sim_dir = os.path.abspath(args.sim_dir)
    if args.full:
        args.run_sim_dir = os.path.abspath(args.run_sim_dir or args.sim_dir)
    # the one-process references
    single_s = _vc_all(main, args.sim_dir, work, "single_", args.device)
    run_ref = args.run_reference
    if args.full and run_ref is None:
        run_ref = os.path.join(work, "single_run")
        t0 = time.perf_counter()
        if main(_run_args(args.run_sim_dir, run_ref, args.device)) != 0:
            raise RuntimeError("one-process run failed")
        single_s["run"] = time.perf_counter() - t0
    q, t, ql, tl = step_inputs(args.n)
    dev = torch.device(args.device)
    ref_step = build_sharded_align_step(
        make_mesh(devices=[dev] * (args.n * STEP_DATA), genome_shards=args.n),
        **STEP, device=args.device)(q, t, ql, tl)

    port = _free_port()
    t0 = time.perf_counter()
    procs = _spawn(args, work, port)
    ok = _wait(procs, args.timeout)
    ranks_s = time.perf_counter() - t0
    rows = []
    for rank in range(args.n):
        lines = _read(os.path.join(work, f"rank{rank}.out")).decode(
            errors="replace").strip().splitlines()
        if procs[rank].returncode == 0 and lines:
            rows.append(json.loads(lines[-1]))
        else:
            ok = False
            err = _read(os.path.join(work, f"rank{rank}.err")).decode(
                errors="replace")
            print(f"rank {rank} exited {procs[rank].returncode}:\n"
                  f"{err[-3000:]}", file=sys.stderr)
    owned = sorted(c for r in rows for c in r["own_chroms"])
    verdicts = {name: _same(os.path.join(work, "single_" + sub, name),
                            os.path.join(work, sub, name))
                for _cmd, sub, name in VC}
    step_same = None
    if len(rows) == args.n:
        parts = [np.load(os.path.join(work, f"step_rank{r}.npz"))
                 for r in range(args.n)]
        want = [x.cpu().numpy() for x in ref_step]
        step_same = bool(
            np.array_equal(np.concatenate([p["score"] for p in parts]),
                           want[0])
            and all(np.array_equal(p["table"], want[1]) for p in parts)
            and all(np.array_equal(p["gathered"], want[2]) for p in parts))
    run_same = None
    if args.full:
        run_same = {name: _same(os.path.join(run_ref, name),
                                os.path.join(work, "multi_run", name))
                    for name in RUN_OUT}
    n_records = sum(1 for ln in _read(os.path.join(
        work, "single_multi", "volcanosv_large_indel.vcf")).splitlines()
        if not ln.startswith(b"#"))
    result = {
        "n_processes": args.n, "device": args.device,
        "ok": bool(ok and len(rows) == args.n and owned == sorted(GENOME_CHROMS)
                   and all(verdicts.values()) and step_same
                   and (run_same is None or all(run_same.values()))),
        "large_vcf_identical": verdicts["volcanosv_large_indel.vcf"],
        "small_vcf_identical": verdicts["volcanosv_small_indel.vcf"],
        "complex_vcf_identical": verdicts["volcanosv_complex_sv.vcf"],
        "large_vcf_records": n_records,
        "step_identical": step_same,
        "run_identical": run_same,
        "single_s": single_s, "ranks_s": ranks_s,
        "work": work, "rows": rows,
    }
    out = args.out or os.path.join(work, "multihost.json")
    with open(out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2, help="ranks")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank: cuda (default; "
                         "raises when absent) or cpu")
    ap.add_argument("--work", help="shared work dir (sim data + outputs)")
    ap.add_argument("--sim_dir", help="sim output (ref.fa, reads.fastq, "
                                      "true_contigs.fa) of the vc drivers")
    ap.add_argument("--full", action="store_true",
                    help="also run the `run` subcommand across the ranks and "
                         "compare its outputs' bytes")
    ap.add_argument("--run_sim_dir", help="sim output `run` reads "
                                          "(default: --sim_dir)")
    ap.add_argument("--run_reference",
                    help="a one-process `run`'s out_dir on --run_sim_dir "
                         "(default: made here)")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds the ranks may take together")
    ap.add_argument("--out", help="result JSON (default <work>/multihost.json)")
    ap.add_argument("--worker", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from ..device import resolve_device
    resolve_device(args.device)
    if args.worker is not None:
        worker(args.worker, args.n, args.port, args.work,
               args.sim_dir, args.device,
               args.run_sim_dir if args.full else None)
        return 0
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())
