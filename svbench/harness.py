"""The benchmark of volcanosv_tpu_torch: a stream of single-chromosome jobs.

    python3 svbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (svbench/configs/<name>.json:
the reads and the variant densities of a deployment) and a traffic mix
(svbench/traffic/<name>.json: the job's chromosome length, any repeats, the
port's commands a job runs, and the pool size); a job's counts of variants
are the densities times its length (svbench/gen/recipe.py).
Its correctness limits are svbench/limits/<cell>.json, and each per-layer
metric is svbench/metrics/<metric>.json with its reader in
svbench/readers/<kind>.py.  All are found by name.

Set-up makes a pool of distinct jobs from the seed, in parallel worker
processes (svbench/gen), runs one warm-up job of the cell's own size, and then
measures: jobs run one after another, in a fixed order, each an in-process
call of the port's `cli.main` per command with a fresh output directory;
none starts once --seconds have passed.  `ref_kb_per_s` is the reference
kilobases of the completed jobs over the time from the window's start to
the last job's end; `host_rss_peak_gb` the highest VmRSS of the process
sampled every 20 ms in the window; `setup_s` the time from the process's
start to the window's.  The process's CPU seconds in the window (its own
and its ended children's, getrusage) are recorded beside them.  Once the window has closed and the device's peak
is read, the plain judge (svbench/reference) holds every completed job's
outputs against what the generator implanted, and the numbers pooled over
the window are compared with the cell's limits.  With --trace 1 the
window runs under torch.profiler (CUDA activity only) with spans around
the port's layers, and the per-layer metrics are reported instead.
"""
from __future__ import annotations

import gc
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "volcanosv_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# --- the benchmark's data, by name -----------------------------------------

def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_cell(name: str) -> dict:
    """The cell, its configuration, traffic, limits and per-layer metrics."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    reports = {m["name"] for m in bench["end_to_end"]
               if name in m.get("workloads", [name])}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in reports]
    return dict(
        cell=cell, bench=bench,
        config=load_json(ROOT, cfg_entry["file"]),
        traffic=load_json(HERE, "traffic", cell["traffic"] + ".json"),
        limits=load_json(HERE, "limits", name + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if m["name"] in reports],
        per_layer=[(m, load_json(HERE, "metrics", m["name"] + ".json"))
                   for m in per_layer])


# --- host facts and the RSS sampler --------------------------------------

def process_age_s() -> float:
    """Seconds since this process started (/proc, read only)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def nvidia_smi() -> dict | None:
    q = "name,clocks.sm,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    first = out.strip().splitlines()[0] if out.strip() else ""
    return dict(zip(q.split(","), (f.strip() for f in first.split(","))))


def host_facts() -> dict:
    import torch
    return dict(cpu_count=os.cpu_count(),
                affinity=len(os.sched_getaffinity(0)),
                loadavg=list(os.getloadavg()),
                torch_threads=torch.get_num_threads(),
                card=nvidia_smi())


def host_probe_s() -> float:
    """Seconds of a fixed piece of single-threaded work: the host's speed
    just before and just after the window, printed beside the rate."""
    import numpy as np
    a = np.arange(1 << 20, dtype=np.float64)
    t0 = time.perf_counter()
    for _ in range(40):
        a = np.sqrt(a + 1.0)
    return time.perf_counter() - t0


class RssSampler:
    """The highest VmRSS of this process, read every `period` seconds."""

    def __init__(self, period: float = 0.02):
        self.period = period
        self.peak_kb = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def rss_kb() -> int:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
        return 0

    def _run(self) -> None:
        while not self._stop.is_set():
            self.peak_kb = max(self.peak_kb, self.rss_kb())
            self._stop.wait(self.period)

    def __enter__(self):
        self.peak_kb = self.rss_kb()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_kb = max(self.peak_kb, self.rss_kb())


# --- a job ------------------------------------------------------------------

def job_commands(traffic: dict, config: dict, job_dir: str, out_dir: str,
                 device: str) -> list[list[str]]:
    """The port's commands of one job, from the traffic's templates."""
    fill = dict(ref=os.path.join(job_dir, "ref.fa"),
                reads=os.path.join(job_dir, "reads.fastq"),
                contigs=os.path.join(job_dir, "contigs.fa"),
                out=out_dir, dtype=config["dtype"], device=device)
    return [[a.format(**fill) for a in cmd] for cmd in traffic["commands"]]


def run_job(cli_main, traffic: dict, config: dict, job: dict, out_dir: str,
            device: str) -> dict:
    """One job: the port's commands in turn, in this process.  Returns the
    job's seconds and the seconds of each of the port's stages in it."""
    from volcanosv_tpu_torch.utils.logging import STAGE_TIMES
    before = {k: v[0] for k, v in STAGE_TIMES.items()}
    t0 = time.perf_counter()
    for argv in job_commands(traffic, config, job["dir"], out_dir, device):
        rc = cli_main(argv)
        if rc != 0:
            raise RuntimeError(f"{argv[0]} exited {rc}")
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    stages = {k: v[0] - before.get(k, 0.0) for k, v in STAGE_TIMES.items()
              if v[0] - before.get(k, 0.0) > 0}
    return dict(start=t0, end=t1, seconds=t1 - t0, stages=stages)


class Pool:
    """Jobs 0..n-1 (0 is the warm-up) made in worker processes of their own
    (`svbench/gen/worker.py`), at most one a core at a time; `get(i)`
    waits for job i and returns its truth."""

    def __init__(self, spec: dict, seed: int, n: int, root: str):
        self.root, self.n = root, n
        self.spec_path = os.path.join(root, "spec.json")
        with open(self.spec_path, "w") as fh:
            json.dump(dict(config=spec["config"], traffic=spec["traffic"]),
                      fh)
        self.seed = seed
        self.width = max(1, min(n, len(os.sched_getaffinity(0))))
        self.procs: dict[int, subprocess.Popen] = {}
        self.next = 0
        self._fill()

    def _dir(self, i: int) -> str:
        return os.path.join(self.root, f"job{i}")

    def _fill(self) -> None:
        while self.next < self.n and sum(
                p.poll() is None for p in self.procs.values()) < self.width:
            i = self.next
            self.procs[i] = subprocess.Popen(
                [sys.executable, "-m", "svbench.gen.worker", self.spec_path,
                 str(self.seed), str(i), self._dir(i)], cwd=ROOT)
            self.next += 1

    def get(self, i: int) -> dict:
        while i not in self.procs or self.procs[i].poll() is None:
            if i in self.procs:
                try:
                    self.procs[i].wait(timeout=0.05)
                except subprocess.TimeoutExpired:
                    pass
            else:
                time.sleep(0.05)
            self._fill()
        if self.procs[i].returncode != 0:
            raise RuntimeError(f"making job {i} exited "
                               f"{self.procs[i].returncode}")
        self._fill()
        with open(os.path.join(self._dir(i), "truth.json")) as fh:
            return json.load(fh)

    def close(self) -> None:
        """Stop what still runs and wait for every worker."""
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            p.wait()


class Window:
    """What the readers see: the window's jobs, their reference Mb, the
    device trace's summary, and what installed readers recorded."""

    def __init__(self):
        self.jobs: list[dict] = []
        self.ref_mb = 0.0
        self.trace: dict | None = None
        self.cpu_s: float | None = None
        self.recorded: dict = {}


def cpu_seconds() -> float:
    """User and system CPU seconds of this process and its ended children."""
    import resource
    return sum(r.ru_utime + r.ru_stime for r in (
        resource.getrusage(resource.RUSAGE_SELF),
        resource.getrusage(resource.RUSAGE_CHILDREN)))


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


# --- the run ----------------------------------------------------------------

def measure(spec: dict, seed: int, seconds: float, trace: bool,
            device: str = "cuda", age_at_start: float = 0.0,
            t_start: float | None = None) -> dict:
    """Set-up, the window and the judging of one run; returns the result
    line's object (and the per-job lines printed on the way)."""
    from svbench.reference import judge
    t_start = time.perf_counter() if t_start is None else t_start
    traffic, config = spec["traffic"], spec["config"]
    pool_n = int(traffic["pool"])
    root = tempfile.mkdtemp(prefix="svbench-")
    try:
        jobs = Pool(spec, seed, pool_n + 1, root)
        try:
            import torch

            from volcanosv_tpu_torch.cli import main as cli_main
            facts = host_facts()
            warm = jobs.get(0)
            warm_run = run_job(cli_main, traffic, config, warm,
                               os.path.join(root, "warm-out"), device)
            shutil.rmtree(os.path.join(root, "warm-out"), ignore_errors=True)
            pool = [jobs.get(i) for i in range(1, pool_n + 1)]
        finally:
            jobs.close()
        print(json.dumps(dict(host=facts, warmup_s=warm_run["seconds"],
                              job_length=traffic["job_length"],
                              pool=pool_n)), flush=True)
        found = forbidden_modules()
        if found:
            raise SystemExit(f"set-up loaded {found}")

        win = Window()
        undo = []
        tracer = dev_trace = None
        if trace:
            from svbench import trace as tr
            tracer = tr.Spans()
            tracer.install()
            undo.append(tracer.uninstall)
            for _m, mspec in spec["per_layer"]:
                rd = importlib.import_module(f"svbench.readers.{mspec['reader']}")
                if hasattr(rd, "install"):
                    undo.append(rd.install(mspec, win))
            dev_trace = tr.DeviceTrace(os.path.join(root, "trace.json"))
        gc.collect()
        os.sync()       # the pool's files reach the disk before the window
        probe_before = host_probe_s()
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = age_at_start + time.perf_counter() - t_start
        attempted = failed = 0
        done = []
        card_before = nvidia_smi() if device == "cuda" else None
        with RssSampler() as rss:
            if dev_trace:
                dev_trace.start()
            c0 = cpu_seconds()
            w0 = time.perf_counter()
            for job in pool:
                if time.perf_counter() - w0 >= seconds:
                    break
                attempted += 1
                out_dir = os.path.join(root, f"out{job['index']}")
                try:
                    r = run_job(cli_main, traffic, config, job, out_dir,
                                device)
                except Exception:
                    failed += 1
                    log(f"job {job['index']} raised:\n"
                        + traceback.format_exc())
                    continue
                finally:
                    gc.collect()
                done.append((job, out_dir, r))
            if device == "cuda":
                torch.cuda.synchronize()
            w1 = time.perf_counter()
            c1 = cpu_seconds()
            if dev_trace:
                dev_trace.stop()
        card_after = nvidia_smi() if device == "cuda" else None
        probe_after = host_probe_s()
        while undo:
            undo.pop()()
        t_last = max([r["end"] for _j, _o, r in done] + [w0])
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

        # the judge: every completed job, once the window has closed
        counts = []
        for job, out_dir, r in done:
            try:
                c = judge.judge_job(job, out_dir, traffic["answers"])
            except Exception:
                failed += 1
                log(f"job {job['index']}: outputs unreadable:\n"
                    + traceback.format_exc())
                continue
            counts.append(c)
            win.jobs.append(dict(stages=r["stages"], length=c["length"]))
            print(json.dumps(dict(job=job["index"], seconds=r["seconds"],
                                  stages=r["stages"], counts=c)), flush=True)
        numbers = judge.pool(counts)
        ok, checks = judge.verdict(numbers, spec["limits"])
        correct = ok and failed == 0 and attempted > 0

        ref_bases = sum(len(s) for job, _o, _r in done
                        for s in job["ref"].values())
        win.ref_mb = ref_bases / 1e6
        win.cpu_s = c1 - c0
        print(json.dumps(dict(
            window_s=w1 - w0, jobs_done=len(done), cpu_s=win.cpu_s,
            loadavg_after=list(os.getloadavg()),
            job_s=[r["seconds"] for _j, _o, r in done],
            card_before=card_before, card_after=card_after,
            probe_before=probe_before, probe_after=probe_after,
            numbers=numbers)), flush=True)

        result = dict(correct=correct, attempted=attempted, failed=failed)
        metrics = {}
        out_device = dict(
            platform="gpu" if device == "cuda" else device,
            kind=torch.cuda.get_device_name(0) if device == "cuda" else device,
            count=1, memory_peak_bytes=int(peak))
        if trace:
            ops = dev_trace.ops()
            s = tr.summarize(ops, tracer.log, w0, w1)
            win.trace = s
            out_device.update(busy_s=s["busy_s"], window_s=s["window_s"])
            for m, mspec in spec["per_layer"]:
                rd = importlib.import_module(f"svbench.readers.{mspec['reader']}")
                v = rd.read(mspec, win)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            result["breakdown"] = dict(device_ops=s["device_ops"],
                                       idle_gaps=s["idle_gaps"])
        else:
            values = dict(
                ref_kb_per_s=ref_bases / 1e3 / (t_last - w0) if done else None,
                host_rss_peak_gb=rss.peak_kb * 1024 / 1e9,
                setup_s=setup_s)
            for m in spec["end_to_end"]:
                if values.get(m["name"]) is not None:
                    metrics[m["name"]] = {"value": values[m["name"]],
                                          "unit": m["unit"]}
        result.update(metrics=metrics, device=out_device, checks=checks)
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    import argparse
    age = process_age_s()
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)

    import torch
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"svbench: {args.workload} needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = measure(spec, args.seed, args.seconds, bool(args.trace),
                     device="cuda", age_at_start=age, t_start=t0)
    found = forbidden_modules()
    if found:
        log(f"svbench: the process holds {found}; no result")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} limit {c['limit']}")
    log(f"correct: {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0
