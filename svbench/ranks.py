"""A job as N rank processes of one `torch.distributed` group, one to a card.

A cell whose traffic sets `ranks` (N > 1) runs each job this way.  At
set-up the harness starts N processes of this module with the environment
that `torchrun --standalone --nproc_per_node N` gives its workers:
MASTER_ADDR=127.0.0.1, a free MASTER_PORT, WORLD_SIZE=N, RANK and
LOCAL_RANK (0..N-1), LOCAL_WORLD_SIZE=N, and OMP_NUM_THREADS=1 where it is
unset.  Each rank imports the port once, refuses to go on if the JAX
package or JAX is loaded, and then serves the harness over a pipe: every
job's commands, the same argv on every rank, through `cli.main` in its own
process.  The port's first command joins the group (`init_multihost`,
which makes `cuda:{LOCAL_RANK}` current), and the group lives across jobs.

A job starts when its commands are sent to every rank and ends when the
last rank reports; a rank reports after a `torch.cuda.synchronize()` on
its card, with its start, end, CPU seconds (getrusage) and the change of
the port's `STAGE_TIMES` and `COUNTS` over the job.  A rank that raises,
exits or passes the job's deadline stops every rank (a rank whose peer
died would wait at a barrier for ever), and every later call fails at
once.  The harness process does no CUDA work in this mode.

With --trace 1 each rank installs the traced run's spans and the readers'
hooks in its own process and traces its own card over the window; what
they record comes back to the harness and is merged.

    python3 -m svbench.ranks <fd_in> <fd_out> <device>   (started by `Ranks`)
"""
from __future__ import annotations

import importlib
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import Connection, wait

from svbench import harness

READY_S = 300.0           # a rank's start: imports
WARM_DEADLINE_S = 900.0   # the first job, which builds the kernels
JOB_DEADLINE_FACTOR = 5.0  # later jobs: this times the first job, at least
JOB_DEADLINE_MIN_S = 60.0  # this
QUIT_S = 30.0             # leaving the group at the end


class RankFailure(RuntimeError):
    """A rank raised, exited or passed its deadline; every rank is stopped."""


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_env(n: int, rank: int, port: int) -> dict:
    """This process's environment with what torchrun sets for a worker."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(n))
    env.setdefault("OMP_NUM_THREADS", "1")
    env["PYTHONPATH"] = os.pathsep.join(
        [harness.ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    return env


def merge(a, b):
    """Two ranks' records as one: dicts merged by key, lists concatenated,
    numbers summed."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            out[k] = merge(out[k], v) if k in out else v
        return out
    if isinstance(a, list) and isinstance(b, list):
        return a + b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and not isinstance(a, bool) and not isinstance(b, bool):
        return a + b
    raise TypeError(f"cannot merge {type(a).__name__} and {type(b).__name__}")


def send(conn: Connection, obj) -> None:
    """obj through the pipe, pickled by the standard pickler: the one of
    multiprocessing, which torch extends, would pass a tensor as a shared
    memory handle that only a process of the same family can open."""
    conn.send_bytes(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def recv(conn: Connection):
    return pickle.loads(conn.recv_bytes())


def summed(dicts: list[dict]) -> dict:
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


class Ranks:
    """The harness's side: N rank processes, driven over pipes.  The same
    calls as `harness.Local`."""

    def __init__(self, n: int, traffic: dict, config: dict, device: str,
                 root: str):
        self.count = n
        self.traffic, self.config, self.device = traffic, config, device
        self.root = root
        self.kind = None
        self.first_s = None
        self.dead: str | None = None
        self.win = None
        self.traced = False
        self.per_rank: list = []
        self.peaks: list[int] = []
        self.procs: list[subprocess.Popen] = []
        self.to: list[Connection] = []
        self.fro: list[Connection] = []
        port = free_port()
        for r in range(n):
            p2c_r, p2c_w = os.pipe()
            c2p_r, c2p_w = os.pipe()
            with open(self._log(r), "w") as out:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "svbench.ranks", str(p2c_r),
                     str(c2p_w), device], cwd=harness.ROOT,
                    env=torchrun_env(n, r, port), pass_fds=(p2c_r, c2p_w),
                    stdout=out, stderr=subprocess.STDOUT))
            os.close(p2c_r)
            os.close(c2p_w)
            self.to.append(Connection(p2c_w, readable=False))
            self.fro.append(Connection(c2p_r, writable=False))
        self.pids = [p.pid for p in self.procs]
        self._collect(READY_S)

    def _log(self, r: int) -> str:
        return os.path.join(self.root, f"rank{r}.log")

    def _fail(self, why: str):
        self.dead = why
        self.close()
        for r in range(self.count):
            try:
                with open(self._log(r), errors="replace") as fh:
                    tail = fh.read()[-3000:]
            except OSError:
                continue
            harness.log(f"rank {r} (exit {self.procs[r].returncode}), its "
                        f"output's end:\n{tail}")
        raise RankFailure(why)

    def _collect(self, timeout: float) -> list:
        """Every rank's next reply, within `timeout` seconds."""
        replies = [None] * self.count
        pending = set(range(self.count))
        deadline = time.monotonic() + timeout
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(f"ranks {sorted(pending)} passed the {timeout:.0f}"
                           " s deadline")
            for c in wait([self.fro[r] for r in pending], timeout=left):
                r = self.fro.index(c)
                try:
                    tag, val = recv(c)
                except EOFError:
                    self._fail(f"rank {r} exited")
                if tag == "error":
                    self._fail(f"rank {r} raised:\n{val}")
                replies[r] = val
                pending.discard(r)
        return replies

    def _ask(self, kind: str, arg=None, timeout: float = 120.0) -> list:
        if self.dead:
            raise RankFailure(f"the ranks were stopped: {self.dead}")
        for r, c in enumerate(self.to):
            try:
                send(c, (kind, arg))
            except OSError:
                self._fail(f"rank {r} exited")
        return self._collect(timeout)

    # --- the harness's calls ------------------------------------------------

    def run(self, job: dict, out_dir: str) -> dict:
        """One job on every rank: the same commands, one group."""
        argvs = harness.job_commands(self.traffic, self.config, job["dir"],
                                     out_dir, self.device)
        timeout = WARM_DEADLINE_S if self.first_s is None else max(
            JOB_DEADLINE_MIN_S, JOB_DEADLINE_FACTOR * self.first_s)
        t0 = time.perf_counter()
        reps = self._ask("job", argvs, timeout)
        t1 = time.perf_counter()
        if self.first_s is None:
            self.first_s, self.kind = t1 - t0, reps[0]["kind"]
        return dict(start=t0, end=t1, seconds=t1 - t0,
                    stages=summed([r["stages"] for r in reps]),
                    counts=summed([r["counts"] for r in reps]),
                    ranks=[dict(rank=k, seconds=r["end"] - r["start"],
                                start=r["start"], end=r["end"],
                                cpu_s=r["cpu_s"], stages=r["stages"],
                                counts=r["counts"])
                           for k, r in enumerate(reps)])

    def install(self, per_layer: list, win, trace_path: str) -> None:
        self.win, self.traced = win, True
        self._ask("install", dict(metrics=[m for _m, m in per_layer],
                                  trace_path=trace_path))

    def sync(self) -> None:
        """Nothing: each rank synchronises its card before it reports."""

    def start(self) -> None:
        if self.traced:
            self._ask("start")

    def cpu_seconds(self) -> float:
        """The harness's CPU seconds and every rank's, summed."""
        own = harness.cpu_seconds()
        if self.dead:
            return own
        return own + sum(self._ask("cpu"))

    def stop(self) -> None:
        """Stop the traces, undo the hooks and gather what the ranks
        recorded, with each card's peak memory."""
        if self.dead:
            return
        reps = self._ask("stop", timeout=300.0)
        self.peaks = [r["peak"] for r in reps]
        if self.traced:
            self.per_rank = [(r["ops"], r["spans"]) for r in reps]
            for r in reps:
                self.win.recorded = merge(self.win.recorded, r["recorded"])

    def uninstall(self) -> None:
        """Nothing: each rank undid its hooks at `stop`."""

    def peak_bytes(self) -> int:
        return max(self.peaks, default=0)

    def summary(self, w0: float, w1: float) -> dict | None:
        from svbench import trace as tr
        if not self.per_rank:
            return None
        return tr.summarize_ranks(self.per_rank, w0, w1)

    def close(self) -> None:
        """Ask every rank to leave the group and exit; stop what does not
        within QUIT_S, and wait for every one."""
        if not self.dead:
            for c in self.to:
                try:
                    send(c, ("quit", None))
                except OSError:
                    pass
        deadline = time.monotonic() + (0 if self.dead else QUIT_S)
        for p in self.procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for c in self.to + self.fro:
            c.close()
        self.to, self.fro = [], []
        self.dead = self.dead or "closed"


# --- the rank's side ----------------------------------------------------------

def to_host(x):
    """x with every tensor in it moved to the host, to be sent."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


class Rank:
    """One rank: runs what the harness sends, in this process."""

    def __init__(self, device: str):
        import torch

        from volcanosv_tpu_torch import cli
        from volcanosv_tpu_torch.utils import logging as port_logging
        self.torch, self.cli, self.port_logging = torch, cli, port_logging
        self.cuda = device == "cuda"
        self.win = harness.Window()
        self.undo: list = []
        self.tracer = self.dev_trace = None

    def job(self, argvs: list) -> dict:
        st, counts = self.port_logging.STAGE_TIMES, self.port_logging.COUNTS
        before = {k: v[0] for k, v in st.items()}
        counts0 = dict(counts)
        c0 = harness.cpu_seconds()
        t0 = time.perf_counter()
        for argv in argvs:
            rc = self.cli.main(argv)
            if rc != 0:
                raise RuntimeError(f"{argv[0]} exited {rc}")
        if self.cuda:
            self.torch.cuda.synchronize()
        t1 = time.perf_counter()
        found = harness.forbidden_modules()
        if found:
            raise RuntimeError(f"the rank holds {found}")
        return dict(
            start=t0, end=t1, cpu_s=harness.cpu_seconds() - c0,
            stages={k: v[0] - before.get(k, 0.0) for k, v in st.items()
                    if v[0] - before.get(k, 0.0) > 0},
            counts={k: v - counts0.get(k, 0) for k, v in counts.items()
                    if v != counts0.get(k, 0)},
            kind=self.torch.cuda.get_device_name() if self.cuda else "cpu")

    def install(self, arg: dict) -> None:
        from svbench import trace as tr
        self.tracer = tr.Spans()
        self.tracer.install()
        self.undo.append(self.tracer.uninstall)
        for mspec in arg["metrics"]:
            rd = importlib.import_module(f"svbench.readers.{mspec['reader']}")
            if hasattr(rd, "install"):
                self.undo.append(rd.install(mspec, self.win))
        rank = os.environ["RANK"]
        self.dev_trace = tr.DeviceTrace(f"{arg['trace_path']}.rank{rank}")

    def start(self, _arg) -> None:
        self.dev_trace.start()

    def cpu(self, _arg) -> float:
        return harness.cpu_seconds()

    def stop(self, _arg) -> dict:
        ops = spans = None
        if self.dev_trace:
            self.dev_trace.stop()
            ops = self.dev_trace.ops()
            spans = self.tracer.log
        while self.undo:
            self.undo.pop()()
        return dict(
            ops=ops, spans=spans, recorded=to_host(self.win.recorded),
            peak=int(self.torch.cuda.max_memory_allocated())
            if self.cuda else 0)


def serve(fd_in: int, fd_out: int, device: str) -> int:
    conn_in = Connection(fd_in, writable=False)
    conn_out = Connection(fd_out, readable=False)
    try:
        rank = Rank(device)
        found = harness.forbidden_modules()
        if found:
            send(conn_out, ("error", f"the rank holds {found}"))
            return 3
        send(conn_out, ("ready", os.getpid()))
        while True:
            try:
                kind, arg = recv(conn_in)
            except EOFError:
                return 1
            if kind == "quit":
                break
            try:
                reply = getattr(rank, kind)(arg)
            except Exception:
                send(conn_out, ("error", traceback.format_exc()))
                return 1
            send(conn_out, ("ok", reply))
        from volcanosv_tpu_torch.parallel.mesh import shutdown_multihost
        shutdown_multihost()
        return 0
    finally:
        conn_in.close()
        conn_out.close()


if __name__ == "__main__":
    sys.exit(serve(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
