"""The traced run's instruments, installed from the benchmark's own files.

- Spans: the port's layer entries and its stage timers are wrapped so that
  each call opens a `torch.profiler.record_function` span and is logged on
  the host's clock (name, start, end).  Only the traced run installs them.
- The device timeline: `torch.profiler` with CUDA activity only, over the
  measured window, exported as a Chrome trace and read back: each device
  operation's name, start and length.  A `spin_kernel` launched on an idle
  stream at the window's start ties the device's clock to the host's.
- From both: the device's busy time (the union of its operations), the
  operations that took most time, and the idle time by the innermost span
  open on the host meanwhile.  Where a job runs as ranks (svbench/ranks.py)
  each rank installs the spans and traces its own card, and the ranks'
  windows are summed up by `summarize_ranks`.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import time

# (module, attribute path) of the layer entries a span is opened around
LAYER_ENTRIES = [
    ("volcanosv_tpu_torch.aligner", "Aligner.align"),
    ("volcanosv_tpu_torch.pipeline.asm", "assemble_chromosome"),
    ("volcanosv_tpu_torch.assembly", "run_assembly"),
    ("volcanosv_tpu_torch.cli", "_call_large_indels"),
    ("volcanosv_tpu_torch.vc.small_indel", "call_small_indels"),
    ("volcanosv_tpu_torch.vc.complex_sv", "call_complex_svs"),
]
# modules that took `stage_timer` by name: each one's copy is wrapped
STAGE_TIMER_USERS = ["volcanosv_tpu_torch.cli", "volcanosv_tpu_torch.aligner",
                     "volcanosv_tpu_torch.pipeline.asm",
                     "volcanosv_tpu_torch.assembly.farm"]


class Spans:
    """Host spans on perf_counter seconds: [name, start, end]."""

    def __init__(self):
        self.log: list[list] = []
        self._undo: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        import torch
        rec = [name, time.perf_counter(), None]
        self.log.append(rec)
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            rec[2] = time.perf_counter()

    def _patch(self, owner, attr: str, new) -> None:
        old = getattr(owner, attr)
        setattr(owner, attr, new)
        self._undo.append(lambda: setattr(owner, attr, old))

    def install(self) -> None:
        for mod_name, path in LAYER_ENTRIES:
            owner = importlib.import_module(mod_name)
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            fn = getattr(owner, attr)
            self._patch(owner, attr, self._wrap(path, fn))
        for mod_name in STAGE_TIMER_USERS:
            mod = importlib.import_module(mod_name)
            self._patch(mod, "stage_timer", self._wrap_stage(mod.stage_timer))

    def _wrap(self, name, fn):
        spans = self

        def wrapper(*a, **kw):
            with spans.span(name):
                return fn(*a, **kw)
        return wrapper

    def _wrap_stage(self, stage_timer):
        spans = self

        @contextlib.contextmanager
        def wrapper(stage, *a, **kw):
            with spans.span(f"stage:{stage}"), stage_timer(stage, *a, **kw):
                yield
        return wrapper

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()


class DeviceTrace:
    """torch.profiler over the window, CUDA activity only."""

    def __init__(self, trace_path: str):
        self.path = trace_path
        self.prof = None
        self.host_start = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.host_start = time.perf_counter()
        torch.cuda._sleep(1000)           # the clock anchor: spin_kernel

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)

    def ops(self) -> list[tuple[str, float, float]]:
        """Device operations as (name, start, end) on the host's
        perf_counter seconds, the anchor itself left out."""
        with open(self.path) as fh:
            events = json.load(fh)["traceEvents"]
        dev = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
               if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
        os.remove(self.path)
        anchor = [d for d in dev if "spin_kernel" in d[0]]
        if not anchor:
            raise RuntimeError("no spin_kernel in the device trace: the "
                               "device clock cannot be tied to the host's")
        t0 = min(a[1] for a in anchor)
        ops = []
        for name, ts, dur in dev:
            if "spin_kernel" in name:
                continue
            s = self.host_start + (ts - t0) / 1e6
            ops.append((name, s, s + dur / 1e6))
        ops.sort(key=lambda o: o[1])
        return ops


def busy_intervals(ops, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of the operations' intervals, clipped to [lo, hi]."""
    out: list[list[float]] = []
    for _n, s, e in ops:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def innermost_segments(spans, lo: float, hi: float):
    """[lo, hi] cut into (start, end, name of the innermost open span, or
    "outside spans")."""
    events = []
    for k, (name, s, e) in enumerate(spans):
        if e is None:
            continue
        events.append((s, 1, -k, name))
        events.append((e, 0, k, name))
    events.sort()
    stack: list[str] = []
    segs = []
    t = lo
    for when, kind, _k, name in events:
        when = min(max(when, lo), hi)
        if when > t:
            segs.append((t, when, stack[-1] if stack else "outside spans"))
            t = when
        if kind == 1:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    if hi > t:
        segs.append((t, hi, stack[-1] if stack else "outside spans"))
    return segs


def idle_by_span(busy, segs, lo: float, hi: float) -> dict[str, float]:
    """Seconds in which the device was idle, by the innermost span open."""
    idle = []
    t = lo
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if hi > t:
        idle.append((t, hi))
    out: dict[str, float] = {}
    j = 0
    for s, e, name in segs:
        while j < len(idle) and idle[j][1] <= s:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < e:
            ov = min(e, idle[k][1]) - max(s, idle[k][0])
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov
            k += 1
    return out


def _tally(ops, spans, lo: float, hi: float):
    """Busy seconds, device seconds by operation and idle seconds by span."""
    busy = busy_intervals(ops, lo, hi)
    by_name: dict[str, float] = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    idle = idle_by_span(busy, innermost_segments(spans, lo, hi), lo, hi)
    return sum(e - s for s, e in busy), by_name, idle


def _top(d: dict) -> list:
    """The ten largest entries, as [name (at most 120 letters), seconds]."""
    return [[n[:120], v] for n, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:10]]


def summarize(ops, spans, lo: float, hi: float) -> dict:
    """busy_s, window_s and the breakdown of the traced window."""
    busy_s, by_name, idle = _tally(ops, spans, lo, hi)
    return dict(busy_s=busy_s, window_s=hi - lo, device_ops=_top(by_name),
                idle_gaps=_top(idle), kernel_s=by_name)


def summarize_ranks(per_rank, lo: float, hi: float) -> dict:
    """The window of N ranks, one card each, from each rank's (ops, spans):
    busy_s the mean over the cards, so that 100 less busy over the window
    is the mean of the cards' idle shares; device seconds by operation
    summed over the cards; each operation and idle gap of the breakdown
    named with its rank."""
    busy, kernel_s, ops_named, idle_named = [], {}, {}, {}
    for r, (ops, spans) in enumerate(per_rank):
        b, by_name, idle = _tally(ops, spans, lo, hi)
        busy.append(b)
        for n, v in by_name.items():
            kernel_s[n] = kernel_s.get(n, 0.0) + v
            ops_named[f"rank{r}:{n}"] = v
        for n, v in idle.items():
            idle_named[f"rank{r}:{n}"] = v
    return dict(busy_s=sum(busy) / len(busy), window_s=hi - lo,
                device_ops=_top(ops_named), idle_gaps=_top(idle_named),
                kernel_s=kernel_s, busy_s_by_card=busy)
