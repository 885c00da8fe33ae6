"""Logging, per-stage timing, spans and work counters.

The reference copy-pastes a ``logging.basicConfig`` block into every script
(e.g. unphased_reads_assignment_kmer_norm.py:23-29) and has no profiling at
all (SURVEY.md §5).  Here: one logger factory + a context-manager stage timer
that accumulates a per-stage wall-clock table usable for pipeline reports.

With tracing on (`set_tracing`), each stage is also kept as a span in
`SPANS`: its name, start and end on `time.perf_counter()`, the index of the
span it opened inside (the innermost one open on the same thread) and the
id of the CLI command it ran under.  `COUNTS` holds work counters that the
stages add to once a batch, always on like `STAGE_TIMES`.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict

_FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
_configured = False

# global stage -> [total_seconds, n_calls]
STAGE_TIMES: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
# global counter -> units of work (queries seeded, overlap hits, ...)
COUNTS: dict[str, int] = defaultdict(int)
# spans while tracing is on: [name, start, end, parent index, command id]
SPANS: list[list] = []

_tracing = False
_command: int | None = None
_n_commands = 0
_open = threading.local()        # .stack: indices of this thread's open spans
_lock = threading.Lock()         # SPANS' indices and COUNTS' sums


def get_logger(name: str = "volcanosv") -> logging.Logger:
    global _configured
    if not _configured:
        logging.basicConfig(level=logging.INFO, format=_FORMAT)
        _configured = True
    return logging.getLogger(name)


def set_tracing(on: bool) -> bool:
    """Turn span recording on or off; returns the previous state."""
    global _tracing
    old, _tracing = _tracing, bool(on)
    return old


@contextlib.contextmanager
def command_scope():
    """A fresh command id for the spans opened inside; yields the id."""
    global _command, _n_commands
    _n_commands += 1
    outer, _command = _command, _n_commands
    try:
        yield _command
    finally:
        _command = outer


def count(name: str, n: int) -> None:
    """Add `n` units of work to the counter `name`."""
    with _lock:
        COUNTS[name] += int(n)


def stage_timer(stage: str, log: logging.Logger | None = None):
    """Time a pipeline stage; accumulate into STAGE_TIMES (and, with
    tracing on, record it in SPANS)."""
    return _traced_stage(stage, log) if _tracing else _stage(stage, log)


def _record(stage: str, dt: float, log: logging.Logger | None) -> None:
    rec = STAGE_TIMES[stage]
    rec[0] += dt
    rec[1] += 1
    if log is not None:
        log.info("stage %-28s %8.3fs", stage, dt)


@contextlib.contextmanager
def _stage(stage: str, log: logging.Logger | None):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record(stage, time.perf_counter() - t0, log)


@contextlib.contextmanager
def _traced_stage(stage: str, log: logging.Logger | None):
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    span = [stage, None, None, stack[-1] if stack else None, _command]
    with _lock:
        stack.append(len(SPANS))
        SPANS.append(span)
    span[1] = t0 = time.perf_counter()
    try:
        yield
    finally:
        span[2] = t1 = time.perf_counter()
        stack.pop()
        _record(stage, t1 - t0, log)


def spans_of(command: int) -> list[dict]:
    """The spans of one command, parents as indices into the returned
    list (None for a span opened outside the command's spans)."""
    keep = [i for i, s in enumerate(SPANS) if s[4] == command]
    at = {i: k for k, i in enumerate(keep)}
    return [dict(name=SPANS[i][0], start=SPANS[i][1], end=SPANS[i][2],
                 parent=at.get(SPANS[i][3]), command=command)
            for i in keep]


def stage_report() -> str:
    lines = [f"{'stage':<32}{'calls':>8}{'total_s':>12}"]
    for k, (tot, n) in sorted(STAGE_TIMES.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{k:<32}{n:>8}{tot:>12.3f}")
    return "\n".join(lines)
