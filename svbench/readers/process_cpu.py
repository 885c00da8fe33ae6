"""The process's CPU seconds in the window (its own threads, the native
pools among them, and its ended children; getrusage), over the reference
Mb of the window's jobs.  Read beside `ref_kb_per_s`, it tells more work a
Mb (CPU seconds up) from a host that ran slow (wall time up, CPU seconds of
the same work not).

spec: {"reader": "process_cpu"}.
"""
from __future__ import annotations


def read(spec: dict, ctx) -> float | None:
    if not ctx.cpu_s or not ctx.ref_mb:
        return None
    return ctx.cpu_s / ctx.ref_mb
