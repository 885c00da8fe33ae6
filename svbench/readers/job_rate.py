"""The reference kb of the window's completed jobs over the seconds from
the window's start to the last job's end: `ref_kb_per_s`'s arithmetic, read
in the traced run.  It stands per layer in a cell where the host's speed
spreads the rate wider than any bound the benchmark may set.

spec: {"reader": "job_rate"}.
"""
from __future__ import annotations


def read(spec: dict, ctx) -> float | None:
    if not ctx.ref_mb or not ctx.seconds:
        return None
    return ctx.ref_mb * 1e3 / ctx.seconds
