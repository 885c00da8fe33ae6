"""The device's idle share of the traced window: 100 less the union of its
operations' times (torch.profiler, CUDA activity only) as a percentage of
the window.  The arithmetic of chip_smoke.py's `_profile_summary` (device
time over wall time, commit 656570a), with the union in place of the sum so
that overlapping operations count once.

spec: {"reader": "device_idle"}.
"""
from __future__ import annotations


def read(spec: dict, ctx) -> float | None:
    t = ctx.trace
    if not t or not t["busy_s"] or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
