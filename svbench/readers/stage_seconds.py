"""Seconds of the port's host stages (`utils/logging.py::STAGE_TIMES`, the
difference before and after each job), summed over the window's jobs and
divided by their reference Mb.

spec: {"reader": "stage_seconds", "stages": [names]}.  A name also matches
the stage of each chromosome (`small-indel` takes `small-indel[chr1]`).
"""
from __future__ import annotations


def _matches(stage: str, names) -> bool:
    return any(stage == n or stage.startswith(n + "[") for n in names)


def read(spec: dict, ctx) -> float | None:
    total, seen = 0.0, False
    for job in ctx.jobs:
        for stage, seconds in job["stages"].items():
            if _matches(stage, spec["stages"]):
                total += seconds
                seen = True
    if not seen or not ctx.ref_mb:
        return None
    return total / ctx.ref_mb
