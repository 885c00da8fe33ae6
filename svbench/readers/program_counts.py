"""Work counts of the port (`utils/logging.py::COUNTS`: queries seeded,
overlap hits, ambiguous polish windows), their change over the traced
window, summed over the named counters and divided by the reference Mb of
the window's jobs.  Read beside a stage's seconds a Mb, a count that holds
while the seconds move tells a slower host from more work.

spec: {"reader": "program_counts", "counters": [names]}.  `install`
records the counters before the window and its undo records them after;
a program without `COUNTS`, or counters that did not move, read None.
"""
from __future__ import annotations


def _snapshot() -> dict | None:
    from volcanosv_tpu_torch.utils import logging as port_logging
    counts = getattr(port_logging, "COUNTS", None)
    return None if counts is None else dict(counts)


def _key(spec: dict) -> str:
    return "program_counts:" + ",".join(spec["counters"])


def install(spec: dict, ctx):
    before = _snapshot()
    if before is None:
        return lambda: None
    rec = ctx.recorded[_key(spec)] = dict(before=before, after=None)

    def undo():
        rec["after"] = _snapshot()
    return undo


def read(spec: dict, ctx) -> float | None:
    rec = ctx.recorded.get(_key(spec))
    if not rec or rec["after"] is None or not ctx.ref_mb:
        return None
    moved = sum(rec["after"].get(c, 0) - rec["before"].get(c, 0)
                for c in spec["counters"])
    if moved == 0:
        return None
    return moved / ctx.ref_mb
