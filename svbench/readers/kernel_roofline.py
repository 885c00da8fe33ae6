"""A kernel's share of its roofline: the summed least time of its calls in
the traced window over the summed device time of its kernels there, in %.

spec: {"reader": "kernel_roofline", "kernel": "banded_dp",
       "bound": "dp_bound"}.  `install` wraps the kernel's wrapper, from
here, to keep each call's shapes and lengths; the device time is that of
the trace's kernels whose names hold the kernel's name.  The least time of
a call is `bounds.<bound>` on that call's own inputs.
"""
from __future__ import annotations

import importlib

from . import bounds


def _dp_args(q, t, qlen, tlen, W, d_lo, scores, with_traceback=True,
             free_t_end=False, free_t_start=False, row0_scores=False, **_kw):
    kind = "dual" if scores.dual else (
        "edit" if scores.gap_open == 0 else "affine")
    return dict(qlen=qlen, tlen=tlen, M=int(q.shape[1]), W=int(W),
                d_lo=int(d_lo), kind=kind, tb=bool(with_traceback),
                row0=bool(row0_scores))


# kernel -> (module, wrapper attribute, the call's bound arguments)
WRAPPERS = {"banded_dp": ("volcanosv_tpu_torch.ops.banded_align",
                          "banded_dp", _dp_args)}


def install(spec: dict, ctx):
    """Wrap the kernel's wrapper where its callers look it up.  The
    wrapper's counters (`launches`, `shapes`) move to the stand-in while it
    is installed and back after, since the wrapper counts through the name
    the stand-in takes."""
    mod_name, attr, args_of = WRAPPERS[spec["kernel"]]
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, attr)
    calls = ctx.recorded.setdefault(spec["kernel"], [])

    def stand_in(*a, **kw):
        if a[0].device.type == "cuda":
            calls.append(args_of(*a, **kw))
        return fn(*a, **kw)
    stand_in.launches = fn.launches
    stand_in.shapes = fn.shapes
    setattr(mod, attr, stand_in)

    def undo():
        fn.launches = stand_in.launches
        setattr(mod, attr, fn)
    return undo


def read(spec: dict, ctx) -> float | None:
    calls = ctx.recorded.get(spec["kernel"])
    if not calls or not ctx.trace:
        return None
    kernel_s = sum(v for name, v in ctx.trace["kernel_s"].items()
                   if spec["kernel"] in name)
    if kernel_s <= 0:
        return None
    fn = getattr(bounds, spec["bound"])
    least_s = 0.0
    for c in calls:
        c = dict(c, qlen=c["qlen"].cpu().numpy(), tlen=c["tlen"].cpu().numpy())
        least_s += fn(**c)["bound_ms"] / 1e3
    return 100.0 * least_s / kernel_s
