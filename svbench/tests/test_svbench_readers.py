"""The per-layer readers: found by the reader name of each metric file,
and silent where they find nothing to read."""
import os

import numpy as np
import pytest

from svbench import harness
from svbench.readers import (bounds, device_idle, job_rate, kernel_roofline,
                             process_cpu, stage_seconds)

METRICS = sorted(f[:-5] for f in os.listdir(os.path.join(harness.HERE,
                                                          "metrics")))


def window(jobs=(), trace=None, recorded=None):
    w = harness.Window()
    w.jobs = list(jobs)
    w.ref_mb = sum(j["length"] for j in w.jobs) / 1e6
    w.trace = trace
    w.recorded = recorded or {}
    return w


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_names_a_reader_that_reads_nothing_from_nothing(name):
    import importlib
    spec = harness.load_json(harness.HERE, "metrics", name + ".json")
    rd = importlib.import_module(f"svbench.readers.{spec['reader']}")
    assert rd.read(spec, window()) is None


def test_stage_seconds_sums_a_stage_and_its_chromosomes():
    jobs = [dict(length=250_000, stages={"small-indel[chr1]": 1.0,
                                         "seed_chain": 2.0}),
            dict(length=250_000, stages={"small-indel[chr1]": 0.5,
                                         "small-indel-x": 9.0})]
    w = window(jobs)
    assert stage_seconds.read({"stages": ["small-indel"]}, w) == 3.0
    assert stage_seconds.read({"stages": ["seed_chain"]}, w) == 4.0
    assert stage_seconds.read({"stages": ["pileup"]}, w) is None


def test_process_cpu_seconds_a_mb():
    w = window([dict(length=250_000, stages={})] * 2)
    w.cpu_s = 40.0
    assert process_cpu.read({}, w) == pytest.approx(80.0)
    assert harness.cpu_seconds() > 0


def test_job_rate_is_the_window_kb_over_its_seconds():
    w = window([dict(length=250_000, stages={})] * 3)
    assert job_rate.read({}, w) is None
    w.seconds = 25.0
    assert job_rate.read({}, w) == pytest.approx(30.0)


def test_device_idle():
    w = window(trace=dict(busy_s=0.5, window_s=50.0))
    assert device_idle.read({}, w) == pytest.approx(99.0)


def test_dp_bound_counts_the_cells_inside_the_matrix():
    # one alignment, 4 x 4, band of 4 lanes from diagonal offset -2
    b = bounds.dp_bound([4], [4], M=4, W=4, d_lo=-2, kind="edit", tb=False,
                        row0=False)
    i = np.arange(4)[:, None]
    j = i + (-2) + np.arange(4)[None, :]
    assert b["cells"] == int(((j >= 0) & (j < 4)).sum())
    assert b["ops"] == b["cells"] * bounds.DP_OPS_PER_CELL[("edit", False)]


def test_kernel_roofline_is_least_time_over_kernel_time():
    import torch
    calls = [dict(qlen=torch.tensor([256] * 64), tlen=torch.tensor([256] * 64),
                  M=256, W=64, d_lo=-32, kind="affine", tb=True, row0=False)]
    least = bounds.dp_bound(**dict(calls[0], qlen=[256] * 64,
                                   tlen=[256] * 64))["bound_ms"] / 1e3
    w = window(trace=dict(kernel_s={"void banded_dp_warp_kernel<8>": 4 * least,
                                    "tb_walk_warp_kernel": 1.0}),
               recorded={"banded_dp": calls})
    spec = {"kernel": "banded_dp", "bound": "dp_bound"}
    assert kernel_roofline.read(spec, w) == pytest.approx(25.0)
