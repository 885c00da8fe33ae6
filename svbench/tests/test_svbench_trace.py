"""The traced run's arithmetic, on a made-up timeline: the device's busy
time is the union of its operations, and its idle time goes to the
innermost span open on the host."""
import pytest

from svbench import trace


def test_busy_is_the_union_clipped_to_the_window():
    ops = [("a", 0.5, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0), ("d", 9.0, 12.0)]
    assert trace.busy_intervals(ops, 1.0, 10.0) == [(1.0, 3.0), (5.0, 6.0),
                                                   (9.0, 10.0)]


def test_idle_goes_to_the_innermost_span():
    spans = [["outer", 0.0, 10.0], ["inner", 2.0, 4.0], ["late", 8.0, 12.0]]
    ops = [("k", 3.0, 3.5), ("k", 6.0, 7.0)]
    s = trace.summarize(ops, spans, 0.0, 10.0)
    assert s["busy_s"] == pytest.approx(1.5)
    assert s["window_s"] == 10.0
    idle = dict(s["idle_gaps"])
    assert idle["inner"] == pytest.approx(1.5)      # 2-3 and 3.5-4
    assert idle["outer"] == pytest.approx(5.0)      # 0-2, 4-6, 7-8
    assert idle["late"] == pytest.approx(2.0)       # 8-10
    assert sum(idle.values()) == pytest.approx(10.0 - s["busy_s"])
    assert s["device_ops"] == [["k", pytest.approx(1.5)]]


def test_time_outside_every_span_is_named():
    s = trace.summarize([], [["x", 1.0, 2.0]], 0.0, 3.0)
    assert dict(s["idle_gaps"]) == pytest.approx({"outside spans": 2.0,
                                                  "x": 1.0})
