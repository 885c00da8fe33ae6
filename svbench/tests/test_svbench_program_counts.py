"""`program_counts`: the port's work counters over the traced window, a
Mb of reference; silent where they did not move or do not exist."""
import pytest

from svbench import harness
from svbench.readers import program_counts
from volcanosv_tpu_torch.utils import logging as port_logging


def _window(length):
    w = harness.Window()
    w.jobs = [dict(length=length, stages={})]
    w.ref_mb = length / 1e6
    return w


def test_a_counter_that_moves_reads_its_change_a_mb():
    spec = {"reader": "program_counts", "counters": ["aligner_queries"]}
    w = _window(500_000)
    port_logging.count("aligner_queries", 7)         # before the window
    undo = program_counts.install(spec, w)
    port_logging.count("aligner_queries", 1000)
    port_logging.count("aligner_queries", 1600)
    port_logging.count("overlap_hits", 99)           # another counter
    undo()
    port_logging.count("aligner_queries", 5)         # after the window
    assert program_counts.read(spec, w) == pytest.approx(5200.0)


def test_a_counter_that_does_not_move_reads_none():
    spec = {"reader": "program_counts",
            "counters": ["polish_ambiguous_windows"]}
    w = _window(250_000)
    undo = program_counts.install(spec, w)
    port_logging.count("aligner_queries", 3)
    undo()
    assert program_counts.read(spec, w) is None
    assert program_counts.read(spec, _window(250_000)) is None


def test_a_program_without_counters_reads_none(monkeypatch):
    monkeypatch.delattr(port_logging, "COUNTS")
    spec = {"reader": "program_counts", "counters": ["overlap_hits"]}
    w = _window(250_000)
    undo = program_counts.install(spec, w)
    undo()
    assert program_counts.read(spec, w) is None
