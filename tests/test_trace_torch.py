"""The port's span log and work counters (`utils/logging.py`) and their two
exporters: `--profile` (stage_times.json, spans.json, counts.json) and
`--profile_trace` (the program's spans inside the torch.profiler trace).
A small `run` on the CPU records every span and counter the benchmark
reads."""
import json
import threading

import pytest
import torch

from volcanosv_tpu_torch.cli import main
from volcanosv_tpu_torch.utils import logging as ulog

NEW_SPANS = {"io_read", "io_write", "polish_records", "polish_windows",
             "polish_resolve", "overlap_native", "small_indel_extract",
             "small_indel_filter"}
COUNTERS = {"aligner_queries", "overlap_hits", "polish_ambiguous_windows"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    assert main(["sim", "-o", str(d / "sim"), "--length", "40000",
                 "--n_del", "1", "--n_ins", "1", "--n_small", "4",
                 "--coverage", "15", "--read_len", "6000",
                 "--seed", "5"]) == 0
    return d


@pytest.fixture(scope="module")
def profiled_run(sim):
    out = sim / "run"
    assert main(["run", "--ref", str(sim / "sim" / "ref.fa"),
                 "--fastq", str(sim / "sim" / "reads.fastq"), "-o", str(out),
                 "--device", "cpu", "--profile"]) == 0
    return {f: json.loads((out / f"{f}.json").read_text())
            for f in ("spans", "counts", "stage_times")}


def _ancestors(spans, i):
    while spans[i]["parent"] is not None:
        i = spans[i]["parent"]
        yield spans[i]["name"]


def _stage_on_thread():
    with ulog.stage_timer("t_thread"):
        pass


def test_untraced_stage_adds_time_and_no_span():
    assert ulog.set_tracing(False) is False
    n_spans = len(ulog.SPANS)
    calls = ulog.STAGE_TIMES["t_untraced"][1]
    with ulog.stage_timer("t_untraced"):
        pass
    assert ulog.STAGE_TIMES["t_untraced"][1] == calls + 1
    assert ulog.STAGE_TIMES["t_untraced"][0] >= 0
    assert len(ulog.SPANS) == n_spans


def test_traced_stages_record_parent_and_command():
    old = ulog.set_tracing(True)
    try:
        with ulog.command_scope() as cmd:
            with ulog.stage_timer("t_outer"):
                with ulog.stage_timer("t_inner"):
                    pass
                # a span opened on another thread has no parent there
                th = threading.Thread(target=_stage_on_thread)
                th.start()
                th.join(timeout=10)
                assert not th.is_alive()
            with ulog.stage_timer("t_second"):
                pass
        with ulog.command_scope() as other:
            with ulog.stage_timer("t_other"):
                pass
    finally:
        assert ulog.set_tracing(old) is True
    assert other != cmd
    spans = ulog.spans_of(cmd)
    assert [s["name"] for s in spans] == ["t_outer", "t_inner", "t_thread",
                                          "t_second"]
    assert [s["parent"] for s in spans] == [None, 0, None, None]
    assert all(s["command"] == cmd for s in spans)
    outer, inner = spans[0], spans[1]
    assert outer["start"] <= inner["start"] <= inner["end"] <= outer["end"]
    assert [s["name"] for s in ulog.spans_of(other)] == ["t_other"]
    # tracing is back off: no span, the time still counted
    n_spans = len(ulog.SPANS)
    with ulog.stage_timer("t_outer"):
        pass
    assert len(ulog.SPANS) == n_spans
    assert ulog.STAGE_TIMES["t_outer"][1] == 2


def test_count_adds_up():
    before = ulog.COUNTS["t_counter"]
    ulog.count("t_counter", 3)
    ulog.count("t_counter", 4)
    assert ulog.COUNTS["t_counter"] == before + 7


def test_profile_writes_spans_and_counts(sim):
    out = sim / "vc"
    assert main(["vc-large-indel", "--ref", str(sim / "sim" / "ref.fa"),
                 "--contig", str(sim / "sim" / "true_contigs.fa"),
                 "--fastq", str(sim / "sim" / "reads.fastq"),
                 "-o", str(out), "--device", "cpu", "--profile"]) == 0
    times = json.loads((out / "stage_times.json").read_text())
    assert any(k.startswith("large-indel") for k in times)
    for v in times.values():
        assert set(v) == {"total_s", "calls"}
        assert v["total_s"] >= 0 and v["calls"] >= 1
    doc = json.loads((out / "spans.json").read_text())
    cmd, spans = doc["command"], doc["spans"]
    assert cmd["name"] == "vc-large-indel"
    names = {s["name"] for s in spans}
    assert {"io_read", "io_write", "align-contigs", "seed_chain"} <= names
    for i, s in enumerate(spans):
        assert s["command"] == cmd["id"]
        assert cmd["start"] <= s["start"] <= s["end"] <= cmd["end"]
        assert s["parent"] is None or s["parent"] < i
    counts = json.loads((out / "counts.json").read_text())
    assert counts["aligner_queries"] > 0
    assert not ulog.set_tracing(False)        # --profile left it off


def test_profile_trace_holds_host_ops_and_spans(sim, tmp_path):
    assert main(["vc-large-indel", "--ref", str(sim / "sim" / "ref.fa"),
                 "--contig", str(sim / "sim" / "true_contigs.fa"),
                 "-o", str(tmp_path / "vc"), "--device", "cpu",
                 "--profile_trace", str(tmp_path / "trace")]) == 0
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())[
        "traceEvents"]
    aten = [e for e in events if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("aten::")]
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert aten
    names = {e["name"] for e in spans}
    assert {"vc-large-indel", "io_read", "io_write", "seed_chain"} <= names
    # the spans sit on the trace's clock: the command's span holds the
    # host operations the command ran
    root = next(e for e in spans if e["name"] == "vc-large-indel")
    inside = [e for e in aten
              if root["ts"] - 1e3 <= e["ts"] <= root["ts"] + root["dur"]]
    assert len(inside) >= 0.9 * len(aten)


def test_run_records_every_span_and_counter(profiled_run):
    spans = profiled_run["spans"]["spans"]
    names = {s["name"] for s in spans}
    assert NEW_SPANS <= names
    assert NEW_SPANS <= set(profiled_run["stage_times"])
    for i, s in enumerate(spans):
        up = set(_ancestors(spans, i))
        if s["name"].startswith("polish_"):
            assert "farm_polish" in up
        if s["name"].startswith("small_indel_"):
            assert "small-indel[chr1]" in up
    assert any("farm_overlap" in set(_ancestors(spans, i))
               for i, s in enumerate(spans) if s["name"] == "overlap_native")
    counts = profiled_run["counts"]
    assert all(counts[c] > 0 for c in COUNTERS)
