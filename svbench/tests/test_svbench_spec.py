"""BENCHMARK.json keeps to the contract's names, keys and files, and a cell
is found by its name alone."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from svbench import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield group, e["name"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["svbench"]


@pytest.mark.parametrize("group,name", list(_names()))
def test_names_use_the_allowed_characters(group, name):
    assert NAME.match(name)


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [e["name"] for g in ("end_to_end", "per_layer")
               for e in BENCH[g]]
    assert len(metrics) == len(set(metrics))


def test_entries_have_just_their_keys_and_allowed_values():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("svbench/")
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] \
            == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    spec = harness.load_cell(cell)
    assert spec["traffic"]["commands"] and spec["limits"]
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for m, mspec in spec["per_layer"]:
        assert os.path.exists(os.path.join(
            harness.HERE, "readers", mspec["reader"] + ".py"))


def test_a_new_cell_is_found_by_its_files_alone(tmp_path):
    """A later PR adds a cell by adding files and BENCHMARK.json entries."""
    shutil.copytree(harness.HERE, tmp_path / "svbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(
        name="hifi-run-newmix", config="hifi-28x", traffic="hifi-run-newmix",
        chips=1, why="a later cell"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    t = json.load(open(os.path.join(harness.HERE, "traffic",
                                    "hifi-run-250kb.json")))
    t["job_length"] = 123_000
    (tmp_path / "svbench" / "traffic" / "hifi-run-newmix.json").write_text(
        json.dumps(t))
    (tmp_path / "svbench" / "limits" / "hifi-run-newmix.json").write_text(
        json.dumps({"sv_miss": 0.5}))
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; sys.path.insert(0, sys.argv[1]); "
         "from svbench import harness; s = harness.load_cell('hifi-run-newmix'); "
         "print(json.dumps([s['traffic']['job_length'], s['limits'], "
         "[m['name'] for m, _ in s['per_layer']]]))", str(tmp_path)],
        capture_output=True, text=True, check=True).stdout
    length, limits, metrics = json.loads(out)
    assert length == 123_000 and limits == {"sv_miss": 0.5}
    # a per-layer metric without `workloads` reaches every cell
    assert metrics == []
