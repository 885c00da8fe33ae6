"""Without a card the benchmark measures nothing: it exits with another
code than 0 and prints no result."""
import json
import os
import shutil
import subprocess
import sys

from svbench import harness


def _run(cwd):
    return subprocess.run(
        [sys.executable, "svbench/run.py", "--workload", "hifi-run-250kb",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _printed_a_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_refuses_without_a_card():
    p = _run(harness.ROOT)
    assert p.returncode != 0
    assert not _printed_a_result(p.stdout)
    assert "CUDA card" in p.stderr


def test_refuses_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and svbench/."""
    shutil.copytree(harness.HERE, tmp_path / "svbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0
    assert not _printed_a_result(p.stdout)
