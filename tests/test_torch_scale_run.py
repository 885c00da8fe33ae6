"""tools/scale_run_torch.py, the port's twin of tools/scale_run.py, against
the JAX package's tool on the CPU.

A small chromosome (0.1 Mb at 10x) through both tools, each in its own
process: the sim's inputs and `run`'s six outputs are byte-identical, the
reports share the JAX tool's keys and agree on SV accuracy, the twin's
process never loads jax or volcanosv_tpu, and the twin refuses a host
without CUDA unless it is asked for the CPU.  The `slow` test holds the
twin's CPU run at tools/pin_scale_run.py's 5 Mb row to the JAX package's
pinned bytes (tests/data/scale_run_sha256.json), as chip_smoke.py's phase 9
does on the card."""
import hashlib
import json
import os
import subprocess
import sys

import pytest

from torch_inputs import ensure_reference_native_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_FILES = ["ref.fa", "reads.fastq", "truth.vcf"]
RUN_OUT = ["volcanosv_variants.vcf", "volcanosv_large_indel.vcf",
           "volcanosv_small_indel.vcf", "volcanosv_complex_sv.vcf",
           "final_contigs.fa", "phased_snps.vcf"]
SMALL = ["--mb", "0.1", "--coverage", "10", "--read_len", "9000",
         "--seed", "11", "--dtype", "Hifi", "--err", "0.002"]
# the keys the twin's report adds to the JAX tool's
DEVICE_KEYS = {"device", "card", "s_per_mb", "device_max_allocated_gb",
               "device_max_reserved_gb", "kernels", "partition_tables"}
SCALE_PIN = os.path.join(REPO, "tests", "data", "scale_run_sha256.json")
# runs the twin's main in this process, then lists the modules of jax or
# of the JAX package that the process loaded
TWIN = (
    "import json, sys\n"
    "sys.path.insert(0, 'tools')\n"
    "import scale_run_torch\n"
    "rc = scale_run_torch.main(sys.argv[1:])\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'volcanosv_tpu')]\n"
    "print(json.dumps({'rc': rc, 'loaded': bad}))\n")


def _digest(path) -> dict:
    with open(path, "rb") as fh:
        data = fh.read()
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}


def _twin(args, one_thread: bool = True):
    """The twin in a process of its own, on one torch thread unless asked:
    the plain versions' many small ops otherwise wait on every pool thread
    while the other test workers hold the cores."""
    env = dict(os.environ, OMP_NUM_THREADS="1") if one_thread else None
    return subprocess.Popen([sys.executable, "-c", TWIN] + args, cwd=REPO,
                            env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Both tools at SMALL, run side by side: (work dir of the JAX tool,
    its report, work dir of the twin, its report, the twin's loaded
    modules)."""
    ensure_reference_native_lib()     # never a half-written library
    tmp = tmp_path_factory.mktemp("scale")
    jax_work, twin_work = tmp / "jax", tmp / "twin"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    jax_run = subprocess.Popen(
        [sys.executable, "tools/scale_run.py", *SMALL, "--work",
         str(jax_work), "--out", str(tmp / "jax.json")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    twin_run = _twin(SMALL + ["--work", str(twin_work), "--out",
                              str(tmp / "twin.json"), "--device", "cpu"])
    out = {}
    for name, p in (("jax", jax_run), ("twin", twin_run)):
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, (name, stderr[-4000:])
        out[name] = stdout
    with open(tmp / "jax.json") as fh:
        jax_report = json.load(fh)
    with open(tmp / "twin.json") as fh:
        twin_report = json.load(fh)
    status = json.loads(out["twin"].strip().splitlines()[-1])
    assert status["rc"] == 0
    return jax_work, jax_report, twin_work, twin_report, status["loaded"]


@pytest.mark.parametrize("group,name", [("sim", n) for n in SIM_FILES]
                         + [("out", n) for n in RUN_OUT])
def test_twin_gives_the_jax_tools_bytes(both, group, name):
    jax_work, _, twin_work, _, _ = both
    assert _digest(twin_work / group / name) == \
        _digest(jax_work / group / name)


def test_reports_share_the_jax_tools_keys(both):
    _, jax_report, _, twin_report, _ = both
    assert set(twin_report) - set(jax_report) == DEVICE_KEYS
    assert set(jax_report) <= set(twin_report)
    # the port times a few more stages (align-reads, align-contigs, the
    # small-indel and complex-SV callers)
    assert set(jax_report["stages"]) <= set(twin_report["stages"])
    for key in ("genome_mb", "coverage", "n_reads", "total_read_gbp"):
        assert twin_report[key] == jax_report[key], key


def test_reports_agree_on_accuracy(both):
    _, jax_report, _, twin_report, _ = both
    assert twin_report["accuracy"] == jax_report["accuracy"]
    assert twin_report["accuracy"]["TP"] > 0


def test_twin_on_the_cpu_reports_no_card(both):
    """On the CPU the device keys are there, empty: no card, no device
    memory, no kernel launched (the plain versions ran)."""
    _, _, _, twin_report, _ = both
    assert twin_report["device"] == "cpu"
    assert twin_report["card"] is None
    assert twin_report["device_max_allocated_gb"] is None
    assert twin_report["device_max_reserved_gb"] is None
    assert all(k["launches"] == 0 for k in twin_report["kernels"].values())
    tables = twin_report["partition_tables"]
    assert tables["cap"] == 8 and tables["built"] >= tables["distinct"]


def test_twin_loads_no_jax(both):
    *_, loaded = both
    assert loaded == []


@pytest.mark.parametrize("device", [["--device", "cuda"], []],
                         ids=["cuda", "default"])
def test_twin_refuses_a_host_without_cuda(tmp_path, device):
    """`--device cuda`, the default, exits non-zero here before the sim:
    no quiet fall back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    p = _twin(SMALL + ["--work", str(tmp_path / "w"), "--out",
                       str(tmp_path / "r.json")] + device)
    _stdout, stderr = p.communicate(timeout=120)
    assert p.returncode != 0
    assert "CUDA is not available" in stderr
    assert not (tmp_path / "w").exists()
    assert not (tmp_path / "r.json").exists()


@pytest.mark.slow
def test_scale_run_is_the_pinned_bytes(tmp_path):
    """The twin with `--device cpu` at the pin's arguments (tools/
    scale_run.py's 5 Mb row at 24x): the sim's inputs and `run`'s six
    outputs have the digests tools/pin_scale_run.py pinned from the JAX
    package, as the card's run (chip_smoke.py phase 9) must."""
    with open(SCALE_PIN) as fh:
        pin = json.load(fh)
    p = _twin(pin["scale_args"] + ["--work", str(tmp_path), "--out",
                                   str(tmp_path / "scale.json"),
                                   "--device", "cpu"], one_thread=False)
    _stdout, stderr = p.communicate(timeout=4 * 3600)
    assert p.returncode == 0, stderr[-4000:]
    for group, d in (("sim", "sim"), ("run", "out")):
        for name, want in pin[group].items():
            assert _digest(tmp_path / d / name) == want, name
    with open(tmp_path / "scale.json") as fh:
        assert json.load(fh)["accuracy"] == pin["accuracy"]
