"""No state leaks between the window's jobs: two jobs run one after the
other in one process give the same outputs, byte for byte, as each run
alone in a fresh process.  Tiny jobs on the CPU, through the job function
(`harness.run_job`); the measuring path is not used."""
import json
import subprocess
import sys

import pytest

from svbench import harness
from svbench.gen import recipe

OUTPUTS = ["volcanosv_variants.vcf", "phased_snps.vcf", "final_contigs.fa",
           "volcanosv_large_indel.vcf", "volcanosv_small_indel.vcf",
           "volcanosv_complex_sv.vcf",
           "vc-large-indel/volcanosv_large_indel.vcf",
           "vc-small-indel/volcanosv_small_indel.vcf",
           "vc-complex-sv/volcanosv_complex_sv.vcf"]

ALONE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from svbench import harness
from volcanosv_tpu_torch.cli import main
spec = json.loads(sys.argv[2])
harness.run_job(main, spec["traffic"], spec["config"], {"dir": sys.argv[3]},
                sys.argv[4], "cpu")
"""


def tiny(cell: str, length: int) -> dict:
    spec = harness.load_cell(cell)
    t = dict(spec["traffic"], job_length=length)
    if "contigs" in t:
        t["contigs"] = {"block_size": 12_000, "overlap": 2_000}
    return dict(config=spec["config"], traffic=t)


@pytest.mark.parametrize("cell,length", [("hifi-run-250kb", 20_000),
                                         ("hifi-vc-otherasm-1mb", 30_000)])
def test_jobs_in_turn_equal_each_job_alone(cell, length, tmp_path):
    from volcanosv_tpu_torch.cli import main
    spec = tiny(cell, length)
    jobs = [recipe.make_job(spec["config"], spec["traffic"], 2 ** 33 + 5, i,
                            str(tmp_path / f"job{i}")) for i in (1, 2)]
    for j in jobs:
        harness.run_job(main, spec["traffic"], spec["config"], j,
                        str(tmp_path / f"turn{j['index']}"), "cpu")
    for j in jobs:
        subprocess.run([sys.executable, "-c", ALONE, harness.ROOT,
                        json.dumps(spec), j["dir"],
                        str(tmp_path / f"alone{j['index']}")],
                       check=True, capture_output=True, timeout=600)
    for j in jobs:
        seen = 0
        for name in OUTPUTS:
            a = tmp_path / f"turn{j['index']}" / name
            b = tmp_path / f"alone{j['index']}" / name
            assert a.exists() == b.exists(), name
            if a.exists():
                seen += 1
                assert a.read_bytes() == b.read_bytes(), (j["index"], name)
        assert seen >= 4
