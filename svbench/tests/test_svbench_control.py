"""The control (the reference one precision below the configuration's:
svbench/reference/control.py) comes out as not correct under every cell's
limits, at a size a test run holds."""
import pytest

from svbench import harness
from svbench.gen import recipe
from svbench.reference import control, judge

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT, "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tmp_path):
    spec = harness.load_cell(cell)
    traffic = dict(spec["traffic"], job_length=min(
        spec["traffic"]["job_length"], 200_000))
    counts = []
    for i in (1, 2, 3):
        job = recipe.make_job(spec["config"], traffic, 7_000_000_019, i,
                              str(tmp_path / f"job{i}"))
        out = str(tmp_path / f"ctl{i}")
        control.control_outputs(job, spec["config"], [7, i], out,
                                traffic["answers"])
        counts.append(judge.judge_job(job, out, traffic["answers"]))
    ok, checks = judge.verdict(judge.pool(counts), spec["limits"])
    assert not ok, checks
    # the control fails the compared numbers it reaches, not one alone
    over = [n for n, c in checks.items() if c["value"] > c["limit"]]
    assert len(over) >= min(2, len(checks)), checks


def test_the_judge_passes_the_truth_itself(tmp_path):
    """The judge reads the generator's own answers as exact."""
    spec = harness.load_cell("hifi-run-250kb")
    var = spec["config"]["variants"]       # SVs in a job of a test's size
    var["sv_per_mb"] = {k: 40 for k in var["sv_per_mb"]}
    traffic = dict(spec["traffic"], job_length=60_000)
    job = recipe.make_job(spec["config"], traffic, 11, 1, str(tmp_path / "j"))
    svs, snps = judge.truth_records(job)
    out = tmp_path / "out"
    out.mkdir()
    header = recipe.vcf_header({c: len(s) for c, s in job["ref"].items()})

    def line(r):
        info = dict(r.info)
        if not r.alt.startswith("<"):
            info.pop("END", None)
        return (r.chrom, r.pos, recipe.vcf_line(
            r.chrom, r.pos, ".", r.ref, r.alt, info, r.gt))
    recipe.write_vcf(str(out / judge.MERGED), header, [line(r) for r in svs])
    recipe.write_vcf(str(out / judge.SNPS), header, [line(r) for r in snps])
    recipe.write_fasta(str(out / judge.CONTIGS), recipe.sim.
                       contigs_from_haplotypes(job["hap1"], job["hap2"]))
    n = judge.pool([judge.judge_job(job, str(out), traffic["answers"])])
    assert n["sv_miss"] == 0 and n["small_miss"] == 0 and n["snp_miss"] == 0
    assert n["sv_err"] == 0 and n["small_err"] == 0
    assert n["sv_gt_err"] == 0 and n["snp_gt_err"] == 0
    assert n["small_fp_per_100kb"] == 0 and n["snp_fp_per_100kb"] == 0
    assert n["contig_err"] == 0 and n["contig_miss"] == 0


def test_edit_distance_is_levenshtein():
    import itertools
    import random
    rng = random.Random(5)

    def plain(a, b):
        d = list(range(len(b) + 1))
        for i, x in enumerate(a, 1):
            prev, d[0] = d[0], i
            for j, y in enumerate(b, 1):
                prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (x != y))
        return d[-1]
    for la, lb in itertools.product((0, 1, 7, 30), (0, 2, 9, 31)):
        a = "".join(rng.choice("ACGT") for _ in range(la))
        b = "".join(rng.choice("ACGT") for _ in range(lb))
        assert judge.edit_distance(a, b) == plain(a, b)
