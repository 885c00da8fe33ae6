"""Jobs of several chromosomes, and a job run as ranks.

- The cells without `chroms` and `ranks` make the jobs they made before
  either key existed: their parameters, seeds and bytes are pinned.
- `chroms` K gives jobs of K chromosomes that hold the configuration's
  densities over K x job_length.
- `ranks` 2 runs each job as two processes of one gloo group on the CPU
  (`harness.measure`, past the look for a card): the run reads `correct`,
  and its merged VCF equals, byte for byte, one process's run of the same
  job.  The ranks' stage seconds and counters come back summed.
- A rank that raises mid-job ends the run with a result line, `correct`
  false, and no rank left running.
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import pytest

from svbench import harness, ranks, trace
from svbench.gen import recipe

SEED = 2 ** 33 + 5

# the jobs of the two cells, as they were before `chroms` and `ranks`
PINNED = {
    "hifi-run-250kb": dict(
        length=250_000,
        counts=dict(n_del=[0, 1] * 7, n_ins=[1, 0, 1, 1, 0, 1, 0, 1, 1, 0,
                                             1, 1, 0, 1],
                    n_inv=[0] * 14, n_dup=[0] * 14, n_small=[66] * 14),
        files={"reads.fastq": "b09a7ca85694fab43e4102838a37468839c8bd0041ca69ed983522f04ffc4b12",
               "ref.fa": "3f39030fdb52371a50e6c1b367fcf713bf136473ffcd4a014fa234556acac1f4"},
        truth="c838a122c102a5e8ac79850d6d2164db616baf3449a6d68cd6e517dcd93c0fd3"),
    "hifi-vc-otherasm-1mb": dict(
        length=1_000_000,
        counts=dict(n_del=[2, 2, 2, 2, 1, 2, 2, 2, 2, 2],
                    n_ins=[3, 2] * 5, n_inv=[0] * 10, n_dup=[0] * 10,
                    n_small=[264] * 5 + [263] + [264] * 4),
        files={"contigs.fa": "dcc1b3ede749719c9f86678f2d2364fa17f05f1688efb7de4eba0e29673f885f",
               "reads.fastq": "2ad3c5d208befc5b8e6ef57175c53064721e3801df70b5f6d8ed08a2c9b113d9",
               "ref.fa": "0b4a38aef62ec9d7c600e62f32918f1d4eda5cca8893650582c184ed6e571cf8"},
        truth="14163b97fa8098174d0b41ac9a1427afaa6cc17c4ddc0b04d459f8f2b6a10ea4"),
}
FIXED = dict(chroms=1, n_tra=0, n_clustered=0, n_nested=0, n_tandem=0,
             n_segdup=0, n_homopoly=0, min_len=60, max_len=400,
             snp_rate=0.0012, coverage=28, read_len=13500, err=0.00114)
COUNTS = ("n_del", "n_ins", "n_inv", "n_dup", "n_small")


def sha(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_the_cells_jobs_are_those_made_before_chroms_and_ranks(cell,
                                                               tmp_path):
    spec = harness.load_cell(cell)
    cfg, t = spec["config"], spec["traffic"]
    assert "chroms" not in t and "ranks" not in t
    pin = PINNED[cell]
    ps = [dataclasses.asdict(recipe.job_params(cfg, t, i))
          for i in range(t["pool"] + 1)]
    for p in ps:
        assert {k: v for k, v in p.items() if k not in COUNTS} == dict(
            FIXED, length=pin["length"])
    assert {k: [p[k] for p in ps] for k in COUNTS} == pin["counts"]
    assert recipe.job_seed(SEED, 1) == [SEED, 0, 1]
    assert recipe.job_seed(-3, 2) == [2 ** 64 - 3, -1, 2]
    job = recipe.make_job(cfg, t, SEED, 1, str(tmp_path))
    assert {f: sha(tmp_path / f) for f in os.listdir(tmp_path)} \
        == pin["files"]
    truth = {k: v for k, v in job.items() if k != "dir"}
    assert hashlib.sha256(json.dumps(truth, sort_keys=True).encode()) \
        .hexdigest() == pin["truth"]


def test_a_job_of_two_chromosomes_holds_the_densities_over_its_length():
    spec = harness.load_cell("hifi-run-250kb")
    cfg = spec["config"]
    t = dict(spec["traffic"], chroms=2)
    var = cfg["variants"]
    n = 14
    ps = [recipe.job_params(cfg, t, i) for i in range(n)]
    mb = 2 * t["job_length"] * n / 1e6
    for key, per_mb in (("n_del", var["sv_per_mb"]["DEL"]),
                        ("n_ins", var["sv_per_mb"]["INS"]),
                        ("n_small", var["small_indel_per_mb"])):
        each = [sum(getattr(p, key)) for p in ps]
        # a job holds the share of its whole length, 2 x job_length
        assert each == [recipe._share(per_mb / 1e6, 2 * t["job_length"], i)
                        for i in range(n)]
        assert abs(sum(each) - per_mb * mb) <= 0.5
    assert all(p.chroms == 2 and p.length == t["job_length"] for p in ps)
    # each chromosome is of the job's length and holds its own counts
    p = ps[1]
    sim = recipe.simulate(dataclasses.replace(p, coverage=0.01),
                          recipe.job_seed(7, 1))
    assert {c: len(s) for c, s in sim.ref.items()} == {
        "chr1": t["job_length"], "chr2": t["job_length"]}
    for k, chrom in enumerate(sim.ref):
        svs = [s for s in sim.truth if s.chrom == chrom]
        assert len(svs) == p.n_del[k] + p.n_ins[k] + p.n_small[k]


def test_a_count_a_chromosome_equal_on_each_reads_as_one_count():
    """(test_svbench_gen.py holds one count to the port's `sim` bytes.)"""
    p = recipe.SimParams(length=20_000, chroms=3, n_del=1, n_ins=2,
                         n_small=4, coverage=0.5)
    a = recipe.simulate(p, 11)
    b = recipe.simulate(dataclasses.replace(p, n_del=[1] * 3, n_ins=[2] * 3,
                                            n_small=[4] * 3), 11)
    assert a == b


# --- the rank mode -------------------------------------------------------------

DENSER = 20     # SVs, so that a test's jobs hold some (as the fault tests)


def small_spec(cell: str, length: int, pool: int, n_ranks: int) -> dict:
    spec = harness.load_cell(cell)
    var = spec["config"]["variants"]
    var["sv_per_mb"] = {k: v * DENSER for k, v in var["sv_per_mb"].items()}
    t = dict(spec["traffic"], job_length=length, pool=pool, chroms=2,
             ranks=n_ranks)
    if "contigs" in t:
        t["contigs"] = {"block_size": 12_000, "overlap": 2_000}
    spec["traffic"] = t
    return spec


OUTPUTS = ["volcanosv_variants.vcf", "phased_snps.vcf", "final_contigs.fa",
           "volcanosv_large_indel.vcf", "volcanosv_small_indel.vcf",
           "volcanosv_complex_sv.vcf"]


def job_lines(out: str) -> dict:
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    return {ln["job"]: ln for ln in lines if "job" in ln}


@pytest.mark.parametrize("cell,length,pool", [
    ("hifi-vc-otherasm-1mb", 20_000, 2), ("hifi-run-250kb", 30_000, 1)])
def test_two_ranks_read_correct_and_equal_one_process(cell, length, pool,
                                                      tmp_path, capsys):
    from volcanosv_tpu_torch.cli import main
    from volcanosv_tpu_torch.utils import logging as port_logging
    spec = small_spec(cell, length, pool, 2)
    root = tmp_path / "run"
    r = harness.measure(spec, seed=9_000_000_023, seconds=1e9, trace=False,
                        device="cpu", root=str(root))
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] == pool and r["failed"] == 0
    assert r["device"]["count"] == 2
    assert r["metrics"]["host_rss_peak_gb"]["value"] > 0
    lines = job_lines(capsys.readouterr().out)
    assert sorted(lines) == list(range(1, pool + 1))
    for i, line in lines.items():
        # one process, the same job
        before = dict(port_logging.COUNTS)
        harness.run_job(main, spec["traffic"], spec["config"],
                        {"dir": str(root / f"job{i}")},
                        str(tmp_path / f"alone{i}"), "cpu")
        alone_counts = {k: v - before.get(k, 0)
                        for k, v in port_logging.COUNTS.items()
                        if v != before.get(k, 0)}
        seen = 0
        for name in OUTPUTS:
            a, b = root / f"out{i}" / name, tmp_path / f"alone{i}" / name
            assert a.exists() == b.exists(), name
            if a.exists():
                seen += 1
                assert a.read_bytes() == b.read_bytes(), (i, name)
        assert seen >= 1
        # the job's stages and counters are the ranks' sums
        rs = line["ranks"]
        assert [x["rank"] for x in rs] == [0, 1]
        for stage, sec in line["stages"].items():
            assert sec == pytest.approx(sum(x["stages"].get(stage, 0.0)
                                            for x in rs))
        assert line["program_counts"] == ranks.summed(
            [x["counts"] for x in rs])
        # every query is seeded on some rank; rank 0 alone also seeds what
        # the genome-wide stages realign
        assert line["program_counts"]["aligner_queries"] \
            >= alone_counts["aligner_queries"]
        assert line["seconds"] >= max(x["seconds"] for x in rs)


SITE = """
import os
if os.environ.get("RANK") == "1":
    import volcanosv_tpu_torch.vc.small_indel as small_indel
    call, calls = small_indel.call_small_indels, [0]

    def planted(*a, **kw):
        calls[0] += 1
        if calls[0] == 2:       # the first job after the warm-up
            raise RuntimeError("planted: rank 1 raises mid-job")
        return call(*a, **kw)
    small_indel.call_small_indels = planted
"""


def test_a_rank_that_raises_ends_the_run_with_no_rank_left(tmp_path,
                                                           monkeypatch):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SITE)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(site)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    started = []
    init = ranks.Ranks.__init__

    def keep(self, *a, **kw):
        started.append(self)
        init(self, *a, **kw)
    monkeypatch.setattr(ranks.Ranks, "__init__", keep)
    spec = small_spec("hifi-run-250kb", 20_000, 2, 2)
    t0 = time.monotonic()
    r = harness.measure(spec, seed=9_000_000_031, seconds=1e9, trace=False,
                        device="cpu")
    assert r["correct"] is False
    assert r["attempted"] == 2 and r["failed"] == 2
    assert time.monotonic() - t0 < 300
    (rk,) = started
    assert rk.dead and "planted" in rk.dead
    for p in rk.procs:
        assert p.returncode is not None
        assert not os.path.exists(f"/proc/{p.pid}")


FAKE_TRACE = """
import os, time
if os.environ.get("RANK"):
    from svbench import trace

    class CardOfText:
        # each rank's card: one 0.1 s operation a rank after the start
        def __init__(self, path):
            self.rank = int(os.environ["RANK"])

        def start(self):
            self.t0 = time.perf_counter()

        def stop(self):
            pass

        def ops(self):
            s = self.t0 + 0.1 * (self.rank + 1)
            return [("kernel_of_rank%d" % self.rank, s, s + 0.1 * (self.rank + 1))]
    trace.DeviceTrace = CardOfText
"""


def test_a_traced_run_merges_what_each_rank_recorded(tmp_path, monkeypatch,
                                                     capsys):
    """The traced window over two ranks on the CPU, each rank's card a
    stand-in that reports one operation: the spans and counters come back
    from the ranks, and the breakdown names each rank."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(FAKE_TRACE)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(site)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    spec = small_spec("hifi-run-250kb", 20_000, 1, 2)
    r = harness.measure(spec, seed=9_000_000_041, seconds=1e9, trace=True,
                        device="cpu")
    assert r["attempted"] == 1 and r["failed"] == 0
    dev = r["device"]
    assert dev["count"] == 2
    assert dev["busy_s"] == pytest.approx((0.1 + 0.2) / 2)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    (cards,) = [ln for ln in lines if "busy_s_by_card" in ln]
    assert cards["busy_s_by_card"] == [pytest.approx(0.1), pytest.approx(0.2)]
    assert dict(r["breakdown"]["device_ops"]) == {
        "rank0:kernel_of_rank0": pytest.approx(0.1),
        "rank1:kernel_of_rank1": pytest.approx(0.2)}
    assert {n.split(":", 1)[0] for n, _v in r["breakdown"]["idle_gaps"]} \
        == {"rank0", "rank1"}
    m = r["metrics"]
    assert m["device_idle_pct.run"]["value"] == pytest.approx(
        100 * (1 - 0.15 / dev["window_s"]))
    for name in ("seed_chain_s_per_mb.run", "farm_polish_s_per_mb",
                 "aligner_queries_per_mb.run", "host_cpu_s_per_mb.run",
                 "ref_kb_per_s.run"):
        assert m[name]["value"] > 0, name
    (line,) = [ln for ln in lines if ln.get("job") == 1]
    mb = line["counts"]["length"] / 1e6
    assert m["aligner_queries_per_mb.run"]["value"] == pytest.approx(
        line["program_counts"]["aligner_queries"] / mb)
    assert m["seed_chain_s_per_mb.run"]["value"] == pytest.approx(
        line["stages"]["seed_chain"] / mb)
    assert "banded_dp_roofline.run" not in m       # no DP call on a card


# --- the instruments over ranks ----------------------------------------------

def test_a_tensor_crosses_the_pipe():
    """What a rank records (tensors on the host among it) reaches the
    harness through the pipe from another process."""
    r, w = os.pipe()
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, torch; from multiprocessing.connection import "
         "Connection; from svbench import ranks; "
         "ranks.send(Connection(int(sys.argv[1]), readable=False), "
         "{'banded_dp': [dict(qlen=torch.arange(5), M=3)]})", str(w)],
        cwd=harness.ROOT, pass_fds=(w,))
    os.close(w)
    from multiprocessing.connection import Connection
    conn = Connection(r, writable=False)
    try:
        got = ranks.recv(conn)
    finally:
        conn.close()
        child.wait(timeout=120)
    assert child.returncode == 0
    assert got["banded_dp"][0]["M"] == 3
    assert got["banded_dp"][0]["qlen"].tolist() == [0, 1, 2, 3, 4]

def test_the_rss_sampler_sums_the_processes():
    procs = [subprocess.Popen([sys.executable, "-c",
                               "import time; x = bytearray(%d); "
                               "time.sleep(30)" % (n << 20)])
             for n in (64, 128)]
    try:
        time.sleep(1.0)
        one = [harness.vmrss_kb(f"/proc/{p.pid}/status") for p in procs]
        assert one[1] > one[0] + 32 * 1024
        both = harness.RssSampler(pids=[p.pid for p in procs])
        assert both.rss_kb() == pytest.approx(sum(one), rel=0.01)
        procs[0].kill()
        procs[0].wait()
        assert both.rss_kb() == pytest.approx(one[1], rel=0.01)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert harness.RssSampler().rss_kb() > 0


def test_the_ranks_records_merge():
    a = {"banded_dp": [1, 2], "program_counts:x": dict(
        before={"x": 1}, after={"x": 4})}
    b = {"banded_dp": [3], "program_counts:x": dict(
        before={"x": 2, "y": 1}, after={"x": 7, "y": 1})}
    assert ranks.merge(a, b) == {
        "banded_dp": [1, 2, 3],
        "program_counts:x": dict(before={"x": 3, "y": 1},
                                 after={"x": 11, "y": 1})}
    assert ranks.summed([{"a": 1.0}, {"a": 2.0, "b": 1.0}]) == {"a": 3.0,
                                                                "b": 1.0}
    with pytest.raises(TypeError):
        ranks.merge("x", "y")


def test_the_ranks_windows_sum_up_by_card():
    r0 = ([("dp", 1.0, 2.0)], [["seed", 0.0, 4.0]])
    r1 = ([("dp", 0.0, 0.5), ("walk", 3.0, 4.0)], [])
    s = trace.summarize_ranks([r0, r1], 0.0, 4.0)
    assert s["busy_s"] == pytest.approx((1.0 + 1.5) / 2)
    assert s["window_s"] == 4.0
    assert s["kernel_s"] == {"dp": pytest.approx(1.5), "walk": 1.0}
    assert dict(s["device_ops"]) == {"rank0:dp": 1.0, "rank1:walk": 1.0,
                                     "rank1:dp": 0.5}
    assert dict(s["idle_gaps"]) == {"rank0:seed": 3.0,
                                    "rank1:outside spans": 2.5}


def test_the_ranks_get_torchruns_environment(monkeypatch):
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    env = ranks.torchrun_env(4, 2, 29555)
    assert {k: env[k] for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                                "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                                "OMP_NUM_THREADS")} == dict(
        MASTER_ADDR="127.0.0.1", MASTER_PORT="29555", WORLD_SIZE="4",
        RANK="2", LOCAL_RANK="2", LOCAL_WORLD_SIZE="4", OMP_NUM_THREADS="1")
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    assert ranks.torchrun_env(4, 0, 1)["OMP_NUM_THREADS"] == "3"
