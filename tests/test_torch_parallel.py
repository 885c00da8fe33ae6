"""The port's parallel layer (volcanosv_tpu_torch.parallel) against the
JAX package's (volcanosv_tpu.parallel) on the CPU: the mesh split rule,
chromosome ownership, the query slices, the WGS signature merge and
global median (the JAX package on its 8-device virtual mesh,
tests/test_wgs_parallel.py's inputs), the sharded step (the JAX package on
its (2, 4) mesh), the aligner's DP batches split over a two-device mesh,
and the multi-process drivers with two gloo ranks
(`python -m volcanosv_tpu_torch.parallel.multihost --device cpu`): their
VCFs must be the bytes of one port process and of the JAX package's one
process."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_pallas_dp import _case
from torch_inputs import ensure_reference_native_lib
from volcanosv_tpu import parallel as ref_par
from volcanosv_tpu.ops import banded_align as ref_ba
from volcanosv_tpu.parallel import mesh as ref_mesh
from volcanosv_tpu.parallel import multiproc as ref_mp
from volcanosv_tpu.parallel import wgs as ref_wgs
from volcanosv_tpu_torch import parallel as port_par
from volcanosv_tpu_torch.ops import banded_align as port_ba
from volcanosv_tpu_torch.parallel import mesh as port_mesh
from volcanosv_tpu_torch.parallel import multihost
from volcanosv_tpu_torch.parallel import multiproc as port_mp
from volcanosv_tpu_torch.parallel import wgs as port_wgs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n, genome_shards=None):
    return port_mesh.make_mesh(devices=["cpu"] * n,
                               genome_shards=genome_shards)


@pytest.mark.parametrize("n,genome_shards", [
    (1, None), (2, None), (3, None), (4, None), (6, None), (8, None),
    (8, 2), (8, 4), (8, 8), (4, 1)])
def test_make_mesh_split_matches(n, genome_shards):
    want = ref_mesh.make_mesh(n, genome_shards=genome_shards)
    got = port_mesh.make_mesh(n, genome_shards=genome_shards,
                              devices=["cpu"] * 8)
    assert got.shape == dict(want.shape)
    assert got.size == n and all(d == torch.device("cpu")
                                 for d in got.flat())


def test_make_mesh_rejects_indivisible_split():
    with pytest.raises(ValueError):
        ref_mesh.make_mesh(6, genome_shards=4)
    with pytest.raises(ValueError):
        _cpu_mesh(6, genome_shards=4)


def test_default_mesh_is_the_cpu_when_asked():
    assert port_mesh.make_mesh(device="cpu").shape == {"genome": 1,
                                                       "data": 1}


def test_host_chromosome_shard_matches():
    chroms = [f"chr{i}" for i in range(1, 23)]
    for n in (1, 2, 3, 4):
        for p in range(n):
            assert port_mesh.host_chromosome_shard(chroms, p, n) == \
                ref_mesh.host_chromosome_shard(chroms, p, n)
    # the single process owns everything
    assert port_mesh.host_chromosome_shard(chroms) == chroms


def test_shard_interval_matches():
    for n in (0, 1, 7, 100, 101):
        for P in (1, 2, 3, 4):
            for p in range(P):
                assert port_mp.shard_interval(n, p, P) == \
                    ref_mp.shard_interval(n, p, P)
    assert port_mp.shard_interval(10) == (0, 10)


def test_single_process_helpers_are_identities(tmp_path):
    assert port_par.init_multihost() is False       # no coordinator
    assert port_mp.n_processes() == 1 and port_mp.process_id() == 0
    assert port_mp.is_rank0()
    port_mp.barrier("noop")
    v = np.arange(5, dtype=np.float64)
    np.testing.assert_array_equal(port_mp.gather_across_processes(v),
                                  v.astype(np.float32))
    assert port_mp.broadcast_from_rank0({"a": 1}, str(tmp_path), "t") == \
        {"a": 1}
    local = {"chr1": [1], "chr2": [2]}
    assert port_mp.exchange_by_chrom(local, str(tmp_path), "t") is local
    assert port_mp.exchange_by_chrom(local, str(tmp_path), "t",
                                     want=["chr2", "chr3"]) == \
        {"chr2": [2], "chr3": []}
    assert not os.path.exists(tmp_path / "xch")


def test_init_multihost_reads_torchrun_env():
    """Two ranks started the way torchrun starts them (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK in the environment) join one
    group with init_multihost() and no arguments."""
    code = ("import torch.distributed as dist\n"
            "from volcanosv_tpu_torch.parallel import multiproc as mp\n"
            "from volcanosv_tpu_torch.parallel.mesh import init_multihost\n"
            "assert init_multihost() is True\n"
            "assert init_multihost() is False\n"
            "v = mp.gather_across_processes([float(mp.process_id())] * "
            "(1 + mp.process_id()))\n"
            "print(dist.get_backend(), mp.n_processes(), v.tolist())\n"
            "dist.destroy_process_group()\n")
    port = multihost._free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", PYTHONPATH=REPO)
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "gloo 2 [0.0, 1.0, 1.0]"


def test_device_backend_rule():
    """NCCL when every rank of a host has its own card, gloo otherwise."""
    assert port_mesh.device_backend(1, 1) == "nccl"
    assert port_mesh.device_backend(4, 8) == "nccl"
    assert port_mesh.device_backend(2, 1) == "gloo"     # two ranks, one card
    assert port_mesh.device_backend(2, 0) == "gloo"     # no card


def _jax_put(mesh, x):
    from jax.sharding import NamedSharding, PartitionSpec as P
    return jax.device_put(jax.numpy.asarray(x),
                          NamedSharding(mesh, P(ref_mesh.AXES.genome)))


def _sig_inputs(seed):
    """tests/test_wgs_parallel.py's boundary-duplicate case (seed None),
    or random padded shards with near-duplicate neighbours."""
    n_sh, S = 4, 8
    pos = np.zeros(n_sh * S, np.int64)
    svlen = np.ones(n_sh * S, np.int64)
    valid = np.zeros(n_sh * S, bool)
    if seed is None:
        pos[0:2] = [1000, 5000]; svlen[0:2] = [100, 60]; valid[0:2] = True
        pos[S] = 5040; svlen[S] = 58; valid[S] = True
        pos[2 * S] = 9000; svlen[2 * S] = 200; valid[2 * S] = True
        return pos, svlen, valid
    rng = np.random.default_rng(seed)
    pos[:] = rng.integers(0, 3000, n_sh * S)
    pos[1::3] = pos[0::3][:len(pos[1::3])] + rng.integers(0, 150,
                                                          len(pos[1::3]))
    svlen[:] = rng.integers(30, 400, n_sh * S)
    valid[:] = rng.random(n_sh * S) < 0.8
    return pos, svlen, valid


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_sig_merge_matches_jax_mesh(seed):
    pos, svlen, valid = _sig_inputs(seed)
    jmesh = ref_mesh.make_mesh(8, genome_shards=4)
    want = [np.asarray(x) for x in ref_wgs.build_sig_merge_step(
        jmesh, max_shift=100, min_size_sim=0.5)(
        _jax_put(jmesh, pos), _jax_put(jmesh, svlen), _jax_put(jmesh, valid))]
    for mesh in (_cpu_mesh(8, 4), None):
        got = port_wgs.build_sig_merge_step(mesh, max_shift=100,
                                            min_size_sim=0.5)(
            torch.from_numpy(pos), torch.from_numpy(svlen),
            torch.from_numpy(valid))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    if seed is None:
        sp, sl, keep = want
        assert sorted(zip(sp[keep].tolist(), sl[keep].tolist())) == \
            [(1000, 100), (5000, 60), (9000, 200)]


@pytest.mark.parametrize("case", ["random", "empty", "one"])
def test_global_median_matches_jax_mesh(case):
    jmesh = ref_mesh.make_mesh(8, genome_shards=4)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, 4 * 16).astype(np.float32)
    valid = {"random": rng.random(4 * 16) < 0.7,
             "empty": np.zeros(4 * 16, bool),
             "one": np.arange(4 * 16) == 37}[case]
    want = np.asarray(ref_wgs.build_global_median_step(jmesh)(
        _jax_put(jmesh, x), _jax_put(jmesh, valid)))
    for mesh in (_cpu_mesh(8, 4), None):
        got = port_wgs.build_global_median_step(mesh)(
            torch.from_numpy(x), torch.from_numpy(valid))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.astype(np.float32).tobytes()


@pytest.mark.parametrize("sizes", [(7, 0, 23, 11, 5), (1,), (0, 0), ()])
def test_wgs_global_median_matches_jax(sizes):
    """The drivers' path: ragged per-chromosome vectors, on a mesh and on
    the host — the JAX package's bits either way."""
    rng = np.random.default_rng(3)
    rels = [rng.uniform(0, 5, n).astype(np.float32) for n in sizes]
    jmesh = ref_mesh.make_mesh(8, genome_shards=4)
    want = ref_wgs.wgs_global_median(rels, jmesh)
    assert ref_wgs.wgs_global_median(rels, None) == want
    assert port_wgs.wgs_global_median(rels, _cpu_mesh(8, 4)) == want
    assert port_wgs.wgs_global_median(rels, _cpu_mesh(2)) == want
    assert port_wgs.wgs_global_median(rels, None) == want


def test_sharded_step_matches_jax_mesh():
    """One process, a (2, 4) CPU mesh: scores, the summed k-mer table and
    the per-genome-row stats of the JAX package's step on its (2, 4)
    mesh."""
    from volcanosv_tpu.parallel.mesh import batch_sharding
    q, t, ql, tl = multihost.step_inputs(2)
    ql = ql.copy()
    ql[::3] = 100                        # ragged k-mer windows
    jmesh = ref_mesh.make_mesh(8, genome_shards=2)
    sh = batch_sharding(jmesh)
    want = [np.asarray(x) for x in ref_par.build_sharded_align_step(
        jmesh, **multihost.STEP)(*(jax.device_put(x, sh)
                                   for x in (q, t, ql, tl)))]
    got = port_par.build_sharded_align_step(
        _cpu_mesh(8, 2), **multihost.STEP)(q, t, ql, tl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert want[2].shape == (2, 3)


@pytest.mark.parametrize("W,d_lo,B,n_dev", [(128, -64, 8, 2), (64, -32, 6, 2),
                                            (128, -64, 8, 4)])
def test_sharded_cigars_dispatch_matches(W, d_lo, B, n_dev):
    """The batch split over a mesh of CPU devices (one DP and one walk a
    device) = the unsplit call = the JAX package's split dispatch over its
    virtual mesh."""
    rng = np.random.default_rng(B + W)
    q, t, qlen, tlen = _case(rng, B, 192, W, d_lo, indel_rate=0.06)
    jmesh = ref_mesh.make_mesh(n_dev)
    want = ref_ba._sharded_cigars_dispatch(jmesh, q, t, qlen, tlen, W, d_lo,
                                           ref_ba.Scores())()
    unsplit = port_ba.banded_align_cigars(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                          device="cpu")
    port_mesh.set_active_mesh(_cpu_mesh(n_dev))
    try:
        calls = []
        fn = port_ba._sharded_cigars_dispatch
        port_ba._sharded_cigars_dispatch = \
            lambda *a: calls.append(1) or fn(*a)
        try:
            split = port_ba.banded_align_cigars(q, t, qlen, tlen, W=W,
                                                d_lo=d_lo, device="cpu")
        finally:
            port_ba._sharded_cigars_dispatch = fn
    finally:
        port_mesh.set_active_mesh(None)
    assert calls == [1]
    assert split == unsplit == [[(int(o), int(n)) for o, n in c]
                                for c in want]


def test_sharded_dispatch_needs_a_divisible_batch():
    """A batch the mesh does not divide runs unsplit, as the JAX package's
    does."""
    q, t, qlen, tlen = _case(np.random.default_rng(5), 5, 128, 64, -32)
    port_mesh.set_active_mesh(_cpu_mesh(2))
    try:
        fn = port_ba._sharded_cigars_dispatch
        port_ba._sharded_cigars_dispatch = None      # must not be reached
        try:
            got = port_ba.banded_align_cigars(q, t, qlen, tlen, W=64,
                                              d_lo=-32, device="cpu")
        finally:
            port_ba._sharded_cigars_dispatch = fn
    finally:
        port_mesh.set_active_mesh(None)
    assert got == port_ba.banded_align_cigars(q, t, qlen, tlen, W=64,
                                              d_lo=-32, device="cpu")


def _gap_dense_case(B, units):
    """Rows whose optimal alignment alternates gaps around single matches
    (q = a c, t = b c per unit, a and b never matching, a gap cheaper than
    a mismatch): more gap runs than matches, so the walk takes more steps
    than qlen + tlen and the bucketed bound (qlen + tlen + 8 rounded up to
    256) cuts it short when that need sits just under a multiple of 256."""
    rng = np.random.default_rng(units)
    c = rng.integers(2, 4, (B, units)).astype(np.int8)
    q = np.stack([np.zeros_like(c), c], -1).reshape(B, -1)
    t = np.stack([np.ones_like(c), c], -1).reshape(B, -1)
    n = np.full(B, 2 * units, np.int32)
    return q, np.pad(t, ((0, 0), (0, 64)), constant_values=4), n, n.copy()


def test_sharded_dispatch_rewalks_gap_dense_batches():
    """A split batch whose walks the bucketed step bound cuts short is
    walked again at the full bound on each device's traceback (one more
    walk a device, no recursion): the same CIGARs as the unsplit call and
    the JAX package's split dispatch."""
    q, t, qlen, tlen = _gap_dense_case(4, 60)       # need 248 → 256 steps
    scores = dict(match=2, mismatch=-4, gap_open=0, gap_extend=-1)
    n_steps, full = port_ba.walk_steps(q.shape[1], 64, qlen, tlen)
    assert (n_steps, full) == (256, 428)
    want = ref_ba._sharded_cigars_dispatch(
        ref_mesh.make_mesh(2), q, t, qlen, tlen, 64, -32,
        ref_ba.Scores(**scores))()
    unsplit = port_ba.banded_align_cigars(q, t, qlen, tlen, W=64, d_lo=-32,
                                          scores=port_ba.Scores(**scores),
                                          device="cpu")
    walks = []
    fn = port_ba.tb_walk
    port_ba.tb_walk = lambda tb, ql, tl, d_lo, steps, **kw: \
        walks.append((len(ql), steps)) or fn(tb, ql, tl, d_lo, steps, **kw)
    port_mesh.set_active_mesh(_cpu_mesh(2))
    try:
        split = port_ba.banded_align_cigars(
            q, t, qlen, tlen, W=64, d_lo=-32,
            scores=port_ba.Scores(**scores), device="cpu")
    finally:
        port_mesh.set_active_mesh(None)
        port_ba.tb_walk = fn
    assert walks == [(2, 256), (2, 256), (2, full), (2, full)]
    assert split == unsplit == [[(int(o), int(n)) for o, n in c]
                                for c in want]
    runs = sum(op != 0 for op, _n in split[0])
    assert runs > sum(n for op, n in split[0] if op == 0)   # gaps > matches


def test_active_mesh_does_not_route_other_device_types():
    """A mesh of cards leaves a `device="cpu"` call unsplit on the CPU (on
    this host a routed call would fail to reach a card)."""
    q, t, qlen, tlen = _case(np.random.default_rng(6), 8, 128, 64, -32)
    want = port_ba.banded_align_cigars(q, t, qlen, tlen, W=64, d_lo=-32,
                                       device="cpu")
    port_mesh.set_active_mesh(port_mesh.make_mesh(
        devices=["cuda:0", "cuda:1"]))
    try:
        got = port_ba.banded_align_cigars(q, t, qlen, tlen, W=64, d_lo=-32,
                                          device="cpu")
    finally:
        port_mesh.set_active_mesh(None)
    assert got == want


def test_commands_scope_the_pipeline_mesh():
    """Each aligning command installs its own mesh at its top (none for
    the CPU, replacing one left active) and clears it when it ends, also
    when it raises."""
    from volcanosv_tpu_torch import cli
    seen = []

    @cli._mesh_scoped
    def cmd(_args):
        cli._pipeline_mesh(torch.device("cpu"))
        seen.append(port_mesh.active_mesh())
        raise KeyError("cmd")

    port_mesh.set_active_mesh(port_mesh.make_mesh(
        devices=["cuda:0", "cuda:1"]))
    with pytest.raises(KeyError):
        cmd(None)
    assert seen == [None] and port_mesh.active_mesh() is None
    for name in ("cmd_asm", "cmd_qc", "cmd_vc_large_indel",
                 "cmd_vc_small_indel", "cmd_vc_complex_sv", "cmd_run"):
        assert getattr(cli, name).__wrapped__, name


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _multihost(work, *extra):
    """`python -m volcanosv_tpu_torch.parallel.multihost` with two ranks
    on the CPU (gloo) → its result JSON."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-m", "volcanosv_tpu_torch.parallel.multihost",
         "--device", "cpu", "--work", str(work), "--timeout", "900",
         *extra], capture_output=True, text=True, timeout=1000, env=env,
        cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads((work / "multihost.json").read_text())


def _jax_args(work):
    sim = work / "sim"
    return ["--ref", str(sim / "ref.fa"), "--fastq", str(sim / "reads.fastq")]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two ranks of the multihost module, and the JAX package's
    one-process vc subcommands on the same sim files."""
    from volcanosv_tpu.cli import main as ref_main
    ensure_reference_native_lib()
    work = tmp_path_factory.mktemp("multihost")
    res = _multihost(work)
    for cmd, sub, _name in multihost.VC:
        extra = ["--large_vcf", str(work / "jax_multi" /
                                    "volcanosv_large_indel.vcf")] \
            if cmd == "vc-complex-sv" else []
        assert ref_main([cmd, *_jax_args(work), "--contig",
                         str(work / "sim" / "true_contigs.fa"),
                         "-o", str(work / f"jax_{sub}"), *extra]) == 0
    return work, res


def test_two_ranks_verdicts(two_ranks):
    """Each rank on the CPU with gloo, disjoint chromosome shares, the
    union's median, the step, and the drivers' bytes equal to one port
    process's."""
    _work, res = two_ranks
    assert res["ok"] is True
    assert res["large_vcf_identical"] and res["small_vcf_identical"] \
        and res["complex_vcf_identical"] and res["step_identical"]
    assert res["run_identical"] is None
    assert res["large_vcf_records"] > 0
    assert [r["rank"] for r in res["rows"]] == [0, 1]
    for r in res["rows"]:
        assert r["device"] == "cpu" and r["backend"] == "gloo"
        assert r["median_ok"]
    assert res["rows"][0]["own_sim_chroms"] == ["chr1"]
    assert res["rows"][1]["own_sim_chroms"] == ["chr2"]


@pytest.mark.parametrize("sub,name", [(s, n) for _c, s, n in multihost.VC])
def test_two_rank_vcfs_are_the_jax_bytes(two_ranks, sub, name):
    work, _res = two_ranks
    want = _read(work / f"jax_{sub}" / name)
    assert _read(work / sub / name) == want and want


@pytest.mark.slow
def test_two_rank_run_is_the_jax_bytes(tmp_path):
    """`run` across two ranks: its six outputs are one port process's and
    the JAX package's one process's bytes.  `slow`: the multihost module
    with `run` and the JAX package's `run` take about three minutes
    together on the CPU, beyond this file's share of tier-1 (the card runs
    it on every chip_smoke.py run, phase 7)."""
    from volcanosv_tpu.cli import main as ref_main
    ensure_reference_native_lib()
    res = _multihost(tmp_path, "--full")
    assert res["ok"] is True and all(res["run_identical"].values())
    assert ref_main(["run", *_jax_args(tmp_path), "-o",
                     str(tmp_path / "jax_run")]) == 0
    for name in multihost.RUN_OUT:
        want = _read(tmp_path / "jax_run" / name)
        assert _read(tmp_path / "multi_run" / name) == want and want, name


def test_two_rank_step_matches_jax_mesh(two_ranks):
    """The ranks' step outputs (each on a 1 x 4 mesh of its CPU) joined =
    the JAX package's step on its (2, 4) mesh."""
    from volcanosv_tpu.parallel.mesh import batch_sharding
    work, _res = two_ranks
    q, t, ql, tl = multihost.step_inputs(2)
    jmesh = ref_mesh.make_mesh(8, genome_shards=2)
    sh = batch_sharding(jmesh)
    score, table, gathered = [np.asarray(x) for x in
                              ref_par.build_sharded_align_step(
                                  jmesh, **multihost.STEP)(
                                  *(jax.device_put(x, sh)
                                    for x in (q, t, ql, tl)))]
    parts = [np.load(work / f"step_rank{r}.npz") for r in range(2)]
    np.testing.assert_array_equal(
        np.concatenate([p["score"] for p in parts]), score)
    for p in parts:
        np.testing.assert_array_equal(p["table"], table)
        np.testing.assert_array_equal(p["gathered"], gathered)
