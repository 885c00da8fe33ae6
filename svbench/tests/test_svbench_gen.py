"""The frozen generator gives the port's `sim` bytes for the same arguments
and seed."""

import pytest

from svbench.gen import recipe

FILES = ["ref.fa", "reads.fastq", "truth.vcf", "truth_snps.vcf",
         "true_contigs.fa", "repeats.bed"]

CASES = {
    "hifi": dict(length=30_000, n_del=2, n_ins=2, n_inv=1, n_dup=1,
                 n_small=5, coverage=6, read_len=15_000, err=0.002),
    "ont": dict(length=20_000, n_del=1, n_ins=1, n_inv=1, n_dup=1,
                n_small=3, coverage=6, read_len=8_000, err=0.06),
    "repeats": dict(length=40_000, n_del=2, n_ins=2, n_inv=1, n_dup=2,
                    n_small=2, n_tandem=2, n_segdup=1, n_homopoly=2,
                    coverage=4, read_len=9_000, err=0.002),
    "two_chroms": dict(length=30_000, chroms=2, n_del=1, n_ins=1,
                       n_tra=1, n_clustered=1, n_nested=1, coverage=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frozen_generator_gives_the_ports_sim_bytes(case, tmp_path):
    from volcanosv_tpu_torch.cli import main
    args = CASES[case]
    seed = 2_147_483_659            # past 32 bits
    argv = ["sim", "-o", str(tmp_path / "port"), "--seed", str(seed)]
    for k, v in args.items():
        argv += [f"--{k}", str(v)]
    assert main(argv) == 0
    recipe.write_sim(recipe.simulate(recipe.SimParams(**args), seed),
                     str(tmp_path / "frozen"))
    for name in FILES:
        a, b = tmp_path / "port" / name, tmp_path / "frozen" / name
        assert a.exists() == b.exists(), name
        if a.exists():
            assert a.read_bytes() == b.read_bytes(), name


def test_job_seeds_are_distinct_and_repeat():
    seeds = {tuple(recipe.job_seed(s, i)) for s in (0, 1, 2 ** 31 + 7, -3)
             for i in range(4)}
    assert len(seeds) == 16
    assert recipe.job_seed(2 ** 31 + 7, 3) == recipe.job_seed(2 ** 31 + 7, 3)


@pytest.mark.parametrize("cell", ["hifi-run-250kb", "hifi-vc-otherasm-1mb"])
def test_job_counts_are_the_densities_and_the_same_for_every_seed(cell):
    """A job's counts depend on its index alone, and the pool's jobs
    together hold the configuration's densities at the job's length."""
    from svbench import harness
    spec = harness.load_cell(cell)
    cfg, t = spec["config"], spec["traffic"]
    var, n = cfg["variants"], t["pool"] + 1
    ps = [recipe.job_params(cfg, t, i) for i in range(n)]
    mb = t["job_length"] * n / 1e6
    for key, per_mb in (("n_del", var["sv_per_mb"]["DEL"]),
                        ("n_ins", var["sv_per_mb"]["INS"]),
                        ("n_inv", var["sv_per_mb"]["INV"]),
                        ("n_dup", var["sv_per_mb"]["DUP"]),
                        ("n_small", var["small_indel_per_mb"])):
        assert abs(sum(getattr(p, key) for p in ps) - per_mb * mb) <= 0.5
    assert all(p.snp_rate == var["snp_per_kb"] / 1e3 for p in ps)
    # every count finds its place at the job's own length, on any seed
    for i, seed in ((1, 11), (2, 2 ** 40 + 3)):
        want = ps[i].n_del + ps[i].n_ins + ps[i].n_small
        sim = recipe.simulate(recipe.SimParams(**dict(
            vars(ps[i]), coverage=0.01)), recipe.job_seed(seed, i))
        assert len(sim.truth) == want
