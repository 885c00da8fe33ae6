"""vc-small-indel and vc-complex-sv restricted to `--chrom chr2`, to a
`--bed` over chr2 and to a `--bed` of sub-intervals on both chromosomes,
through both CLIs (tests/torch_region_modes.py): each VCF byte-identical
to the JAX package's, and each caller with records inside a
restriction."""
import pytest

from torch_region_modes import (RESTRICTIONS, VCF, both, inputs, read,
                                records, vc_args)

CMDS = ["vc-small-indel", "vc-complex-sv"]


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    return inputs(tmp_path_factory.mktemp("region_callers"))


@pytest.fixture(scope="module")
def outs(d):
    cache = {}

    def get(cmd, case):
        if (cmd, case) not in cache:
            cache[cmd, case] = both(vc_args(cmd, d, RESTRICTIONS[case]), d,
                                    f"{cmd}_{case}")
        return cache[cmd, case]
    return get


@pytest.mark.parametrize("case", list(RESTRICTIONS))
@pytest.mark.parametrize("cmd", CMDS)
def test_byte_identical(outs, cmd, case):
    jax, port = outs(cmd, case)
    want = read(f"{jax}/{VCF[cmd]}")
    assert read(f"{port}/{VCF[cmd]}") == want


@pytest.mark.parametrize("cmd", CMDS)
def test_restricted_records(outs, cmd):
    """Records inside the chr2 restriction, on chr2 alone."""
    got = records(f"{outs(cmd, 'chrom')[1]}/{VCF[cmd]}")
    assert got and {r[0] for r in got} == {"chr2"}
