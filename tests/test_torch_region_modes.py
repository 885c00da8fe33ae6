"""vc-large-indel's restricted and alternative entry points through both
CLIs (tests/torch_region_modes.py): `--chrom chr2`, `--bed` over chr2,
`--bed` of sub-intervals on both chromosomes (which also cuts the
GT-signature task grid, `include_bed`), `--asm other` and `--bam` with the
reads as an unaligned BAM, each byte-identical to the JAX package's VCF.
As in tests/test_cli_multichrom.py, the whole-chr2 restrictions give the
(pos, svtype, svlen) of the unrestricted caller's chr2 records; here the
unrestricted run is vc-large-indel itself, since `run`'s INS → DUP
recovery takes this recipe's chr2 INS out of its large-indel VCF.  The
small-indel and complex-SV callers are in
tests/test_torch_region_modes_callers.py, `asm --chrom` in
tests/test_torch_region_modes_asm.py."""
import pytest

from torch_region_modes import (RESTRICTIONS, VCF, both, inputs, read,
                                records, vc_args)

CMD = "vc-large-indel"
CASES = {**{k: (v, "fastq") for k, v in RESTRICTIONS.items()},
         "asm_other": (["--asm", "other"], "fastq"),
         "bam": ([], "bam")}


@pytest.fixture(scope="module")
def d(tmp_path_factory):
    return inputs(tmp_path_factory.mktemp("region_li"))


@pytest.fixture(scope="module")
def outs(d):
    """Each case's two output dirs, run when first asked for."""
    cache = {}

    def get(case):
        if case not in cache:
            extra, reads = CASES[case]
            cache[case] = both(vc_args(CMD, d, extra, reads), d, case)
        return cache[case]
    return get


@pytest.fixture(scope="module")
def unrestricted(d):
    from volcanosv_tpu.cli import main as ref_main
    out = f"{d}/full_jax"
    assert ref_main(vc_args(CMD, d, []) + ["-o", out]) == 0
    return records(f"{out}/{VCF[CMD]}")


@pytest.mark.parametrize("case", list(CASES))
def test_byte_identical(outs, case):
    jax, port = outs(case)
    want = read(f"{jax}/{VCF[CMD]}")
    assert read(f"{port}/{VCF[CMD]}") == want


@pytest.mark.parametrize("case", ["chrom", "bed_chr2"])
def test_whole_chr2_is_the_chr2_subset(outs, unrestricted, case):
    _jax, port = outs(case)
    got = records(f"{port}/{VCF[CMD]}")
    want = [r for r in unrestricted if r[0] == "chr2"]
    assert want and [r[1:] for r in got] == [r[1:] for r in want]
    assert {r[0] for r in got} == {"chr2"}


def test_restrictions_hold_records(outs, unrestricted):
    """Every restricted VCF has records, and the sub-interval BED keeps
    records of both chromosomes."""
    for case in RESTRICTIONS:
        assert records(f"{outs(case)[1]}/{VCF[CMD]}"), case
    got = records(f"{outs('bed_sub')[1]}/{VCF[CMD]}")
    assert {r[0] for r in got} == {"chr1", "chr2"}
    assert len(unrestricted) > 0
