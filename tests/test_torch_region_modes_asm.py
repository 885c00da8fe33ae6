"""`asm --chrom chr2` through both CLIs on tests/torch_region_modes.py's
recipe: the contigs, the phased SNPs, the read haplotypes and phased.bam
byte-identical to the JAX package's, and only chr2 assembled."""
import os

import pytest

from torch_region_modes import SIM, both, read

OUT = ["final_contigs.fa", "phased_snps.vcf", "phased.bam",
       os.path.join("checkpoints", "read_hp_chr2.tsv")]


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    from torch_inputs import ensure_reference_native_lib
    from volcanosv_tpu.cli import main as ref_main
    ensure_reference_native_lib()
    d = str(tmp_path_factory.mktemp("region_asm"))
    assert ref_main(["sim", "-o", f"{d}/sim"] + SIM) == 0
    return both(["asm", "--ref", f"{d}/sim/ref.fa", "--fastq",
                 f"{d}/sim/reads.fastq", "--chrom", "chr2"], d, "asm")


@pytest.mark.parametrize("name", OUT)
def test_byte_identical(outs, name):
    jax, port = outs
    want = read(f"{jax}/{name}")
    assert read(f"{port}/{name}") == want and want


def test_only_chr2_assembled(outs):
    from volcanosv_tpu_torch.io.vcf import read_vcf
    _jax, port = outs
    ck = os.listdir(f"{port}/checkpoints")
    assert "asm_chr2.fa" in ck and "asm_chr1.fa" not in ck
    _h, snps = read_vcf(f"{port}/phased_snps.vcf")
    assert snps and {r.chrom for r in snps} == {"chr2"}
