"""Restricted and alternative entry points of the vc commands and `asm`,
through both CLIs: the body of tests/test_torch_region_modes*.py.

The recipe is tests/test_torch_run.py's (2 x 50 kb with DELs, INSs, an
INV, a DUP, a translocation and small indels, 20x HiFi), so that the
large-indel, small-indel and complex-SV callers all write records inside
a restriction.  The JAX package's `sim` and `asm` make the reads and the
contigs once (`inputs`); each case then runs one command by both packages
on them, the port with `--device cpu` on one torch thread, and the two
output files must be equal bytes.

The restrictions: `--chrom chr2` (the reference's single-chromosome
mode), `--bed` over the whole of chr2, and `--bed` of sub-intervals on both
chromosomes (for vc-large-indel also the GT-signature task grid,
`include_bed`).  Besides them: `vc-large-indel --asm other` (the imported
assembly's coverage bands) and `vc-large-indel --bam` with the reads as an
unaligned BAM."""
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from pin_repeat_run import write_reads_bam  # noqa: E402

SIM = ["--length", "50000", "--chroms", "2", "--n_del", "2", "--n_ins", "2",
       "--n_inv", "1", "--n_dup", "1", "--n_small", "4", "--n_tra", "1",
       "--min_len", "300", "--max_len", "1000", "--coverage", "20",
       "--read_len", "7000", "--seed", "3"]
BEDS = {"chr2.bed": "chr2\t0\t50000\n",
        "sub.bed": "chr1\t10000\t30000\nchr2\t5000\t30000\n"}
RESTRICTIONS = {"chrom": ["--chrom", "chr2"],
                "bed_chr2": ["--bed", "{d}/chr2.bed"],
                "bed_sub": ["--bed", "{d}/sub.bed"]}
VCF = {"vc-large-indel": "volcanosv_large_indel.vcf",
       "vc-small-indel": "volcanosv_small_indel.vcf",
       "vc-complex-sv": "volcanosv_complex_sv.vcf"}


def read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def inputs(d) -> str:
    """The JAX package's sim, its `asm` contigs, the BEDs and the reads as
    an unaligned BAM, under d; returns d as a string."""
    from torch_inputs import ensure_reference_native_lib
    from volcanosv_tpu.cli import main as ref_main
    from volcanosv_tpu.io import bam
    from volcanosv_tpu.io.fastq import read_fastq
    ensure_reference_native_lib()
    d = str(d)
    assert ref_main(["sim", "-o", f"{d}/sim"] + SIM) == 0
    assert ref_main(["asm", "--ref", f"{d}/sim/ref.fa", "--fastq",
                     f"{d}/sim/reads.fastq", "-o", f"{d}/asm"]) == 0
    for name, text in BEDS.items():
        with open(os.path.join(d, name), "w") as fh:
            fh.write(text)
    write_reads_bam(f"{d}/reads.bam", read_fastq(f"{d}/sim/reads.fastq"),
                    bam)
    return d


def vc_args(cmd: str, d: str, extra: list[str], reads: str = "fastq"):
    """`cmd` on d's contigs, with the reads as --fastq or --bam."""
    src = f"{d}/sim/reads.fastq" if reads == "fastq" else f"{d}/reads.bam"
    return [cmd, "--ref", f"{d}/sim/ref.fa", "--contig",
            f"{d}/asm/final_contigs.fa", f"--{reads}", src] \
        + [a.format(d=d) for a in extra]


def both(args: list[str], d: str, tag: str) -> tuple[str, str]:
    """`args` by the JAX package and by the port (`--device cpu`, one torch
    thread) into d/<tag>_jax and d/<tag>_port; returns the two dirs."""
    from volcanosv_tpu.cli import main as ref_main
    from volcanosv_tpu_torch.cli import main as port_main
    outs = (f"{d}/{tag}_jax", f"{d}/{tag}_port")
    assert ref_main(args + ["-o", outs[0]]) == 0
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert port_main(args + ["-o", outs[1], "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(n)
    return outs


def records(path) -> list:
    """The VCF's records as (chrom, pos, svtype, svlen)."""
    from volcanosv_tpu_torch.io.vcf import read_vcf
    _h, recs = read_vcf(str(path))
    return [(r.chrom, r.pos, r.svtype, r.svlen) for r in recs]
