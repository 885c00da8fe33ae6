"""The benchmark's job generator: the port's `sim` recipe and writers, frozen.

`simulate` draws from the seed in the order of `cmd_sim` in
volcanosv_tpu_torch/cli.py at commit 656570a, and `write_sim` writes the
files that command writes, byte for byte (ref.fa, reads.fastq, truth.vcf,
truth_snps.vcf, true_contigs.fa, and repeats.bed when the reference has
repeats).  The FASTA, FASTQ and VCF writers are plain copies of the port's
`io/fasta.py::write_fasta`, `io/fastq.py::write_fastq` and
`io/vcf.py::make_header` / `write_vcf` / `VcfRecord.to_line` at the same
commit.  Nothing here imports the program.

`make_job` is what the benchmark's set-up runs, one process a job: the
cell's chromosomes (`chroms`, one unless the traffic says) of its length
from (seed, index), their reference and reads (and, for a cell that brings
its own assembly, its contigs) written under the job's directory, and the
truth handed back for the judge.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, fields

import numpy as np

from . import sim


@dataclass
class SimParams:
    """The arguments of the port's `sim` subcommand, with its defaults.  The
    port implants each count on every chromosome; here a count may also be
    a list, one count a chromosome."""
    length: int = 80_000
    chroms: int = 1
    n_del: int | list[int] = 4
    n_ins: int | list[int] = 4
    n_inv: int | list[int] = 0
    n_dup: int | list[int] = 0
    n_tra: int = 0
    n_clustered: int = 0
    n_nested: int = 0
    n_small: int | list[int] = 0
    n_tandem: int = 0
    n_segdup: int = 0
    n_homopoly: int = 0
    min_len: int = 60
    max_len: int = 400
    snp_rate: float = 1 / 1500
    coverage: float = 24.0
    read_len: int = 8_000
    err: float = 0.001

    @classmethod
    def from_dict(cls, d: dict) -> "SimParams":
        names = {f.name for f in fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown sim parameters: {sorted(unknown)}")
        return cls(**d)


@dataclass
class Sim:
    ref: dict
    feats: dict | None
    hap1: dict
    hap2: dict
    truth: list
    truth_snps: list
    reads: list


def _implant_svs(rng, ref: dict, p: SimParams):
    """`sim.implant_svs` a chromosome at a time, with that chromosome's
    counts.  It draws for each chromosome in turn from the one generator,
    so with the same count on every chromosome this is its one call."""
    def of(n, k):
        return n[k] if isinstance(n, list) else n
    hap1, hap2, truth = {}, {}, []
    for k, (chrom, seq) in enumerate(ref.items()):
        h1, h2, t = sim.implant_svs(
            rng, {chrom: seq}, n_del=of(p.n_del, k), n_ins=of(p.n_ins, k),
            n_inv=of(p.n_inv, k), n_dup=of(p.n_dup, k), min_len=p.min_len,
            max_len=p.max_len, n_clustered=p.n_clustered,
            n_nested=p.n_nested, n_small=of(p.n_small, k))
        hap1.update(h1)
        hap2.update(h2)
        truth += t
    return hap1, hap2, truth


def simulate(p: SimParams, seed) -> Sim:
    """The port's `sim` draws, in its order, from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    ref = sim.random_genome(rng, p.length, n_chroms=p.chroms)
    feats = None
    if p.n_tandem or p.n_segdup or p.n_homopoly:
        ref, feats = sim.implant_repeats(
            rng, ref, n_tandem=p.n_tandem, n_segdup=p.n_segdup,
            n_homopoly=p.n_homopoly)
    hap1, hap2, truth = _implant_svs(rng, ref, p)
    hap1, hap2, truth_snps = sim.implant_snps_ref(
        rng, ref, hap1, hap2, truth, rate=p.snp_rate)
    if p.n_tra:
        if p.chroms < 2:
            raise ValueError("n_tra needs chroms >= 2")
        truth += sim.implant_tra(rng, ref, hap1, hap2, truth)
    reads = sim.simulate_reads(
        rng, {1: hap1, 2: hap2}, coverage=p.coverage, read_len=p.read_len,
        sub_rate=p.err, indel_rate=p.err / 2)
    return Sim(ref, feats, hap1, hap2, truth, truth_snps, reads)


# --- writers (copies of the port's io/ writers) ---------------------------

def write_fasta(path: str, seqs: dict, width: int = 80) -> None:
    with open(path, "w") as fh:
        for name, seq in seqs.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")


def write_fastq(path: str, records) -> int:
    n = 0
    with open(path, "w") as fh:
        for name, seq, qual in records:
            if qual is None:
                qual = "!" * len(seq)
            fh.write(f"@{name}\n{seq}\n+\n{qual}\n")
            n += 1
    return n


STANDARD_INFO = [
    '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">',
    '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Length of structural variant">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End position of structural variant">',
    '##INFO=<ID=TIG_REGION,Number=1,Type=String,Description="Contig region of variant">',
    '##INFO=<ID=QUERY_STRAND,Number=1,Type=String,Description="Contig strand">',
    '##INFO=<ID=SIG_SOURCE,Number=1,Type=String,Description="Signature source: CIGAR/SPLIT">',
    '##INFO=<ID=TIG_MAPQ,Number=1,Type=Integer,Description="Contig alignment MAPQ">',
    '##INFO=<ID=CollapseId,Number=1,Type=String,Description="Redundancy component id">',
    '##INFO=<ID=CONTEXT,Number=1,Type=String,Description="Context sequence window">',
    '##INFO=<ID=READS,Number=.,Type=String,Description="Supporting contig names">',
    '##INFO=<ID=SUPPORT,Number=1,Type=Integer,Description="Read signature support">',
    '##INFO=<ID=CHR2,Number=1,Type=String,Description="Mate chromosome for BND">',
]
STANDARD_FORMAT = [
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase set">',
]


def vcf_header(contigs: dict) -> list[str]:
    lines = ["##fileformat=VCFv4.2", "##source=volcanosv_tpu"]
    lines += STANDARD_INFO + STANDARD_FORMAT
    for name, length in contigs.items():
        lines.append(f"##contig=<ID={name},length={length}>")
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSample")
    return lines


def vcf_line(chrom, pos, vid, ref, alt, info: dict, gt: str) -> str:
    inf = ";".join(f"{k}={v}" for k, v in info.items()) if info else "."
    return "\t".join([chrom, str(pos), vid, ref, alt, ".", "PASS", inf,
                      "GT", gt])


def write_vcf(path: str, header: list[str], rows: list[tuple]) -> None:
    """rows: (chrom, pos, line); sorted by (chrom, pos), stably."""
    rows = sorted(rows, key=lambda r: (r[0], r[1]))
    with open(path, "w") as fh:
        for h in header:
            fh.write(h + "\n")
        for _c, _p, line in rows:
            fh.write(line + "\n")


def _gt(t) -> str:
    return "1|1" if t.gt == (1, 1) else ("1|0" if t.gt[0] else "0|1")


def write_sim(s: Sim, out_dir: str) -> None:
    """The files of the port's `sim` subcommand."""
    os.makedirs(out_dir, exist_ok=True)
    if s.feats is not None:
        with open(os.path.join(out_dir, "repeats.bed"), "w") as fh:
            for c, fs in s.feats.items():
                for kind, st, en in fs:
                    fh.write(f"{c}\t{st}\t{en}\t{kind}\n")
    write_fasta(os.path.join(out_dir, "ref.fa"), s.ref)
    write_fastq(os.path.join(out_dir, "reads.fastq"),
                ((n, q, None) for n, q, *_ in s.reads))
    rows = []
    for i, t in enumerate(s.truth):
        if t.svtype == "BND":
            line = vcf_line(t.chrom, t.pos + 1, f"truth-{i}", "N",
                            f"N[{t.chrom2}:{t.pos2 + 1}[",
                            {"SVTYPE": "BND", "CHR2": t.chrom2,
                             "END": t.pos2 + 1}, _gt(t))
        else:
            line = vcf_line(t.chrom, t.pos + 1, f"truth-{i}", "N",
                            f"<{t.svtype}>",
                            {"SVTYPE": t.svtype, "SVLEN": t.svlen,
                             "END": t.pos + 1 + t.svlen}, _gt(t))
        rows.append((t.chrom, t.pos + 1, line))
    header = vcf_header({c: len(q) for c, q in s.ref.items()})
    write_vcf(os.path.join(out_dir, "truth.vcf"), header, rows)
    order = {c: i for i, c in enumerate(s.ref)}
    snp_rows = [(n.chrom, n.pos + 1, vcf_line(
        n.chrom, n.pos + 1, f"tsnp-{i}", n.ref, n.alt, {},
        "1/1" if n.hap == 0 else ("1|0" if n.hap == 1 else "0|1")))
        for i, n in enumerate(s.truth_snps)]
    snp_rows.sort(key=lambda r: (order[r[0]], r[1]))
    write_vcf(os.path.join(out_dir, "truth_snps.vcf"), header, snp_rows)
    write_fasta(os.path.join(out_dir, "true_contigs.fa"),
                sim.contigs_from_haplotypes(s.hap1, s.hap2))


# --- the benchmark's jobs -------------------------------------------------

def _share(per_bp: float, length: int, index: int) -> int:
    """Job `index`'s share of a density: the count that jobs 0..index hold
    together, rounded, less what jobs 0..index-1 hold.  It depends on the
    index alone, so every seed gets the same counts at the same index."""
    return (int(per_bp * length * (index + 1) + 0.5)
            - int(per_bp * length * index + 0.5))


def job_params(config: dict, traffic: dict, index: int) -> SimParams:
    """Job `index`'s sim arguments: the configuration's reads and variant
    densities over the job's `chroms` chromosomes (traffic key, default 1)
    of the cell's length, and the cell's repeats (each count on every
    chromosome).  Chromosome c of job i is the (i * chroms + c)-th of the
    cell's chromosomes and takes that one's share, so that a job holds the
    share of its whole length, chroms x job_length; one chromosome keeps
    plain counts."""
    reads, var = config["reads"], config["variants"]
    length = int(traffic["job_length"])
    chroms = int(traffic.get("chroms", 1))
    sv = var["sv_per_mb"]
    lo, hi = var["small_indel_len"]
    if (lo, hi) != (2, 29):
        raise ValueError("the generator draws small indels of 2-29 bp only")

    def share(per_mb: float):
        n = [_share(per_mb / 1e6, length, index * chroms + c)
             for c in range(chroms)]
        return n[0] if chroms == 1 else n
    return SimParams.from_dict(dict(
        length=length, chroms=chroms,
        coverage=reads["coverage"], read_len=reads["read_len"],
        err=reads["err"], snp_rate=var["snp_per_kb"] / 1e3,
        min_len=var["sv_len"][0], max_len=var["sv_len"][1],
        n_del=share(sv["DEL"]), n_ins=share(sv["INS"]),
        n_inv=share(sv["INV"]), n_dup=share(sv["DUP"]),
        n_small=share(var["small_indel_per_mb"]),
        **traffic.get("repeats", {})))


def job_seed(seed: int, index: int) -> list[int]:
    """The job's entropy: the run's seed (any size) and the job's index."""
    return [int(seed) & (2 ** 64 - 1), int(seed) >> 64, int(index)]


def make_job(config: dict, traffic: dict, seed: int, index: int,
             job_dir: str) -> dict:
    """Write one job's inputs under job_dir; return its truth for the judge:
    the reference, both haplotypes, the implanted SVs and SNPs (the
    generator's own objects, as plain tuples)."""
    p = job_params(config, traffic, index)
    s = simulate(p, job_seed(seed, index))
    os.makedirs(job_dir, exist_ok=True)
    write_fasta(os.path.join(job_dir, "ref.fa"), s.ref)
    write_fastq(os.path.join(job_dir, "reads.fastq"),
                ((n, q, None) for n, q, *_ in s.reads))
    if traffic.get("contigs"):
        write_fasta(os.path.join(job_dir, "contigs.fa"),
                    sim.contigs_from_haplotypes(
                        s.hap1, s.hap2, **traffic["contigs"]))
    return dict(
        dir=job_dir, index=index, ref=s.ref, hap1=s.hap1, hap2=s.hap2,
        svs=[(t.chrom, t.pos, t.svtype, t.svlen, t.gt, t.seq)
             for t in s.truth],
        snps=[(n.chrom, n.pos, n.hap, n.ref, n.alt) for n in s.truth_snps],
        n_reads=len(s.reads), read_bases=sum(len(r[1]) for r in s.reads))
