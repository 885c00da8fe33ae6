"""The control: the reference put in the program's place, one precision below.

The configurations state consensus precision: every answer of a job (an SV,
an indel, a SNP with its genotype, a contig base) is called from the whole
pile of reads at the locus, both haplotypes of it.  The nearest precision
below is that of one read.  A read comes from one haplotype and carries the
read error model of the configuration, so the control answers as one read
at each locus would:

- each implanted SV, indel and SNP that is homozygous is reported, and one
  that is heterozygous is reported with probability 1/2 (the read came
  from its haplotype), always as 1/1, since one read sees one haplotype;
- the read's own errors are reported too: its 2-3 bp indel errors (the
  generator's indel errors are 1-3 bp) as small indels and its
  substitutions as SNPs;
- the contigs are the two true haplotypes, each carrying the read error
  model once.

It imports nothing of the program.  `control_outputs` writes the answers in
the files the program writes, so that the judge reads them as it reads the
program's.
"""
from __future__ import annotations

import os

import numpy as np

from ..gen import recipe, sim
from .judge import CONTIGS, MERGED, SNPS


def control_outputs(truth: dict, config: dict, seed, out_dir: str,
                    answers: list[str]) -> None:
    rng = np.random.default_rng(seed)
    sub = config["reads"]["err"]
    indel = sub / 2
    os.makedirs(out_dir, exist_ok=True)
    ref = truth["ref"]
    header = recipe.vcf_header({c: len(s) for c, s in ref.items()})

    def seen(gt) -> bool:
        return tuple(gt) == (1, 1) or rng.random() < 0.5

    if "svs" in answers:
        rows = []
        for n, (chrom, pos, svtype, svlen, gt, seq) in enumerate(
                truth["svs"]):
            if not seen(gt):
                continue
            base = ref[chrom][pos]
            if svtype == "DEL" and svlen < 30:
                alt, r = base, ref[chrom][pos:pos + 1 + svlen]
                info = {"SVTYPE": "DEL", "SVLEN": svlen}
            elif svtype == "INS":
                alt, r = base + sim.mutate_read(rng, seq, sub, 0.0), base
                info = {"SVTYPE": "INS", "SVLEN": svlen}
            else:
                alt, r = f"<{svtype}>", base
                info = {"SVTYPE": svtype, "SVLEN": svlen,
                        "END": pos + 1 + svlen}
            rows.append((chrom, pos + 1, recipe.vcf_line(
                chrom, pos + 1, f"ctl-sv-{n}", r, alt, info, "1/1")))
        for chrom, seq in ref.items():
            L = len(seq)
            for n in range(rng.poisson(indel * L)):
                ln = int(rng.integers(1, 4))
                if ln < 2:
                    continue
                p = int(rng.integers(1, L - 4))
                if rng.random() < 0.5:
                    r, alt = seq[p:p + 1 + ln], seq[p]
                    info = {"SVTYPE": "DEL", "SVLEN": ln}
                else:
                    r = seq[p]
                    alt = r + "".join(rng.choice(sim.BASES, ln))
                    info = {"SVTYPE": "INS", "SVLEN": ln}
                rows.append((chrom, p + 1, recipe.vcf_line(
                    chrom, p + 1, f"ctl-err-{n}", r, alt, info, "1/1")))
        recipe.write_vcf(os.path.join(out_dir, MERGED), header, rows)
    if "snps" in answers:
        rows = []
        for n, (chrom, pos, hap, r, a) in enumerate(truth["snps"]):
            if hap == 0 or rng.random() < 0.5:
                rows.append((chrom, pos + 1, recipe.vcf_line(
                    chrom, pos + 1, f"ctl-snp-{n}", r, a, {}, "1/1")))
        for chrom, seq in ref.items():
            L = len(seq)
            for p in rng.integers(0, L, rng.poisson(sub * L)):
                r = seq[p]
                a = str(rng.choice(sim.BASES))
                if a == r:        # the generator's substitution kept the base
                    continue
                rows.append((chrom, int(p) + 1, recipe.vcf_line(
                    chrom, int(p) + 1, f"ctl-sub-{p}", r, a, {}, "1/1")))
        recipe.write_vcf(os.path.join(out_dir, SNPS), header, rows)
    if "contigs" in answers:
        contigs = {}
        for h, haps in (("hp1", truth["hap1"]), ("hp2", truth["hap2"])):
            for chrom, seq in haps.items():
                contigs[f"{chrom}_{h}"] = sim.mutate_read(rng, seq, sub,
                                                          indel)
        recipe.write_fasta(os.path.join(out_dir, CONTIGS), contigs)
