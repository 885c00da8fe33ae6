"""Phased SNP VCF emission.

The reference's SNP output IS longshot's phased VCF (README.md:237-238;
volcanosv-asm.py reformats it at :54-56, injecting PS= from the sample
column and writing {out_dir}/phased_vcf).  Here the PhaseResult already
carries the het sites with their phase and phase-set id plus the hom-alt
sites, so emission is a direct transform.
"""
from __future__ import annotations

import numpy as np

from ..io.vcf import VcfRecord
from ..ops.pack import decode_codes
from .phase import PhaseResult


def snp_vcf_records(chrom: str, ph: PhaseResult) -> list[VcfRecord]:
    """Het sites as phased GT (0|1 / 1|0) with PS, hom-alt sites as 1/1.

    Phase convention (phase.py): phase=+1 → hap1 carries REF → GT 0|1."""
    recs: list[VcfRecord] = []
    ref_b = decode_codes(np.asarray(ph.ref_base)) if len(ph.snp_pos) else ""
    alt_b = decode_codes(np.asarray(ph.alt_base)) if len(ph.snp_pos) else ""
    for i in range(len(ph.snp_pos)):
        if ph.marker is not None and len(ph.marker) and ph.marker[i]:
            continue          # SV phasing marker — not a SNP (pileup.py)
        gt = "0|1" if ph.phase[i] > 0 else "1|0"
        recs.append(VcfRecord(
            chrom=chrom, pos=int(ph.snp_pos[i]) + 1,
            id=f"{chrom}-SNP-{i}", ref=ref_b[i], alt=alt_b[i],
            gt=gt, ps=int(ph.block_id[i])))
    hom_r = decode_codes(np.asarray(ph.hom_ref)) if len(ph.hom_pos) else ""
    hom_a = decode_codes(np.asarray(ph.hom_alt)) if len(ph.hom_pos) else ""
    for i in range(len(ph.hom_pos)):
        recs.append(VcfRecord(
            chrom=chrom, pos=int(ph.hom_pos[i]) + 1,
            id=f"{chrom}-SNPHOM-{i}", ref=hom_r[i], alt=hom_a[i], gt="1/1"))
    recs.sort(key=lambda r: r.pos)
    return recs
