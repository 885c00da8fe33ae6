"""Large-indel (SVLEN ≥ 30) calling from haplotype-resolved contigs.

The end-to-end per-chromosome path of the reference's
volcanosv-vc-large-indel.py + Raw_variant_call.py +
extract_contig_signature_*.py + FP_filter_v1.py + remove_redundancy.py:

  contig alignments → per-hap signature extraction → hp1×hp2 pairing → GT
  → ALT/REF sequence attach → reads-signature FP filter → redundancy
  removal → phased VCF (GT 0/1 → h|h' via TIG_REGION hp tag, PS from the
  PS<pb>_ contig-name prefix; volcanosv-vc-large-indel.py phase_vcf
  :202-231).
"""
from __future__ import annotations

import numpy as np

from ..config import PipelineConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..io.bam import BamRecord
from ..io.vcf import VcfRecord
from ..ops.pack import revcomp_seq
from ..utils.logging import get_logger
from .gt_correction import correct_genotypes, coverage_filter
from .pairing import PairedCall, pair_haplotype_sigs
from .redundancy import find_redundant
from .reads_sig import (extract_gt_read_sigs, extract_reads_signatures,
                        support_counts)
from .signatures import Signature, extract_contig_signatures

log = get_logger("large_indel")


def _ins_alt_seq(sig: Signature, contig_seqs: dict[str, str]) -> str | None:
    """Inserted sequence from the contig, strand-aware.

    ref add_seq_to_sig (extract_contig_signature_Hifi.py:655-676):
    '-' strand slices contig[-q_end:-q_start] reverse-complemented."""
    seq = contig_seqs.get(sig.qname)
    if seq is None:
        return None
    if sig.strand == "-":
        lo, hi = len(seq) - sig.q_end, len(seq) - sig.q_start
        if lo < 0 or hi > len(seq) or lo >= hi:
            return None
        return revcomp_seq(seq[lo:hi])
    if sig.q_end > len(seq) or sig.q_start < 0 or sig.q_start >= sig.q_end:
        return None
    return seq[sig.q_start:sig.q_end]


def calls_to_vcf_records(
    calls: list[PairedCall], chrom: str, ref_seq: str,
    contig_seqs: dict[str, str],
) -> list[VcfRecord]:
    """Genotyped calls → VCF records anchored at the preceding base
    (ref write_vcf, extract_contig_signature_Hifi.py:678-714)."""
    out: list[VcfRecord] = []
    ins_cnt = del_cnt = 0
    for c in calls:
        s = c.sig
        pos0 = s.pos - 1          # anchor base, 0-based
        if pos0 < 0 or pos0 >= len(ref_seq):
            continue
        anchor = ref_seq[pos0].upper()
        if s.svtype == "DEL":
            if s.pos + s.svlen > len(ref_seq):
                continue
            ref_allele = (anchor + ref_seq[s.pos : s.pos + s.svlen]).upper()
            alt_allele = anchor
            del_cnt += 1
            idx = del_cnt
            svlen = -s.svlen
        else:
            ins_seq = _ins_alt_seq(s, contig_seqs)
            if ins_seq is None:
                continue
            ref_allele = anchor
            alt_allele = (anchor + ins_seq).upper()
            ins_cnt += 1
            idx = ins_cnt
            svlen = len(alt_allele) - 1
        info = {
            "SVLEN": svlen, "SVTYPE": s.svtype, "TIG_REGION": c.tig_region,
            "QUERY_STRAND": c.strand, "SIG_SOURCE": c.source,
            "TIG_MAPQ": c.mapq,
        }
        out.append(VcfRecord(
            chrom=chrom, pos=s.pos, id=f"volcano.{chrom}.{s.svtype}.{idx}",
            ref=ref_allele, alt=alt_allele, qual="20", filter="PASS",
            info=info, gt=c.gt))
    return out


def fp_filter_records(records: list[VcfRecord],
                      reads_sigs: list[Signature],
                      cfg: PipelineConfig) -> list[VcfRecord]:
    """Drop calls with zero supporting read signatures (auto-pass > 250bp).

    ref FP_filter_v1.py eval_sig/filter_vcf (:106-147)."""
    if not records:
        return records
    fcfg = cfg.fp_filter
    pos = np.array([r.pos for r in records], np.int64)
    ln = np.array([r.svlen for r in records], np.int64)
    spos = np.array([s.pos for s in reads_sigs], np.int64)
    slen = np.array([s.svlen for s in reads_sigs], np.int64)
    auto = ln > fcfg.auto_pass_svlen
    sup = support_counts(pos, ln, spos, slen, fcfg)
    keep = auto | (sup >= fcfg.min_support)
    n_drop = int((~keep).sum())
    if n_drop:
        log.info("FP filter dropped %d/%d calls", n_drop, len(records))
    return [r for r, k in zip(records, keep) if k]


def remove_redundancy_records(records: list[VcfRecord],
                              cfg: PipelineConfig,
                              device=DEFAULT_DEVICE) -> list[VcfRecord]:
    """Dedup overlapping-contig calls; annotate CollapseId on survivors
    of multi-member components (ref remove_redundancy.py write_vcf)."""
    device = resolve_device(device)
    if not records:
        return records
    pos = np.array([r.pos for r in records], np.int64)
    svlen = np.array([r.svlen for r in records], np.int64)
    is_del = np.array([r.svtype == "DEL" for r in records])
    alts = [r.alt for r in records]
    keep, cid = find_redundant(pos, svlen, is_del, alts, cfg.redundancy,
                               device=device)
    out = []
    for i, r in enumerate(records):
        if not keep[i]:
            continue
        if cid[i] >= 0:
            r.info["CollapseId"] = ("DEL" if is_del[i] else "INS") + str(int(cid[i]))
        out.append(r)
    if len(out) != len(records):
        log.info("redundancy removed %d/%d calls", len(records) - len(out),
                 len(records))
    return out


def phase_records(records: list[VcfRecord]) -> list[VcfRecord]:
    """GT 0/1 → 1|0 / 0|1 by the hp tag of the first TIG_REGION contig;
    PS = the PS<pb> prefix of the contig name (phase_vcf :202-231)."""
    for r in records:
        region = str(r.info.get("TIG_REGION", ""))
        first = region.split(",")[0]
        ps = first.split("_")[0][2:] if first.startswith("PS") else None
        if r.gt == "0/1":
            r.gt = "1|0" if "hp1" in first else "0|1"
        elif r.gt == "1/1":
            r.gt = "1|1"
        if ps is not None:
            try:
                r.info["PS"] = int(ps)
            except ValueError:
                pass
    return records


def call_chromosome_raw(
    chrom: str,
    contig_records: list[BamRecord],
    ref_seq: str,
    contig_seqs: dict[str, str],
    cfg: PipelineConfig,
    reads_records: list[BamRecord] | None = None,
    reads_sigs: list[Signature] | None = None,
    include_bed: list[tuple[int, int]] | None = None,
    device=DEFAULT_DEVICE,
) -> tuple[list[VcfRecord], list[Signature] | None]:
    """Per-chromosome raw calling up to redundancy removal (the
    Raw_variant_call.py stage).  Returns (records, gt_sigs) where gt_sigs
    is the merged cuteSV-style read-signature stream feeding the
    filter_GT_correction.py chain (None without reads).  include_bed
    restricts the GT-signature task grid (sig_extract -include_bed);
    `device` is the torch device the redundancy edit distances run on."""
    device = resolve_device(device)
    sig_hp1 = extract_contig_signatures(contig_records, chrom, "hp1",
                                        cfg.signature)
    sig_hp2 = extract_contig_signatures(contig_records, chrom, "hp2",
                                        cfg.signature)
    log.info("%s: %d hp1 sigs, %d hp2 sigs", chrom, len(sig_hp1), len(sig_hp2))
    calls = pair_haplotype_sigs(sig_hp1, sig_hp2, cfg.signature)
    records = calls_to_vcf_records(calls, chrom, ref_seq, contig_seqs)
    if reads_sigs is None and reads_records is not None:
        reads_sigs = extract_reads_signatures(reads_records, chrom,
                                              cfg.fp_filter)
    if reads_sigs is not None:
        records = fp_filter_records(records, reads_sigs, cfg)
    records = remove_redundancy_records(records, cfg, device=device)
    gt_sigs = None
    if reads_records is not None:
        gt_sigs = extract_gt_read_sigs(reads_records, chrom,
                                       cfg.gt_correction,
                                       include_bed=include_bed)
    elif reads_sigs is not None:
        gt_sigs = reads_sigs       # pre-computed -rdsig fallback (unmerged)
    return records, gt_sigs


def finalize_chromosome(
    records: list[VcfRecord],
    gt_sigs: list[Signature] | None,
    reads_records: list[BamRecord] | None,
    cfg: PipelineConfig,
    cov_medians: dict[str, float] | None = None,
    read_hp: dict[str, int] | None = None,
) -> list[VcfRecord]:
    """The filter_GT_correction.py chain + phasing for one chromosome's raw
    records.  cov_medians carries the WGS-global per-svtype rel_cov median
    (filter_vcf_by_sig_cov_insdel.py:38-55 computes it over the
    concatenated all-chromosome set) — see parallel.wgs.wgs_global_median.
    read_hp (read name → haplotype 1|2, the longshot-equivalent HP map)
    enables the phase-aware 1/1→het downgrade on one-sided carriers."""
    if gt_sigs is not None and reads_records is not None:
        records = coverage_filter(records, gt_sigs, cfg.cov_filter,
                                  medians=cov_medians)
        # depth counts PRIMARY alignments only: a split read's
        # supplementary segments or a secondary hit would double-count one
        # molecule (check_full_cover_reads iterates fetch() once per read,
        # correct_gt_del_real_data.py:149-170)
        prim = [r for r in reads_records
                if not (r.is_unmapped or r.is_secondary
                        or r.is_supplementary)]
        rs = np.array([r.pos for r in prim], np.int64)
        re_ = np.array([r.reference_end for r in prim], np.int64)
        records = correct_genotypes(records, gt_sigs, rs, re_,
                                    cfg.gt_correction)
        if read_hp:
            from .gt_correction import phase_aware_gt
            records = phase_aware_gt(records, gt_sigs, read_hp,
                                     cfg.gt_correction,
                                     read_names=[r.name for r in prim],
                                     read_start=rs, read_end=re_)
    return phase_records(records)


def call_chromosome(
    chrom: str,
    contig_records: list[BamRecord],
    ref_seq: str,
    contig_seqs: dict[str, str],
    cfg: PipelineConfig,
    reads_records: list[BamRecord] | None = None,
    reads_sigs: list[Signature] | None = None,
    device=DEFAULT_DEVICE,
) -> list[VcfRecord]:
    """Full large-indel calling for one chromosome (single-chrom mode:
    the coverage-filter median is this chromosome's own call set)."""
    device = resolve_device(device)
    records, gt_sigs = call_chromosome_raw(
        chrom, contig_records, ref_seq, contig_seqs, cfg,
        reads_records=reads_records, reads_sigs=reads_sigs, device=device)
    return finalize_chromosome(records, gt_sigs, reads_records, cfg)
