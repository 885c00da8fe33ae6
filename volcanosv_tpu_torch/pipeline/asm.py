"""volcanosv-asm equivalent: phase → partition → assemble one chromosome.

ref driver: volcanosv-asm.py — longshot phasing (:75-80), k-mer partition
(:87-95), per-hap FASTQ write (:110-113), assembly farm (:117-121).  Here
the stages hand dense arrays to each other in memory instead of
pickles/FASTQs through a directory tree.  Every device stage (the pair-HMM
realignment, the MEC votes, the k-mer partition and the assembly's DP)
runs on the caller's torch device.
"""
from __future__ import annotations

import numpy as np

from ..config import PipelineConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..io.bam import BamRecord
from ..partition import PartitionResult, partition_reads
from ..phasing import PhaseResult, phase_chromosome, pileup_chromosome
from ..utils.logging import get_logger, stage_timer

log = get_logger("asm")


def assemble_chromosome(
    records: list[BamRecord],
    ref_codes: np.ndarray,
    read_seqs: dict[str, str],
    cfg: PipelineConfig,
    hybrid_bed: list[tuple[int, int]] | None = None,
    device=DEFAULT_DEVICE,
) -> tuple[dict[str, str], PhaseResult, PartitionResult]:
    """records: read alignments on one chromosome (primary, with seq).
    read_seqs: read name → full-length sequence (original orientation).
    Returns (contigs {PS…_hp…_n: seq}, phase result, partition result).

    hybrid_bed: optional interval list on this chromosome; phase blocks
    overlapping an interval are assembled with the duplicate-aware "in-BED"
    profile, the rest with the default — the reference's two-assembler
    hybrid mode (volcanosv-asm_hybrid.py:118-124) collapsed onto per-region
    assembly profiles of the single native assembler."""
    device = resolve_device(device)
    with stage_timer("pileup", log):
        pile = pileup_chromosome(records, ref_codes, cfg.phasing,
                                 device=device)
    with stage_timer("phase", log):
        ph = phase_chromosome(pile, cfg.phasing, device=device)
    blocks = ph.blocks()
    log.info("phased %d het SNPs into %d blocks (MEC %d)",
             len(ph.snp_pos), len(blocks), ph.mec)

    # read intervals from primary alignments
    intervals: dict[str, tuple[int, int]] = {}
    for r in records:
        if r.is_unmapped or r.is_secondary or r.is_supplementary:
            continue
        iv = intervals.get(r.name)
        s, e = r.pos, r.reference_end
        if iv is None:
            intervals[r.name] = (s, e)
        else:
            intervals[r.name] = (min(iv[0], s), max(iv[1], e))

    name_to_idx = {n: i for i, n in enumerate(ph.read_names)}
    phased: dict[str, tuple[int, int]] = {}
    unphased: dict[str, tuple[str, tuple[int, int]]] = {}
    for name, iv in intervals.items():
        seq = read_seqs.get(name)
        if not seq:
            continue
        i = name_to_idx.get(name)
        if i is not None and ph.read_hap[i] != 0 and ph.read_block[i] >= 0:
            phased[name] = (int(ph.read_hap[i]), int(ph.read_block[i]))
        else:
            unphased[name] = (seq, iv)

    if not blocks:
        # no het SNPs → single unphased block spanning the chromosome
        from ..partition import hap_name
        L = len(ref_codes)
        hn = hap_name(1, 1, L, 1)
        part = PartitionResult(
            {name: [hn] for name in intervals if name in read_seqs},
            [(1, 0, L - 1)])
    else:
        with stage_timer("partition", log):
            part = partition_reads(phased, unphased, read_seqs, blocks,
                                   cfg.partition, device=device)

    groups: dict[str, list[str]] = {}
    weights: dict[str, list[float]] = {}
    for rname, haps in part.assignment.items():
        seq = read_seqs.get(rname)
        if not seq:
            continue
        # phase-confidence vote weight: a double-assigned read may belong
        # to the OTHER haplotype — it still provides layout connectivity
        # but must not outvote phased reads at a het variant
        w = 1.0 if len(haps) == 1 else 0.25
        for h in haps:
            groups.setdefault(h, []).append(seq)
            weights.setdefault(h, []).append(w)

    from ..assembly import run_assembly
    with stage_timer("assembly", log):
        if hybrid_bed:
            import dataclasses

            def in_bed(hap: str) -> bool:
                # PS<pb>_<start>_<end>_hp<h> — 1-based block span
                f = hap.split("_")
                s0, e0 = int(f[1]) - 1, int(f[2])
                return any(s0 < e and b < e0 for b, e in hybrid_bed)

            in_groups = {h: g for h, g in groups.items() if in_bed(h)}
            out_groups = {h: g for h, g in groups.items() if h not in in_groups}
            in_cfg = dataclasses.replace(
                cfg.assembly, dedup_reads=True,
                consensus_rounds=cfg.assembly.consensus_rounds + 1)
            c1, f1 = run_assembly(in_groups, in_cfg, weights=weights,
                                  device=device)
            c2, f2 = run_assembly(out_groups, cfg.assembly, weights=weights,
                                  device=device)
            contigs, failed = {**c1, **c2}, f1 + f2
        else:
            contigs, failed = run_assembly(groups, cfg.assembly,
                                           weights=weights, device=device)
    return contigs, ph, part
