"""Segmental-duplication recovery: QC → re-assemble collapsed blocks → swap.

Replaces the reference's optional SD loop (SURVEY.md §3.5):
Evaluate_Assembly.py (Flagger run, collapsed hap-name grep :68-69) →
General_Assembly_Workflow_SD.py (re-assemble only collapsed phase blocks)
→ Replace_Collapsed_Contigs.py (swap recovered contigs into the assembly
FASTA by hap name :10-27).  The coverage HMM and the re-assembly's DP run
on the caller's device.
"""
from __future__ import annotations

import dataclasses

from ..config import PipelineConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..io.bam import BamRecord
from ..qc import FlaggerResult, evaluate_assembly
from ..utils.logging import get_logger

log = get_logger("sd")


def hap_of_contig(contig_name: str) -> str:
    """PS<pb>_<s>_<e>_hp<h>_<n> → its hap-group name (strip trailing _<n>)."""
    return contig_name.rsplit("_", 1)[0]


def sd_recover(
    contigs: dict[str, str],
    read_groups: dict[str, list[str]],
    reads_on_contigs: list[BamRecord],
    cfg: PipelineConfig,
    device=DEFAULT_DEVICE,
) -> tuple[dict[str, str], FlaggerResult]:
    """QC the assembly; re-assemble collapsed hap groups with the SD
    profile; swap recovered contigs in.  Returns (new contigs, QC result).

    read_groups: hap-group name → read sequences (the same partition the
    original assembly consumed).  reads_on_contigs: reads aligned to the
    contigs (ref_id indexes the sorted contig-name list)."""
    from ..assembly import run_assembly
    device = resolve_device(device)
    names = list(contigs)
    qc = evaluate_assembly(contigs, reads_on_contigs, names, cfg.qc,
                           device=device)
    collapsed_haps = sorted({hap_of_contig(c) for c in qc.collapsed})
    if not collapsed_haps:
        return contigs, qc
    # SD assembly profile: duplicate-aware, extra consensus polish
    sd_cfg = dataclasses.replace(
        cfg.assembly, dedup_reads=True,
        consensus_rounds=cfg.assembly.consensus_rounds + 1)
    groups = {h: read_groups[h] for h in collapsed_haps if h in read_groups}
    missing = [h for h in collapsed_haps if h not in read_groups]
    if missing:
        log.warning("no reads for collapsed haps %s — keeping originals",
                    missing)
    recovered, failed = run_assembly(groups, sd_cfg, device=device)
    out = dict(contigs)
    n_swap = 0
    for h in groups:
        if h in failed:
            continue            # keep the original contigs for this hap
        for name in [c for c in out if hap_of_contig(c) == h]:
            del out[name]
        for name, seq in recovered.items():
            if hap_of_contig(name) == h:
                out[name] = seq
                n_swap += 1
    log.info("SD recovery: %d collapsed haps, %d contigs swapped in",
             len(collapsed_haps), n_swap)
    return out, qc
