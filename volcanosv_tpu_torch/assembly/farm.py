"""Per-haplotype assembly farm — batched across ALL phase-block haplotypes.

ref: General_Assembly_Workflow.py run_assembly/run_assembly_one_folder —
joblib fan-out of one assembler process per phase-block haplotype, contig
renaming to <hap_name>_<n> (reformat_fasta :37-45), resumable via
log.txt/fail_log.txt skip lists (:530-547), final concat (:565-566).

Batched (SURVEY.md §2.3 'pad/bucket phase blocks, vmap over blocks'):
instead of one assembler invocation per hap group, the farm runs

  1. ONE shared minimizer index + chain pass over the pooled reads of
     every group (anchors masked to stay within a group),
  2. per-group greedy layout on host (graphs are tiny),
  3. ONE polish aligner launch per consensus round for ALL groups' drafts
     (reads vote only on their own group's drafts),

so device launches per chromosome are O(polish_rounds), not O(groups).
Failures (empty assemblies / per-group exceptions) are recorded and
tolerated, like the reference's fail_log."""
from __future__ import annotations

import numpy as np

from ..config import AlignConfig, AssemblyConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..utils.logging import get_logger, stage_timer
from .olc import (_dedup_reads, _find_overlaps, _Overlap, layout_block,
                  polish_grouped)

log = get_logger("assembly_farm")


def run_assembly(groups: dict[str, list[str]], cfg: AssemblyConfig,
                 weights: dict[str, list[float]] | None = None,
                 device=DEFAULT_DEVICE,
                 ) -> tuple[dict[str, str], list[str]]:
    """groups: hap_name → read seqs.  Returns (contigs {name: seq},
    failed hap names).  Contig naming: <hap_name>_<n>.

    weights: per-read phase-confidence vote weights aligned with each
    group's seq list (pipeline.asm passes 1.0 for phased/single-assigned
    reads, <1 for double-assigned ones — those may be the OTHER
    haplotype, so they must not outvote phased reads in consensus).

    The overlap pass and the polish stage run on `device`."""
    device = resolve_device(device)
    names = sorted(groups)
    if not names:
        return {}, []
    reads_by_gi: dict[int, list[str]] = {}
    weights_by_gi: dict[int, list[float]] = {}
    pool: list[str] = []
    group_of: list[int] = []
    offsets: list[int] = []
    for gi, name in enumerate(names):
        seqs = groups[name]
        wts = (weights or {}).get(name)
        if wts is None or len(wts) != len(seqs):
            wts = [1.0] * len(seqs)
        if cfg.dedup_reads:
            seen: dict[str, int] = {}
            ds, dw = [], []
            for s, w in zip(seqs, wts):
                if s in seen:
                    continue
                seen[s] = 1
                ds.append(s)
                dw.append(w)
            seqs, wts = ds, dw
        reads_by_gi[gi] = seqs
        weights_by_gi[gi] = wts
        offsets.append(len(pool))
        pool.extend(seqs)
        group_of.extend([gi] * len(seqs))

    with stage_timer("farm_overlap", log):
        overlaps = _find_overlaps(pool, cfg, AlignConfig.preset("ava"),
                                  group_of=np.asarray(group_of, np.int64),
                                  device=device) \
            if len(pool) > 1 else []
    ov_by_gi: dict[int, list[_Overlap]] = {}
    for ov in overlaps:
        gi = group_of[ov.a]
        off = offsets[gi]
        ov_by_gi.setdefault(gi, []).append(
            _Overlap(ov.a - off, ov.b - off, ov.a_start, ov.a_end,
                     ov.b_start, ov.b_end, ov.strand, ov.score))

    drafts_by_gi: dict[int, list[str]] = {}
    failed: list[str] = []
    for gi, name in enumerate(names):
        seqs = reads_by_gi[gi]
        if len(seqs) < max(cfg.min_reads, 1):
            failed.append(name)
            continue
        if len(seqs) == 1:
            drafts_by_gi[gi] = [seqs[0]]
            continue
        try:
            drafts = layout_block(seqs, ov_by_gi.get(gi, []), cfg)
        except Exception as e:            # tolerate per-hap failure
            log.warning("assembly failed for %s: %s", name, e)
            failed.append(name)
            continue
        if not drafts:
            failed.append(name)
            continue
        drafts_by_gi[gi] = drafts

    if cfg.consensus_rounds > 0:
        with stage_timer("farm_polish", log):
            drafts_by_gi, votes = polish_grouped(
                drafts_by_gi, reads_by_gi, AlignConfig.preset("polish"),
                rounds=cfg.consensus_rounds,
                weights_by_group=weights_by_gi, device=device)
        # drop leak-artifact fragment drafts: a draft of a multi-draft,
        # polished group attracting less than min_draft_reads of WEIGHTED
        # primary votes (double-assigned reads count 0.25) is built from
        # stray reads of the OTHER haplotype
        for gi, ds in list(drafts_by_gi.items()):
            v = votes.get(gi) or []
            if len(ds) < 2 or len(v) != len(ds):
                continue
            kept = [(d, n) for d, n in zip(ds, v)
                    if n[0] >= cfg.min_draft_reads]
            if kept and len(kept) < len(ds):
                log.info("dropped %d low-evidence draft(s) in %s",
                         len(ds) - len(kept), names[gi])
                drafts_by_gi[gi] = [d for d, _ in kept]
                votes[gi] = [n for _, n in kept]
        # containment dedup: a draft CONTAINED in a longer draft of the
        # same group AND supported mostly by double-assigned reads
        # (weighted << raw votes) is an other-haplotype leak duplicating a
        # covered span.  A contained fragment of PHASED reads is the
        # opposite — the true local allele the layout walked around — and
        # must stay; coverage-gap fragments don't overlap at all.
        for gi, ds in list(drafts_by_gi.items()):
            if len(ds) < 2:
                continue
            v = votes.get(gi)
            if not v or len(v) != len(ds):
                continue
            ovs = _find_overlaps(ds, cfg, AlignConfig.preset("ava"),
                                 device=device)
            drop = [False] * len(ds)

            def ambiguous(i: int) -> bool:
                w, raw = v[i]
                return raw > 0 and w < 0.5 * raw

            for ov in ovs:
                la, lb = len(ds[ov.a]), len(ds[ov.b])
                if (ov.a_end - ov.a_start) >= 0.8 * la and lb > la \
                        and v[ov.b][0] >= v[ov.a][0] and ambiguous(ov.a):
                    drop[ov.a] = True
                if (ov.b_end - ov.b_start) >= 0.8 * lb and la > lb \
                        and v[ov.a][0] >= v[ov.b][0] and ambiguous(ov.b):
                    drop[ov.b] = True
            if any(drop) and not all(drop):
                log.info("dropped %d contained leak draft(s) in %s",
                         sum(drop), names[gi])
                drafts_by_gi[gi] = [d for d, x in zip(ds, drop) if not x]
                votes[gi] = [n for n, x in zip(v, drop) if not x]

    contigs: dict[str, str] = {}
    for gi, name in enumerate(names):
        ds = drafts_by_gi.get(gi)
        if not ds:
            continue
        for n, seq in enumerate(sorted(ds, key=len, reverse=True)):
            contigs[f"{name}_{n}"] = seq
    log.info("assembled %d contigs from %d hap groups (%d failed)",
             len(contigs), len(groups), len(failed))
    return contigs, failed
