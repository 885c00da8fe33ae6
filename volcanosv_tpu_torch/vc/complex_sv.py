"""Complex SV calling (INV / DUP / TRA) from haplotype contig alignments.

Replaces the reference's complex-SV chain (volcanosv-vc-complex-sv.py):
svim-asm diploid mode (SVIM_COLLECT.py segment collection, SVIM_inter.py
segment-pair typing, SVIM_COMBINE.py hap pairing) + DUP recovery from INS
calls (align_ins2ref.py:82-131) + TRA breakend clustering (filter_tra.py:
70-116) + INV merge & read-orientation support filter (filter_inv.py:57-190).

Device mapping: candidate typing, clustering and the read-orientation
scans for INV support are host passes (tiny tables).  Two stages run the
banded DP on the caller's torch device: the haplotype pairing's edit
distances (one `edit_distance_pairs` batch per call, band W = 128 at the
10-edit cut) and the DUP-recovery realignment of INS ALT sequences (a
`map-hifi` `Aligner`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import ComplexSVConfig, PipelineConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..io.bam import BamRecord
from ..io.vcf import VcfRecord
from ..ops.pack import revcomp_seq
from ..utils.logging import get_logger
from .redundancy import edit_distance_pairs

log = get_logger("complex_sv")

_M, _I, _D, _S, _H, _EQ, _X = 0, 1, 2, 4, 5, 7, 8


@dataclass
class Candidate:
    svtype: str            # INV | DUP | BND
    chrom: str
    pos: int               # 0-based
    end: int               # 0-based end (INV/DUP); for BND: mate pos
    svlen: int
    hap: int               # 1 | 2
    qname: str
    chrom2: str = ""       # BND mate chrom
    orient: str = ""       # BND bracket orientation: 'N[', 'N]', '[N', ']N'


@dataclass
class _Segment:
    """One alignment segment in original-query orientation.

    ref: svim-asm reconstructs the same table from SA tags
    (SVIM_COLLECT.py:9-54)."""
    ref_name: str
    pos: int
    ref_end: int
    strand: int            # +1 / -1
    qo_start: int          # original query orientation coords
    qo_end: int
    mapq: int


def _segments_of(recs: list[BamRecord]) -> list[_Segment]:
    segs = []
    for r in recs:
        if r.is_unmapped or r.is_secondary or len(r.cigar) == 0:
            continue
        left, right = r.query_clips()
        alen_q = r.query_length() - sum(
            int(l) for op, l in r.cigar if op == _S)
        qlen = left + right + alen_q
        if r.is_reverse:
            qo_start, qo_end = right, right + alen_q
        else:
            qo_start, qo_end = left, left + alen_q
        _ = qlen
        segs.append(_Segment(
            ref_name="", pos=r.pos, ref_end=r.reference_end,
            strand=-1 if r.is_reverse else 1,
            qo_start=qo_start, qo_end=qo_end, mapq=r.mapq))
    return segs


def segment_candidates(records_by_chrom: dict[str, list[BamRecord]],
                       hap: int, cfg: ComplexSVConfig,
                       min_mapq: int = 20) -> list[Candidate]:
    """svim-asm segment-pair typing for one haplotype.

    Groups all segments of each contig across chromosomes, orders them along
    the original query, and classifies adjacent pairs
    (SVIM_inter.py:62-340): strand flip → INV (the minority-strand segment
    span), ref back-jump → tandem DUP, chrom change → BND."""
    by_name: dict[str, list[_Segment]] = {}
    for chrom, recs in records_by_chrom.items():
        for r in recs:
            if (r.is_unmapped or r.is_secondary or r.mapq < min_mapq
                    or f"hp{hap}" not in r.name):
                continue
            seg = _segments_of([r])
            if seg:
                seg[0].ref_name = chrom
                by_name.setdefault(r.name, []).append(seg[0])
    out: list[Candidate] = []
    for qname, segs in by_name.items():
        if len(segs) < 2:
            continue
        segs.sort(key=lambda s: s.qo_start)
        # INV: minority-strand segments (fwd-REV-fwd contig path)
        span = {1: 0, -1: 0}
        for s in segs:
            span[s.strand] += s.qo_end - s.qo_start
        dominant = 1 if span[1] >= span[-1] else -1
        for s in segs:
            if s.strand != dominant:
                ln = s.ref_end - s.pos
                if cfg.min_sv_size <= ln <= cfg.max_sv_size:
                    out.append(Candidate("INV", s.ref_name, s.pos, s.ref_end,
                                         ln, hap, qname))
        # junction list for interspersed-DUP pairing, svim "translocations":
        # (dir1, dir2, chr1, pos1, chr2, pos2)  (SVIM_inter.py:293-321).
        # Junction analysis ignores tiny segments (dup-copy re-alignments
        # interleaving the chain fabricate junctions, cfg.min_segment_len)
        # AND segments query-CONTAINED in a longer segment (an inversion
        # supplementary lives inside its parent's span — pairing it with
        # the next chain link fabricates a junction at the inversion)
        def contained(s: _Segment) -> bool:
            ln = s.qo_end - s.qo_start
            return any(o is not s
                       and min(s.qo_end, o.qo_end)
                       - max(s.qo_start, o.qo_start) >= 0.8 * ln
                       and (o.qo_end - o.qo_start) > ln
                       for o in segs)
        segs_j = [s for s in segs
                  if s.qo_end - s.qo_start >= cfg.min_segment_len
                  and not contained(s)]
        juncs: list[tuple[str, str, str, int, str, int]] = []
        for a, b in zip(segs_j, segs_j[1:]):
            q_gap = b.qo_start - a.qo_end
            if a.ref_name != b.ref_name:
                # breakend pair at the junction (filter_tra.py bracket
                # types).  Strand table (recorded at the a side):
                #   (+,+) N[  — a's fwd end joins b's fwd start
                #   (+,-) N]  — a's fwd end joins b reverse
                #   (-,+) [N  — reverse a joined by b's fwd start
                #   (-,-) ]N  — the (+,+) junction seen from a RC contig
                pos1 = a.ref_end if a.strand == 1 else a.pos
                pos2 = b.pos if b.strand == 1 else b.ref_end
                orient = ("N[" if b.strand == 1 else "N]") if a.strand == 1 \
                    else ("[N" if b.strand == 1 else "]N")
                out.append(Candidate("BND", a.ref_name, pos1, pos2, 0, hap,
                                     qname, chrom2=b.ref_name, orient=orient))
                if a.strand == b.strand:
                    d = "fwd" if a.strand == 1 else "rev"
                    juncs.append((d, d, a.ref_name, pos1, b.ref_name, pos2))
                continue
            if a.strand != b.strand:
                continue                       # INV handled above
            if a.strand == 1:
                ref_gap = b.pos - a.ref_end
                dup_len = a.ref_end - b.pos
                dup_pos = b.pos
            else:
                ref_gap = a.pos - b.ref_end
                dup_len = b.ref_end - a.pos
                dup_pos = a.pos
            if ref_gap < -cfg.segment_overlap_tol:
                # back-jump on the reference → tandem duplication; a real
                # junction is contiguous on the query (SVIM_inter DUP_TAN
                # distance tolerance) — large |q_gap| means a chimeric contig
                if (cfg.min_sv_size <= dup_len <= cfg.max_sv_size
                        and abs(q_gap) <= 2 * cfg.segment_overlap_tol):
                    out.append(Candidate("DUP", a.ref_name, dup_pos,
                                         dup_pos + dup_len, dup_len, hap,
                                         qname))
                elif (dup_len > cfg.max_sv_size
                        and abs(q_gap) <= 2 * cfg.segment_overlap_tol):
                    # very large tandem or translocation
                    _emit_same_chrom_bnd(out, juncs, a, b, hap, qname)
            elif (ref_gap > cfg.max_sv_size
                    and abs(q_gap) <= 2 * cfg.segment_overlap_tol):
                # very large DEL or intra-chromosomal translocation
                # (SVIM_inter.py:131-140)
                _emit_same_chrom_bnd(out, juncs, a, b, hap, qname)
        out.extend(_interspersed_dups(juncs, hap, qname, cfg))
    return out


def _emit_same_chrom_bnd(out: list[Candidate], juncs: list, a: _Segment,
                         b: _Segment, hap: int, qname: str) -> None:
    """Same-chromosome breakend from a > max_sv_size jump
    (SVIM_inter.py:131-140, 155-160, 166-171)."""
    if a.strand == 1:
        pos1, pos2, d = a.ref_end - 1, b.pos, "fwd"
        orient = "N["
    else:
        pos1, pos2, d = a.pos, b.ref_end - 1, "rev"
        orient = "]N"
    out.append(Candidate("BND", a.ref_name, pos1, pos2, 0, hap, qname,
                         chrom2=b.ref_name, orient=orient))
    juncs.append((d, d, a.ref_name, pos1, b.ref_name, pos2))


def _interspersed_dups(juncs: list, hap: int, qname: str,
                       cfg: ComplexSVConfig) -> list[Candidate]:
    """Interspersed duplication (DUP:INT) from an out-and-back junction
    pair: the contig leaves the destination locus to a distant origin and
    returns to (within 20bp of) the same destination breakpoint, so the
    origin span is a copy spliced in at the destination
    (SVIM_inter.py:293-321).  POS/END give the genomic *source* span, as in
    svim-asm's DUP:INT records that volcanosv-vc-complex-sv.py greps into
    DUP_final.vcf (:135-138)."""
    out = []
    for j in range(len(juncs)):
        t_dir1, t_dir2, t_chr1, t_pos1, t_chr2, t_pos2 = juncs[j]
        for b_dir1, b_dir2, b_chr1, b_pos1, b_chr2, b_pos2 in juncs[:j]:
            if not (b_dir1 == t_dir2 and b_dir2 == t_dir1
                    and b_dir1 == b_dir2):
                continue
            # destination breakpoints coincide, origin on one chromosome
            if (b_chr1 != t_chr2
                    or abs(b_pos1 - t_pos2) >= cfg.dup_int_dest_tol
                    or b_chr2 != t_chr1):
                continue
            if b_dir1 == "fwd":
                length = t_pos1 + 1 - b_pos2
                src = b_pos2
            else:
                length = b_pos2 + 1 - t_pos1
                src = t_pos1
            if cfg.min_sv_size <= length <= cfg.max_sv_size:
                out.append(Candidate("DUP", b_chr2, src, src + length,
                                     length, hap, qname))
    return out


# ---------------------------------------------------------------------------
# haplotype pairing by reconstructed-sequence distance (SVIM_COMBINE.py)
# ---------------------------------------------------------------------------

def _form_partitions(cands: list[Candidate], max_distance: int
                     ) -> list[list[Candidate]]:
    """Coarse partitions of pos-sorted same-type candidates: a gap >
    max_distance (or a chrom change) starts a new partition
    (form_partitions, SVIM_COMBINE.py:15-31)."""
    out: list[list[Candidate]] = []
    for c in sorted(cands, key=lambda c: (c.chrom, c.pos)):
        if (out and out[-1][-1].chrom == c.chrom
                and abs(c.pos - out[-1][-1].pos) <= max_distance):
            out[-1].append(c)
        else:
            out.append([c])
    return out


def _reconstruct_hap(c: Candidate, ref_seq: str, lo: int, hi: int) -> str:
    """The candidate's local haplotype sequence over window [lo, hi)
    (compute_distance, SVIM_COMBINE.py:34-105): flanks from the reference,
    the variant region inverted (INV) or doubled (tandem DUP)."""
    left = ref_seq[lo:c.pos]
    right = ref_seq[c.end:hi]
    body = ref_seq[c.pos:c.end]
    if c.svtype == "INV":
        return left + revcomp_seq(body) + right
    return left + body * 2 + right            # DUP (one extra copy)


def _complete_linkage(dist: np.ndarray, threshold: float) -> list[list[int]]:
    """Agglomerative complete-linkage clusters cut at `threshold`
    (scipy linkage(method='complete') + fcluster equivalent; partitions are
    ≤ pair_max_partition members so O(n³) host code is fine)."""
    n = dist.shape[0]
    clusters = [[i] for i in range(n)]
    while len(clusters) > 1:
        best = None
        for a in range(len(clusters)):
            for b in range(a + 1, len(clusters)):
                d = max(dist[i, j] for i in clusters[a] for j in clusters[b])
                if d <= threshold and (best is None or d < best[0]):
                    best = (d, a, b)
        if best is None:
            break
        _, a, b = best
        clusters[a] = clusters[a] + clusters[b]
        del clusters[b]
    return clusters


def pair_candidates_by_sequence(
    cands: list[Candidate], ref_seqs: dict[str, str], cfg: ComplexSVConfig,
    device=DEFAULT_DEVICE,
) -> list[list[Candidate]]:
    """svim-asm diploid pairing for INV/DUP: partition → pairwise edit
    distance of reconstructed haplotype sequences (same-hap pairs never
    cluster) → complete-linkage cut at pair_max_edit_distance
    (pair_haplotypes, SVIM_COMBINE.py:124-140).  The edlib distance matrix
    is one batched banded-DP launch over all partitions' pairs, on
    `device`."""
    device = resolve_device(device)
    parts = [p for p in _form_partitions(cands, cfg.partition_max_distance)]
    # gather every within-partition cross-hap pair for one device batch
    pair_idx: list[tuple[int, int, int]] = []     # (part, i, j)
    seq_pairs: list[tuple[str, str]] = []
    spans: list[tuple[int, int]] = []
    for pi, part in enumerate(parts):
        if not (2 <= len(part) <= cfg.pair_max_partition):
            continue
        ref_seq = ref_seqs.get(part[0].chrom, "")
        lo = max(0, min(c.pos for c in part) - 100)
        hi = min(len(ref_seq), max(c.end for c in part) + 100)
        spans.append((lo, hi))
        for i in range(len(part) - 1):
            for j in range(i + 1, len(part)):
                if part[i].hap == part[j].hap:
                    continue                       # ∞ distance, never pairs
                pair_idx.append((pi, i, j))
                seq_pairs.append((
                    _reconstruct_hap(part[i], ref_seq, lo, hi),
                    _reconstruct_hap(part[j], ref_seq, lo, hi)))
    dists = edit_distance_pairs(seq_pairs,
                                clip_to=cfg.pair_max_edit_distance,
                                device=device) \
        if seq_pairs else np.zeros(0, np.int64)
    by_part: dict[int, dict[tuple[int, int], float]] = {}
    for (pi, i, j), d in zip(pair_idx, dists):
        by_part.setdefault(pi, {})[(i, j)] = float(d)

    clusters: list[list[Candidate]] = []
    for pi, part in enumerate(parts):
        if len(part) == 1:
            clusters.append(part)
            continue
        if len(part) > cfg.pair_max_partition:
            log.info("dropped pairing partition of %d %s candidates at "
                     "%s:%d (difficult region, SVIM_COMBINE.py:128-130)",
                     len(part), part[0].svtype, part[0].chrom, part[0].pos)
            continue
        n = len(part)
        INF = 1e9
        dm = np.full((n, n), INF)
        np.fill_diagonal(dm, 0.0)
        for (i, j), d in by_part.get(pi, {}).items():
            dm[i, j] = dm[j, i] = d
        for idxs in _complete_linkage(dm, cfg.pair_max_edit_distance):
            clusters.append([part[k] for k in idxs])
    return clusters


def pair_breakends(cands: list[Candidate], cfg: ComplexSVConfig
                   ) -> list[list[Candidate]]:
    """BND pairing by span-position distance: same orientations, different
    haps, (|Δpos1| + |Δpos2|)/bnd_pair_norm ≤ bnd_pair_threshold
    (span_position_distance_breakends + pair_haplotypes_breakends,
    SVIM_COMBINE.py:108-160)."""
    def key(c: Candidate):
        return (c.chrom, c.chrom2, c.pos)
    parts = []
    for c in sorted(cands, key=key):
        if (parts and parts[-1][-1].chrom == c.chrom
                and parts[-1][-1].chrom2 == c.chrom2
                and abs(c.pos - parts[-1][-1].pos)
                <= cfg.partition_max_distance):
            parts[-1].append(c)
        else:
            parts.append([c])
    clusters: list[list[Candidate]] = []
    for part in parts:
        if len(part) == 1 or len(part) > cfg.pair_max_partition:
            if len(part) == 1:
                clusters.append(part)
            else:
                clusters.extend([c] for c in part)
            continue
        n = len(part)
        dm = np.full((n, n), 1e9)
        np.fill_diagonal(dm, 0.0)
        for i in range(n - 1):
            for j in range(i + 1, n):
                a, b = part[i], part[j]
                if a.hap == b.hap or a.orient != b.orient:
                    continue
                dm[i, j] = dm[j, i] = (abs(a.pos - b.pos)
                                       + abs(a.end - b.end)) / cfg.bnd_pair_norm
        for idxs in _complete_linkage(dm, cfg.bnd_pair_threshold):
            clusters.append([part[k] for k in idxs])
    return clusters


# ---------------------------------------------------------------------------
# DUP recovery from INS calls (align_ins2ref.py)
# ---------------------------------------------------------------------------

def recover_dups_from_ins(ins_records: list[VcfRecord], ref_seqs: dict,
                          cfg: ComplexSVConfig, dtype: str = "Hifi",
                          device=DEFAULT_DEVICE
                          ) -> tuple[list[VcfRecord], set[str]]:
    """An INS whose ALT sequence re-aligns next to its own breakpoint is a
    duplication (is_dup, align_ins2ref.py:82-97): size_sim ≥ 0.7, shift ≤
    300, shift/svlen ≤ 0.3.  Returns (DUP records, consumed INS ids).
    The realignment's DP runs on `device`."""
    from ..aligner import Aligner
    from ..config import AlignConfig
    device = resolve_device(device)
    queries = []
    for r in ins_records:
        if r.svtype == "INS" and len(r.alt) > len(r.ref):
            queries.append((r.id, r.alt[1:]))
    if not queries:
        return [], set()
    preset = {"Hifi": "map-hifi", "CLR": "map-pb", "ONT": "map-ont"}.get(
        dtype, "map-hifi")
    aligner = Aligner(ref_seqs, AlignConfig.preset(preset), device=device)
    alns = aligner.align(queries)
    by_id: dict[str, list] = {}
    for a in alns:
        by_id.setdefault(a.qname, []).append(a)
    rec_by_id = {r.id: r for r in ins_records}
    dups, consumed = [], set()
    n = 0
    for rid, hits in by_id.items():
        r = rec_by_id[rid]
        svlen = len(r.alt) - len(r.ref)
        best = None
        for a in hits:
            if a.ref_name != r.chrom:
                continue
            hit_len = a.t_end() - a.pos
            size_sim = min(hit_len, svlen) / max(hit_len, svlen)
            shift = abs(a.pos - (r.pos - 1))
            if (size_sim >= cfg.dup_min_size_sim
                    and shift <= cfg.dup_max_shift
                    and shift / max(svlen, 1) <= cfg.dup_max_shift_ratio):
                score = size_sim - shift / (cfg.dup_max_shift + 1)
                if best is None or score > best[0]:
                    best = (score, a)
        if best is not None:
            n += 1
            consumed.add(rid)
            dups.append(VcfRecord(
                chrom=r.chrom, pos=r.pos, id=f"{r.chrom}-DUP-{n}",
                ref=r.ref[0], alt="<DUP>", qual=r.qual, gt=r.gt,
                info={"SVTYPE": "DUP", "SVLEN": svlen,
                      "END": r.pos + svlen,
                      "TIG_REGION": r.info.get("TIG_REGION", ""),
                      "PS": r.info.get("PS", "")},
            ))
    log.info("DUP recovery: %d/%d INS reclassified", n, len(queries))
    return dups, consumed


# ---------------------------------------------------------------------------
# INV merge + read-orientation support (filter_inv.py)
# ---------------------------------------------------------------------------

def _merge_candidates_by_span(cands: list[Candidate], dist: int
                              ) -> list[list[Candidate]]:
    """Single-linkage grouping by both endpoints within `dist`."""
    cands = sorted(cands, key=lambda c: (c.chrom, c.pos))
    groups: list[list[Candidate]] = []
    for c in cands:
        placed = False
        for g in groups:
            ref = g[0]
            if (ref.chrom == c.chrom and abs(ref.pos - c.pos) <= dist
                    and abs(ref.end - c.end) <= dist):
                g.append(c)
                placed = True
                break
        if not placed:
            groups.append([c])
    return groups


def inv_read_genotype(chrom_reads: list[BamRecord], pos: int, end: int
                      ) -> tuple[int, int]:
    """(carrier, clean) read counts over the INV span.

    A carrier read crosses the inversion as mismatch/small-indel soup or
    with an opposite-strand supplementary; a clean read matches the
    reference through it.  Zygosity from the carrier fraction is robust to
    assembly-bin noise — a design improvement over svim-asm, which
    genotypes from contig cluster sizes alone (SVIM_COMBINE.py:165+) and
    inherits every consensus artifact."""
    span = max(end - pos, 1)
    need = min(150, span)
    _M_, _I_, _D_ = 0, 1, 2
    prim_strand: dict[str, bool] = {}
    for r in chrom_reads:
        if not (r.is_unmapped or r.is_secondary or r.is_supplementary):
            prim_strand[r.name] = r.is_reverse
    by_name: dict[str, list[int]] = {}   # name -> [carrier?, clean?]
    for r in chrom_reads:
        if r.is_unmapped or r.is_secondary:
            continue
        lo, hi = max(r.pos, pos), min(r.reference_end, end)
        if hi - lo < need:
            continue
        ov = hi - lo
        e = by_name.setdefault(r.name, [0, 0])
        if r.is_supplementary:
            # an OPPOSITE-strand supplementary over the span = carrier
            # (the rescued/split inverted segment)
            if r.name in prim_strand \
                    and r.is_reverse != prim_strand[r.name]:
                e[0] = 1
            continue
        # small-indel soup count within the overlap
        cnt = 0
        rp = r.pos
        for op, ln in np.asarray(r.cigar):
            op, ln = int(op), int(ln)
            if op in (_M_, 7, 8):
                rp += ln
            elif op == _D_:
                if ln <= 15 and lo <= rp <= hi:
                    cnt += 1
                rp += ln
            elif op == _I_:
                if ln <= 15 and lo <= rp <= hi:
                    cnt += 1
        if cnt >= max(3, int(0.02 * ov)):
            e[0] = 1
        elif cnt <= max(1, int(0.005 * ov)) and ov >= min(200, span):
            e[1] = 1
    nc = sum(1 for c, _cl in by_name.values() if c)
    nr = sum(1 for c, cl in by_name.values() if cl and not c)
    return nc, nr


def inv_read_support(chrom_reads: list[BamRecord], pos: int, end: int,
                     flank: int) -> int:
    """Reads aligned in BOTH orientations near each breakend
    (extract_reads_support_one_region, filter_inv.py:123-157).  Returns
    min(support_left, support_right)."""
    sup = []
    for bk in (pos, end):
        fwd, rev = set(), set()
        for r in chrom_reads:
            if r.is_unmapped or r.reference_end < bk - flank \
                    or r.pos > bk + flank:
                continue
            (rev if r.is_reverse else fwd).add(r.name)
        sup.append(len(fwd & rev))
    return min(sup)


def _dedup_same_hap(cands: list[Candidate], tol: int = 100
                    ) -> list[Candidate]:
    """Overlapping contigs of ONE haplotype duplicate a candidate with
    small coordinate jitter; keep the longest per (hap, ~span) run — the
    per-hap role the contig-signature clustering plays in the large-indel
    path (cluster_del, extract_contig_signature_Hifi.py:196-249).  Cross-hap
    merging is pairing's job, never done here."""
    out: list[Candidate] = []
    for c in sorted(cands, key=lambda c: (c.hap, c.chrom, c.chrom2, c.pos)):
        if (out and out[-1].hap == c.hap and out[-1].chrom == c.chrom
                and out[-1].chrom2 == c.chrom2
                and out[-1].orient == c.orient
                and abs(out[-1].pos - c.pos) <= tol
                and abs(out[-1].end - c.end) <= tol):
            if c.svlen > out[-1].svlen:
                out[-1] = c
        else:
            out.append(c)
    return out


def _gt_of(haps: set) -> str:
    return "1|1" if haps == {1, 2} else ("1|0" if haps == {1} else "0|1")


def call_inversions(cands: list[Candidate], cfg: ComplexSVConfig,
                    reads_by_chrom: dict[str, list[BamRecord]] | None,
                    ref_seqs: dict[str, str],
                    device=DEFAULT_DEVICE) -> list[VcfRecord]:
    """svim-asm sequence pairing (GT) → filter_inv merge + read support.

    Two *different* INVs on hp1/hp2 stay two het clusters (edit distance >
    pair_max_edit_distance); identical ones pair to one 1|1 cluster
    (SVIM_COMBINE.py pair_haplotypes + :208-240).  Clusters are then
    span-merged ≤ inv_merge_dist at both ends with a per-hap GT OR vote
    (merge_inv/get_gt_votes, filter_inv.py:57-96).  The pairing's edit
    distances run on `device`."""
    device = resolve_device(device)
    inv = _dedup_same_hap([c for c in cands if c.svtype == "INV"])
    clusters = pair_candidates_by_sequence(inv, ref_seqs, cfg, device=device)
    reps = [(max(cl, key=lambda c: c.svlen), {c.hap for c in cl})
            for cl in clusters]
    reps.sort(key=lambda rh: (rh[0].chrom, rh[0].pos))
    groups: list[list[tuple[Candidate, set]]] = []
    for rep, haps in reps:
        g0 = groups[-1][0][0] if groups else None
        if (g0 is not None and g0.chrom == rep.chrom
                and abs(g0.pos - rep.pos) <= cfg.inv_merge_dist
                and abs(g0.end - rep.end) <= cfg.inv_merge_dist):
            groups[-1].append((rep, haps))
        else:
            groups.append([(rep, haps)])
    out = []
    n = 0
    for g in groups:
        haps = set().union(*(h for _, h in g))
        best = max((r for r, _ in g), key=lambda c: c.svlen)
        gt = _gt_of(haps)
        if reads_by_chrom is not None:
            support = inv_read_support(
                reads_by_chrom.get(best.chrom, []), best.pos, best.end,
                cfg.inv_support_flank)
            if support < cfg.inv_min_support:
                continue
            # zygosity from the read carrier fraction (robust to
            # assembly-bin noise; see inv_read_genotype).  Phase
            # orientation keeps the contig hap when the zygosity agrees,
            # else falls back to the majority-candidate hap.
            nc, nr = inv_read_genotype(reads_by_chrom.get(best.chrom, []),
                                       best.pos, best.end)
            if nc + nr >= 6:
                frac = nc / (nc + nr)
                if frac >= 0.75:
                    gt = "1|1"
                elif frac >= 0.2:
                    cnt = {1: 0, 2: 0}
                    for c in (c for cl in g for c in [cl[0]]):
                        cnt[c.hap] += 1
                    if haps == {1}:
                        gt = "1|0"
                    elif haps == {2}:
                        gt = "0|1"
                    else:
                        gt = "1|0" if cnt[1] >= cnt[2] else "0|1"
        n += 1
        ref_base = ref_seqs.get(best.chrom, "N")[best.pos] \
            if best.pos < len(ref_seqs.get(best.chrom, "")) else "N"
        out.append(VcfRecord(
            chrom=best.chrom, pos=best.pos + 1,
            id=f"{best.chrom}-INV-{n}", ref=ref_base, alt="<INV>",
            qual="30", gt=gt,
            info={"SVTYPE": "INV", "SVLEN": best.svlen,
                  "END": best.end, "READS": best.qname}))
    return out


# ---------------------------------------------------------------------------
# TRA/BND clustering (filter_tra.py)
# ---------------------------------------------------------------------------

# VCF BND mate bracket orientation: t[p[ ↔ ]p]t, t]p] ↔ t]p],
# ]p]t ↔ t[p[, [p[t ↔ [p[t
_MATE_ORIENT = {"N[": "]N", "]N": "N[", "N]": "N]", "[N": "[N"}


def _bnd_alt(orient: str, chrom: str, pos1: int) -> str:
    mate = f"{chrom}:{pos1}"
    return {"N[": f"N[{mate}[", "N]": f"N]{mate}]",
            "]N": f"]{mate}]N", "[N": f"[{mate}[N"}[orient]


def _canonical_bnd(c: Candidate) -> Candidate:
    """Normalize a breakend to its lexicographically-smaller mate form: a
    junction observed from a reverse-complement-assembled contig is the
    MATE representation of the same breakend ((c2,p2,mate-orient) instead
    of (c1,p1,orient)) — canonicalizing makes the hp1/hp2 observations of
    one junction cluster regardless of contig orientation."""
    if (c.chrom2, c.end) < (c.chrom, c.pos):
        return Candidate("BND", c.chrom2, c.end, c.pos, 0, c.hap, c.qname,
                         chrom2=c.chrom, orient=_MATE_ORIENT[c.orient])
    return c


def call_translocations(cands: list[Candidate], cfg: ComplexSVConfig
                        ) -> list[VcfRecord]:
    """svim span-position BND pairing (GT) → filter_tra clustering.

    Pairing: cross-hap, same-orientation breakend pairs within
    (|Δpos1|+|Δpos2|)/3000 ≤ 0.3 form one genotyped candidate
    (SVIM_COMBINE.py:108-160).  Then single-linkage clustering within
    tra_cluster_dist collapses duplicates with a GT union
    (cluster_bnd/merge_bnd, filter_tra.py:70-116).  Each breakend emits
    BOTH mates as reciprocal records linked by MATEID (VCF BND
    semantics, svim-asm output contract)."""
    bnds = _dedup_same_hap([_canonical_bnd(c) for c in cands
                            if c.svtype == "BND"])
    reps = [(cl[0], {c.hap for c in cl}) for cl in pair_breakends(bnds, cfg)]
    groups: list[list[tuple[Candidate, set]]] = []
    for c, haps in sorted(reps, key=lambda rh: (rh[0].chrom, rh[0].chrom2,
                                                rh[0].pos)):
        placed = False
        for g in groups:
            ref = g[0][0]
            if (ref.chrom == c.chrom and ref.chrom2 == c.chrom2
                    and ref.orient == c.orient
                    and abs(ref.pos - c.pos) <= cfg.tra_cluster_dist
                    and abs(ref.end - c.end) <= cfg.tra_cluster_dist):
                g.append((c, haps))
                placed = True
                break
        if not placed:
            groups.append([(c, haps)])
    out = []
    for n, g in enumerate(groups, 1):
        best = g[0][0]
        gt = _gt_of(set().union(*(h for _, h in g)))
        id1 = f"{best.chrom}-TRA-{n}-1"
        id2 = f"{best.chrom}-TRA-{n}-2"
        out.append(VcfRecord(
            chrom=best.chrom, pos=best.pos + 1, id=id1, ref="N",
            alt=_bnd_alt(best.orient, best.chrom2, best.end + 1),
            qual="30", gt=gt,
            info={"SVTYPE": "BND", "CHR2": best.chrom2,
                  "END": best.end + 1, "MATEID": id2,
                  "READS": best.qname}))
        out.append(VcfRecord(
            chrom=best.chrom2, pos=best.end + 1, id=id2, ref="N",
            alt=_bnd_alt(_MATE_ORIENT[best.orient], best.chrom,
                         best.pos + 1),
            qual="30", gt=gt,
            info={"SVTYPE": "BND", "CHR2": best.chrom,
                  "END": best.pos + 1, "MATEID": id1,
                  "READS": best.qname}))
    return out


def call_complex_svs(
    contig_records_by_chrom: dict[str, list[BamRecord]],
    ref_seqs: dict[str, str],
    cfg: PipelineConfig,
    ins_records: list[VcfRecord] | None = None,
    reads_by_chrom: dict[str, list[BamRecord]] | None = None,
    consumed_ins: set | None = None,
    device=DEFAULT_DEVICE,
) -> list[VcfRecord]:
    """Full complex-SV calling (parity with volcanosv-vc-complex-sv.py).

    ins_records: large-indel INS calls for DUP recovery (:131-138).
    consumed_ins (when passed) receives the ids of INS records the DUP
    recovery reclassified — `run` drops them from the large-indel VCF
    so a tandem duplication is reported once, as <DUP>.
    device: the torch device of the pairing's edit distances and of the
    DUP-recovery realignment."""
    device = resolve_device(device)
    csv = cfg.complex_sv
    cands = (segment_candidates(contig_records_by_chrom, 1, csv)
             + segment_candidates(contig_records_by_chrom, 2, csv))
    log.info("complex-SV candidates: %d (%s)", len(cands),
             {t: sum(1 for c in cands if c.svtype == t)
              for t in ("INV", "DUP", "BND")})
    out: list[VcfRecord] = []
    out += call_inversions(cands, csv, reads_by_chrom, ref_seqs,
                           device=device)
    out += call_translocations(cands, csv)
    # direct tandem-DUP candidates from segment back-jumps, genotyped by
    # sequence pairing (svim-asm emits one record per cluster; two nearby
    # DUPs with different copies/extents stay two hets)
    n = 0
    dups = _dedup_same_hap([c for c in cands if c.svtype == "DUP"])
    for cl in pair_candidates_by_sequence(dups, ref_seqs, csv,
                                          device=device):
        haps = {c.hap for c in cl}
        best = max(cl, key=lambda c: c.svlen)
        n += 1
        out.append(VcfRecord(
            chrom=best.chrom, pos=best.pos + 1, id=f"{best.chrom}-DUPSEG-{n}",
            ref="N", alt="<DUP>", qual="30", gt=_gt_of(haps),
            info={"SVTYPE": "DUP", "SVLEN": best.svlen, "END": best.end,
                  "READS": best.qname}))
    if ins_records:
        dups, consumed = recover_dups_from_ins(ins_records, ref_seqs, csv,
                                               cfg.dtype.value,
                                               device=device)
        out += dups
        if consumed_ins is not None:
            consumed_ins |= consumed
    out.sort(key=lambda r: (r.chrom, r.pos))
    return out
