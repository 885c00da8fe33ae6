"""SNP-candidate pileup over read alignments.

Replaces the variant-calling half of longshot (volcanosv-asm.py:75-80): a
vectorized mismatch pileup instead of pair-HMM realignment — mismatch
observations are collected per alignment in O(aligned bases) numpy, then
candidates are selected by a per-dtype genotype-likelihood model
(PhasingConfig.error_rate: binomial hom-ref / het / hom-alt likelihoods,
SNP qual = -10·log10 P(hom-ref | data) gated at min_snp_qual — longshot's
role at CLR/ONT error rates, where a plain allele-fraction band would
drown in noise).  Bases below min_base_qual are excluded when base
qualities are present.  With error_rate=None the legacy allele-fraction
band applies (the assembler's consensus pileup uses that mode).  The
per-read allele observations feed the MEC phaser (phase.py) whose
iterations run on device.  The one device call here is the pair-HMM
realignment (realign.pairhmm_alleles), on the caller's torch device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import PhasingConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..io.bam import BamRecord
from ..ops.pack import encode_seq

_M, _I, _D, _S, _H, _EQ, _X = 0, 1, 2, 4, 5, 7, 8


def _aligned_pairs(rec: BamRecord):
    """(ref_idx, read_idx) int64 arrays for all M/=/X columns plus the ref
    positions/lengths/types of I/D gap events (vectorized)."""
    cigar = np.asarray(rec.cigar)
    ops = cigar[:, 0]
    lens = cigar[:, 1].astype(np.int64)
    cr = np.isin(ops, (_M, _D, _EQ, _X)) * lens
    cq = np.isin(ops, (_M, _I, _S, _EQ, _X)) * lens
    ref0 = rec.pos + np.concatenate([[0], np.cumsum(cr)[:-1]])
    q0 = np.concatenate([[0], np.cumsum(cq)[:-1]])
    ind = np.isin(ops, (_I, _D)) & (lens > 0)
    indel_pos = ref0[ind]
    indel_len = lens[ind]
    indel_isdel = ops[ind] == _D
    m = np.isin(ops, (_M, _EQ, _X)) & (lens > 0)
    if not m.any():
        z = np.zeros(0, np.int64)
        return z, z, indel_pos, indel_len, indel_isdel
    ls = lens[m]
    total = int(ls.sum())
    base = np.repeat(np.cumsum(ls) - ls, ls)
    offs = np.arange(total) - base
    ref_idx = np.repeat(ref0[m], ls) + offs
    read_idx = np.repeat(q0[m], ls) + offs
    return ref_idx, read_idx, indel_pos, indel_len, indel_isdel


def _rec_arrays(rec: BamRecord, L: int, cfg: PhasingConfig):
    """Aligned-pair arrays for one record, recomputed on demand (streaming
    memory model): (ref_idx, rb_masked, read_idx, codes, indel_pos,
    indel_len, indel_isdel) — ref_idx is None when the record has no
    aligned columns."""
    ref_idx, read_idx, indel_pos, indel_len, indel_isdel = \
        _aligned_pairs(rec)
    if len(ref_idx) == 0:
        return None, None, None, None, indel_pos, indel_len, indel_isdel
    ok = (ref_idx >= 0) & (ref_idx < L)
    ref_idx, read_idx = ref_idx[ok], read_idx[ok]
    codes = encode_seq(rec.seq)
    rb = codes[read_idx]
    if rec.qual is not None and len(rec.qual) == len(rec.seq):
        # mask low-quality bases (longshot --min_base_qual role)
        q = np.asarray(rec.qual)[read_idx]
        rb = np.where(q >= cfg.min_base_qual, rb, np.int8(5))
    return ref_idx, rb, read_idx, codes, indel_pos, indel_len, indel_isdel


@dataclass
class PileupResult:
    snp_pos: np.ndarray        # (S,) 0-based candidate positions, sorted
    ref_base: np.ndarray       # (S,) int8 codes
    alt_base: np.ndarray       # (S,) int8 codes
    ref_count: np.ndarray      # (S,) int32
    alt_count: np.ndarray      # (S,) int32
    depth: np.ndarray          # (S,) int32 coverage
    is_het: np.ndarray         # (S,) bool (af band) — only het sites phase
    # sparse read × SNP observations
    obs_read: np.ndarray       # (O,) int32 read index
    obs_snp: np.ndarray        # (O,) int32 snp index
    obs_allele: np.ndarray     # (O,) int8 +1=ref, -1=alt, 0=other
    read_names: list[str]
    # SV-aware phasing markers (PhasingConfig.sv_markers): True rows are
    # het indel/inversion-soup columns used ONLY for phasing/partition —
    # they must never reach the SNP VCF
    marker: np.ndarray = None  # (S,) bool
    # per-read reference spans, index-aligned with read_names (drives the
    # desert test for single-marker-obs read assignment in phase.py)
    read_span: np.ndarray = None  # (R, 2) int64 [start, end)


def pileup_chromosome(records: list[BamRecord], ref_codes: np.ndarray,
                      cfg: PhasingConfig,
                      device=DEFAULT_DEVICE) -> PileupResult:
    """Candidate SNPs + read observation lists for one chromosome; the
    pair-HMM realignment runs on `device`."""
    device = resolve_device(device)
    L = len(ref_codes)
    cov = np.zeros(L + 1, np.int32)
    icov = np.zeros(L + 1, np.int32)   # reads-with-an-indel-nearby overlay
    mm_pos: list[np.ndarray] = []
    mm_base: list[np.ndarray] = []
    names: list[str] = []
    do_realign = cfg.realign and cfg.error_rate is not None
    rec_span: list[tuple[int, int]] = []    # per pileup record (start, end)
    rec_events: list[tuple] = []            # per record (pos, len, isdel)
    kept_recs: list[BamRecord] = []
    # pass 1 is STREAMING: per-record aligned-pair arrays (16+ bytes/bp)
    # are recomputed on demand in the realign/observation passes instead
    # of being retained — retained pairs+segs were ~25 bytes/bp of host
    # RSS, the round-3 scale wall (a 50Mb chromosome at 24x is 1.2 Gbp)
    for rec in records:
        if rec.is_unmapped or rec.is_secondary or rec.mapq < cfg.min_mapq \
                or not rec.seq:
            continue
        ref_idx, rb, _read_idx, _codes, indel_pos, indel_len, indel_isdel \
            = _rec_arrays(rec, L, cfg)
        if ref_idx is None:
            continue
        if do_realign:
            # this read votes 'indel nearby' on ±10bp around each gap event
            for ip in indel_pos:
                lo = max(int(ip) - 10, 0)
                icov[lo] += 1
                icov[min(int(ip) + 11, L)] -= 1
        kept_recs.append(rec)
        names.append(rec.name)
        rec_span.append((rec.pos, rec.reference_end))
        cov[rec.pos] += 1
        cov[min(rec.reference_end, L)] -= 1
        mism = (rb != ref_codes[ref_idx]) & (rb < 4) & (ref_codes[ref_idx] < 4)
        rec_events.append((indel_pos, indel_len, indel_isdel,
                           ref_idx[mism]))
        mm_pos.append(ref_idx[mism])
        mm_base.append(rb[mism])
    coverage = np.cumsum(cov[:-1])
    indel_cov = np.cumsum(icov[:-1]) if do_realign else None
    if not mm_pos or not sum(len(m) for m in mm_pos):
        # no mismatch observations at all (e.g. reads matching a polished
        # draft exactly) — empty candidate set
        z8, z32, z64 = np.zeros(0, np.int8), np.zeros(0, np.int32), np.zeros(0, np.int64)
        return PileupResult(z64, z8, z8, z32, z32, z32,
                            np.zeros(0, bool), z32, z32, z8, names,
                            marker=np.zeros(0, bool),
                            read_span=np.array(rec_span, np.int64).reshape(
                                -1, 2))

    ap = np.concatenate(mm_pos)
    ab = np.concatenate(mm_base).astype(np.int64)
    key = ap * 4 + ab
    uk, counts = np.unique(key, return_counts=True)
    upos, ubase = uk // 4, (uk % 4).astype(np.int8)
    # best alt per position
    order = np.lexsort((-counts, upos))
    upos_o, ubase_o, cnt_o = upos[order], ubase[order], counts[order]
    first = np.concatenate([[True], upos_o[1:] != upos_o[:-1]])
    cand_pos = upos_o[first]
    cand_alt = ubase_o[first]
    cand_cnt = cnt_o[first].astype(np.int32)
    # second-best alt per position — at shifted columns near indels the
    # raw counts can rank the wrong base first; the pair-HMM pass re-ranks
    cand_alt2 = cand_alt.copy()
    if len(upos_o) > 1:
        second = np.zeros(len(upos_o), bool)
        second[1:] = first[:-1] & (upos_o[1:] == upos_o[:-1])
        fi = np.cumsum(first) - 1
        tgt = fi[second]
        cand_alt2[tgt] = ubase_o[second]

    depth = coverage[cand_pos]
    af = cand_cnt / np.maximum(depth, 1)
    near_indel = np.zeros(len(cand_pos), bool)
    if indel_cov is not None:
        frac = indel_cov[cand_pos] / np.maximum(depth, 1)
        near_indel = frac >= cfg.realign_indel_frac
    # near-indel sites get a relaxed af pre-gate: alignment shift dilutes
    # the mismatch column exactly there; the pair-HMM pass re-derives the
    # true counts before the likelihood gate decides
    af_floor = np.where(near_indel,
                        cfg.min_allele_frac * cfg.realign_af_relax,
                        cfg.min_allele_frac)
    keep = (depth >= cfg.min_depth) & (depth <= cfg.max_depth) & \
           (af >= af_floor)
    cand_pos, cand_alt, cand_cnt = cand_pos[keep], cand_alt[keep], cand_cnt[keep]
    cand_alt2 = cand_alt2[keep]
    depth, af, near_indel = depth[keep], af[keep], near_indel[keep]
    af_floor = af_floor[keep]

    # --- pair-HMM realignment of candidate sites ------------------------
    # near-indel sites by default; ALL candidate sites in realign_all mode
    # (longshot's model — at CLR/ONT error rates the aligner's columns are
    # unreliable everywhere, and the HMM's per-read re-read is also what
    # kills shifted-noise columns the raw-count GL would miscall)
    realigned_obs: dict[tuple[int, int], int] = {}   # (read idx, site j)
    k_eff = cand_cnt.astype(np.float64)
    n_eff = depth.astype(np.float64)
    realigned = np.zeros(len(cand_pos), bool)
    ri = np.arange(len(cand_pos)) if cfg.realign_all \
        else np.nonzero(near_indel)[0]
    if do_realign and len(ri):
        flank = cfg.realign_flank
        W = 2 * flank + 1
        R_MAX = W + 16
        ri_pos = cand_pos[ri]
        p_segs, p_lens, p_read, p_site = [], [], [], []
        for ridx, rec in enumerate(kept_recs):
            s0, e0 = rec_span[ridx]
            # cheap span prefilter before recomputing the aligned pairs
            if not ((ri_pos >= s0) & (ri_pos < e0)).any():
                continue
            ref_idx, _rb, read_idx, codes, *_ = _rec_arrays(rec, L, cfg)
            if ref_idx is None or len(ref_idx) == 0:
                continue
            lo_s = np.searchsorted(ri_pos, ref_idx[0] + 2, side="left")
            hi_s = np.searchsorted(ri_pos, ref_idx[-1] - 2, side="right")
            for j in range(lo_s, hi_s):
                p = int(ri_pos[j])
                lo_c = np.searchsorted(ref_idx, p - flank, side="left")
                hi_c = np.searchsorted(ref_idx, p + flank, side="right") - 1
                if hi_c < lo_c:
                    continue
                r_lo, r_hi = int(read_idx[lo_c]), int(read_idx[hi_c])
                if r_hi - r_lo + 1 > R_MAX or r_hi < r_lo:
                    continue
                seg = codes[r_lo:r_hi + 1]
                p_segs.append(seg)
                p_lens.append(len(seg))
                p_read.append(ridx)
                p_site.append(int(ri[j]))
        if p_segs:
            from .realign import pairhmm_alleles
            N = len(p_segs)
            seg_arr = np.full((N, R_MAX), 4, np.int8)
            for i, s in enumerate(p_segs):
                seg_arr[i, :len(s)] = s
            site_arr = np.asarray(p_site)
            pos_arr = cand_pos[site_arr]
            hap_ref = np.full((N, W), 4, np.int8)
            for i in range(N):
                p = int(pos_arr[i])
                lo, hi = max(p - flank, 0), min(p + flank + 1, L)
                hap_ref[i, lo - (p - flank):lo - (p - flank) + hi - lo] = \
                    ref_codes[lo:hi]
            lens_arr = np.asarray(p_lens, np.int32)
            n_sites = len(cand_pos)

            def _score(alt_bases):
                hap_alt = hap_ref.copy()
                hap_alt[:, flank] = alt_bases[site_arr]
                al = pairhmm_alleles(seg_arr, lens_arr, hap_ref, hap_alt,
                                     cfg.error_rate,
                                     margin=cfg.realign_margin,
                                     device=device)
                k = np.zeros(n_sites, np.float64)
                nn = np.zeros(n_sites, np.float64)
                np.add.at(k, site_arr, (al == -1).astype(np.float64))
                np.add.at(nn, site_arr, (al != 0).astype(np.float64))
                return al, k, nn

            # the raw counts can rank the wrong base first at shifted
            # columns: score both top alts, keep the one with more support
            al1, k1, n1 = _score(cand_alt)
            has2 = cand_alt2 != cand_alt
            if has2[site_arr].any():
                al2, k2, n2 = _score(cand_alt2)
            else:
                al2, k2, n2 = al1, k1, n1
            use2 = has2 & (k2 > k1)
            cand_alt = np.where(use2, cand_alt2, cand_alt)
            alleles = np.where(use2[site_arr], al2, al1).astype(np.int8)
            k_new = np.where(use2, k2, k1)
            n_new = np.where(use2, n2, n1)
            has = np.zeros(n_sites, bool)
            has[site_arr] = True
            realigned = has
            k_eff = np.where(has, k_new, k_eff)
            n_eff = np.where(has, np.maximum(n_new, 1.0), n_eff)
            for i in range(N):
                realigned_obs[(p_read[i], int(site_arr[i]))] = int(alleles[i])

    # dense intervals measured on the PRE-likelihood candidate set, kept
    # only when the merged interval SPANS ≥ dense_window: a het inversion's
    # carrier reads mismatch at ~3/4 of its columns over its whole length
    # (100s of bp), while the alignment-shift shadow cluster around a real
    # indel is dense but TIGHT (≲30bp) — span separates them, so the
    # pair-HMM can still rescue the shadowed SNP while every in-soup
    # column (the round-3 FP-SNP source) is interval-masked.
    dense_ivals: list[tuple[int, int]] = []
    if cfg.dense_count > 0 and cfg.error_rate is not None and len(cand_pos):
        half = cfg.dense_window // 2
        lo_d = np.searchsorted(cand_pos, cand_pos - half, side="left")
        hi_d = np.searchsorted(cand_pos, cand_pos + half, side="right")
        dpos = cand_pos[(hi_d - lo_d) >= cfg.dense_count]
        raw: list[list[int]] = []
        for p in dpos:
            p = int(p)
            if raw and p - raw[-1][1] <= cfg.dense_window:
                raw[-1][1] = p
            else:
                raw.append([p, p])
        dense_ivals = [(a - cfg.dense_margin, b + cfg.dense_margin)
                       for a, b in raw if b - a >= cfg.dense_min_span]

    if cfg.error_rate is not None and len(cand_pos):
        # genotype likelihoods (binomial, flat prior): hom-ref sees the alt
        # only via error (e/3 to a specific base), het at ~0.5, hom-alt
        # symmetric; qual = -10·log10 P(hom-ref | data) ≥ min_snp_qual
        e3 = max(cfg.error_rate / 3, 1e-6)
        n = n_eff
        k = k_eff
        ll_rr = k * np.log(e3) + (n - k) * np.log1p(-e3)
        ll_aa = (n - k) * np.log(e3) + k * np.log1p(-e3)
        ll_ra = n * np.log(0.5)
        mx = np.maximum(np.maximum(ll_rr, ll_aa), ll_ra)
        p_rr = np.exp(ll_rr - mx)
        tot = p_rr + np.exp(ll_aa - mx) + np.exp(ll_ra - mx)
        qual = -10.0 * np.log10(np.maximum(p_rr / tot, 1e-300))
        keep2 = qual >= cfg.min_snp_qual
        is_het = (ll_ra >= ll_aa)[keep2]
        cand_pos, cand_alt = cand_pos[keep2], cand_alt[keep2]
        cand_cnt = np.where(realigned, k_eff.astype(np.int32),
                            cand_cnt)[keep2]
        depth = depth[keep2]
        if realigned_obs:
            # remap realigned site indices through the keep2 filter
            new_of = np.full(len(keep2), -1, np.int64)
            new_of[keep2] = np.arange(int(keep2.sum()))
            realigned_obs = {(r, int(new_of[j])): a
                             for (r, j), a in realigned_obs.items()
                             if new_of[j] >= 0}
    else:
        is_het = af <= cfg.max_allele_frac

    # dense-cluster filter (longshot -D role): drop survivors inside a
    # pre-likelihood dense interval (inversion soup), plus the plain
    # survivor-density rule — real SNVs never pack ≥ dense_count into
    # dense_window bp
    if len(cand_pos) and cfg.dense_count > 0 and cfg.error_rate is not None:
        in_iv = np.zeros(len(cand_pos), bool)
        if dense_ivals:
            iv_lo = np.array([a for a, _ in dense_ivals], np.int64)
            iv_hi = np.array([b for _, b in dense_ivals], np.int64)
            j = np.searchsorted(iv_lo, cand_pos, side="right") - 1
            in_iv = (j >= 0) & \
                (cand_pos <= iv_hi[np.clip(j, 0, len(iv_hi) - 1)])
        half = cfg.dense_window // 2
        lo_s = np.searchsorted(cand_pos, cand_pos - half, side="left")
        hi_s = np.searchsorted(cand_pos, cand_pos + half, side="right")
        sparse = ~in_iv & ((hi_s - lo_s) < cfg.dense_count)
        if not sparse.all():
            cand_pos, cand_alt = cand_pos[sparse], cand_alt[sparse]
            cand_cnt, depth = cand_cnt[sparse], depth[sparse]
            is_het = is_het[sparse]
            if realigned_obs:
                new_of = np.full(len(sparse), -1, np.int64)
                new_of[sparse] = np.arange(int(sparse.sum()))
                realigned_obs = {(r, int(new_of[j])): a
                                 for (r, j), a in realigned_obs.items()
                                 if new_of[j] >= 0}
    markers = _build_sv_markers(rec_span, rec_events, dense_ivals, cfg) \
        if (cfg.sv_markers and cfg.error_rate is not None) else []

    if len(cand_pos) == 0 and not markers:
        z8, z32 = np.zeros(0, np.int8), np.zeros(0, np.int32)
        return PileupResult(cand_pos.astype(np.int64), z8, z8, z32, z32,
                            z32, np.zeros(0, bool), z32, z32, z8, names,
                            marker=np.zeros(0, bool),
                            read_span=np.array(rec_span, np.int64).reshape(
                                -1, 2))

    # observations at candidate sites
    obs_read, obs_snp, obs_allele = [], [], []
    rbase = ref_codes[cand_pos]
    if len(cand_pos):
        for ridx, rec in enumerate(kept_recs):
            ref_idx, rb, *_ = _rec_arrays(rec, L, cfg)
            if ref_idx is None:
                continue
            j = np.searchsorted(cand_pos, ref_idx)
            j = np.clip(j, 0, len(cand_pos) - 1)
            hit = cand_pos[j] == ref_idx
            if not hit.any():
                continue
            js = j[hit]
            bases = rb[hit]
            allele = np.where(bases == rbase[js], np.int8(1),
                              np.where(bases == cand_alt[js], np.int8(-1),
                                       np.int8(0)))
            if realigned_obs:
                # pair-HMM votes override the raw CIGAR-column read-off
                for t, jj in enumerate(js):
                    a = realigned_obs.get((ridx, int(jj)))
                    if a is not None:
                        allele[t] = a
            obs_read.append(np.full(len(js), ridx, np.int32))
            obs_snp.append(js.astype(np.int32))
            obs_allele.append(allele)

    ref_cnt = (depth - cand_cnt).astype(np.int32)
    cat = (lambda xs, d: np.concatenate(xs) if xs else np.zeros(0, d))
    out_read = cat(obs_read, np.int32)
    out_snp = cat(obs_snp, np.int32)
    out_allele = cat(obs_allele, np.int8)
    S0 = len(cand_pos)
    snp_pos = cand_pos.astype(np.int64)
    ref_base = rbase.astype(np.int8)
    alt_base = cand_alt
    alt_cnt = cand_cnt
    depth32 = depth.astype(np.int32)
    mark = np.zeros(S0, bool)

    if markers:
        # append marker columns, then re-sort everything by position
        m_pos = np.array([p for p, _ in markers], np.int64)
        m_obs_read, m_obs_snp, m_obs_allele = [], [], []
        m_alt = np.zeros(len(markers), np.int32)
        m_dep = np.zeros(len(markers), np.int32)
        for k, (_p, obs) in enumerate(markers):
            for ridx, al in obs:
                m_obs_read.append(ridx)
                m_obs_snp.append(S0 + k)
                m_obs_allele.append(al)
            m_alt[k] = sum(1 for _r, al in obs if al == -1)
            m_dep[k] = len(obs)
        snp_pos = np.concatenate([snp_pos, m_pos])
        ref_base = np.concatenate([ref_base, np.zeros(len(markers), np.int8)])
        alt_base = np.concatenate([alt_base, np.zeros(len(markers), np.int8)])
        alt_cnt = np.concatenate([alt_cnt, m_alt])
        ref_cnt = np.concatenate([ref_cnt, m_dep - m_alt])
        depth32 = np.concatenate([depth32, m_dep])
        is_het = np.concatenate([is_het, np.ones(len(markers), bool)])
        mark = np.concatenate([mark, np.ones(len(markers), bool)])
        out_read = np.concatenate([out_read,
                                   np.array(m_obs_read, np.int32)])
        out_snp = np.concatenate([out_snp, np.array(m_obs_snp, np.int32)])
        out_allele = np.concatenate([out_allele,
                                     np.array(m_obs_allele, np.int8)])
        order = np.argsort(snp_pos, kind="stable")
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        snp_pos, ref_base, alt_base = snp_pos[order], ref_base[order], alt_base[order]
        alt_cnt, ref_cnt, depth32 = alt_cnt[order], ref_cnt[order], depth32[order]
        is_het, mark = is_het[order], mark[order]
        out_snp = rank[out_snp].astype(np.int32)

    return PileupResult(
        snp_pos=snp_pos, ref_base=ref_base,
        alt_base=alt_base, ref_count=ref_cnt.astype(np.int32),
        alt_count=alt_cnt.astype(np.int32),
        depth=depth32, is_het=is_het,
        obs_read=out_read, obs_snp=out_snp,
        obs_allele=out_allele, read_names=names, marker=mark,
        read_span=np.array(rec_span, np.int64).reshape(-1, 2))


def _build_sv_markers(rec_span: list[tuple[int, int]],
                      rec_events: list[tuple],
                      dense_ivals: list[tuple[int, int]],
                      cfg: PhasingConfig) -> list[tuple[int, list]]:
    """Het SV columns for the MEC phaser: [(pos, [(read_idx, allele)])].

    Two marker classes, both invisible to longshot (it models SNVs only):

    * indel markers — ≥ marker_min_len read-CIGAR indels clustered by
      (type, shift ≤ marker_max_shift, size-sim ≥ 0.5); carrier reads hold
      the alt allele, clean spanning reads the ref allele.
    * soup markers — a dense-mismatch interval (het inversion alignment
      soup, the same intervals the SNP dense filter masks) separates reads
      by small-indel event count inside it.

    A marker must look het (carrier fraction in [min_frac, max_frac], ≥
    min_carriers and ≥ min_refs) — hom SVs separate nothing and would just
    burn a column.  Reads phased by these columns partition correctly
    around het SVs in het-SNP deserts, which is what keeps the het allele
    alive through assembly consensus."""
    n = len(rec_span)
    if n == 0:
        return []
    starts = np.array([s for s, _ in rec_span], np.int64)
    ends = np.array([e for _, e in rec_span], np.int64)
    out: list[tuple[int, list]] = []

    # platform noise model: total events/bp and indel events/bp — the
    # clean/carrier gates must sit relative to these, or the markers are
    # HiFi-only (at CLR's 13.5% total error every read fails a fixed
    # "≤1 small event per 100bp" cleanliness test and no marker ever
    # forms — het SVs in het-SNP deserts then die in assembly consensus)
    er = cfg.error_rate or 0.0
    noise = 1.5 * er                 # subs + indels per bp
    indel_noise = 0.5 * er
    clean_cap = max(1, int(2 * indel_noise * 100))   # ±50bp window

    def in_dense(p: int) -> bool:
        return any(a <= p <= b for a, b in dense_ivals)

    # per-read large-event position lists for the 'clean read' test
    big_pos: list[np.ndarray] = []
    for ep, el, _ed, _mm in rec_events:
        big_pos.append(ep[el >= cfg.marker_min_len])

    def is_clean_at(r: int, pos: int) -> bool:
        """A ref observation needs a CLEAN alignment at the locus: no big
        event nearby AND at most ~2× the platform's expected small-indel
        count within ±50bp.  A carrier whose alignment hid the event as
        soup/shifted ops otherwise lands on the ref side and poisons the
        MEC column (a false 'two sub-haplotypes' signal — the round-4
        regression where markers at nested DELs split one haplotype in
        half)."""
        if len(big_pos[r]) and \
                (np.abs(big_pos[r] - pos) <= 300).any():
            # representation lottery: the same event can surface hundreds
            # of bp away in another read's alignment — wide exclusion
            return False
        ep = rec_events[r][0]
        return int(np.count_nonzero(np.abs(ep - pos) <= 50)) <= clean_cap

    ev = []
    for ridx, (ep, el, ed, _mm) in enumerate(rec_events):
        big = el >= cfg.marker_min_len
        for p, l, d in zip(ep[big], el[big], ed[big]):
            ev.append((int(d), int(p), int(l), ridx))
    ev.sort()
    used = np.zeros(len(ev), bool)
    for i in range(len(ev)):
        if used[i]:
            continue
        d0, p0, l0, r0 = ev[i]
        used[i] = True
        members = [(p0, l0, r0)]
        for j in range(i + 1, len(ev)):
            dj, pj, lj, rj = ev[j]
            if dj != d0 or pj - p0 > cfg.marker_max_shift:
                break
            if used[j]:
                continue
            if min(lj, l0) / max(lj, l0) >= 0.5:
                members.append((pj, lj, rj))
                used[j] = True
        pos = int(np.median([p for p, _l, _r in members]))
        if in_dense(pos):
            # inside an inversion-soup interval carrier alignments are
            # unreliable either way — the soup marker owns this region
            continue
        carriers = {r for _p, _l, r in members}
        span = np.nonzero((starts <= pos - 50) & (ends >= pos + 50))[0]
        refs = [int(r) for r in span
                if r not in carriers and is_clean_at(int(r), pos)]
        nc, nr = len(carriers), len(refs)
        frac = nc / max(nc + nr, 1)
        if (nc >= cfg.marker_min_carriers and nr >= cfg.marker_min_refs
                and cfg.marker_min_frac <= frac <= cfg.marker_max_frac):
            out.append((pos, [(int(r), -1) for r in sorted(carriers)]
                        + [(r, 1) for r in refs]))

    for a, b in dense_ivals:
        if b - a < 50:
            continue
        # PARTIAL overlaps count too: a read ending inside the soup is
        # still allele-informative over its overlapped stretch, and those
        # are exactly the reads that otherwise stay unphased (double-
        # assigned) and contaminate the assembly bins around a het SV
        ov_arr = np.minimum(ends, b) - np.maximum(starts, a)
        need = min(150, b - a)           # small soup → spanning reads only
        cand_r = np.nonzero(ov_arr >= need)[0]
        obs = []
        nc = nr = 0
        for r in cand_r:
            r = int(r)
            lo, hi = max(int(starts[r]), a), min(int(ends[r]), b)
            ov = hi - lo
            ep, _el, _ed, mm = rec_events[r]
            # soup = small indels AND mismatches (a short inversion shows
            # mostly mismatch columns)
            cnt = int(np.count_nonzero((ep >= lo) & (ep <= hi))) \
                + int(np.count_nonzero((mm >= lo) & (mm <= hi)))
            # thresholds sit relative to platform noise: an inversion
            # interior runs at ~0.5+ events/bp regardless of platform,
            # while background is `noise` events/bp — carrier needs a
            # clear excess over noise, clean must sit within it.  The
            # low-noise floors (0.05 / 0.01) are the tuned HiFi constants;
            # the noise terms only take over at CLR/ONT error rates
            if cnt >= max(cfg.marker_soup_events,
                          int(max(0.05, 2 * noise + 0.03) * ov)):
                obs.append((r, -1))
                nc += 1
            elif cnt <= max(1, int(max(0.01, 1.3 * noise + 0.005) * ov)) \
                    and ov >= min(200, b - a):
                obs.append((r, 1))
                nr += 1
        frac = nc / max(nc + nr, 1)
        if (nc >= cfg.marker_min_carriers and nr >= cfg.marker_min_refs
                and cfg.marker_min_frac <= frac <= cfg.marker_max_frac):
            out.append(((a + b) // 2, obs))
    return out
