"""Cross-contig call dedup (overlapping phase blocks call the same SV twice).

ref: remove_redundancy.py — pairwise links within a distance window
(INS: dist ≤ 500, size-sim ≥ 0.5, ALT edit-similarity ≥ 0.5;
DEL: dist ≤ 3000, size-sim ≥ 0.1, reciprocal overlap ≥ 0), connected
components, keep the longest SV per component, annotate CollapseId.

Device mapping: the edlib edit-distance calls (remove_redundancy.py:75-81)
become one batched banded-DP launch over all candidate INS pairs
(ops.banded_align with unit costs, on the caller's torch device);
components via union-find on host (replaces networkx).
"""
from __future__ import annotations

import numpy as np

from ..config import RedundancyConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.banded_align import edit_distance_batch_auto, pad_batch_pow2
from ..ops.pack import encode_seq, pad_codes


class _UnionFind:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, x: int) -> int:
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


def _pow2ceil(n: int) -> int:
    p = 64
    while p < n:
        p *= 2
    return p


def edit_distance_pairs(seq_pairs: list[tuple[str, str]],
                        clip_to: int | None = None,
                        device=DEFAULT_DEVICE) -> np.ndarray:
    """Raw edit distance per pair, batched on device (edlib align()
    equivalent).  Banding restricts paths, so the result can only
    OVER-estimate the true distance; with clip_to set, the band is sized so
    any true distance ≤ clip_to is exact — thresholding `dist ≤ clip_to`
    is therefore exact, and larger distances stay conservatively large."""
    device = resolve_device(device)
    if not seq_pairs:
        return np.zeros(0, np.int64)
    out = np.zeros(len(seq_pairs), np.int64)
    buckets: dict[int, list[int]] = {}
    for i, (a, b) in enumerate(seq_pairs):
        m = max(len(a), len(b), 1)
        buckets.setdefault(min(_pow2ceil(m), 16384), []).append(i)
    for L, all_idxs in buckets.items():
        # row cap per dispatch: score-only, but a chromosome-wide call can
        # hold millions of pairs — bound device input bytes per launch
        b_cap = max(1024, (128 << 20) // (2 * L))
        for lo in range(0, len(all_idxs), b_cap):
            idxs = all_idxs[lo:lo + b_cap]
            qs = [encode_seq(seq_pairs[i][0]) for i in idxs]
            ts = [encode_seq(seq_pairs[i][1]) for i in idxs]
            q, qlen = pad_codes(qs, pad_to=L)
            t, tlen = pad_codes(ts, pad_to=L)
            q, t, qlen_p, tlen_p, B = pad_batch_pow2(q, t, qlen, tlen)
            W = min(max(128, _pow2ceil(L // 2 + 64)), 4096)
            if clip_to is not None:
                W = min(max(128, _pow2ceil(2 * clip_to + 64)), W)
            dist = np.asarray(edit_distance_batch_auto(
                q, t, qlen_p, tlen_p, W=W, device=device))[:B]
            out[idxs] = dist
    return out


def edit_sim_batch(seq_pairs: list[tuple[str, str]],
                   device=DEFAULT_DEVICE) -> np.ndarray:
    """(len1+len2-ed)/(len1+len2) per pair, batched on device.

    Band width per length bucket covers the maximum length difference the
    size-sim prefilter admits, so matching (similar) pairs get their exact
    distance; truly dissimilar pairs may be clipped low — which only makes
    them non-matches, same as the reference."""
    device = resolve_device(device)
    if not seq_pairs:
        return np.zeros(0)
    sims = np.zeros(len(seq_pairs))
    buckets: dict[int, list[int]] = {}
    for i, (a, b) in enumerate(seq_pairs):
        m = max(len(a), len(b), 1)
        buckets.setdefault(min(_pow2ceil(m), 16384), []).append(i)
    for L, idxs in buckets.items():
        qs = [encode_seq(seq_pairs[i][0]) for i in idxs]
        ts = [encode_seq(seq_pairs[i][1]) for i in idxs]
        q, qlen = pad_codes(qs, pad_to=L)
        t, tlen = pad_codes(ts, pad_to=L)
        q, t, qlen_p, tlen_p, B = pad_batch_pow2(q, t, qlen, tlen)
        W = min(max(128, _pow2ceil(L // 2 + 64)), 4096)
        dist = np.asarray(edit_distance_batch_auto(
            q, t, qlen_p, tlen_p, W=W, device=device))[:B]
        tot = qlen.astype(np.int64) + tlen.astype(np.int64)
        tot = np.maximum(tot, 1)
        sims[idxs] = (tot - dist) / tot
    return sims


def find_redundant(
    pos: np.ndarray, svlen: np.ndarray, is_del: np.ndarray,
    alt_seqs: list[str], cfg: RedundancyConfig, device=DEFAULT_DEVICE,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (keep_mask, collapse_id) per call; collapse_id -1 when the
    call is in no collapse group."""
    device = resolve_device(device)
    n = len(pos)
    uf = _UnionFind(n)
    order = np.argsort(pos, kind="stable")

    # DEL links: window sweep, no seq comparison
    didx = order[is_del[order]]
    dpos = pos[didx]
    for a in range(len(didx)):
        i = didx[a]
        b = a + 1
        while b < len(didx) and dpos[b] - dpos[a] <= cfg.del_max_dist:
            j = didx[b]
            b += 1
            ssim = min(svlen[i], svlen[j]) / max(svlen[i], svlen[j])
            if ssim < cfg.del_min_size_sim:
                continue
            e_i, e_j = pos[i] + svlen[i], pos[j] + svlen[j]
            ov = (min(e_i, e_j) - max(pos[i], pos[j])) / max(svlen[i], svlen[j])
            if ov >= 0:
                uf.union(i, j)

    # INS candidate pairs by window + size-sim, then batched edit-sim
    iidx = order[~is_del[order]]
    ipos = pos[iidx]
    cand: list[tuple[int, int]] = []
    for a in range(len(iidx)):
        i = iidx[a]
        b = a + 1
        while b < len(iidx) and ipos[b] - ipos[a] <= cfg.ins_max_dist:
            j = iidx[b]
            b += 1
            ssim = min(svlen[i], svlen[j]) / max(svlen[i], svlen[j])
            if ssim >= cfg.ins_min_size_sim:
                cand.append((i, j))
    if cand:
        sims = edit_sim_batch([(alt_seqs[i], alt_seqs[j]) for i, j in cand],
                              device=device)
        for (i, j), sim in zip(cand, sims):
            if sim >= cfg.ins_min_edit_sim:
                uf.union(i, j)

    roots = np.array([uf.find(i) for i in range(n)])
    keep = np.ones(n, bool)
    collapse_id = np.full(n, -1, np.int64)
    next_id_del, next_id_ins = 0, 0
    for r in np.unique(roots):
        members = np.nonzero(roots == r)[0]
        if len(members) < 2:
            continue
        if is_del[members[0]]:
            cid = next_id_del
            next_id_del += 1
        else:
            cid = next_id_ins
            next_id_ins += 1
        collapse_id[members] = cid
        best = members[np.argmax(svlen[members])]
        for m in members:
            if m != best:
                keep[m] = False
    return keep, collapse_id
