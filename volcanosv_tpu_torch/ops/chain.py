"""Anchor chaining: minimizer hits → colinear chains (minimap2-equivalent).

The reference gets chains for free from minimap2 (Raw_variant_call.py:46-58).
Here: a windowed chaining DP + greedy non-overlapping backtrack, both in
the C++ native helpers (native/seedchain.cpp).  Multiple chains per query
are kept — split-chain structure is exactly the split-read SV signal the
large-indel caller consumes (extract_sig_from_split at
extract_contig_signature_Hifi.py:307-371).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import AlignConfig
from ..native import get_lib


@dataclass
class Chain:
    """One colinear anchor chain on a single (query, strand)."""
    q_start: int
    q_end: int          # query coords in *forward* orientation, end-exclusive
    t_start: int
    t_end: int          # global target coords, end-exclusive
    strand: int         # +1 / -1
    score: float
    anchors_q: np.ndarray   # anchor query starts (strand-oriented coords)
    anchors_t: np.ndarray   # anchor target starts
    n_anchors: int = 0

    def __post_init__(self):
        self.n_anchors = len(self.anchors_q)


def seed_chain_batch(code_list: list[np.ndarray], index, cfg: AlignConfig,
                     max_chains: int = 64, max_hits: int = 64,
                     max_pred: int = 48,
                     select: tuple[int, float] | None = None,
                     ) -> list[list[Chain]]:
    """Fused native front-end for a BATCH of queries: sketch → index lookup
    → anchor expansion → per-strand chain DP → backtrack in one ctypes call
    (threaded across host cores, GIL released so planning overlaps).  The
    native lib is built at the first call; a failed build raises."""
    lib = get_lib()
    n = len(code_list)
    out: list[list[Chain]] = [[] for _ in range(n)]
    if n == 0:
        return out
    q_off = np.zeros(n + 1, np.int64)
    for i, c in enumerate(code_list):
        q_off[i + 1] = q_off[i] + len(c)
    codes = np.ascontiguousarray(
        np.concatenate(code_list) if n else np.zeros(0, np.int8), np.int8)
    sel_hole, sel_frac = select if select is not None else (0, -1.0)
    res = lib.seed_chain_batch(
        codes, q_off, n, cfg.k, cfg.w,
        index.sorted_hash, index.sorted_pos, index.sorted_strand,
        len(index.sorted_hash), max_hits,
        max_pred, cfg.max_anchor_gap, cfg.chain_bandwidth, 0.05,
        float(cfg.min_chain_score), cfg.min_chain_anchors, max_chains, 0,
        sel_hole, sel_frac)
    r = res.contents
    nc, na = int(r.n_chains), int(r.n_anchors)
    cq = np.ctypeslib.as_array(r.chain_query, (nc + 1,))[:nc].copy()
    cs = np.ctypeslib.as_array(r.chain_strand, (nc + 1,))[:nc].copy()
    sc = np.ctypeslib.as_array(r.chain_score, (nc + 1,))[:nc].copy()
    off = np.ctypeslib.as_array(r.anchor_off, (nc + 1,)).copy()
    aq = np.ctypeslib.as_array(r.aq, (na + 1,))[:na].copy()
    at = np.ctypeslib.as_array(r.at, (na + 1,))[:na].copy()
    lib.seed_chain_free(res)
    if nc:
        # vectorized span extraction (was a per-chain python loop with
        # .min()/.max() — ~30% of warm seed_chain wall on a 1-core host)
        starts = off[:-1]
        qmin = np.minimum.reduceat(aq, starts)
        qmax = np.maximum.reduceat(aq, starts) + cfg.k
        tmin = np.minimum.reduceat(at, starts)
        tmax = np.maximum.reduceat(at, starts) + cfg.k
        qlens = q_off[cq.astype(np.int64) + 1] - q_off[cq.astype(np.int64)]
        neg = cs == -1
        fq_start = np.where(neg, qlens - qmax, qmin)
        fq_end = np.where(neg, qlens - qmin, qmax)
        for ci in range(nc):
            qi = int(cq[ci])
            out[qi].append(Chain(
                q_start=int(fq_start[ci]), q_end=int(fq_end[ci]),
                t_start=int(tmin[ci]), t_end=int(tmax[ci]),
                strand=int(cs[ci]), score=float(sc[ci]),
                anchors_q=aq[off[ci]:off[ci + 1]],
                anchors_t=at[off[ci]:off[ci + 1]]))
    for chains in out:
        chains.sort(key=lambda c: -c.score)
    return out
