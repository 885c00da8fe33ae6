"""Minimizer sketching + reference index (replaces minimap2's index).

minimap2 (invoked throughout the reference, e.g. Raw_variant_call.py:49-52)
seeds alignment with (k,w)-minimizers.  We reproduce the scheme:
strand-canonical k-mer hashes, murmur-mixed, windowed minimum; the index is
a *sorted array* of (hash, global_pos, strand) — lookups are searchsorted
(binary search) which vectorizes on host and device alike, instead of a
pointer-chasing hash table.  High-frequency minimizers are masked (like
minimap2's -f occurrence filter).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .pack import CODE_N, encode_seq


def mix32_np(h: np.ndarray) -> np.ndarray:
    """murmur3 finalizer — invertible mix for uniform minimizer selection."""
    h = h.astype(np.uint32)
    h ^= h >> 16
    h = (h * np.uint32(0x85EBCA6B)) & np.uint32(0xFFFFFFFF)
    h ^= h >> 13
    h = (h * np.uint32(0xC2B2AE35)) & np.uint32(0xFFFFFFFF)
    h ^= h >> 16
    return h


def _rolling_hashes_np(codes: np.ndarray, k: int):
    """(fwd, rc, valid) rolling 2k-bit hashes, numpy-vectorized."""
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        z = np.zeros(0, np.uint64)
        return z, z, np.zeros(0, bool)
    c = codes.astype(np.uint64)
    fwd = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    bad = np.zeros(n, bool)
    for j in range(k):
        cj = c[j : j + n]
        fwd = (fwd << np.uint64(2)) | (cj & np.uint64(3))
        rc = rc | (((cj ^ np.uint64(3)) & np.uint64(3)) << np.uint64(2 * j))
        bad |= cj == CODE_N
    return fwd, rc, ~bad


def sketch_np(codes: np.ndarray, k: int, w: int):
    """Minimizers of one sequence (host path, used for the reference index
    and contigs).  Dispatches to the O(L) native monotonic-deque kernel
    (native/sketch.cpp) for k <= 31; the numpy path below serves longer k.

    Returns (pos (M,) int64, hash (M,) uint32, strand (M,) int8) where
    strand=0 if the canonical k-mer is the forward strand."""
    from ..native import get_lib
    if k <= 31:
        lib = get_lib()
        n = max(len(codes) - k + 1, 0)
        if n < w:
            return (np.zeros(0, np.int64), np.zeros(0, np.uint32),
                    np.zeros(0, np.int8))
        pos = np.empty(n, np.int64)
        h = np.empty(n, np.uint32)
        strand = np.empty(n, np.int8)
        m = lib.sketch_dna(np.ascontiguousarray(codes, np.int8), len(codes),
                           k, w, pos, h, strand)
        if m >= 0:
            return pos[:m].copy(), h[:m].copy(), strand[:m].copy()
    fwd, rc, valid = _rolling_hashes_np(codes, k)
    n = len(fwd)
    if n < w:
        return (np.zeros(0, np.int64), np.zeros(0, np.uint32), np.zeros(0, np.int8))
    strand = (rc < fwd).astype(np.int8)
    canon = np.where(strand == 1, rc, fwd)
    # mix to 32 bits (2k<=38 bits: fold)
    h = mix32_np((canon ^ (canon >> np.uint64(29))).astype(np.uint32))
    # palindromic k-mers (fwd==rc) are strand-ambiguous: minimap2 skips them
    ambiguous = fwd == rc
    h_masked = h.astype(np.float64)
    h_masked[~valid | ambiguous] = np.inf
    # sliding window min over w consecutive k-mer starts
    win = np.lib.stride_tricks.sliding_window_view(h_masked, w)
    wmin = win.min(axis=1)
    starts = np.arange(n - w + 1)
    # a position is a minimizer if it achieves the min of any window covering it
    is_min = np.zeros(n, bool)
    # rightmost-min tie-break: mark the last argmin per window (vectorized)
    rev_argmin = w - 1 - np.argmin(win[:, ::-1], axis=1)
    ok = np.isfinite(wmin)
    is_min[starts[ok] + rev_argmin[ok]] = True
    pos = np.nonzero(is_min)[0]
    return pos.astype(np.int64), h[pos], strand[pos]


@dataclass
class MinimizerIndex:
    """Sorted minimizer index over a multi-sequence reference."""
    k: int
    w: int
    names: list[str]
    offsets: np.ndarray          # (n_seq+1,) global coordinate offsets
    sorted_hash: np.ndarray      # (M,) uint32, ascending
    sorted_pos: np.ndarray       # (M,) int64 global positions
    sorted_strand: np.ndarray    # (M,) int8
    max_occ: int = 500

    @staticmethod
    def build(seqs: dict[str, str] | dict[str, np.ndarray], k: int, w: int,
              max_occ_frac: float = 2e-4) -> "MinimizerIndex":
        names = list(seqs)
        offsets = [0]
        all_pos, all_hash, all_strand = [], [], []
        for name in names:
            s = seqs[name]
            codes = encode_seq(s) if isinstance(s, (str, bytes)) else np.asarray(s)
            pos, h, strand = sketch_np(codes, k, w)
            all_pos.append(pos + offsets[-1])
            all_hash.append(h)
            all_strand.append(strand)
            offsets.append(offsets[-1] + len(codes))
        pos = np.concatenate(all_pos) if all_pos else np.zeros(0, np.int64)
        h = np.concatenate(all_hash) if all_hash else np.zeros(0, np.uint32)
        st = np.concatenate(all_strand) if all_strand else np.zeros(0, np.int8)
        order = np.argsort(h, kind="stable")
        h, pos, st = h[order], pos[order], st[order]
        # occurrence filter: drop hashes occurring more than max_occ times
        if len(h):
            uniq, counts = np.unique(h, return_counts=True)
            max_occ = max(10, int(np.quantile(counts, 1.0) if len(counts) < 50
                                  else np.quantile(counts, 1 - max_occ_frac)))
            bad = uniq[counts > max_occ]
            if len(bad):
                keep = ~np.isin(h, bad)
                h, pos, st = h[keep], pos[keep], st[keep]
        else:
            max_occ = 500
        return MinimizerIndex(k, w, names, np.array(offsets, np.int64),
                              h, pos, st, max_occ)

    def global_to_local(self, gpos: np.ndarray):
        """global coords → (seq_idx, local_pos)."""
        idx = np.searchsorted(self.offsets, gpos, side="right") - 1
        return idx, gpos - self.offsets[idx]
