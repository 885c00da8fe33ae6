"""k-mer hashing and dense counting — torch integer ops on the caller's
device.

Replaces the reference's pure-Python hot loops (SURVEY.md §3.1):
  * HashSeq.py:74-117      — per-read k-mer integer hashing (k=12, joblib)
  * count_kmer_v1.py:32-146 — per-haplotype Counter-of-kmers map/reduce

Design: 2-bit codes → rolling 2k-bit integer hashes as a sum of k shifted
code vectors (static unroll over k), then dense 4^k count tables via
scatter-add (`index_add_`).  k=12 → 4^12 = 16.7M int32 = 67MB, resident on
the card; per-haplotype tables live on the device and the 4-way overlap
vote of the read-partition stage
(get_raw_kmer_overlap_count_unphased_est_pbs_v1.py) becomes gathers and
sums.  Every function here is integer arithmetic, so the card, the CPU and
the reference package's jitted versions give equal outputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .pack import CODE_N

_BIG = 1 << 30        # sort key of invalid windows (distinct_runs)


def kmer_hashes_np(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Host/numpy rolling k-mer hashes.

    codes: (L,) int8.  Returns (hashes (L-k+1,) int64, valid (L-k+1,) bool)
    where valid marks windows free of N."""
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    c = codes.astype(np.int64)
    h = np.zeros(n, np.int64)
    bad = np.zeros(n, bool)
    for j in range(k):
        cj = c[j : j + n]
        h = (h << 2) | (cj & 3)
        bad |= cj == CODE_N
    return h, ~bad


def kmer_hashes(codes: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched rolling k-mer hashes on codes' device.

    codes: (B, L) int8 (padded with CODE_N).  Returns
    (hashes (B, L-k+1) int32 for k<=15, valid (B, L-k+1) bool)."""
    B, L = codes.shape
    n = L - k + 1
    c = codes.to(torch.int32)
    h = torch.zeros((B, n), dtype=torch.int32, device=codes.device)
    bad = torch.zeros((B, n), dtype=torch.bool, device=codes.device)
    for j in range(k):
        cj = c[:, j:j + n]
        h = (h << 2) | (cj & 3)
        bad = bad | (cj == CODE_N)
    return h, ~bad


def canonical_hashes(hashes: torch.Tensor, k: int) -> torch.Tensor:
    """min(h, revcomp(h)) — strand-canonical k-mer hash.  The reference's
    uint32 arithmetic is carried in int64 (no value exceeds 2k <= 32 bits),
    then wrapped to int32 as its astype does."""
    h = hashes.to(torch.int64) & 0xFFFFFFFF
    # complement: code ^ 3 for every 2-bit field
    comp = h ^ ((1 << (2 * k)) - 1)
    # reverse the k 2-bit fields
    rc = torch.zeros_like(h)
    for _ in range(k):
        rc = (rc << 2) | (comp & 3)
        comp = comp >> 2
    return torch.minimum(h, rc).to(torch.int32)


def count_kmers_dense(hashes: torch.Tensor, valid: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Dense 4^k k-mer count table via `index_add_`.

    hashes/valid: (B, n).  Returns (4^k,) int32 counts.  Invalid windows
    add 0 and hashes outside [0, 4^k) are dropped, as the reference's
    `mode="drop"` scatter does."""
    size = 4**k
    flat = hashes.reshape(-1).to(torch.int64)
    inside = (flat >= 0) & (flat < size)
    w = (valid.reshape(-1) & inside).to(torch.int32)
    table = torch.zeros(size, dtype=torch.int32, device=hashes.device)
    return table.index_add_(0, torch.where(inside, flat, 0), w)


def unique_mask(tables: torch.Tensor) -> torch.Tensor:
    """tables: (H, 4^k) counts for H haplotype DBs.  A k-mer is 'unique' to
    hap h if present in h and absent from all others
    (ref: get_unique_kmer at get_raw_kmer_overlap_count…py:57-71).
    Returns (H, 4^k) bool."""
    present = tables > 0
    n_present = present.sum(dim=0, keepdim=True)
    return present & (n_present == 1)


def distinct_runs(hashes: torch.Tensor, valid: torch.Tensor):
    """Per-row distinct k-mer view: sort each row, mark first occurrences,
    compute multiplicities — the device replacement for the reference's
    per-read `Counter` (get_raw_kmer_overlap…py count_overlap:43-49).

    hashes/valid: (B, n).  Returns (sorted_h (B,n) int32 with invalid rows
    pushed to the end as 2^30, first (B,n) bool, runlen (B,n) int32)."""
    B, n = hashes.shape
    dev = hashes.device
    big = torch.tensor(_BIG, dtype=torch.int32, device=dev)
    h = torch.where(valid, hashes, big)
    s = torch.sort(h, dim=1).values
    first = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                       s[:, 1:] != s[:, :-1]], dim=1)
    first = first & (s != big)
    # run length of each first occurrence = next boundary - index
    idx = torch.arange(n, dtype=torch.int32, device=dev)[None, :].expand(B, n)
    # boundary index of the *next* first occurrence (or n)
    nxt = torch.where(first, idx, torch.tensor(n + 1, dtype=torch.int32,
                                               device=dev))
    nxt = torch.cat([nxt[:, 1:], torch.full((B, 1), n, dtype=torch.int32,
                                            device=dev)], dim=1)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
    # count of valid entries per row caps the final run
    nvalid = valid.sum(dim=1, keepdim=True, dtype=torch.int32)
    runlen = torch.clamp(torch.minimum(nxt, nvalid) - idx, min=0)
    return s, first, runlen


def overlap_scores(sorted_h: torch.Tensor, first: torch.Tensor,
                   runlen: torch.Tensor, tables: torch.Tensor,
                   unique: torch.Tensor) -> torch.Tensor:
    """4-way (or H-way) unique-k-mer overlap vote.

    score[b, j] = Σ_{distinct k of read b present & unique in table j}
                  (R_b[k] + table_j[k])   — get_raw_kmer_overlap…py:43-49.

    tables: (H, 4^k) counts; unique: (H, 4^k) bool.  Returns (B, H) int32."""
    g = torch.clamp(sorted_h, 0, tables.shape[1] - 1).to(torch.int64)
    t = tables[:, g]                     # (H, B, n)
    u = unique[:, g]                     # (H, B, n)
    w = (first & (runlen > 0))[None, :, :]
    contrib = torch.where(u & w, runlen[None, :, :] + t, 0)
    return contrib.sum(dim=2, dtype=torch.int32).T.contiguous()


def count_kmers_dense_np(codes_list, k: int) -> np.ndarray:
    """Host version for small inputs."""
    table = np.zeros(4**k, np.int64)
    for codes in codes_list:
        h, v = kmer_hashes_np(np.asarray(codes), k)
        np.add.at(table, h[v], 1)
    return table
