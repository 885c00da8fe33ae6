"""k-mer hashing, dense counting and the read vote of the k-mer partition.

Replaces the reference's pure-Python hot loops (SURVEY.md §3.1):
  * HashSeq.py:74-117      — per-read k-mer integer hashing (k=12, joblib)
  * count_kmer_v1.py:32-146 — per-haplotype Counter-of-kmers map/reduce

Design: 2-bit codes → rolling 2k-bit integer hashes, dense 4^k count
tables (k=12 → 4^12 = 16.7M int32 = 67MB, resident on the card), and the
4-way unique-k-mer overlap vote of the read-partition stage
(get_raw_kmer_overlap_count_unphased_est_pbs_v1.py).  The partition calls
three wrappers, each with a hand-written CUDA kernel (`csrc/kmer.cu`) for
CUDA tensors and a plain torch version for CPU tensors (as has
`canonical_hashes`, which no path calls):

  * `kmer_count_into`  — hash + count of a chunk, into a table in place
                         (plain: `kmer_hashes` + `count_kmers_dense`)
  * `unique_mask`      — present in exactly one table
  * `kmer_vote`        — hash + `distinct_runs` + `overlap_scores` of a
                         chunk of reads

`kmer_hashes`, `_canonical_hashes_plain`, `count_kmers_dense`,
`distinct_runs` and `overlap_scores` are the JAX package's functions as
torch ops.  Every function here is integer arithmetic, so the kernels, the
plain versions and the reference package's jitted versions give equal
outputs.
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


def _canonical_hashes_plain(hashes: torch.Tensor, k: int) -> torch.Tensor:
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


def canonical_hashes(hashes: torch.Tensor, k: int) -> torch.Tensor:
    """min(h, revcomp(h)) of int32 hashes of any shape, in the reference's
    uint32 arithmetic (bits above 2k kept), 1 <= k <= 16; int32 out.  The
    CUDA kernel (`csrc/kmer.cu::canonical_hashes_kernel`, on the current
    stream) for CUDA tensors, `_canonical_hashes_plain` for CPU tensors.
    Each launch appends (numel, k) to `canonical_hashes.shapes`."""
    if not 1 <= k <= 16:
        raise ValueError(f"canonical_hashes: k={k} outside 1..16")
    dev = _check("canonical_hashes",
                 [("hashes", hashes, torch.int32, hashes.dim())])
    if dev == "cpu":
        return _canonical_hashes_plain(hashes, k)
    out = torch.empty_like(hashes)
    n = hashes.numel()
    if n == 0:
        return out
    from . import cuda_build
    with torch.cuda.device(hashes.device):
        rc = cuda_build.lib("kmer").canonical_hashes_launch(
            hashes.data_ptr(), n, k, out.data_ptr(), _stream(hashes))
    cuda_build.check(rc, "canonical_hashes launch", "kmer")
    canonical_hashes.launches += 1
    canonical_hashes.shapes.append((n, k))
    return out


canonical_hashes.launches = 0
canonical_hashes.shapes = []


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


def _unique_mask_plain(tables: torch.Tensor) -> torch.Tensor:
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


def _valid_windows(codes: torch.Tensor, k: int, lens):
    """`kmer_hashes` of codes with validity clipped to w < lens - k + 1
    (where lens is given), as partition.py's `_read_hashes` clips it."""
    h, v = kmer_hashes(codes, k)
    if lens is not None:
        idx = torch.arange(h.shape[1], device=codes.device)[None, :]
        v = v & (idx < (lens.to(torch.int64)[:, None] - k + 1))
    return h, v


def _kmer_count_plain(table, codes, k, lens=None):
    table += count_kmers_dense(*_valid_windows(codes, k, lens), k)
    return table


def _kmer_vote_plain(codes, lens, k, tables, unique):
    h, v = _valid_windows(codes, k, lens)
    return overlap_scores(*distinct_runs(h, v), tables, unique)


def _check(name: str, specs, k: int | None = None) -> str:
    """Raise ValueError unless every (label, tensor, dtype, dim) of specs is
    a contiguous tensor of that dtype and rank on the first one's device,
    and 1 <= k <= 15.  Returns the device type."""
    if k is not None and not 1 <= k <= 15:
        raise ValueError(f"{name}: k={k} outside 1..15")
    dev = specs[0][1].device
    for label, x, dt, dim in specs:
        if not isinstance(x, torch.Tensor) or x.dtype != dt or \
                x.dim() != dim or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name}: {label} must be a contiguous {dim}-d "
                             f"{dt} tensor on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def kmer_count_into(table: torch.Tensor, codes: torch.Tensor, k: int,
                    lens: torch.Tensor | None = None) -> torch.Tensor:
    """table[h] += 1 for each valid window of codes, in place: (B, L) int8
    codes (N = 4 invalid), optional (B,) int32 lengths (windows w <
    lens[b] - k + 1), a (4^k,) int32 table.  The CUDA kernel
    (`csrc/kmer.cu::kmer_count_kernel`, on the current stream) for CUDA
    tensors, `_kmer_count_plain` for CPU tensors.  Returns the table.  Each
    launch appends (B, L, k) to `kmer_count_into.shapes`."""
    specs = [("table", table, torch.int32, 1), ("codes", codes, torch.int8, 2)]
    if lens is not None:
        specs.append(("lens", lens, torch.int32, 1))
    dev = _check("kmer_count_into", specs, k)
    B, L = codes.shape
    if table.numel() != 4**k or lens is not None and lens.shape != (B,):
        raise ValueError(f"kmer_count_into: table {tuple(table.shape)} or "
                         f"lens shape is not (4^{k},), ({B},)")
    if B == 0 or L < k:
        return table
    if dev == "cpu":
        return _kmer_count_plain(table, codes, k, lens)
    from . import cuda_build
    with torch.cuda.device(codes.device):
        rc = cuda_build.lib("kmer").kmer_count_launch(
            codes.data_ptr(), lens.data_ptr() if lens is not None else None,
            B, L, k, table.data_ptr(), _stream(codes))
    cuda_build.check(rc, "kmer_count launch", "kmer")
    kmer_count_into.launches += 1
    kmer_count_into.shapes.append((B, L, k))
    return table


kmer_count_into.launches = 0
kmer_count_into.shapes = []


def unique_mask(tables: torch.Tensor) -> torch.Tensor:
    """(H, 4^k) bool: present in exactly one of the (H, 4^k) int32 tables.
    The CUDA kernel (`csrc/kmer.cu::unique_mask_kernel`, on the current
    stream) for CUDA tensors, `_unique_mask_plain` for CPU tensors.  Each
    launch appends (H, 4^k) to `unique_mask.shapes`."""
    dev = _check("unique_mask", [("tables", tables, torch.int32, 2)])
    if dev == "cpu":
        return _unique_mask_plain(tables)
    H, N = tables.shape
    out = torch.empty((H, N), dtype=torch.bool, device=tables.device)
    if H == 0 or N == 0:
        return out
    from . import cuda_build
    with torch.cuda.device(tables.device):
        rc = cuda_build.lib("kmer").unique_mask_launch(
            tables.data_ptr(), H, N, out.data_ptr(), _stream(tables))
    cuda_build.check(rc, "unique_mask launch", "kmer")
    unique_mask.launches += 1
    unique_mask.shapes.append((H, N))
    return out


unique_mask.launches = 0
unique_mask.shapes = []


def kmer_vote(codes: torch.Tensor, lens: torch.Tensor, k: int,
              tables: torch.Tensor, unique: torch.Tensor) -> torch.Tensor:
    """(B, H) int32 votes of a chunk of reads: score[b, j] = Σ over the
    distinct valid k-mers x of read b with unique[j, x] of (count of x in
    read b + tables[j, x]).  codes (B, L) int8, lens (B,) int32 (windows w
    < lens[b] - k + 1, as `_read_hashes` clips them), tables (H, 4^k)
    int32, unique (H, 4^k) bool.  The CUDA kernel
    (`csrc/kmer.cu::kmer_vote_tile_kernel`, on the current stream) for CUDA
    tensors, `_kmer_vote_plain` for CPU tensors.  Each launch appends
    (B, L, k, H) to `kmer_vote.shapes`."""
    dev = _check("kmer_vote", [("codes", codes, torch.int8, 2),
                               ("lens", lens, torch.int32, 1),
                               ("tables", tables, torch.int32, 2),
                               ("unique", unique, torch.bool, 2)], k)
    B, L = codes.shape
    H = tables.shape[0]
    if lens.shape != (B,) or tables.shape != (H, 4**k) or \
            unique.shape != tables.shape or not 1 <= H <= 32:
        raise ValueError(f"kmer_vote: shapes {tuple(lens.shape)}, "
                         f"{tuple(tables.shape)}, {tuple(unique.shape)} are "
                         f"not ({B},), (H <= 32, 4^{k}), (H, 4^{k})")
    out = torch.zeros((B, H), dtype=torch.int32, device=codes.device)
    if B == 0 or L < k:
        return out
    if dev == "cpu":
        return _kmer_vote_plain(codes, lens, k, tables, unique)
    from . import cuda_build
    lib = cuda_build.lib("kmer")
    n = lib.kmer_vote_scratch_ints(B, L, k, H)
    scratch = torch.empty(n, dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        rc = lib.kmer_vote_launch(
            codes.data_ptr(), lens.data_ptr(), B, L, k, tables.data_ptr(),
            unique.data_ptr(), H, scratch.data_ptr(), n, out.data_ptr(),
            _stream(codes))
    cuda_build.check(rc, "kmer_vote launch", "kmer")
    kmer_vote.launches += 1
    kmer_vote.shapes.append((B, L, k, H))
    return out


kmer_vote.launches = 0
kmer_vote.shapes = []


def count_kmers_dense_np(codes_list, k: int) -> np.ndarray:
    """Host version for small inputs."""
    table = np.zeros(4**k, np.int64)
    for codes in codes_list:
        h, v = kmer_hashes_np(np.asarray(codes), k)
        np.add.at(table, h[v], 1)
    return table
