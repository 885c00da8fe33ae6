"""Peaks of the card and the least time of a `banded_dp` call: a frozen copy
of chip_smoke.py's `HBM_BYTES_PER_S`, `INT32_OPS_PER_S`, `FP32_OPS_PER_S`,
`DP_OPS_PER_CELL`, `_bound` and `_dp_bound` at commit 656570a.

The peaks are those of one H100 SXM at its 700 W limit, from its
architecture and not from a measurement: HBM3 at the published 3.35 TB/s;
int32 at 132 SMs x 64 int32 lanes x 1.98 GHz (the boost clock); fp32
outside the tensor cores at 132 SMs x 128 lanes x 1.98 GHz, one operation
a lane a cycle.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_OPS_PER_S = 132 * 128 * 1.98e9

# int32 operations of one DP cell, counted from the recurrence of the
# port's plain DP (ops/banded_align.py::banded_dp_plain); an add, max,
# compare or select counts one.  Affine, score only (13): the match compare
# and the substitution select; E = max(H_up + go + ge, E_up + ge) (3);
# Htmp = max(H_diag + sub, E) (2); F: Htmp - ge*l, the running prefix max,
# + ge*l + go (3); H = max(Htmp, F) (1); the band masks of H and E (2).  A
# traceback adds the E-open, up, F-open (an add and a compare) and left
# tests and two to merge them into the byte (7).  Dual-affine adds E2, its
# prefix F2 and their maxes and mask (9), and with a traceback their four
# tests and one merge (7).  Edit distance (go = 0, one gap class), the least
# its recurrence needs (5): the match compare and the add of the
# substitution to H_diag (2); E = H_up + ge (1); Htmp = max(H_diag + sub,
# E) (1); one max for F and H (1).  Its traceback adds the up, F-open (an
# add and a compare) and left tests and the merge (6).
DP_OPS_PER_CELL = {("edit", False): 5, ("edit", True): 11,
                   ("affine", False): 13, ("affine", True): 20,
                   ("dual", False): 22, ("dual", True): 36}


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = INT32_OPS_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their rate (int32 unless said)."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / ops_per_s * 1e3
    return dict(bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations",
                bytes=int(n_bytes), ops=int(n_ops))


def dp_bound(qlen, tlen, M: int, W: int, d_lo: int, kind: str, tb: bool,
             row0: bool) -> dict:
    """Bound of one banded_dp call on these inputs.  Operations: the band
    cells inside the matrix (rows < qlen, 0 <= j < tlen).  Bytes: each
    query and target byte read once, the lengths, the outputs (score, end
    column, the traceback of rows < qlen, the row-0 profile) written
    once."""
    ql = np.asarray(qlen, np.int64)
    tl = np.asarray(tlen, np.int64)
    B = len(ql)
    rows = np.minimum(np.maximum(ql, 0), M)
    i = np.arange(M, dtype=np.int64)
    j_lo = np.maximum(0, -(i + d_lo))
    cells = 0
    for s in range(0, B, 256):
        hi = np.minimum(W, tl[s:s + 256, None] - i - d_lo)
        n = np.maximum(hi - j_lo, 0) * (i < rows[s:s + 256, None])
        cells += int(n.sum())
    n_bytes = rows.sum() + tl.sum() + 16 * B \
        + (int(rows.sum()) * W if tb else 0) + (4 * M * B if row0 else 0)
    return dict(bound(n_bytes, cells * DP_OPS_PER_CELL[(kind, tb)]),
                cells=cells)
