"""All-vs-all read overlaps of one read group on the card.

The assembly farm (`assembly/olc.py::_find_overlaps`) finds the dovetail
candidates of a read group with `native/ava.cpp::ava_overlaps`: sketch,
index, anchor expansion, a sort into (target, strand) segments, one best
chain a segment (`chain.cpp::chain_dp`), then '+' before '-' for each
(query, target).  `ava_overlaps` here gives the same eight columns, bit for
bit, with the bulk of that work on the card:

  host   `native/ava_index.cpp`: the reads' minimizers and the
         occurrence-filtered, stably hash-sorted index, as ava.cpp builds
         them, and chain_dp's gap costs for gaps 0..bandwidth as a table
         (the card's log2f and an FMA contraction would move scores in
         the last bit);
  card   `csrc/ava.cu`: a thread a query minimizer finds its index run
         (`ava_hits_kernel`), counts its anchors into a dense table of
         (query, target, strand) segments (`ava_count_kernel`) and, after
         a scan, scatters each anchor as one 64-bit key (target pos, query
         pos) into its segment (`ava_scatter_kernel`): the segment is the
         leading part of ava.cpp's sort order, so no global sort is
         needed.  A block a segment sorts its keys in shared memory
         (`ava_sort_kernel`; in place in device memory past 28,672
         anchors), then a warp a segment runs the chain DP
         (`ava_dp_kernel`), its lanes over the 16 predecessors, ties to
         the nearest as chain_dp's strict `>` going down, `(f[j] + m) -
         cost` in that order without contraction; each anchor's chain
         start and length ride along, so the first maximum's chain and
         the gates need no walk back;
  glue   numpy on the host: the segment table's scan, the segment
         lists, the chunk plan, the '+'-over-'-' pick and the compaction
         in ava.cpp's order (query, then target); torch ops on the card
         would map each op family's kernels into the host process at
         first use, about 0.35 GB of host RSS that the rest of a job
         never needs.

Queries are cut into chunks whose anchors (`max_anchors`) and segment
counters (`max_segments`) stay within a budget, from the per-query anchor
counts of the first kernel.

Source note: the pass replaces no TPU kernel.  The JAX package runs the
same C++ (`volcanosv_tpu/native/ava.cpp`) on the host; on the card the
anchors of a 250 kb haplotype group (about 15.7 M of them) are written
and read a few times and tested against 16 predecessors each, so the pass
is bound by the DP's serial chain within a segment and by memory traffic
around it; the design sorts each segment in shared memory, keeps the DP's
window of predecessors in registers (shuffled one lane a step) with the
next 32 keys loading meanwhile, and runs every segment of a chunk at
once, a warp each.

`_ava_chunk_plain` is the plain PyTorch version of the card's part,
vectorised across segments, one step of the DP at a time; the wrapper
takes it for the CPU, the kernels for CUDA (no fallback).  On the CPU the
farm keeps calling ava.cpp itself; the plain version serves the tests and
`chip_smoke.py`.  `ava_overlaps.launches` counts the card's passes that
launched kernels (a group without minimizers launches none), and
`.shapes` holds (reads, minimizers, anchors, chunks, segments past shared
memory) of each call on the card.
"""
from __future__ import annotations

import numpy as np
import torch

# ava_overlaps_np's fixed arguments (native/__init__.py)
MAX_HITS = 64
MAX_PRED = 16
GAP_SCALE = 0.05
# a pass's budget: anchors (8-byte keys) and (query, target, strand)
# segment counters held at once
MAX_ANCHORS = 64 << 20
MAX_SEGMENTS = 4 << 20
# the sort kernel's classes by segment size: the keys a block holds in
# shared memory (8 bytes each); larger segments sort in place in device
# memory
SMEM_CAPS = (1024, 4096, 8192, 28672)
_COLS = ("a", "b", "strand", "score", "q_start", "q_end", "t_start", "t_end")


def _params(acfg) -> dict:
    return dict(k=int(acfg.k), max_hits=MAX_HITS, max_pred=MAX_PRED,
                max_gap=int(min(acfg.max_anchor_gap, 2**31 - 1)),
                bandwidth=int(acfg.chain_bandwidth),
                min_score=float(acfg.min_chain_score),
                min_anchors=int(acfg.min_chain_anchors))


def _empty_columns() -> tuple:
    return (np.zeros(0, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.int8), np.zeros(0, np.float32),
            *(np.zeros(0, np.int64) for _ in range(4)))


def _upload(ix: dict, qlen: np.ndarray, costs: np.ndarray, dev) -> dict:
    n = len(qlen)
    min_read = np.repeat(np.arange(n, dtype=np.int32),
                         np.diff(ix["min_off"]))

    def put(a, dt=None):
        # a copy on the CPU too: the views' buffers are freed after this
        t = torch.from_numpy(a if dt is None else a.view(dt))
        return t.clone() if dev.type == "cpu" else t.to(dev)

    return dict(min_hash=put(ix["min_hash"], np.int32),
                min_read=put(min_read), min_pos=put(ix["min_pos"]),
                min_strand=put(ix["min_strand"]),
                idx_hash=put(ix["idx_hash"], np.int32),
                idx_read=put(ix["idx_read"]), idx_pos=put(ix["idx_pos"]),
                idx_strand=put(ix["idx_strand"]), qlen=put(qlen),
                costs=put(costs))


def plan_chunks(per_query: np.ndarray, n_reads: int, max_anchors: int,
                max_segments: int) -> list[tuple[int, int]]:
    """Cut queries 0..n-1 into [q0, q1) chunks, in order, whose anchors
    stay within `max_anchors` and whose segment counters (queries x reads
    x 2) within `max_segments`; a query alone may pass either."""
    chunks = []
    q0, held = 0, 0
    for q in range(n_reads):
        a = int(per_query[q])
        if q > q0 and (held + a > max_anchors
                       or (q + 1 - q0) * n_reads * 2 > max_segments):
            chunks.append((q0, q))
            q0, held = q, 0
        held += a
    if n_reads:
        chunks.append((q0, n_reads))
    return chunks


# ---------------------------------------------------------------- plain

def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


def _hits_plain(T: dict, p: dict, moff: np.ndarray):
    """Each query minimizer's index run (lo, cap) and each query's anchors
    (the non-self hits), numpy."""
    ih, mh = _u32(T["idx_hash"]), _u32(T["min_hash"])
    lo = torch.searchsorted(ih, mh, side="left")
    cap = (torch.searchsorted(ih, mh, side="right") - lo).clamp(
        max=p["max_hits"])
    m, j = _expand(lo, cap)
    own = T["idx_read"][j] != T["min_read"][m]
    nh = torch.zeros(len(lo), dtype=torch.int64, device=lo.device)
    nh.index_add_(0, m, own.to(torch.int64))
    cs = np.concatenate([[0], np.cumsum(nh.cpu().numpy())])
    return lo, cap, cs[moff[1:]] - cs[moff[:-1]]


def _expand(lo: torch.Tensor, cap: torch.Tensor, m0: int = 0):
    """(minimizer, index entry) of every hit of minimizers m0.. in turn."""
    m = torch.repeat_interleave(
        torch.arange(len(cap), device=cap.device), cap)
    first = torch.cumsum(cap, 0) - cap
    j = lo[m] + (torch.arange(len(m), device=cap.device) - first[m])
    return m + m0, j


def _ava_chunk_plain(T: dict, p: dict, hits, q0: int, q1: int, m0: int,
                     m1: int, n: int):
    """The chunk's per-segment results (ok, score, q of the chain's first
    and last anchor, t of both), segment s = ((q - q0) * n + t) * 2 +
    ('+'), in torch ops."""
    lo, cap, _nh = hits
    dev = lo.device
    n_seg = (q1 - q0) * n * 2
    m, j = _expand(lo[m0:m1], cap[m0:m1], m0)
    q = T["min_read"][m].to(torch.int64)
    t = T["idx_read"][j].to(torch.int64)
    keep = t != q
    m, j, q, t = m[keep], j[keep], q[keep], t[keep]
    plus = T["idx_strand"][j] == T["min_strand"][m]
    pos = T["min_pos"][m].to(torch.int64)
    qp = torch.where(plus, pos,
                     T["qlen"][q].to(torch.int64) - p["k"] - pos)
    tl = T["idx_pos"][j].to(torch.int64)
    seg = ((q - q0) * n + t) * 2 + plus.to(torch.int64)
    key = (tl << 32) | qp
    order = torch.argsort(key, stable=True)
    order = order[torch.argsort(seg[order], stable=True)]
    seg, key = seg[order], key[order]
    counts = torch.bincount(seg, minlength=n_seg)
    start = torch.cumsum(counts, 0) - counts
    res = _empty_results(n_seg)
    segs = torch.nonzero(counts >= max(p["min_anchors"], 1)).flatten()
    if len(segs) == 0:
        return res
    ns = counts[segs]
    ns_h = ns.cpu().numpy()
    res["past_smem"] = int((ns_h > SMEM_CAPS[-1]).sum())
    S = len(segs)
    # the chosen segments' anchors, compacted; cst: a segment's first
    own = torch.repeat_interleave(torch.arange(S, device=dev), ns)
    cst = torch.cumsum(ns, 0) - ns
    local = torch.arange(len(own), device=dev) - cst[own]
    kk = key[start[segs][own] + local]
    tt, qq = kk >> 32, kk & 0xFFFFFFFF
    f = torch.zeros(len(kk), dtype=torch.float32, device=dev)
    pre = torch.full((len(kk),), -1, dtype=torch.int64, device=dev)
    # segments longest first, so that step i's segments are a prefix
    by_len = torch.argsort(ns, descending=True, stable=True)
    st_sorted = cst[by_len]
    active = np.sort(ns_h)[::-1].copy()
    kf = float(p["k"])
    costs = T["costs"]
    for i in range(int(active[0])):
        A = int(np.searchsorted(-active, -i, side="left"))
        ci = st_sorted[:A] + i
        P = min(p["max_pred"], i)
        if P == 0:
            f[ci] = kf
            continue
        jp = ci[:, None] - 1 - torch.arange(P, device=dev)[None, :]
        dt = tt[ci][:, None] - tt[jp]
        dq = qq[ci][:, None] - qq[jp]
        gap = (dt - dq).abs()
        ok = (dq > 0) & (dt > 0) & (dq <= p["max_gap"]) & \
            (dt <= p["max_gap"]) & (gap <= p["bandwidth"])
        mm = torch.minimum(torch.minimum(dq, dt),
                           torch.full_like(dq, p["k"])).to(torch.float32)
        sc = (f[jp] + mm) - costs[gap.clamp(0, p["bandwidth"])]
        sc = torch.where(ok, sc, torch.full_like(sc, -float("inf")))
        best, arg = sc.max(dim=1)     # the first maximum: the nearest j
        take = best > kf
        f[ci] = torch.where(take, best, torch.full_like(best, kf))
        pre[ci] = torch.where(take, i - 1 - arg, torch.full_like(arg, -1))
    # the first maximum of each segment, the walk back to its start
    fmax = torch.full((S,), -float("inf"), device=dev).scatter_reduce(
        0, own, f, "amax")
    big = torch.full_like(local, 2**62)
    best_i = torch.full((S,), 2**62, dtype=torch.int64, device=dev)
    best_i = best_i.scatter_reduce(
        0, own, torch.where(f == fmax[own], local, big), "amin")
    x, first, cnt = best_i.clone(), best_i.clone(), torch.zeros_like(best_i)
    while True:
        live = x >= 0
        if not bool(live.any()):
            break
        first = torch.where(live, x, first)
        cnt += live.to(torch.int64)
        x = torch.where(live, pre[cst + x.clamp(min=0)], x)
    fb = f[cst + best_i]
    segs = segs.cpu().numpy()
    for c, v in (("ok", (cnt >= p["min_anchors"]) & (fb >= p["min_score"])),
                 ("score", fb), ("qs0", qq[cst + first]),
                 ("qs1", qq[cst + best_i]), ("ts0", tt[cst + first]),
                 ("ts1", tt[cst + best_i])):
        res[c][segs] = v.cpu().numpy()
    return res


def _empty_results(n_seg: int) -> dict:
    """Per-segment results (numpy), and the count of segments past shared
    memory's reach (`past_smem`)."""
    out = dict(past_smem=0, ok=np.zeros(n_seg, np.int8),
               score=np.zeros(n_seg, np.float32))
    for c in ("qs0", "qs1", "ts0", "ts1"):
        out[c] = np.zeros(n_seg, np.int32)
    return out


# ----------------------------------------------------------------- card

def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _hits_card(T: dict, p: dict, moff: np.ndarray):
    """`_hits_plain` by `ava_hits_kernel` and `ava_read_sums_kernel`."""
    from . import cuda_build
    lib = cuda_build.lib("ava")
    n_min = T["min_hash"].numel()
    dev = T["min_hash"].device
    lo, cap, nh = (torch.empty(n_min, dtype=torch.int32, device=dev)
                   for _ in range(3))
    n = len(moff) - 1
    if n_min == 0:
        return lo, cap, np.zeros(n, np.int64)
    rc = lib.ava_hits_launch(
        T["min_hash"].data_ptr(), T["min_read"].data_ptr(), n_min,
        T["idx_hash"].data_ptr(), T["idx_read"].data_ptr(),
        T["idx_hash"].numel(), p["max_hits"], lo.data_ptr(),
        cap.data_ptr(), nh.data_ptr(), _stream(dev))
    cuda_build.check(rc, "ava_hits launch", "ava")
    ava_overlaps.launches += 1
    off = torch.from_numpy(moff).to(dev)
    sums = torch.empty(n, dtype=torch.int64, device=dev)
    rc = lib.ava_read_sums_launch(nh.data_ptr(), off.data_ptr(), n,
                                  sums.data_ptr(), _stream(dev))
    cuda_build.check(rc, "ava_read_sums launch", "ava")
    return lo, cap, sums.cpu().numpy()


def _ava_chunk_card(T: dict, p: dict, hits, q0: int, q1: int, m0: int,
                    m1: int, n: int):
    """`_ava_chunk_plain`'s results from the kernels of csrc/ava.cu."""
    from . import cuda_build
    lib = cuda_build.lib("ava")
    lo, cap, _nh = hits
    dev = lo.device
    st = _stream(dev)
    n_seg = (q1 - q0) * n * 2
    res = _empty_results(n_seg)
    if m1 == m0:
        return res
    counts = torch.zeros(n_seg, dtype=torch.int32, device=dev)
    common = (T["min_read"].data_ptr(), T["min_strand"].data_ptr(),
              lo.data_ptr(), cap.data_ptr(), T["idx_read"].data_ptr(),
              T["idx_strand"].data_ptr())
    rc = lib.ava_count_launch(m0, m1, q0, n, *common, counts.data_ptr(), st)
    cuda_build.check(rc, "ava_count launch", "ava")
    # the segment table's scan and lists on the host (numpy): the table is
    # small beside the anchors, and the card is spared kernels of its own
    # for them
    counts_h = counts.cpu().numpy()
    off_h = np.zeros(n_seg + 1, np.int64)
    np.cumsum(counts_h, out=off_h[1:])
    segs_h = np.nonzero(counts_h >= max(p["min_anchors"], 1))[0]
    ns_h = counts_h[segs_h]
    # longest first: the DP's blocks hold segments of like lengths, and
    # the sort's size classes lie in runs, the largest first
    by_len = np.argsort(-ns_h, kind="stable")
    segs_h, ns_h = segs_h[by_len], ns_h[by_len]
    per_class = np.bincount(np.searchsorted(SMEM_CAPS, ns_h, side="left"),
                            minlength=len(SMEM_CAPS) + 1)
    res["past_smem"] = int(per_class[-1])
    S = len(segs_h)
    if S == 0:
        return res
    off = torch.from_numpy(off_h).to(dev)
    segs = torch.from_numpy(segs_h).to(dev)
    keys = torch.empty(int(off_h[-1]), dtype=torch.int64, device=dev)
    cursor = off[:-1].clone()
    rc = lib.ava_scatter_launch(m0, m1, q0, n, *common,
                                T["min_pos"].data_ptr(),
                                T["idx_pos"].data_ptr(),
                                T["qlen"].data_ptr(), p["k"],
                                cursor.data_ptr(), keys.data_ptr(), st)
    cuda_build.check(rc, "ava_scatter launch", "ava")
    a = 0
    for c in reversed(range(len(per_class))):
        cnt = int(per_class[c])
        if cnt:
            smem_cap = SMEM_CAPS[c] if c < len(SMEM_CAPS) else 0
            rc = lib.ava_sort_launch(segs[a:].data_ptr(), cnt,
                                     off.data_ptr(), counts.data_ptr(),
                                     keys.data_ptr(), smem_cap, st)
            cuda_build.check(rc, "ava_sort launch", "ava")
        a += cnt
    # the DP's results, a slot a listed segment
    out = dict(ok=torch.empty(S, dtype=torch.int8, device=dev),
               score=torch.empty(S, dtype=torch.float32, device=dev))
    for c in ("qs0", "qs1", "ts0", "ts1"):
        out[c] = torch.empty(S, dtype=torch.int32, device=dev)
    rc = lib.ava_dp_launch(
        segs.data_ptr(), S, off.data_ptr(), counts.data_ptr(),
        keys.data_ptr(), T["costs"].data_ptr(), p["k"], p["max_pred"],
        p["max_gap"], p["bandwidth"], p["min_score"], p["min_anchors"],
        *(out[c].data_ptr() for c in ("ok", "score", "qs0", "qs1", "ts0",
                                      "ts1")), st)
    cuda_build.check(rc, "ava_dp launch", "ava")
    for c, v in out.items():
        res[c][segs_h] = v.cpu().numpy()
    return res


# ----------------------------------------------------------------- pass

def _pick(res: dict, qlen: np.ndarray, q0: int, q1: int, n: int,
          k: int) -> list:
    """Per (query, target): the '+' segment's chain where it passed, else
    the '-' one's; in ava.cpp's order (query, then target) and frames."""
    ok = res["ok"].reshape(q1 - q0, n, 2) != 0
    plus = ok[..., 1]
    qi, ti = np.nonzero(plus | ok[..., 0])
    s = plus[qi, ti].astype(np.int64)
    seg = (qi * n + ti) * 2 + s
    qs0 = res["qs0"][seg].astype(np.int64)
    qe = res["qs1"][seg].astype(np.int64) + k
    ql = qlen[q0 + qi].astype(np.int64)
    fwd = s == 1
    return [(q0 + qi).astype(np.int32), ti.astype(np.int32),
            (2 * s - 1).astype(np.int8), res["score"][seg],
            np.where(fwd, qs0, ql - qe), np.where(fwd, qe, ql - qs0),
            res["ts0"][seg].astype(np.int64),
            res["ts1"][seg].astype(np.int64) + k]


def _ava_pass(codes: list, acfg, dev: torch.device, plain: bool,
              max_anchors: int, max_segments: int) -> tuple:
    """The pass on `dev`: the host's index, then each chunk of queries by
    the plain version (`plain`) or the kernels.  Returns (the columns,
    (reads, minimizers, anchors, chunks, segments past shared memory))."""
    from .. import native
    lib = native.get_lib()
    n = len(codes)
    p = _params(acfg)
    costs = native.ava_gap_costs_np(lib, GAP_SCALE, p["bandwidth"])
    qlen = np.array([len(c) for c in codes], np.int32)
    with native.ava_index_views(lib, codes, int(acfg.k), int(acfg.w)) as ix:
        T = _upload(ix, qlen, costs, dev)
        moff = ix["min_off"].copy()
    hits = (_hits_plain if plain else _hits_card)(T, p, moff)
    per_query = hits[2]
    chunks = plan_chunks(per_query, n, max_anchors, max_segments)
    chunk_fn = _ava_chunk_plain if plain else _ava_chunk_card
    cols = []
    past_smem = 0
    for q0, q1 in chunks:
        res = chunk_fn(T, p, hits, q0, q1, int(moff[q0]), int(moff[q1]), n)
        cols.append(_pick(res, qlen, q0, q1, n, p["k"]))
        past_smem += res["past_smem"]
    stats = (n, int(moff[-1]), int(per_query.sum()), len(chunks), past_smem)
    if not cols:
        return _empty_columns(), stats
    out = tuple(np.concatenate([c[i] for c in cols])
                for i in range(len(_COLS)))
    return out, stats


def ava_overlaps(codes: list, acfg, device, max_anchors: int = MAX_ANCHORS,
                 max_segments: int = MAX_SEGMENTS) -> tuple:
    """`native.ava_overlaps_np`'s eight numpy columns (a, b, strand, score,
    q_start, q_end, t_start, t_end) for one read group of 2-bit code
    arrays, bit for bit: the card's pass (csrc/ava.cu) on a CUDA device,
    the plain version on the CPU.  `max_anchors` and `max_segments` bound
    a chunk of queries."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ava_overlaps: unsupported device {dev}")
    out, stats = _ava_pass(codes, acfg, dev, dev.type == "cpu",
                           max_anchors, max_segments)
    if dev.type == "cuda":
        ava_overlaps.shapes.append(stats)
    return out


ava_overlaps.launches = 0
ava_overlaps.shapes = []
