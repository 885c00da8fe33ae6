"""Multi-process pipeline execution: query sharding, shared-FS exchange,
cross-process gathers.

The reference's WGS story is N independent jobs over a shared filesystem
whose per-chromosome outputs are concatenated and then band-passed against
the *global* coverage median (volcanosv-vc-large-indel.py:266-278 +
filter_vcf_by_sig_cov_insdel.py:38-55, Merge_VCF.py).  Here every process
is one `torch.distributed` rank (parallel.mesh.init_multihost) and the
same joins become:

  * `gather_across_processes` — the WGS rel_cov union: every rank
    contributes its OWN chromosomes' vectors (per-rank-distinct data) and
    gets back the identical global array (gloo all_gather of host
    tensors, padded to the max local size).
  * `exchange_by_chrom`       — the alignment-record all-to-all: each rank
    aligns a contiguous 1/P slice of the query set against the (replicated)
    full-reference index, then per-chromosome record lists are exchanged
    over the shared filesystem (the reference's cluster medium) so each
    rank receives exactly its owned chromosomes' records.  Concatenating
    parts in rank order and stable-sorting by position reproduces the
    single-process record order byte-for-byte (contiguous slices preserve
    global query order on ties).
  * `barrier`                 — a fence of the gloo group between the
    produce and consume sides of an exchange.

All helpers are identity/no-op when running single-process, so the serial
and distributed paths share one driver code path.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist


def n_processes() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_id() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_rank0() -> bool:
    return process_id() == 0


def barrier(name: str) -> None:
    """Global fence across all processes (no-op single-process).  `name`
    labels the fence at its call site, as the reference's named sync
    does."""
    if n_processes() > 1:
        from .mesh import host_group
        dist.barrier(group=host_group())


def shard_interval(n: int, pid: int | None = None,
                   n_procs: int | None = None) -> tuple[int, int]:
    """This process's contiguous [lo, hi) slice of an n-item work list.

    Contiguous (not round-robin) so that concatenating per-process outputs
    in pid order restores the original global item order — the property
    exchange_by_chrom's tie-breaking relies on."""
    p = process_id() if pid is None else pid
    P = n_processes() if n_procs is None else n_procs
    return (n * p) // P, (n * (p + 1)) // P


def gather_across_processes(values: np.ndarray) -> np.ndarray:
    """Union of every process's local float32 vector, ordered by process id.

    Identity when single-process.  This is the collective behind the
    WGS-global coverage median under per-rank-distinct chromosome shards:
    lengths are allgathered first, vectors are padded to the max and
    allgathered, and the valid prefixes are concatenated — every process
    returns the identical global array.  Every process MUST call this the
    same number of times (it is a collective)."""
    v = np.asarray(values, np.float32).reshape(-1)
    P = n_processes()
    if P == 1:
        return v
    from .mesh import host_group
    group = host_group()
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(P)]
    dist.all_gather(sizes, torch.tensor([v.size], dtype=torch.int64),
                    group=group)
    sizes = [int(s) for s in sizes]
    s_max = max(sizes)
    if s_max == 0:
        return np.zeros(0, np.float32)
    pad = torch.zeros(s_max, dtype=torch.float32)
    pad[: v.size] = torch.from_numpy(v)
    allv = [torch.empty(s_max, dtype=torch.float32) for _ in range(P)]
    dist.all_gather(allv, pad, group=group)
    return np.concatenate([allv[p][: sizes[p]].numpy() for p in range(P)])


def _atomic_pickle(path: str, obj) -> None:
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        pickle.dump(obj, fh, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def broadcast_from_rank0(obj, out_dir: str, tag: str):
    """Rank 0 computes once; every other process loads its pickle after
    the barrier (the WGS-global complex-SV stage runs once, not once per
    rank).  Single-process: identity.  Non-rank-0 callers pass obj=None."""
    P = n_processes()
    if P == 1:
        return obj
    xch = os.path.join(out_dir, "xch")
    os.makedirs(xch, exist_ok=True)
    path = os.path.join(xch, f"{tag}_P{P}_bcast.pkl")
    if is_rank0():
        _atomic_pickle(path, obj)
    barrier(f"bcast:{tag}")
    if is_rank0():
        return obj
    with open(path, "rb") as fh:
        return pickle.load(fh)


def exchange_by_chrom(local: dict[str, list], out_dir: str, tag: str,
                      want: list[str] | None = None,
                      sort_key=lambda r: r.pos) -> dict[str, list]:
    """All-to-all of per-chromosome object lists over the shared filesystem.

    Each process contributes `local` (its query slice's records grouped by
    chromosome); after the barrier each process loads every part and keeps
    the chromosomes in `want` (None = all).  Parts concatenate in process
    order and stable-sort by `sort_key`, so ties keep global query order
    (see shard_interval).  Single-process: pure dict filter, no I/O."""
    P = n_processes()
    if P == 1:
        if want is None:
            return local
        return {c: local.get(c, []) for c in want}
    xch = os.path.join(out_dir, "xch")
    os.makedirs(xch, exist_ok=True)
    mine = os.path.join(xch, f"{tag}_P{P}_p{process_id()}.pkl")
    _atomic_pickle(mine, local)
    barrier(f"xch:{tag}")
    merged: dict[str, list] = {c: [] for c in (want or [])}
    for p in range(P):
        with open(os.path.join(xch, f"{tag}_P{P}_p{p}.pkl"), "rb") as fh:
            part = pickle.load(fh)
        for c, recs in part.items():
            if want is not None and c not in merged:
                continue
            merged.setdefault(c, []).extend(recs)
    for c in merged:
        merged[c].sort(key=sort_key)            # stable → query-order ties
    return merged
