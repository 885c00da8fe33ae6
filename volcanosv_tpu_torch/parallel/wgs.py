"""WGS cross-shard collectives: signature merge + global call statistics.

The reference's WGS story is chromosome-aligned shards whose outputs are
file-concatenated (volcanosv-vc-large-indel.py:266-278, Merge_VCF.py) and
whose coverage band-pass uses a *global* per-run median
(filter_vcf_by_sig_cov_insdel.py) — computed after the concat.  Over the
port's genome shards (the ranks of the process group, and the genome rows
of an in-process mesh) the same joins become collectives:

  * `build_sig_merge_step` — all_gather each shard's (pos, svlen) signature
    tensor, sort globally, drop near-duplicate neighbors (the cross-shard
    boundary dedup; match = shift ≤ max_shift ∧ size-sim ≥ min_size_sim,
    same rule as remove_redundancy.py:92-125).
  * `build_global_median_step` — all_gather per-shard rel_cov vectors and
    take the masked global median on the device: the WGS statistic the
    coverage filter bands against.

Values follow the JAX package's dtypes (int32 signatures, float32 values),
so both give the same merge and the same median bits.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import AXES, Mesh, all_gather_device


def _gather_genome(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """all_gather over the genome axis: the rank's (n·S,) local array is
    split into one shard per genome row of its mesh (one shard without
    one), each on its row's first device; the shards of every row of every
    rank, in order, come back as one flat array on the first device."""
    if mesh is None:
        shards = [x]
    else:
        rows = mesh.devices[:, 0]
        shards = [s.to(d) for s, d in zip(x.chunk(len(rows)), rows)]
        x = torch.cat([s.to(rows[0]) for s in shards])
    return all_gather_device(x).reshape(-1)


def _sig_merge_local(pos, svlen, valid, *, max_shift: int,
                     min_size_sim: float, mesh: Mesh | None = None):
    """Per-rank body: gather all shards' sigs, sort, neighbor-dedup."""
    gp = _gather_genome(pos.to(torch.int32), mesh)
    gl = _gather_genome(svlen.to(torch.int32), mesh)
    gv = _gather_genome(valid.to(torch.bool), mesh)
    # sort by (valid desc, pos): invalid rows sink to the end, ties stay in
    # shard order
    key = torch.where(gv, gp, torch.iinfo(torch.int32).max)
    order = torch.sort(key, stable=True).indices
    sp, sl, sv = gp[order], gl[order], gv[order]
    prev_pos = torch.cat([sp[:1] - max_shift - 1, sp[:-1]])
    prev_len = torch.cat([sl[:1], sl[:-1]])
    ssim = torch.minimum(sl, prev_len) / torch.clamp(
        torch.maximum(sl, prev_len), min=1)
    dup = (sp - prev_pos <= max_shift) & (ssim >= min_size_sim)
    keep = sv & ~dup
    return sp, sl, keep


def build_sig_merge_step(mesh: Mesh | None = None, *, max_shift: int = 100,
                         min_size_sim: float = 0.5):
    """Per-rank signature merge: the rank's padded sig arrays (n·S,), split
    into its mesh's genome rows → globally sorted (S·n_shards,) arrays +
    keep mask, the same on every rank."""
    def step(pos, svlen, valid):
        return _sig_merge_local(pos, svlen, valid, max_shift=max_shift,
                                min_size_sim=min_size_sim, mesh=mesh)
    return step


def _median_local(x, valid, mesh: Mesh | None = None):
    gx = _gather_genome(x.to(torch.float32), mesh)
    gv = _gather_genome(valid.to(torch.bool), mesh)
    n = gv.sum()
    big = torch.finfo(torch.float32).max
    sx = torch.sort(torch.where(gv, gx, big)).values
    N = gx.shape[0]
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, N - 1)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, N - 1)
    med = (sx[lo] + sx[hi]) / 2
    return torch.where(n > 0, med, torch.zeros((), dtype=torch.float32,
                                               device=med.device))


def build_global_median_step(mesh: Mesh | None = None):
    """Per-rank masked median: the rank's (n·S,) float values + valid mask,
    split into its mesh's genome rows → the global median scalar, the same
    on every rank."""
    def step(x, valid):
        return _median_local(x, valid, mesh)
    return step


def wgs_global_median(values_by_shard: list, mesh: Mesh | None = None,
                      ) -> float:
    """WGS-global median of per-chromosome value vectors — THE statistic the
    coverage band-pass bands against (filter_vcf_by_sig_cov_insdel.py:38-55
    takes the 0.5 quantile of the concatenated all-chromosome rel_cov set,
    after the concat at volcanosv-vc-large-indel.py:266-278).

    The large-indel drivers (cli._call_large_indels) pass the values every
    rank gathered.  With a mesh of more than one device each chromosome's
    vector is a genome-axis shard (round-robin, padded to a common length)
    and the median is the masked device sort of `_median_local` on the
    mesh's devices; without one (or with empty values) it is the host's
    float32 mirror of that sort, so both give identical bits (→
    byte-identical VCFs)."""
    arrs = [np.asarray(v, np.float32).reshape(-1) for v in values_by_shard]
    flat = np.concatenate(arrs) if arrs else np.zeros(0, np.float32)
    if flat.size == 0:
        return 0.0
    if mesh is None or mesh.size <= 1:
        s = np.sort(flat)
        n = len(s)
        return float((s[(n - 1) // 2] + s[n // 2]) / np.float32(2))
    n_sh = mesh.shape[AXES.genome]
    # pack chromosome vectors into n_sh equal shards (round-robin), padded
    per = [list() for _ in range(n_sh)]
    for i, a in enumerate(arrs):
        per[i % n_sh].append(a)
    shards = [np.concatenate(p) if p else np.zeros(0, np.float32)
              for p in per]
    S = max(max(len(s) for s in shards), 1)
    vals = np.zeros((n_sh, S), np.float32)
    valid = np.zeros((n_sh, S), bool)
    for i, s in enumerate(shards):
        vals[i, :len(s)] = s
        valid[i, :len(s)] = True
    dev = mesh.devices[0, 0]
    med = _median_local(torch.from_numpy(vals.reshape(-1)).to(dev),
                        torch.from_numpy(valid.reshape(-1)).to(dev), mesh)
    return float(med.cpu())
