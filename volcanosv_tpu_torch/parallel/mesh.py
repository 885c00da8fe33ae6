"""Process group and device mesh of the port's parallel layer.

The reference's "cluster story" is 22 independent SLURM jobs over a shared
filesystem (README.md:244-255) with joblib fan-out inside each job
(SURVEY.md §2.3).  The JAX package maps it onto a 2-D device mesh over
every process's devices; the port maps it onto PyTorch's two layers:

  * one `torch.distributed` rank per process.  Each rank owns a
    round-robin share of the chromosomes (`host_chromosome_shard`, the
    "one job per chromosome" replacement) and its card,
    `cuda:{LOCAL_RANK % device_count}`.  Host collectives (the gathers of
    `multiproc.py`) go over a gloo group on CPU tensors; device collectives
    (the all_reduce and all_gather of `step.py` and `wgs.py`) over the
    default group, whose backend `device_backend` picks;
  * an in-process mesh: a (genome, data) grid of `torch.device`s, active
    only when one process sees more than one card.  Its "genome" axis
    holds genome shards (the WGS signature merge and coverage median), its
    "data" axis splits window batches (the aligner's DP, the sharded step).

There is no tensor/pipeline/sequence parallelism to map: the reference is a
genomics pipeline, not an ML trainer (SURVEY.md §2.3 last row).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE, resolve_device
from ..utils.logging import get_logger

log = get_logger("mesh")


@dataclass(frozen=True)
class MeshAxes:
    genome: str = "genome"
    data: str = "data"


AXES = MeshAxes()


@dataclass(frozen=True)
class Mesh:
    """A (genome, data) grid of torch devices; a device may repeat."""
    devices: np.ndarray                     # (genome, data) of torch.device

    @property
    def shape(self) -> dict[str, int]:
        g, d = self.devices.shape
        return {AXES.genome: g, AXES.data: d}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list[torch.device]:
        """The devices genome-major, the order a batch is split in."""
        return list(self.devices.reshape(-1))


def make_mesh(n_devices: int | None = None, genome_shards: int | None = None,
              devices=None, device=DEFAULT_DEVICE) -> Mesh:
    """Build the (genome, data) mesh over `devices` (default: every card
    of `device`'s type in this process: all CUDA cards, or the one CPU).

    genome_shards defaults to the largest power-of-two ≤ n_devices capped at
    the device count; remaining devices go to the data axis."""
    if devices is None:
        dev = resolve_device(device)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())] \
            if dev.type == "cuda" else [dev]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if genome_shards is None:
        genome_shards = 1
        while genome_shards * 2 <= n_devices and (n_devices % (genome_shards * 2)) == 0:
            genome_shards *= 2
        # balanced split: half the axes to genome
        while genome_shards > 1 and genome_shards > n_devices // genome_shards:
            genome_shards //= 2
        genome_shards = max(1, genome_shards)
    if n_devices % genome_shards:
        raise ValueError(f"{n_devices} devices not divisible by genome={genome_shards}")
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(genome_shards, n_devices // genome_shards))


_ACTIVE_MESH: Mesh | None = None


def set_active_mesh(mesh: Mesh | None) -> None:
    """Install the pipeline's device mesh: while set, the aligner's
    refine-window DP batches are split over the mesh's devices
    (ops.banded_align._sharded_cigars_dispatch) instead of running on one
    device."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh() -> Mesh | None:
    return _ACTIVE_MESH


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

_HOST_GROUP = None          # the gloo group of the host collectives


def device_backend(local_ranks: int, n_cards: int) -> str:
    """The backend of the device collectives: NCCL when every rank of a
    host has a card of its own; gloo otherwise — on a host without cards,
    and where ranks outnumber cards (NCCL refuses two ranks on one card),
    gloo on the CUDA tensors themselves."""
    return "nccl" if 0 < local_ranks <= n_cards else "gloo"


def host_group():
    """The process group of the host collectives (gloo on CPU tensors)."""
    return _HOST_GROUP


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> bool:
    """Multi-process entry point: joins this process to one
    `torch.distributed` group of `num_processes` ranks.

    Arguments left None are read from torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK and
    LOCAL_WORLD_SIZE for the card and the backend rule).  A rank with
    cards runs on `cuda:{LOCAL_RANK % device_count}` (made the current
    device, so that "cuda" names it).

    Returns True when a process group was initialized, False when running
    single-process (local dev / tests) or when one already exists."""
    global _HOST_GROUP
    env = os.environ
    if dist.is_initialized():
        return False
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if coordinator_address is None or num_processes <= 1:
        return False
    local_rank = int(env.get("LOCAL_RANK", process_id))
    local_ranks = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = device_backend(local_ranks, n_cards)
    if n_cards:
        torch.cuda.set_device(local_rank % n_cards)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _HOST_GROUP = dist.new_group(backend="gloo") if backend != "gloo" \
        else dist.group.WORLD
    log.info("rank %d/%d: device %s, device collectives %s (%d local ranks, "
             "%d cards), host collectives gloo", process_id, num_processes,
             f"cuda:{local_rank % n_cards}" if n_cards else "cpu", backend,
             local_ranks, n_cards)
    return True


def all_gather_device(x: torch.Tensor) -> torch.Tensor:
    """(P, *x.shape): every rank's x in rank order, on x's device, over
    the device collectives' group; x[None] single-process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x[None]
    P = dist.get_world_size()
    if x.is_cuda and dist.get_backend() == "gloo":
        # gloo's all_gather takes CPU tensors only (its all_reduce takes
        # CUDA tensors): this one collective goes through the host
        parts = [torch.empty_like(x, device="cpu") for _ in range(P)]
        dist.all_gather(parts, x.cpu())
        return torch.stack(parts).to(x.device)
    parts = [torch.empty_like(x) for _ in range(P)]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts)


def host_chromosome_shard(chroms: list[str],
                          process_id: int | None = None,
                          n_processes: int | None = None) -> list[str]:
    """The chromosomes this process owns — round-robin over ranks, the
    multi-process analogue of 'submit one job per chromosome'
    (README.md:244-255).  Deterministic: every rank computes the same
    partition."""
    from .multiproc import n_processes as _n, process_id as _pid
    if process_id is None:
        process_id = _pid()
    if n_processes is None:
        n_processes = _n()
    return [c for i, c in enumerate(chroms) if i % n_processes == process_id]
