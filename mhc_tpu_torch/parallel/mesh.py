"""The ranks of the data-parallel pipeline.

Counterpart of `mhc_tpu/parallel/mesh.py`. The reference runs one
process over an N-device `jax.sharding.Mesh` with one data axis; torch's
idiom is one process per GPU, so the port's mesh is a `torch.distributed`
world of N ranks, each with its own device. The program is the same on
every rank: NCCL carries the collectives between cards, gloo between CPU
processes (or between ranks that share one card).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..config import resolve_device


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the world. `group` is None for a world of one
    without `torch.distributed`, where every collective is the identity."""
    group: object | None
    rank: int
    world_size: int
    device: torch.device
    # the rank on its node: only local rank 0 writes output files
    local_rank: int = 0

    @property
    def comm_device(self) -> torch.device:
        """Where collective tensors live: the rank's card under NCCL,
        the CPU under gloo."""
        if self.group is not None and dist.get_backend(self.group) == "nccl":
            return self.device
        return torch.device("cpu")


def _local_rank(default: int) -> int:
    return int(os.environ.get("LOCAL_RANK", default))


def make_mesh(device=None) -> Mesh:
    """The initialised `torch.distributed` world, or a world of one on
    `resolve_device(device)`. Under NCCL, device None is the card
    `cuda:LOCAL_RANK`."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(None, 0, 1, resolve_device(device))
    rank = dist.get_rank()
    nccl = dist.get_backend() == "nccl"
    if device is None and nccl:
        device = torch.device("cuda", _local_rank(rank))
    dev = resolve_device(device)
    if nccl and dev.type != "cuda":
        raise ValueError(f"an NCCL world needs a CUDA device, not {dev}")
    return Mesh(dist.group.WORLD, rank, dist.get_world_size(), dev,
                _local_rank(rank))


def init_distributed(device=None) -> Mesh:
    """`init_process_group` from torchrun's environment (env://:
    MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK), NCCL on a
    CUDA device (None: `cuda:LOCAL_RANK`), gloo on the CPU; raises
    where a CUDA device has no NCCL, never falling back to gloo."""
    dev = (torch.device("cuda", _local_rank(0)) if device is None
           else torch.device(device))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", _local_rank(0))
        if not dist.is_nccl_available():
            raise RuntimeError("init_distributed: a CUDA device needs the "
                               "NCCL backend, which this torch lacks")
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method="env://")
    return make_mesh(dev)


def pad_to_multiple(n: int, n_shards: int) -> int:
    return (n + n_shards - 1) // n_shards * n_shards
