"""Rank helpers: the counterpart of the JAX package's device mesh.

Counterpart of `yolat_tpu/parallel/mesh.py`. JAX's data parallelism is a
1-D ('data',) mesh with shard_map; the port's is one process per device
(`parallel/distributed.py`), so the mesh becomes a process group, a
replicated value a broadcast from rank 0, a sharded batch each rank's own
row, and the model's `axis_name` the sync group `set_sync_group` sets on
every module that reduces batch moments (`nn/layers.MaskedBatchNorm` and
`FusedPoolFusion`, the fused head of kernels 3 and 11). TP / PP / EP have
no counterpart at this model scale, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def world(group=None) -> int:
    """Ranks in `group` (the world group by default); 1 without a run."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in `group`; 0 without a run."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def rank_device(local_rank: int, device_type: str = "cuda") -> torch.device:
    """The device of local rank r: `cuda:r` (an explicit index, so no rank
    lands on another's card by default), or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank)
    return torch.device(device_type)


def make_mesh(n_devices: int | None = None):
    """The group of ranks 0..n_devices-1 (every rank joins the call, as
    `new_group` asks): the counterpart of a ('data',) mesh over the first
    n_devices devices. The world group when n_devices is None or the
    world."""
    w = world()
    if n_devices is None or n_devices == w:
        return dist.group.WORLD
    if n_devices > w:
        raise ValueError(f"requested {n_devices} devices, have {w}")
    return dist.new_group(ranks=list(range(n_devices)))


@torch.no_grad()
def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Broadcast every parameter and buffer from the group's rank 0, so
    all ranks start from its values; returns the module."""
    if world(group) == 1:
        return module
    src = dist.get_global_rank(group, 0) if group not in (
        None, dist.group.WORLD) else 0
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
    return module


def shard_leading_axis(stacked: dict, rank: int) -> dict:
    """Rank `rank`'s row of a [D, ...] stacked batch (`data/loader.
    stack_shards`); 0-d leaves stay as they are."""
    return {k: (v[rank] if np.ndim(v) > 0 else v) for k, v in stacked.items()}


def set_sync_group(model: torch.nn.Module, group) -> int:
    """Sync the batch moments of every module of `model` that has a
    `sync_group` (each MaskedBatchNorm; FusedPoolFusion's fused head reads
    its BatchNorm's) over `group`; None turns syncing off. Returns the
    number of modules set. No constructor changes: `build_model(cfg)`
    keeps its signature."""
    n = 0
    for m in model.modules():
        if hasattr(m, "sync_group"):
            m.sync_group = group
            n += 1
    return n
