"""Multi-process execution: one process per GPU over torch.distributed.

Counterpart of `yolat_tpu/parallel/distributed.py`. The JAX package runs
one process per host and a global ('data',) mesh over every chip; the port
runs one process per GPU (a rank is one device of that mesh), NCCL between
CUDA devices and gloo when the caller asks for the CPU.

  - `initialize_from_config` joins this process to the run: global rank
    `process_id * local + local_rank` of `n_devices`, the store at
    `--coordinator host:port` (a TCPStore served by rank 0) or, on one node
    without a coordinator, a FileStore the launcher names; every collective
    and the store time out after `timeout_s` instead of waiting forever.
  - Each rank's loader yields its own window of every global step
    (`data/loader.PackedLoader(rank=)`), so the JAX package's
    `global_batch` (host-local shards assembled into global arrays) has no
    counterpart: nothing here builds an array over all ranks.
  - `coordination_barrier` is a store barrier, not a collective: gloo's
    rendezvous has its own timeout (the JAX module's note, :72-86, holds
    for torch's gloo too), so points where ranks may skew by more than that
    (the kernels' first build, dataset preprocessing) are fenced with the
    store before the next collective.

`all_reduce_sum` is the autograd-aware sum over ranks: its backward sums
the cotangent over ranks, the transpose of `psum` under shard_map's
`check_vma=False` that the JAX step differentiates through
(`torch.distributed.nn.functional.all_reduce` computes the same; that
module is deprecated).
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass
class Ranks:
    """This process's place in a data-parallel run. `group` is the world
    group; `host_group` carries host objects (gloo: NCCL moves CUDA tensors
    only) and is the world group when the backend is gloo already."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    node: int
    n_nodes: int
    backend: str
    store: object
    timeout_s: float
    group: object = None
    host_group: object = None
    _barriers: dict = dataclasses.field(default_factory=dict)

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def parse_coordinator(address: str) -> tuple:
    """'host:port' -> (host, port)."""
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"--coordinator {address!r}: expected host:port")
    return host, int(port)


def _local_ranks(cfg) -> int:
    n_procs = max(int(getattr(cfg, "n_processes", 0) or 1), 1)
    if cfg.n_devices % n_procs != 0:
        raise ValueError(f"n_devices={cfg.n_devices} must divide evenly over "
                         f"{n_procs} processes")
    return cfg.n_devices // n_procs


def local_device_count(cfg, device_type: str = "cuda") -> int:
    """Ranks this process's node contributes to the cfg.n_devices-wide run
    (cfg.n_devices counts GLOBAL devices, as in JAX). On CUDA each local
    rank takes its own card, so more local ranks than cards raise."""
    local = _local_ranks(cfg)
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if local > have:
            raise ValueError(f"need {local} local devices, have {have}")
    return local


def _store(cfg, rank: int, world: int, store_path: str | None,
           timeout: datetime.timedelta):
    if cfg.coordinator:
        host, port = parse_coordinator(cfg.coordinator)
        return dist.TCPStore(host, port, world, is_master=rank == 0,
                             timeout=timeout)
    if int(getattr(cfg, "n_processes", 0) or 1) > 1:
        raise ValueError("--n_processes > 1 requires --coordinator host:port")
    if store_path is None:
        raise ValueError("a run over several ranks needs --coordinator "
                         "host:port or a store file")
    store = dist.FileStore(store_path, world)
    store.set_timeout(timeout)
    return store


def initialize_from_config(cfg, local_rank: int, device,
                           store_path: str | None = None,
                           backend: str | None = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> Ranks:
    """Join this process to the run cfg describes (n_devices ranks over
    n_processes nodes) as local rank `local_rank` on `device`. backend
    defaults to nccl for a CUDA device and gloo for the CPU. The device is
    the caller's choice (`mesh.rank_device`; the CLIs check the card count
    with `local_device_count` before they start the ranks). CPU ranks on
    one node share its cores: each keeps 1 / local of torch's threads."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    local = _local_ranks(cfg)
    if not 0 <= local_rank < local:
        raise ValueError(f"local rank {local_rank} of {local}")
    node = int(getattr(cfg, "process_id", 0) or 0)
    rank = node * local + local_rank
    world = cfg.n_devices
    timeout = datetime.timedelta(seconds=timeout_s)
    store = _store(cfg, rank, world, store_path, timeout)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // local))
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    host_group = (dist.group.WORLD if backend == "gloo"
                  else dist.new_group(backend="gloo", timeout=timeout))
    return Ranks(rank=rank, world=world, local_rank=local_rank,
                 local_world=local, node=node, n_nodes=world // local,
                 backend=backend, store=store,
                 timeout_s=timeout_s, group=dist.group.WORLD,
                 host_group=host_group)


def coordination_barrier(ranks: Ranks, name: str,
                         timeout_s: float | None = None) -> None:
    """Block until every rank reaches this barrier, through the store (no
    collective). Ranks pass barriers of one name in the same order; each
    pass is counted, so a name may be reused."""
    if ranks is None or ranks.world == 1:
        return
    n = ranks._barriers.get(name, 0)
    ranks._barriers[name] = n + 1
    key = f"yolat_barrier/{name}/{n}"
    if ranks.store.add(key, 1) == ranks.world:
        ranks.store.set(key + "/open", b"1")
    ranks.store.wait([key + "/open"], datetime.timedelta(
        seconds=ranks.timeout_s if timeout_s is None else timeout_s))


def local_first(ranks: Ranks | None, name: str, fn):
    """fn() on local rank 0 first, then, past a barrier, on the other
    ranks: for work that the first call leaves on the node's disk (the
    kernels' build, the dataset caches), so W ranks do not each do it."""
    if ranks is None or ranks.world == 1:
        return fn()
    if ranks.local_rank == 0:
        out = fn()
        coordination_barrier(ranks, name)
        return out
    coordination_barrier(ranks, name)
    return fn()


def shutdown(ranks: Ranks | None) -> None:
    """Leave the run (destroys the process groups)."""
    if ranks is not None and dist.is_initialized():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(tensor, group=None):
    """Sum of `tensor` over the ranks of `group`, differentiable: the
    gradient is the sum of the ranks' cotangents (psum's transpose)."""
    return _AllReduceSum.apply(tensor, group)
