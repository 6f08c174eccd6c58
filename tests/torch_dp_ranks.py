"""Rank workers of the port's data-parallel CPU tests (no test here).

Each function runs in a process started by
`yolat_tpu_torch.parallel.launch.spawn_ranks`, joins a gloo group on a
FileStore with a 60 s timeout and imports only torch and the port, so the
ranks start quickly and the tests that hold them to the JAX package keep
jax in the test process alone.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.nn import layers
from yolat_tpu_torch.nn.model import SparseCADGCN
from yolat_tpu_torch.parallel.distributed import (initialize_from_config,
                                                  shutdown)
from yolat_tpu_torch.train.loop import make_dp_train_step, make_train_step
from yolat_tpu_torch.train.optim import make_optimizer

TIMEOUT_S = 60.0


def join(local_rank: int, store_path: str, world: int):
    torch.set_num_threads(2 * world)  # 2 a rank once joined
    return initialize_from_config(Config(n_devices=world), local_rank, "cpu",
                                  store_path=store_path, timeout_s=TIMEOUT_S)


_SUM = layers.all_reduce_sum


def _plain_all_reduce(tensor, group=None):
    """A planted fault: the sum over ranks without its backward."""
    out = tensor.clone()
    dist.all_reduce(out, group=group)
    return out


def _model(sc: dict, state: dict):
    model = SparseCADGCN(sc["n_classes"], channels=sc["width"],
                         fused_pool=sc["fused"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    cfg = Config(n_classes=sc["n_classes"], n_filters=sc["width"],
                 data_aug=False, fused_head_train=sc["fused"], lr=sc["lr"])
    if sc["optimizer"] == "sgd":
        opt = torch.optim.SGD(model.parameters(), lr=sc["lr"])
    else:
        opt = make_optimizer(sc["optimizer"], model.parameters(), sc["lr"],
                             cfg.weight_decay)
    return cfg, model, opt


def _state(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


def train_scenarios(local_rank: int, store_path: str, data_dir: str,
                    world: int, scenarios: dict, states: dict,
                    one_rank: dict) -> dict:
    """Each scenario: a model from states[sc['state']], the DP step over
    the world group on this rank's windows of the train split (batch 1,
    the loader's own schedule; 'identical': rank 0's windows on every
    rank), every step's loss and the state after the last. `one_rank`
    (rank 0 only): its steps of the DP step over a group of rank 0 alone
    and of make_train_step, on rank 0's windows."""
    ranks = join(local_rank, store_path, world)
    try:
        solo = dist.new_group(ranks=[0])  # every rank joins the call
        ds = SESYDDataset(data_dir, "train", bbox_sampling_step=10)
        windows = {r: list(PackedLoader(ds, batch_size=1, n_devices=world,
                                        rank=r, prefetch=0))
                   for r in {0, ranks.rank}}
        out: dict = {"n_images": [int(b["n_images"])
                                  for b in windows[ranks.rank]]}
        for name, sc in scenarios.items():
            cfg, model, opt = _model(sc, states[sc["state"]])
            step = make_dp_train_step(cfg, model, opt, group=ranks.group)
            batches = windows[0 if sc.get("identical") else ranks.rank]
            if sc.get("fault"):
                layers.all_reduce_sum = _plain_all_reduce
            try:
                losses = [float(step(to_device(b, "cpu"))["loss"])
                          for b in batches[:sc["steps"]]]
            finally:
                layers.all_reduce_sum = _SUM
            out[name] = (losses, _state(model))
        if ranks.rank == 0:
            got = {}
            for arm in ("dp", "single"):
                cfg, model, opt = _model(one_rank, states[one_rank["state"]])
                step = (make_dp_train_step(cfg, model, opt, group=solo)
                        if arm == "dp" else make_train_step(cfg, model, opt))
                losses = [step(to_device(b, "cpu"))
                          for b in windows[0][:one_rank["steps"]]]
                got[arm] = ([(float(m["loss"]), float(m["loss_cls"]))
                             for m in losses], _state(model))
            out["one_rank"] = got
        return out
    finally:
        shutdown(ranks)


def sharded_ops(local_rank: int, store_path: str, world: int,
                data: dict) -> dict:
    """parallel/partition on this rank's shard (row `rank` of each [W, ...]
    input) and the rank helpers: sharded_segment_sum / mean,
    edge_sharded_gp2_layer, replicate, make_mesh."""
    from yolat_tpu_torch.parallel import partition
    from yolat_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                               shard_leading_axis)

    ranks = join(local_rank, store_path, world)
    try:
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in
             shard_leading_axis(data["sharded"], ranks.rank).items()}
        out = {
            "sum": partition.sharded_segment_sum(
                t["data"], t["seg"], data["S"], ranks.group,
                mask=t["mask"]).numpy(),
            "mean": partition.sharded_segment_mean(
                t["data"], t["seg"], data["S"], ranks.group).numpy(),
        }
        conv = {k: torch.from_numpy(v) for k, v in data["conv"].items()}
        out["gp2"] = partition.edge_sharded_gp2_layer(
            conv, torch.from_numpy(data["x"]), t["edge"], t["e_attr"],
            t["edge_mask"], ranks.group).numpy()
        # the differentiable sum: d(sum_r sum(total))/d(data_r) per rank
        d = t["data"].clone().requires_grad_(True)
        partition.sharded_segment_sum(d, t["seg"], data["S"],
                                      ranks.group).sum().backward()
        out["grad"] = d.grad.numpy()
        lin = torch.nn.Linear(3, 2)
        torch.nn.init.constant_(lin.weight, float(ranks.rank))
        replicate(lin, ranks.group)
        out["replicated"] = lin.weight.detach().numpy()
        first = make_mesh(1)
        out["mesh_world"] = (dist.get_world_size(make_mesh())
                             if ranks.rank == 0 else None)
        out["mesh_one"] = (dist.get_world_size(first) if ranks.rank == 0
                           else None)
        return out
    finally:
        shutdown(ranks)


class OracleModel(torch.nn.Module):
    """Logits that name each proposal's label (a score of 4 over 0), boxes
    the proposals': detections with true positives and exact score ties
    across images, so the AP depends on the order images are taken in."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.n_classes = n_classes
        self.unused = torch.nn.Parameter(torch.zeros(1))

    def forward(self, batch):
        logits = 4.0 * torch.nn.functional.one_hot(
            batch["labels"].long(), self.n_classes).float()
        return logits, batch["bbox"]


def evaluate_ranks(local_rank: int, store_path: str, world: int,
                   data_dir: str, partition: str, cfg: Config,
                   serves: tuple) -> dict:
    """eval/runner.evaluate over the ranks (each on its windows of the
    split, batch 1), per serve mode, of cfg's seeded model, and of
    OracleModel on the module route ('oracle')."""
    from yolat_tpu_torch.eval.runner import evaluate
    from yolat_tpu_torch.nn.model import seeded_model

    ranks = join(local_rank, store_path, world)
    try:
        ds = SESYDDataset(data_dir, partition, bbox_sampling_step=10)
        loader = PackedLoader(ds, batch_size=1, n_devices=world,
                              rank=ranks.rank, prefetch=0)
        out = {}
        for serve in serves:
            model = (OracleModel(cfg.n_classes) if serve == "oracle"
                     else seeded_model(cfg))
            out[serve] = evaluate(cfg, model, loader,
                                  serve="flax" if serve == "oracle"
                                  else serve, device="cpu",
                                  group=ranks.host_group)
        return out
    finally:
        shutdown(ranks)
