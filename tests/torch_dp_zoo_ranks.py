"""Rank workers of the conv zoo's data-parallel CPU tests (no test here;
tests/test_torch_dp_zoo.py holds them to the JAX package).

`zoo_scenarios` runs in a process started by
`yolat_tpu_torch.parallel.launch.spawn_ranks`, joins a gloo group through
`torch_dp_ranks.join` (a FileStore, a 60 s timeout) and imports only
torch and the port. It also runs on CUDA tensors, two ranks on one card
(`chip_smoke.py` phase 26).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from torch_dp_ranks import TIMEOUT_S, _SUM, _plain_all_reduce, _state, join
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader, train_plans_for
from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.nn import layers
from yolat_tpu_torch.nn.model import build_model
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops import fused_pool_train as fpt
from yolat_tpu_torch.parallel.distributed import (initialize_from_config,
                                                  shutdown)
from yolat_tpu_torch.train.loop import make_dp_train_step, make_train_step

# the launch counts each arm reports
KERNELS = ("folded_mlp_block_max", "fused_pool_train_bwd")


def case_config(case: dict) -> Config:
    """The Config of one case: {'n_classes', 'width', 'lr', 'model': the
    Config fields that pick the model (conv, act, norm, arch, ...)}."""
    return Config(n_classes=case["n_classes"], n_filters=case["width"],
                  data_aug=False, lr=case["lr"], **case["model"])


def _model(case: dict, state: dict, device):
    cfg = case_config(case)
    model = build_model(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model = model.to(device)
    return cfg, model, torch.optim.SGD(model.parameters(), lr=case["lr"])


def zoo_scenarios(local_rank: int, store_path: str, data_dir: str,
                  world: int, cases: dict, states: dict,
                  device: str = "cpu", step: int = 10,
                  batch_size: int = 1, f64: bool = True,
                  spread: bool = False) -> dict:
    """Per case, SGD from states[case] for case['steps'] steps on the
    train split at bbox_sampling_step `step` (`batch_size` images a rank,
    the loader's own schedule, the plans the case's arch trains on):
      'dp'         the DP step over the world group on this rank's windows;
      'dp64'       with `f64`, the same with the model and the batch's
                   float fields in float64 (the reference an f32 update is
                   held to where rounding decides it; the ranks still
                   average the gradients in f32, and MaskedBatchNorm's
                   moments are f32);
      'identical'  the DP step on rank 0's windows on every rank;
      'single'     on rank 0, make_train_step on rank 0's windows (with
                   `spread`, also 'single_again': its spread where float
                   atomics make two runs differ, as on a card);
      'dp_plain'   for a case with 'plain', 'dp' on the fused head's plain
                   route.
    A case with 'fault' runs only 'dp', with a plain all_reduce (no
    backward) in MaskedBatchNorm. case['noise'], if given, is added to the
    batches: per step {key: [W, ...] by the rank whose window it is}.
    -> {case: {arm: (losses, state after, launches of KERNELS), 'seconds':
    the case's wall}}, and this rank's image counts. `device` 'cuda': both
    ranks on card 0, CUDA tensors over gloo."""
    if device == "cpu":
        ranks = join(local_rank, store_path, world)
        # one thread a rank: the test runs beside other workers' tests
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = torch.device(device, 0)
        ranks = initialize_from_config(Config(n_devices=world), local_rank,
                                       dev, store_path=store_path,
                                       backend="gloo", timeout_s=TIMEOUT_S)
    try:
        ds = SESYDDataset(data_dir, "train", bbox_sampling_step=step)
        windows: dict = {}

        def window(cfg, rank):
            plans = train_plans_for(cfg)
            key = (tuple(sorted(plans.items())), rank)
            if key not in windows:
                windows[key] = list(PackedLoader(
                    ds, batch_size=batch_size, n_devices=world, rank=rank,
                    prefetch=0, **plans))
            return windows[key]

        def run(name, case, arm):
            cfg, model, opt = _model(case, states[name], dev)
            r = ranks.rank if arm.startswith("dp") else 0
            batches = window(cfg, r)[:case["steps"]]
            if case.get("noise") is not None:
                batches = [{**b, **{k: b[k] + noise[k][r]
                                    for k in noise}}
                           for b, noise in zip(batches, case["noise"])]
            if arm == "dp64":
                model.double()
                batches = [{k: (v.astype(np.float64)
                                if v.dtype == np.float32 else v)
                            for k, v in b.items()} for b in batches]
            if arm.startswith("single"):
                step = make_train_step(cfg, model, opt)
            else:
                step = make_dp_train_step(cfg, model, opt, group=ranks.group)
            if case.get("fault") and arm == "dp":
                layers.all_reduce_sum = _plain_all_reduce
            if arm == "dp_plain":
                layers.fused_pool_train = functools.partial(
                    fpt.fused_pool_train, route="plain")
            _build.reset_launch_counts()
            try:
                losses = [float(step(to_device(b, dev))["loss"])
                          for b in batches]
            finally:
                layers.all_reduce_sum = _SUM
                layers.fused_pool_train = fpt.fused_pool_train
            return (losses, _state(model.cpu()),
                    tuple(_build.launch_counts[k] for k in KERNELS))

        out: dict = {}
        for name, case in cases.items():
            arms = ["dp"] + (["dp64"] if f64 else []) + ["identical"]
            if case.get("plain"):
                arms.append("dp_plain")
            if case.get("fault"):
                arms = ["dp"]
            elif ranks.rank == 0:
                arms += ["single"] + (["single_again"] if spread else [])
            t0 = time.perf_counter()
            out[name] = {arm: run(name, case, arm) for arm in arms}
            out[name]["seconds"] = time.perf_counter() - t0
        out["n_images"] = [int(b["n_images"]) for b in window(
            case_config(next(iter(cases.values()))), ranks.rank)]
        return out
    finally:
        shutdown(ranks)
