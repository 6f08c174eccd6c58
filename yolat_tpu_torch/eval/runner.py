"""Test-split evaluation: predict -> NMS -> the reference's AP table.

Counterpart of `yolat_tpu/eval/runner.py:58-150` (`evaluate`, one
device) on the port's `make_predict_core`: the device runs the forward and
NMS per batch, the host accumulates the protocol metrics
(`eval/metrics.Evaluator`). `serve` picks the forward: 'flax' the
eval-mode module (the parity route; the name is the JAX package's),
eager, 'fast' / 'fast_bf16' the folded-BN engine of cfg's arch with its
kernels, through `make_serving_fn` (one transfer of the kept arrays, on
the card a CUDA graph) with the plans at capacity, one per (slot cap,
signature), as `yolat_tpu/eval/runner.py:80-100` does
(`batch_predictor`, which `cli.detect` serves through too).

Data parallel (`group`, :30-32, :85-87): each rank predicts the batches
of its own loader (its windows of the split: `PackedLoader(n_devices=,
rank=)`) and computes the per-image statistics on its host; the ranks'
statistics cross the group as host objects (a gloo group: NCCL carries
CUDA tensors only) and are taken in the global image order, step then
rank, the order one device sees. Ties in the score sort would otherwise
move the AP. Every rank returns the same table, the single-device table
of the split.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.eval.fast_forward import fold_params_for
from yolat_tpu_torch.eval.metrics import Evaluator
from yolat_tpu_torch.data.staging import batch_signature
from yolat_tpu_torch.eval.predict import (img_slot_cap, make_predict_core,
                                          make_serving_fn)
from yolat_tpu_torch.ops.plans import pad_plans


def batch_predictor(cfg, model, serve: str = "flax", device=None,
                    max_det: int = 300):
    """predict(numpy batch) -> numpy detections dict (`make_predict_core`'s
    keys) on the route `serve` names, with each batch's exact slot cap
    (`img_slot_cap`), as `yolat_tpu/eval/runner.py:56-100` predicts:
    'flax' the eval-mode `model`, eager; 'fast' / 'fast_bf16' the arch's
    folded-BN engine through `make_serving_fn` over the plans at capacity
    (`pad_plans`), one serving fn, on the card one CUDA graph, per (slot
    cap, batch signature), kept in `predict.serving_fns`. The model is
    folded as it stands: put it in eval mode first."""
    if serve not in ("flax", "fast", "fast_bf16"):
        raise ValueError(f"serve {serve!r}: flax, fast or fast_bf16")
    device = device or next(model.parameters()).device
    folded = fold_params_for(cfg, model, device) if serve != "flax" else None
    fns: dict = {}

    def predict(batch: dict) -> dict:
        cap = img_slot_cap(batch)
        if folded is None:
            core = make_predict_core(cfg, model=model, max_det=max_det,
                                     img_slots=cap)
            with torch.no_grad():
                return {k: v.cpu().numpy() for k, v in
                        core(to_device(batch, device)).items()}
        staged = pad_plans(batch)
        key = (cap, batch_signature(staged))
        if key not in fns:
            fns[key] = make_serving_fn(
                cfg, staged, device=device, folded=folded,
                bf16=serve == "fast_bf16", max_det=max_det, img_slots=cap)
        return fns[key](staged).numpy()

    predict.serving_fns = fns
    return predict


def evaluate(cfg, model, loader, max_det: int = 300, verbose: bool = False,
             serve: str = "flax", device=None, group=None) -> dict:
    """The AP table of `model` over the loader's batches (numpy dicts):
    map_per_th, map_50, map_all, test_value, top1_acc, confusion. The model
    is put in eval mode and returned to its former mode. With `group` (a
    process group that carries host objects), the table of all its ranks'
    batches (module docstring)."""
    was_training = model.training
    model.eval()
    ev = Evaluator(cfg.n_classes)
    steps: list = []  # per batch: (proposal statistics, image statistics)
    try:
        predict = batch_predictor(cfg, model, serve, device, max_det)
        for batch in loader:
            out = predict(batch)
            kept = out["kept"]
            images = []
            for img in range(min(batch["gt_bbox"].shape[0],
                                 int(batch["n_images"]))):
                valid = out["valid"][img]
                gmask = batch["gt_mask"][img]
                w, h = batch["wh"][img]
                gt_px = batch["gt_bbox"][img][gmask] * np.array([w, h, w, h])
                images.append(ev.image_stats(
                    out["boxes"][img][valid], out["scores"][img][valid],
                    out["classes"][img][valid], gt_px,
                    batch["gt_labels"][img][gmask]))
            steps.append((ev.proposal_stats(out["pred_label"][kept],
                                            batch["labels"][kept]), images))
    finally:
        model.train(was_training)
    by_rank = [steps]
    if group is not None:
        by_rank = [None] * dist.get_world_size(group)
        dist.all_gather_object(by_rank, steps, group=group)
        if len({len(r) for r in by_rank}) != 1:
            raise RuntimeError("ranks evaluated different numbers of batches: "
                               f"{[len(r) for r in by_rank]}")
    for step in range(len(steps)):
        for rank_steps in by_rank:
            props, images = rank_steps[step]
            ev.add_proposal_stats(props)
            for stats in images:
                ev.add_image_stats(stats)
    result = ev.compute()
    if verbose:
        for th, m in zip(result["ths"], result["map_per_th"]):
            print(f"MAP@{th:.2f}: {m:.4f}")
        print(f"MAP@ALL: {result['map_all']:.4f}  top1: {result['top1_acc']:.4f}")
    return result
