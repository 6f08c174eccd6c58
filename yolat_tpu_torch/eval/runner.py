"""Test-split evaluation: predict -> NMS -> the reference's AP table.

Counterpart of `yolat_tpu/eval/runner.py:58-150` (`evaluate`, one
device) on the port's `make_predict_core`: the device runs the forward and
NMS per batch, the host accumulates the protocol metrics
(`eval/metrics.Evaluator`). `serve` picks the forward: 'flax' the
eval-mode module (the parity route; the name is the JAX package's),
'fast' / 'fast_bf16' the folded-BN engine of cfg's arch with its
kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.eval.fast_forward import fold_params_for
from yolat_tpu_torch.eval.metrics import Evaluator
from yolat_tpu_torch.eval.predict import img_slot_cap, make_predict_core


def evaluate(cfg, model, loader, max_det: int = 300, verbose: bool = False,
             serve: str = "flax", device=None) -> dict:
    """The AP table of `model` over the loader's batches (numpy dicts):
    map_per_th, map_50, map_all, test_value, top1_acc, confusion. The model
    is put in eval mode and returned to its former mode."""
    if serve not in ("flax", "fast", "fast_bf16"):
        raise ValueError(f"serve {serve!r}: flax, fast or fast_bf16")
    device = device or next(model.parameters()).device
    was_training = model.training
    model.eval()
    folded = fold_params_for(cfg, model, device) if serve != "flax" else None
    ev = Evaluator(cfg.n_classes)
    try:
        for batch in loader:
            predict = make_predict_core(
                cfg, folded=folded, model=model, bf16=serve == "fast_bf16",
                max_det=max_det, img_slots=img_slot_cap(batch))
            with torch.no_grad():
                out = {k: v.cpu().numpy()
                       for k, v in predict(to_device(batch, device)).items()}
            kept = out["kept"]
            ev.add_proposals(out["pred_label"][kept], batch["labels"][kept])
            for img in range(min(batch["gt_bbox"].shape[0],
                                 int(batch["n_images"]))):
                valid = out["valid"][img]
                gmask = batch["gt_mask"][img]
                w, h = batch["wh"][img]
                gt_px = batch["gt_bbox"][img][gmask] * np.array([w, h, w, h])
                ev.add_image(out["boxes"][img][valid], out["scores"][img][valid],
                             out["classes"][img][valid], gt_px,
                             batch["gt_labels"][img][gmask])
    finally:
        model.train(was_training)
    result = ev.compute()
    if verbose:
        for th, m in zip(result["ths"], result["map_per_th"]):
            print(f"MAP@{th:.2f}: {m:.4f}")
        print(f"MAP@ALL: {result['map_all']:.4f}  top1: {result['top1_acc']:.4f}")
    return result
