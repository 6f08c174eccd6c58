"""One-pass prediction + NMS over a packed batch.

Counterpart of `yolat_tpu/eval/predict.py:78-186` (`make_predict_core`,
with its dispatch on the arch, :91-113: a YOLaT++ config runs
`fast_forward_pp`) and `yolat_tpu/eval/runner.py:40` (`img_slot_cap`). In eval mode the
reference's two passes (roots, then children of background roots) reduce
to one forward over all proposals plus a selection mask
  keep(p) = is_root(p) or argmax(logits[root_of(p)]) == background,
then the x1.05 box inflation, the score rewrite [1 - p_bg, p_0..p_K-1],
pixel scaling, a per-image slot layout and class-offset NMS.
"""

from __future__ import annotations

import numpy as np
import torch

from yolat_tpu_torch.config import PP_ARCHS
from yolat_tpu_torch.data.packing import finalize_batch
from yolat_tpu_torch.eval.fast_forward import fast_forward, fast_forward_pp
from yolat_tpu_torch.ops.iou import inflate_boxes
from yolat_tpu_torch.ops.nms import batched_nms


def img_slot_cap(batch: dict, quantum: int = 256) -> int:
    """Per-image NMS slot cap of one numpy batch: the max real-proposal
    count of any image, rounded up to `quantum`. Exact by construction,
    so the capped layout gives the same detections as the uncapped one."""
    real = np.asarray(batch["image_id"])[np.asarray(batch["proposal_mask"])]
    mx = int(np.bincount(real).max()) if real.size else 1
    return -(-mx // quantum) * quantum


def make_predict_core(cfg, folded=None, model=None, bf16: bool = False,
                      max_det: int = 300, img_slots: int | None = None,
                      detections_only: bool = False):
    """Returns predict(batch) -> detections dict, for a tensor batch.

    With `folded` (eval/fast_forward.fold_params_for) the forward runs
    the arch's folded-BN engine (bf16 selects its precision); otherwise the
    eval-mode `model`.
    Output (leading axis = image slot): boxes [B, max_det, 4] pixel xyxy,
    scores [B, max_det], classes [B, max_det] i32, valid [B, max_det];
    unless detections_only, also pred_label/kept [P] and the per-proposal
    prop_boxes/prop_obj/prop_cls.
    """
    if folded is None and model is None:
        raise ValueError("make_predict_core needs folded params or the model")
    background = cfg.n_classes - 1
    engine = (fast_forward_pp if getattr(cfg, "arch", "") in PP_ARCHS
              else fast_forward)

    @torch.no_grad()
    def predict(batch):
        batch = finalize_batch(batch)
        if folded is not None:
            logits, prop_boxes = engine(folded, batch, bf16=bf16)
        else:
            logits, prop_boxes = model(batch)

        pred_label = torch.argmax(logits, dim=1)
        root_is_bg = pred_label[batch["root_slot"].long()] == background
        kept = batch["proposal_mask"] & (batch["is_root"] | root_is_bg)
        boxes = inflate_boxes(prop_boxes, 1.05)
        probs = torch.softmax(logits, dim=1) if cfg.classifier == "softmax" \
            else logits
        obj = 1.0 - probs[:, background]
        cls_scores = probs[:, :background]

        image_id = batch["image_id"].long()
        wh = batch["wh"][image_id]
        boxes = boxes * torch.cat([wh, wh], dim=1)

        # proposals are packed contiguously per image: position within the
        # image = index - first index of the image
        P = logits.shape[0]
        B = batch["gt_bbox"].shape[0]
        arange = torch.arange(P, device=logits.device)
        first = torch.full((B,), P, dtype=arange.dtype, device=arange.device)
        first = first.scatter_reduce(
            0, image_id, torch.where(batch["proposal_mask"], arange,
                                     torch.full_like(arange, P)), "amin")
        idx_in_img = arange - first[image_id]
        S = P if img_slots is None else min(int(img_slots), P)
        ok = kept & (idx_in_img < S)
        # rows not kept (or past the cap) go to a trash slot B*S
        flat_slot = torch.where(ok, image_id * S + torch.clamp(idx_in_img, 0, S - 1),
                                torch.full_like(arange, B * S))

        def scatter(v, fill=0.0):
            out = torch.full((B * S + 1,) + v.shape[1:], fill, dtype=v.dtype,
                             device=v.device)
            m = ok.reshape(ok.shape + (1,) * (v.dim() - 1))
            out[flat_slot] = torch.where(m, v, torch.full_like(v, fill))
            return out[:B * S]

        nms = batched_nms(
            scatter(boxes).reshape(B, S, 4),
            scatter(cls_scores).reshape(B, S, background),
            scatter(obj).reshape(B, S),
            scatter(kept, False).reshape(B, S),
            iou_thres=cfg.nms_iou, conf_thres=cfg.nms_conf, max_det=max_det,
            algorithm=cfg.nms_algorithm, topk=cfg.nms_topk)
        if detections_only:
            return nms
        nms.update(pred_label=pred_label, kept=kept, prop_boxes=boxes,
                   prop_obj=obj, prop_cls=cls_scores)
        return nms

    return predict
