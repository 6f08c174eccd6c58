"""Box IoU and the predict-time box inflation.

Counterpart of `yolat_tpu/ops/iou.py` (`box_iou_matrix` :26,
`xywh_to_xyxy` :49, `inflate_boxes` :61): no +1-pixel convention unless
`plus1` (the reference's eval-protocol variant, det_util.py:214-244).
"""

from __future__ import annotations

import torch


def box_iou_matrix(a, b, plus1: bool = False):
    """IoU matrix [A, B] between box sets [A, 4] and [B, 4] (xyxy)."""
    p = 1.0 if plus1 else 0.0
    a_, b_ = a[:, None, :], b[None, :, :]
    iw = torch.clamp(torch.minimum(a_[..., 2], b_[..., 2])
                     - torch.maximum(a_[..., 0], b_[..., 0]) + p, min=0)
    ih = torch.clamp(torch.minimum(a_[..., 3], b_[..., 3])
                     - torch.maximum(a_[..., 1], b_[..., 1]) + p, min=0)
    inter = iw * ih
    area_a = (a_[..., 2] - a_[..., 0] + p) * (a_[..., 3] - a_[..., 1] + p)
    area_b = (b_[..., 2] - b_[..., 0] + p) * (b_[..., 3] - b_[..., 1] + p)
    return inter / (area_a + area_b - inter + 1e-16)


def xywh_to_xyxy(x):
    return torch.stack([x[..., 0] - x[..., 2] / 2, x[..., 1] - x[..., 3] / 2,
                        x[..., 0] + x[..., 2] / 2, x[..., 1] + x[..., 3] / 2],
                       dim=-1)


def inflate_boxes(boxes, factor: float = 1.05):
    """Scale boxes about their centres (predict's x1.05 inflation,
    architecture3cc_rpn_gp_iter2.py:339-351)."""
    c = (boxes[..., 0:2] + boxes[..., 2:4]) / 2
    wh = (boxes[..., 2:4] - boxes[..., 0:2]) * factor
    return torch.cat([c - wh / 2, c + wh / 2], dim=-1)
