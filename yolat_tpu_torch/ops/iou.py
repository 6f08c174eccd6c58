"""Box IoU and the predict-time box inflation.

Counterpart of `yolat_tpu/ops/iou.py` (`box_iou_matrix` :26,
`box_iou_pairwise` :36, `box_iou_plus1` :44, `xywh_to_xyxy` :49,
`inflate_boxes` :61): no +1-pixel convention unless `plus1` (the
reference's eval-protocol variant, det_util.py:214-244).
"""

from __future__ import annotations

import torch


def _inter(b1, b2, p: float):
    iw = torch.clamp(torch.minimum(b1[..., 2], b2[..., 2])
                     - torch.maximum(b1[..., 0], b2[..., 0]) + p, min=0)
    ih = torch.clamp(torch.minimum(b1[..., 3], b2[..., 3])
                     - torch.maximum(b1[..., 1], b2[..., 1]) + p, min=0)
    return iw * ih


def _area(b, p: float):
    return (b[..., 2] - b[..., 0] + p) * (b[..., 3] - b[..., 1] + p)


def box_iou_pairwise(a, b, plus1: bool = False):
    """Elementwise IoU between aligned box arrays [..., 4] (xyxy)."""
    p = 1.0 if plus1 else 0.0
    inter = _inter(a, b, p)
    return inter / (_area(a, p) + _area(b, p) - inter + 1e-16)


def box_iou_matrix(a, b, plus1: bool = False):
    """IoU matrix [A, B] between box sets [A, 4] and [B, 4] (xyxy)."""
    return box_iou_pairwise(a[:, None, :], b[None, :, :], plus1)


def box_iou_plus1(a, b):
    """The eval-protocol variant (det_util.bbox_iou:214-244)."""
    return box_iou_matrix(a, b, plus1=True)


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
