"""Fixed-shape class-offset NMS over a batch of images.

Counterpart of `yolat_tpu/ops/nms.py:31-316` (`single_image_nms` with the
`fixpoint` default, the `loop` oracle and the per-class `classfix`):
YOLOv5-style batched NMS with the class-offset trick (offset 4096) over
multi-label candidates conf = objectness * class score > conf_thres,
greedy suppression at IoU > iou_thres, at most max_det detections.

`fixpoint` is exact greedy NMS over the top-C candidates: the fixed point
of kept_i = valid_i and no kept j ranked above i with IoU > th. The JAX
function's `lax.top_k` ranks equal scores lowest index first; torch.topk
promises no order, so candidates are ranked with a stable sort of -score.
Here the images of a batch run together ([B, ...] leading axis). Both
fixed points run on the device (`ops/nms_fixpoint.py`, kernel N1) for CUDA
tensors, as the JAX package's `lax.while_loop`s do, and as the plain loop
for CPU tensors. `loop` reads back per pick and cannot be captured in a
CUDA graph: the graph route (`eval/predict.make_serving_fn`) refuses it.

`classfix` is exact greedy NMS over all M x K candidates: classes never
suppress each other under the class offset, so the [M, M] box IoU is
formed once and the same recurrence runs per class, with "j outranks i"
read off a rank from one stable sort of -score per class (equal scores:
the lower box index first). The final max_det detections are the best
kept scores over the class-major [K, M] layout, again by a stable sort.
"""

from __future__ import annotations

import torch

from yolat_tpu_torch.ops.nms_fixpoint import classfix_kept, fixpoint_kept

MAX_WH = 4096.0  # class-offset magnitude (train.py:45)
MAX_NMS = 30000  # candidate cap before suppression (train.py:47)


def batched_nms(boxes, cls_scores, obj_scores, valid, iou_thres: float = 0.5,
                conf_thres: float = 0.0, max_det: int = 300,
                algorithm: str = "fixpoint", topk: int = 4096) -> dict:
    """boxes [B, M, 4] pixel xyxy, cls_scores [B, M, K] (background
    dropped), obj_scores [B, M], valid [B, M] bool -> dict of
    boxes [B, max_det, 4], scores [B, max_det], classes [B, max_det] i32
    (-1 where empty), valid [B, max_det] bool."""
    B, M, K = cls_scores.shape
    conf = cls_scores * obj_scores[..., None]
    conf = torch.where(valid[..., None], conf, torch.full_like(conf, -1.0))
    cand_valid = conf > conf_thres  # strictly greater (train.py:81)
    if algorithm == "fixpoint":
        return _fixpoint_nms(conf.reshape(B, M * K), cand_valid.reshape(B, M * K),
                             boxes, K, iou_thres, max_det,
                             min(topk, MAX_NMS, M * K))
    if algorithm == "loop":
        outs = [_loop_nms(boxes[b], conf[b], cand_valid[b], iou_thres,
                          max_det) for b in range(B)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    if algorithm == "classfix":
        return _class_fixpoint_nms(boxes, conf, cand_valid, iou_thres, max_det)
    raise ValueError(f"nms algorithm {algorithm!r}: 'fixpoint', 'loop' or "
                     "'classfix'")


def single_image_nms(boxes, cls_scores, obj_scores, valid, **kw) -> dict:
    """NMS over one image's proposals ([M, ...] inputs, [max_det, ...])."""
    out = batched_nms(boxes[None], cls_scores[None], obj_scores[None],
                      valid[None], **kw)
    return {k: v[0] for k, v in out.items()}


def _pair_iou(a, b):
    """IoU of broadcastable xyxy box tensors [..., 4]."""
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2])
                     - torch.maximum(a[..., 0], b[..., 0]), min=0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3])
                     - torch.maximum(a[..., 1], b[..., 1]), min=0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + 1e-16)


def _fixpoint_nms(flat_conf, cand_valid, boxes, K: int, iou_thres: float,
                  max_det: int, C: int) -> dict:
    scores = torch.where(cand_valid, flat_conf,
                         torch.full_like(flat_conf, float("-inf")))
    neg, top_idx = torch.sort(-scores, dim=1, stable=True)
    top_idx = top_idx[:, :C]
    top_scores = -neg[:, :C]
    tvalid = cand_valid.gather(1, top_idx)
    # flat candidate index = proposal * K + class
    cl = (top_idx % K).to(torch.int32)
    bx = boxes.gather(1, (top_idx // K)[..., None].expand(-1, -1, 4))
    ob = bx + cl[..., None].to(bx.dtype) * MAX_WH
    iou = _pair_iou(ob[:, :, None, :], ob[:, None, :, :])
    # j suppresses i only if j outranks i (strictly lower triangle)
    above = torch.ones(C, C, dtype=torch.bool, device=ob.device).tril(-1)
    sup = (iou > iou_thres) & above
    kept = fixpoint_kept(sup, tvalid)

    rank = torch.cumsum(kept.to(torch.int64), dim=1) - 1
    sel = kept & (rank < max_det)
    slot = torch.where(sel, rank, torch.full_like(rank, max_det))
    B = kept.shape[0]

    def place(vals, fill):
        shape = (B, max_det + 1) + vals.shape[2:]
        out = torch.full(shape, fill, dtype=vals.dtype, device=vals.device)
        s = slot.reshape(slot.shape + (1,) * (vals.dim() - 2)).expand_as(vals)
        m = sel.reshape(sel.shape + (1,) * (vals.dim() - 2))
        return out.scatter_(1, s, torch.where(m, vals, torch.full_like(vals, fill))
                            )[:, :max_det]

    count = torch.clamp(kept.sum(dim=1), max=max_det)
    det_valid = (torch.arange(max_det, device=kept.device)[None, :]
                 < count[:, None])
    det_classes = place(cl, -1)
    return {
        "boxes": place(bx, 0.0),
        "scores": place(top_scores, 0.0),
        "classes": torch.where(det_valid, det_classes,
                               torch.full_like(det_classes, -1)),
        "valid": det_valid,
    }


def _class_fixpoint_nms(boxes, conf, cand_valid, iou_thres: float,
                        max_det: int) -> dict:
    """boxes [B, M, 4], conf / cand_valid [B, M, K]
    (`yolat_tpu/ops/nms.py:232-316`)."""
    B, M, K = conf.shape
    dev = conf.device
    overb = _pair_iou(boxes[:, :, None, :], boxes[:, None, :, :]) > iou_thres
    s = conf.transpose(1, 2)                      # [B, K, M]
    cand = cand_valid.transpose(1, 2)
    order = torch.sort(-s, dim=2, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        2, order, torch.arange(M, device=dev).expand(B, K, M)
    ).to(torch.int32)
    kept = classfix_kept(overb, rank, cand.contiguous())

    flat = torch.where(kept, s, torch.full_like(s, float("-inf"))
                       ).reshape(B, K * M)
    kk = min(max_det, K * M)
    neg, flat_idx = torch.sort(-flat, dim=1, stable=True)
    det_scores, flat_idx = -neg[:, :kk], flat_idx[:, :kk]
    if kk < max_det:
        det_scores = torch.cat([det_scores, det_scores.new_full(
            (B, max_det - kk), float("-inf"))], dim=1)
        flat_idx = torch.cat([flat_idx, flat_idx.new_zeros(
            (B, max_det - kk))], dim=1)
    det_valid = det_scores > float("-inf")
    det_boxes = boxes.gather(1, (flat_idx % M)[..., None].expand(-1, -1, 4))
    cls_idx = (flat_idx // M).to(torch.int32)
    return {
        "boxes": torch.where(det_valid[..., None], det_boxes,
                             torch.zeros_like(det_boxes)),
        "scores": torch.where(det_valid, det_scores,
                              torch.zeros_like(det_scores)),
        "classes": torch.where(det_valid, cls_idx,
                               torch.full_like(cls_idx, -1)),
        "valid": det_valid,
    }


def _loop_nms(boxes, conf, cand_valid, iou_thres: float, max_det: int) -> dict:
    """The literal greedy loop over all candidates of one image
    (torchvision semantics oracle)."""
    M, K = conf.shape
    n = M * K
    dev = conf.device
    flat_conf = conf.reshape(n)
    cv = cand_valid.reshape(n)
    classes = torch.arange(K, dtype=torch.int32, device=dev).repeat(M)
    box_rep = boxes.repeat_interleave(K, dim=0)
    order = torch.sort(-torch.where(cv, flat_conf, torch.full_like(
        flat_conf, float("-inf"))), stable=True).indices
    flat_conf, cv = flat_conf[order], cv[order]
    classes, box_rep = classes[order], box_rep[order]
    offset_boxes = box_rep + classes[:, None].to(box_rep.dtype) * MAX_WH
    alive = cv & (torch.arange(n, device=dev) < MAX_NMS)
    picks = []
    while len(picks) < max_det and bool(alive.any()):
        pick = int(torch.nonzero(alive)[0])
        alive &= ~(_pair_iou(offset_boxes[pick], offset_boxes) > iou_thres)
        alive[pick] = False
        picks.append(pick)
    count = len(picks)
    out_idx = torch.full((max_det,), n - 1, dtype=torch.int64, device=dev)
    out_idx[:count] = torch.tensor(picks, dtype=torch.int64, device=dev)
    det_valid = torch.arange(max_det, device=dev) < count
    return {
        "boxes": torch.where(det_valid[:, None], box_rep[out_idx],
                             torch.zeros_like(box_rep[out_idx])),
        "scores": torch.where(det_valid, flat_conf[out_idx],
                              torch.zeros_like(flat_conf[out_idx])),
        "classes": torch.where(det_valid, classes[out_idx],
                               torch.full_like(classes[out_idx], -1)),
        "valid": det_valid,
    }
