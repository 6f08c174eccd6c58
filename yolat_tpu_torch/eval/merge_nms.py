"""Greedy weighted-merge NMS, on the host.

A numpy copy of `yolat_tpu/eval/merge_nms.py` (whose package init imports
jax), the counterpart of the reference's utils/det_util.py
non_max_suppression:365-414, which the visual detect driver runs at conf
0.75 (detect.py:340): detections are taken in score order (a stable
sort); every same-class detection overlapping the current best above the
IoU threshold (the "+1"-pixel IoU) is absorbed, and the kept box becomes
the confidence-weighted mean of the absorbed boxes, in float64.
tests/test_torch_detect.py holds it bit for bit to the original.
"""

from __future__ import annotations

import numpy as np


def _iou_one_to_many(box, boxes):
    ix0 = np.maximum(box[0], boxes[:, 0])
    iy0 = np.maximum(box[1], boxes[:, 1])
    ix1 = np.minimum(box[2], boxes[:, 2])
    iy1 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(ix1 - ix0 + 1, 0, None) * np.clip(iy1 - iy0 + 1, 0, None)
    a1 = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    a2 = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    return inter / (a1 + a2 - inter + 1e-16)


def merge_nms(boxes, obj_conf, cls_scores, conf_thres: float = 0.5,
              nms_thres: float = 0.4):
    """Args: boxes [M,4], obj_conf [M], cls_scores [M,K].

    Returns dict(boxes, obj_conf, cls_conf, classes) of kept detections,
    score-ordered, boxes confidence-weight merged.
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    obj_conf = np.asarray(obj_conf, dtype=np.float64)
    cls_scores = np.asarray(cls_scores, dtype=np.float64)

    keep_mask = obj_conf >= conf_thres
    boxes, obj_conf, cls_scores = (boxes[keep_mask], obj_conf[keep_mask],
                                   cls_scores[keep_mask])
    if len(boxes) == 0:
        return {"boxes": np.zeros((0, 4)), "obj_conf": np.zeros(0),
                "cls_conf": np.zeros(0), "classes": np.zeros(0, np.int64)}

    score = obj_conf * cls_scores.max(axis=1)
    order = np.argsort(-score, kind="stable")
    boxes, obj_conf, cls_scores = boxes[order], obj_conf[order], cls_scores[order]
    cls_conf = cls_scores.max(axis=1)
    classes = cls_scores.argmax(axis=1)

    out_boxes, out_obj, out_cls_conf, out_classes = [], [], [], []
    alive = np.ones(len(boxes), bool)
    while alive.any():
        i = int(np.argmax(alive))
        iou = _iou_one_to_many(boxes[i], boxes)
        absorb = alive & (iou > nms_thres) & (classes == classes[i])
        absorb[i] = True
        w = obj_conf[absorb][:, None]
        merged = (w * boxes[absorb]).sum(axis=0) / w.sum()
        out_boxes.append(merged)
        out_obj.append(obj_conf[i])
        out_cls_conf.append(cls_conf[i])
        out_classes.append(classes[i])
        alive &= ~absorb

    return {
        "boxes": np.asarray(out_boxes),
        "obj_conf": np.asarray(out_obj),
        "cls_conf": np.asarray(out_cls_conf),
        "classes": np.asarray(out_classes, dtype=np.int64),
    }
