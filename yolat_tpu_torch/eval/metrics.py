"""Host-side detection metrics: the exact eval protocol of the reference.

A numpy copy of `yolat_tpu/eval/metrics.py` (whose package init imports
jax), with the loop oracle `batch_statistics_loop`; tests hold it equal
to the original.

Counterparts (utils/det_util.py + cad_recognition/train.py:324-509):
  batch_statistics    get_batch_statistics:154-202 — greedy per-detection TP
                      matching in score order, each GT consumed once, IoU
                      with the +1-pixel convention (bbox_iou:214-244),
                      matching restricted to same-class GTs.
  average_precision   compute_ap:126-151 — PR-envelope AP (py-faster-rcnn).
  ap_per_class        ap_per_class:71-123 — per-class PR/AP over
                      score-sorted detections.
  Evaluator           train.test:324-509 — accumulates detections over the
                      test set at 10 IoU thresholds 0.5:0.05:0.95, reports
                      mAP@th, mAP@ALL, proposal top-1 accuracy and the
                      confusion matrix; `test_value` mirrors the reference's
                      best-checkpoint key (the AP of the LAST threshold row,
                      i.e. AP@0.95 — train.py:508's loop-variable quirk).

These run in numpy on the host: greedy sequential matching is cheap
(hundreds of boxes) and bitwise parity with the reference protocol matters
more than device residency.
"""

from __future__ import annotations

import numpy as np


def _iou_plus1(box, boxes):
    ix0 = np.maximum(box[0], boxes[:, 0])
    iy0 = np.maximum(box[1], boxes[:, 1])
    ix1 = np.minimum(box[2], boxes[:, 2])
    iy1 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(ix1 - ix0 + 1, 0, None) * np.clip(iy1 - iy0 + 1, 0, None)
    a1 = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    a2 = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    return inter / (a1 + a2 - inter + 1e-16)


def _iou_matrix_plus1(a, b):
    """[D, G] IoU matrix with the +1-pixel convention."""
    ix0 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy0 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix1 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy1 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix1 - ix0 + 1, 0, None) * np.clip(iy1 - iy0 + 1, 0, None)
    a1 = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    a2 = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / (a1[:, None] + a2[None, :] - inter + 1e-16)


def batch_statistics(det_boxes, det_scores, det_labels, gt_boxes, gt_labels,
                     iou_threshold: float):
    """Greedy TP assignment for one image.

    Detections must already be score-ordered (NMS emits them that way).
    Returns (true_positives [D], scores [D], labels [D]).

    The IoU/label matching is one [D, G] matrix pass; only the greedy
    consumption scan stays a (cheap) python loop — it is inherently
    sequential, and the reference's exact quirk must hold: a detection
    whose argmax GT is already consumed scores NO true positive, even if
    another unconsumed GT also matches above threshold
    (det_util.get_batch_statistics:154-202).
    """
    D = len(det_boxes)
    G = len(gt_boxes)
    tp = np.zeros(D)
    if G and D:
        det_boxes = np.asarray(det_boxes, dtype=np.float64)
        gt_boxes = np.asarray(gt_boxes, dtype=np.float64)
        iou = _iou_matrix_plus1(det_boxes, gt_boxes)
        matched = (np.asarray(det_labels)[:, None] == np.asarray(gt_labels)[None, :])
        cand = matched & (iou >= iou_threshold)
        # has_cand keeps the loop's class-presence skip exact at
        # iou_threshold <= 0, where the 0.0 mask fill would otherwise pass
        # the >= test for a detection with no same-class GT at all
        has_cand = cand.any(axis=1)
        iou = np.where(cand, iou, 0.0)
        best = np.argmax(iou, axis=1)
        best_iou = iou[np.arange(D), best]
        consumed = np.zeros(G, dtype=bool)
        n_consumed = 0
        for i in range(D):
            if n_consumed == G:
                break
            j = best[i]
            if has_cand[i] and best_iou[i] >= iou_threshold and not consumed[j]:
                tp[i] = 1.0
                consumed[j] = True
                n_consumed += 1
    return tp, det_scores, det_labels


def batch_statistics_loop(det_boxes, det_scores, det_labels, gt_boxes,
                          gt_labels, iou_threshold: float):
    """Per-detection loop form: the direct transliteration of
    det_util.get_batch_statistics:154-202, kept as the fuzz oracle of the
    vectorised batch_statistics."""
    D = len(det_boxes)
    tp = np.zeros(D)
    if len(gt_boxes):
        consumed: list = []
        for i in range(D):
            if len(consumed) == len(gt_boxes):
                break
            if det_labels[i] not in gt_labels:
                continue
            iou = _iou_plus1(det_boxes[i], gt_boxes)
            matched = (gt_labels == det_labels[i]) & (iou >= iou_threshold)
            iou = np.where(matched, iou, 0.0)
            j = int(np.argmax(iou))
            if iou[j] >= iou_threshold and j not in consumed:
                tp[i] = 1
                consumed.append(j)
    return tp, det_scores, det_labels


def average_precision(recall, precision):
    """PR-envelope AP."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def ap_per_class(tp, conf, pred_cls, target_cls):
    """Per-class AP over all detections of the split.

    Returns (precision, recall, AP, f1, classes) over the unique classes
    present in the ground truth.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    target_cls = np.asarray(target_cls)
    classes = np.unique(target_cls)

    p, r, ap = [], [], []
    for c in classes:
        sel = pred_cls == c
        n_gt = int((target_cls == c).sum())
        n_p = int(sel.sum())
        if n_p == 0 and n_gt == 0:
            continue
        if n_p == 0 or n_gt == 0:
            p.append(0.0)
            r.append(0.0)
            ap.append(0.0)
            continue
        tpc = np.cumsum(tp[sel])
        fpc = np.cumsum(1 - tp[sel])
        recall = tpc / (n_gt + 1e-16)
        precision = tpc / (tpc + fpc)
        r.append(float(recall[-1]))
        p.append(float(precision[-1]))
        ap.append(average_precision(recall, precision))

    p, r, ap = np.array(p), np.array(r), np.array(ap)
    f1 = 2 * p * r / (p + r + 1e-16)
    return p, r, ap, f1, classes.astype(np.int64)


class Evaluator:
    """Accumulates NMS outputs + GT over a test split; computes the full
    reference metric table."""

    def __init__(self, n_classes: int, iou_thresholds=None):
        self.n_classes = n_classes
        self.ths = (
            np.asarray(iou_thresholds)
            if iou_thresholds is not None
            else np.linspace(0.5, 0.95, 10)
        )
        self.samples = [[] for _ in self.ths]
        self.gt_labels_all: list = []
        self.n_true = 0
        self.n_total = 0
        self.confusion = np.zeros((n_classes, n_classes), dtype=np.int64)

    def image_stats(self, det_boxes, det_scores, det_labels, gt_boxes_px,
                    gt_labels):
        """One image's statistics (per threshold, `batch_statistics`) and
        GT labels: what `add_image` accumulates, as a host object that a
        rank can send (`eval/runner.evaluate(group=)`)."""
        return ([batch_statistics(det_boxes, det_scores, det_labels,
                                  gt_boxes_px, gt_labels, float(th))
                 for th in self.ths], list(gt_labels))

    def add_image_stats(self, stats) -> None:
        samples, gt_labels = stats
        self.gt_labels_all += gt_labels
        for i, s in enumerate(samples):
            self.samples[i].append(s)

    def add_image(self, det_boxes, det_scores, det_labels, gt_boxes_px, gt_labels):
        """All arrays numpy; det_* already NMS-filtered & score-ordered;
        gt boxes in pixels."""
        self.add_image_stats(self.image_stats(det_boxes, det_scores,
                                              det_labels, gt_boxes_px,
                                              gt_labels))

    def proposal_stats(self, pred_label, gt_label):
        """(correct, total, confusion counts) of one batch's proposals."""
        pred_label = np.asarray(pred_label)
        gt_label = np.asarray(gt_label)
        confusion = np.zeros_like(self.confusion)
        np.add.at(confusion, (gt_label, pred_label), 1)
        return int((pred_label == gt_label).sum()), len(pred_label), confusion

    def add_proposal_stats(self, stats) -> None:
        n_true, n_total, confusion = stats
        self.n_true += n_true
        self.n_total += n_total
        self.confusion += confusion

    def add_proposals(self, pred_label, gt_label):
        """Proposal-level top-1 accuracy + confusion (train.py:383-388)."""
        self.add_proposal_stats(self.proposal_stats(pred_label, gt_label))

    def compute(self) -> dict:
        out = {"map_per_th": [], "ths": self.ths.tolist()}
        ap_total = 0.0
        last_map = 0.0
        for i, th in enumerate(self.ths):
            if not self.samples[i]:
                out["map_per_th"].append(0.0)
                continue
            tp = np.concatenate([s[0] for s in self.samples[i]])
            conf = np.concatenate([s[1] for s in self.samples[i]])
            cls = np.concatenate([s[2] for s in self.samples[i]])
            _, _, ap, _, _ = ap_per_class(tp, conf, cls, self.gt_labels_all)
            last_map = float(np.mean(ap)) if len(ap) else 0.0
            out["map_per_th"].append(last_map)
            ap_total += last_map
        out["map_50"] = out["map_per_th"][0] if out["map_per_th"] else 0.0
        out["map_all"] = ap_total / max(len(self.ths), 1)
        # reference best-model key: AP at the last threshold (train.py:508)
        out["test_value"] = last_map
        out["top1_acc"] = self.n_true / max(self.n_total, 1)
        out["confusion"] = self.confusion
        return out


def format_confusion(confusion: np.ndarray, class_dict: dict) -> str:
    """The reference's confusion-matrix printout (train.py:493-505)."""
    names = [""] * len(class_dict)
    for k, v in class_dict.items():
        names[v] = k
    lines = ["          " + "".join(f"{n:>12}" for n in names)]
    for i, row in enumerate(confusion):
        lines.append(f"{names[i]:>10}" + "".join(f"{v:12d}" for v in row))
    return "\n".join(lines)
