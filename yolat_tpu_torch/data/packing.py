"""Flat-packed, statically-shaped batches for the canonical detector.

Counterpart of `yolat_tpu/data/packing.py`: `PadSizes` (:53-79),
`CompactFile` (:98-289), `pack_files` (:362-579), `finalize_batch`
(:587-670, with the train-time augmentation and edge dropout) and
`_seg_min` (:747). That module reaches `yolat_tpu.ops.segment`
(and so jax) inside `CompactFile` and `pack_files`, so the port carries
its own jax-free copy, restricted to the keys the canonical detector reads:

  pos [N,2] f32, node_mask [N] bool, bbox_idx [N] i32 (sorted),
  edge [E,2] i32 (dst-sorted, padding rows at the front), e_attr [E,4] f32,
  edge_mask [E] bool, labels [P] i32, proposal_mask [P] bool,
  bbox [P,4] f32, label_iou [P] f32, label_iou_rel [P] f32,
  image_id [P] i32, is_root [P] bool, root_slot [P] i32,
  gt_bbox [B,G,4], gt_labels [B,G], gt_mask [B,G], wh [B,2], n_images,
  dst_count [N] f32, prop_count [P] f32, pool_* (aligned pool plan),
  ew_* (edge-window plan, in the CUDA kernel's layout).

For those keys other than ew_* `pack_files` is bitwise equal to
`yolat_tpu`'s (tests/test_torch_packing.py). No dense neighbour table:
the port's conv route (the edge-window message sum) does not read one.
"""

from __future__ import annotations

import numpy as np
import torch

from yolat_tpu_torch.ops.plans import (POOL_BLOCK, edge_window_plan,
                                       plan_of, pool_plan)
from yolat_tpu_torch.ops.segment import NEG, _two_level, segment_broadcast


def round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


class PadSizes:
    """Static bucket sizes for one batch shape (no super-edge family)."""

    def __init__(self, n_nodes, n_edges, n_proposals, n_gt, n_images):
        self.n_nodes = n_nodes
        self.n_edges = n_edges
        self.n_proposals = n_proposals
        self.n_gt = n_gt
        self.n_images = n_images


class CompactFile:
    """A ProposalFile in packed-batch dtypes: edges dst-sorted, each
    proposal's node run padded to a multiple of POOL_BLOCK (masked rows
    carrying the run's bbox_idx), and the per-proposal root pointer
    materialised."""

    __slots__ = ("pos", "node_mask", "bbox_idx", "edge", "e_attr",
                 "dst_count", "prop_count", "labels", "bbox", "label_iou",
                 "label_iou_rel", "is_root_mask", "root_slot_local",
                 "n_proposals")

    def __init__(self, f, n_classes=None):
        bbox_idx = np.asarray(f.bbox_idx, np.int64)
        pos = np.asarray(f.pos, np.float32)
        n_prop = len(np.asarray(f.labels))
        counts = np.bincount(bbox_idx, minlength=n_prop)
        new_counts = ((counts + POOL_BLOCK - 1) // POOL_BLOCK) * POOL_BLOCK
        new_counts[counts == 0] = 0
        old_starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        new_starts = np.concatenate([[0], np.cumsum(new_counts)[:-1]])
        old2new = (new_starts[bbox_idx]
                   + (np.arange(len(bbox_idx)) - old_starts[bbox_idx]))
        n2 = int(new_counts.sum())
        self.pos = np.zeros((n2, 2), np.float32)
        self.pos[old2new] = pos
        self.node_mask = np.zeros(n2, bool)
        self.node_mask[old2new] = True
        self.bbox_idx = np.repeat(np.arange(n_prop, dtype=np.int32), new_counts)
        # stable dst sort + endpoint remap; old2new is strictly increasing,
        # so the remapped list stays dst-sorted
        edge = np.asarray(f.edge, np.int64)
        eo = np.argsort(edge[:, 1], kind="stable")
        self.edge = np.ascontiguousarray(old2new[edge[eo]], np.int32)
        self.e_attr = np.ascontiguousarray(
            np.asarray(f.e_attr)[eo, 0:4], np.float32)
        self.dst_count = np.bincount(
            self.edge[:, 1], minlength=n2).astype(np.float32)
        self.prop_count = counts.astype(np.float32)
        self.labels = np.ascontiguousarray(f.labels, np.int32)
        self.bbox = np.ascontiguousarray(f.bbox, np.float32)
        self.label_iou, self.label_iou_rel = _label_quality(
            f, self.labels, n_classes)
        self.n_proposals = len(self.labels)
        self.is_root_mask = np.zeros(self.n_proposals, bool)
        self.is_root_mask[np.asarray(f.root_of_cc, np.int64)] = True
        self.root_slot_local = np.repeat(
            np.asarray(f.root_of_cc, np.int32), np.diff(np.asarray(f.cc_slice)))


def _label_quality(f, labels, n_classes):
    """(label_iou, label_iou_rel) [P] f32: IoU of each positive proposal
    with its matched GT box (from the labeler's bbox_targets), and that IoU
    over the best IoU of its sibling group (same GT box and label); 0 for
    background. Positivity from the label when n_classes is known, else
    from a nonzero target box (packing.py:240-280)."""
    tgt = np.asarray(f.bbox_targets, np.float64)
    box = np.asarray(f.bbox, np.float64)
    if n_classes is not None:
        pos_lbl = labels != (n_classes - 1)
    else:
        pos_lbl = tgt.any(axis=1)
    ix0 = np.maximum(box[:, 0], tgt[:, 0])
    iy0 = np.maximum(box[:, 1], tgt[:, 1])
    ix1 = np.minimum(box[:, 2], tgt[:, 2])
    iy1 = np.minimum(box[:, 3], tgt[:, 3])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
    ab = (box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1])
    at = (tgt[:, 2] - tgt[:, 0]) * (tgt[:, 3] - tgt[:, 1])
    iou = inter / np.maximum(ab + at - inter, 1e-12)
    rel = np.zeros_like(iou)
    if pos_lbl.any():
        keys = np.concatenate(
            [tgt[pos_lbl].round(9),
             labels[pos_lbl][:, None].astype(np.float64)], axis=1)
        _, grp = np.unique(keys, axis=0, return_inverse=True)
        grp = grp.reshape(-1)
        gmax = np.zeros(int(grp.max()) + 1)
        np.maximum.at(gmax, grp, iou[pos_lbl])
        rel[pos_lbl] = iou[pos_lbl] / np.maximum(gmax[grp], 1e-12)
    return (np.where(pos_lbl, iou, 0.0).astype(np.float32),
            np.where(pos_lbl, rel, 0.0).astype(np.float32))


def pack_files(files: list, gts: list, whs: list, pad: PadSizes,
               edge_window: bool = True) -> dict:
    """Concatenate CompactFiles into one padded flat batch (numpy).

    Real edge rows fill the END of the edge buffer (padding rows keep dst 0
    at the front), so per-file dst-sorted lists concatenate into a globally
    dst-sorted batch. Attaches the aligned pool plan and, with
    `edge_window`, the edge-window plan.
    """
    B = pad.n_images
    if len(files) > B:
        raise ValueError(f"{len(files)} files for {B} image slots")
    E_tot = sum(len(f.edge) for f in files)
    N_tot = sum(len(f.pos) for f in files)
    P_tot = sum(f.n_proposals for f in files)
    if N_tot > pad.n_nodes or E_tot > pad.n_edges or P_tot > pad.n_proposals:
        raise ValueError("pad sizes too small for batch contents")

    batch = {
        "pos": np.zeros((pad.n_nodes, 2), np.float32),
        "node_mask": np.zeros(pad.n_nodes, bool),
        # padding nodes point at the last proposal slot: bbox_idx stays sorted
        "bbox_idx": np.full(pad.n_nodes, pad.n_proposals - 1, np.int32),
        "edge": np.zeros((pad.n_edges, 2), np.int32),
        "e_attr": np.zeros((pad.n_edges, 4), np.float32),
        "edge_mask": np.zeros(pad.n_edges, bool),
        "labels": np.zeros(pad.n_proposals, np.int32),
        "proposal_mask": np.zeros(pad.n_proposals, bool),
        "bbox": np.zeros((pad.n_proposals, 4), np.float32),
        "label_iou": np.zeros(pad.n_proposals, np.float32),
        "label_iou_rel": np.zeros(pad.n_proposals, np.float32),
        "image_id": np.zeros(pad.n_proposals, np.int32),
        "is_root": np.zeros(pad.n_proposals, bool),
        "root_slot": np.zeros(pad.n_proposals, np.int32),
        "gt_bbox": np.zeros((B, pad.n_gt, 4), np.float32),
        "gt_labels": np.zeros((B, pad.n_gt), np.int32),
        "gt_mask": np.zeros((B, pad.n_gt), bool),
        "wh": np.ones((B, 2), np.float32),
        "n_images": np.int32(len(files)),
        "dst_count": np.zeros(pad.n_nodes, np.float32),
        "prop_count": np.zeros(pad.n_proposals, np.float32),
    }

    n_off = p_off = 0
    e_off = pad.n_edges - E_tot
    for img, (f, (gt_bbox, gt_labels), wh) in enumerate(zip(files, gts, whs)):
        n, e, p = len(f.pos), len(f.edge), f.n_proposals
        batch["pos"][n_off:n_off + n] = f.pos
        batch["node_mask"][n_off:n_off + n] = f.node_mask
        np.add(f.bbox_idx, np.int32(p_off),
               out=batch["bbox_idx"][n_off:n_off + n])
        np.add(f.edge, np.int32(n_off), out=batch["edge"][e_off:e_off + e])
        batch["e_attr"][e_off:e_off + e] = f.e_attr
        batch["edge_mask"][e_off:e_off + e] = True
        batch["labels"][p_off:p_off + p] = f.labels
        batch["proposal_mask"][p_off:p_off + p] = True
        batch["bbox"][p_off:p_off + p] = f.bbox
        batch["label_iou"][p_off:p_off + p] = f.label_iou
        batch["label_iou_rel"][p_off:p_off + p] = f.label_iou_rel
        batch["image_id"][p_off:p_off + p] = img
        batch["is_root"][p_off:p_off + p] = f.is_root_mask
        np.add(f.root_slot_local, np.int32(p_off),
               out=batch["root_slot"][p_off:p_off + p])
        batch["dst_count"][n_off:n_off + n] = f.dst_count
        batch["prop_count"][p_off:p_off + p] = f.prop_count
        g = len(gt_bbox)
        batch["gt_bbox"][img, :g] = gt_bbox
        batch["gt_labels"][img, :g] = gt_labels
        batch["gt_mask"][img, :g] = True
        batch["wh"][img] = wh
        n_off += n
        e_off += e
        p_off += p

    # every proposal run is block-aligned, so no block straddles a segment
    batch.update(pool_plan(batch["bbox_idx"], pad.n_proposals, cap=0))
    if edge_window:
        batch.update(edge_window_plan(batch["edge"], batch["edge_mask"],
                                      batch["e_attr"], pad.n_nodes))
    return batch


def to_device(batch: dict, device) -> dict:
    """numpy batch -> dict of tensors on `device` (scalars stay Python)."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = torch.from_numpy(v).to(device) if v.ndim else v.item()
    return out


def draw_augmentation(n_images: int, generator: torch.Generator, device):
    """Per-image augmentation parameters, as packing.py:624-628 draws them:
    scale 1 +- 0.6 [B], angle U[0, 2pi) [B], translate +-0.1 [B, 2], axis
    flips [B, 2] bool."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return (u(n_images) * 1.2 + 0.4, u(n_images) * 2.0 * np.pi,
            (u(n_images, 2) * 2.0 - 1.0) * 0.1, u(n_images, 2) < 0.5)


def _seg_min(vals, seg, n: int, mask, big: float, plan=None):
    """Masked segment min of vals [N, C]; empty segments give 0."""
    if plan is not None:
        out = -_two_level(-vals, mask, plan, n, "max", -big)
    else:
        v = torch.where(mask.bool()[:, None], vals, torch.full_like(vals, big))
        out = torch.full((n, vals.shape[1]), big, dtype=vals.dtype,
                         device=vals.device).scatter_reduce_(
            0, seg.long()[:, None].expand_as(v), v, "amin", include_self=True)
    return torch.where(out >= big / 2, torch.zeros_like(out), out)


def finalize_batch(batch: dict, generator: torch.Generator | None = None,
                   data_aug: bool = False, drop_edge: float = 0.0,
                   aug=None) -> dict:
    """Batch epilogue on a tensor batch: the model input x = [0,0,0 | pos]
    (graph_dict3.py:966-969).

    With data_aug: per-image random flip / rotate / scale / translate of
    the proposal-normalised positions (random_transfer,
    graph_dict3.py:283-298), then the proposal boxes recomputed from the
    moved positions as masked per-proposal min/max (update_bbox,
    :934-955). Flips are sampled once per image, as the JAX package does.
    `aug` = (scale [B], angle [B], translate [B, 2], flips [B, 2]) gives
    the parameters instead of drawing them from `generator` (tests feed
    both packages the same). drop_edge > 0 drops each real edge with that
    probability; the caller removes the stale pack-time counts first.
    """
    pos = batch["pos"]
    if drop_edge > 0.0:
        keep = torch.rand(batch["edge_mask"].shape, generator=generator,
                          device=pos.device) >= drop_edge
        batch = {**batch, "edge_mask": batch["edge_mask"] & keep}
    if data_aug:
        if aug is None:
            aug = draw_augmentation(batch["gt_bbox"].shape[0], generator,
                                    pos.device)
        scale, angle, translate, flips = (t.to(pos.device) for t in aug)
        pp = plan_of(batch)
        n = pos.shape[0]
        bidx = batch["bbox_idx"]
        img = batch["image_id"].long()
        s = segment_broadcast(scale.float()[img], bidx, n, pp)[:, None]
        a = segment_broadcast(angle.float()[img], bidx, n, pp)
        t = segment_broadcast(translate.float()[img], bidx, n, pp)
        fl = segment_broadcast(flips.bool()[img], bidx, n, pp)
        p = pos - 0.5
        p = torch.where(fl, -p, p)
        cos, sin = torch.cos(a), torch.sin(a)
        p = torch.stack([p[:, 0] * cos - p[:, 1] * sin,
                         p[:, 0] * sin + p[:, 1] * cos], dim=1)
        p = (p + 0.5 + t) * s
        pos = torch.where(batch["node_mask"][:, None], p, torch.zeros_like(p))
        vals = torch.stack([pos[:, 0], pos[:, 1], -pos[:, 0], -pos[:, 1]],
                           dim=1)
        mins = _seg_min(vals, bidx, batch["labels"].shape[0],
                        batch["node_mask"], -NEG, pp)
        bbox = torch.stack([mins[:, 0], mins[:, 1], -mins[:, 2], -mins[:, 3]],
                           dim=1)
        bbox = torch.where(batch["proposal_mask"][:, None], bbox,
                           torch.zeros_like(bbox))
        batch = {**batch, "pos": pos, "bbox": bbox}
    x = torch.cat([pos.new_zeros(pos.shape[0], 3), pos], dim=1)
    return {**batch, "x": x}
