"""Flat-packed, statically-shaped batches for the canonical serving path.

Counterpart of `yolat_tpu/data/packing.py`: `PadSizes` (:53-79),
`CompactFile` (:98-289), `pack_files` (:362-579) and the eval form of
`finalize_batch` (:587-670). That module reaches `yolat_tpu.ops.segment`
(and so jax) inside `CompactFile` and `pack_files`, so the port carries
its own jax-free copy, restricted to the keys the canonical detector reads:

  pos [N,2] f32, node_mask [N] bool, bbox_idx [N] i32 (sorted),
  edge [E,2] i32 (dst-sorted, padding rows at the front), e_attr [E,4] f32,
  edge_mask [E] bool, labels [P] i32, proposal_mask [P] bool,
  bbox [P,4] f32, image_id [P] i32, is_root [P] bool, root_slot [P] i32,
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

from yolat_tpu_torch.ops.plans import POOL_BLOCK, edge_window_plan, pool_plan


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
                 "dst_count", "prop_count", "labels", "bbox",
                 "is_root_mask", "root_slot_local", "n_proposals")

    def __init__(self, f):
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
        self.n_proposals = len(self.labels)
        self.is_root_mask = np.zeros(self.n_proposals, bool)
        self.is_root_mask[np.asarray(f.root_of_cc, np.int64)] = True
        self.root_slot_local = np.repeat(
            np.asarray(f.root_of_cc, np.int32), np.diff(np.asarray(f.cc_slice)))


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


def finalize_batch(batch: dict) -> dict:
    """Eval epilogue on a tensor batch: the model input x = [0,0,0 | pos]
    (graph_dict3.py:966-969). Train-time augmentation arrives with the
    training slice."""
    pos = batch["pos"]
    x = torch.cat([pos.new_zeros(pos.shape[0], 3), pos], dim=1)
    return {**batch, "x": x}
