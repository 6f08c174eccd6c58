"""Flat-packed, statically-shaped batches for both detectors.

Counterpart of `yolat_tpu/data/packing.py`: `PadSizes` (:53-79),
`CompactFile` (:98-289, the numpy branches; the native sort-and-align
helper is not carried), `_align_runs` (:317), `pack_files` (:362-579),
`finalize_batch` (:587-670, with the train-time augmentation and edge
dropout) and `_seg_min` (:747), and the dense neighbour table
(`CompactFile.dense_table` :291-314, `add_dense_neighbors` :673-744).
That module reaches `yolat_tpu.ops.segment` (and so jax) inside
`CompactFile` and `pack_files`, so the port carries its own jax-free copy.
The keys every batch has (what the canonical detector reads):

  pos [N,2] f32, node_mask [N] bool, bbox_idx [N] i32 (sorted),
  edge [E,2] i32 (dst-sorted, padding rows at the front), e_attr [E,4] f32,
  edge_mask [E] bool, labels [P] i32, proposal_mask [P] bool,
  bbox [P,4] f32, label_iou [P] f32, label_iou_rel [P] f32,
  image_id [P] i32, is_root [P] bool, root_slot [P] i32,
  gt_bbox [B,G,4], gt_labels [B,G], gt_mask [B,G], wh [B,2], n_images,
  dst_count [N] f32, prop_count [P] f32, pool_* (aligned pool plan),
  ew_* (edge-window plan, in the CUDA kernels' layout), and, on request,
  nbr_idx [N, D] i32, nbr_attr [N, D, 4] f32, nbr_mask [N, D] bool (the
  dense neighbour table: slot k of node i holds the source of its k-th
  in-edge; unused slots point at node 0 with mask False).

With `super_family` (YOLaT++; the JAX package packs these always,
:159-235, :394-423, :434-528) a batch also has the super-edge clique
family and the factored primitive level's fields:

  edge_super [S,2] i32 (dst-sorted, each dst run padded to SUPER_BLOCK
  rows with src = dst, attr 0, mask False), e_attr_super [S,4] f32,
  super_mask [S] bool, src_count [N] f32, super_dst_count [N] f32 (real
  super edges only), sup_member [N] bool, sup_rank [N] f32,
  sup_abar [N,4] f32, prop_first_row [P] i32, sup_pool_* (the aligned
  pool plan over the super-edge runs),

and the clique family's banded plan `sew_*` (`ops.plans.banded_plan`,
kernel 5's layout; the JAX package's `extra_plans=("super",)`, :555-577):
left out with `sew_plan="none"` (a train batch of the per-edge sparse or
the factored route reads none), with its transpose `sew_tperm`, `sew_tptr`
under `sew_plan="transpose"` (the banded training route, kernels 7 and 8).

For all keys other than ew_* and sew_*, `pack_files` and
`add_dense_neighbors` are bitwise equal to `yolat_tpu`'s
(tests/test_torch_packing.py, tests/test_torch_pp_packing.py); a batch
packed without `super_family` is what it was before that option existed.
"""

from __future__ import annotations

import numpy as np
import torch

from yolat_tpu_torch.ops.plans import (POOL_BLOCK, SUPER_BLOCK, banded_plan,
                                       edge_window_plan, plan_of, pool_plan)
from yolat_tpu_torch.ops.segment import NEG, _two_level, segment_broadcast


def round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


class PadSizes:
    """Static bucket sizes for one batch shape. `n_super` is the super-edge
    buffer's rows (after run alignment); 0 for batches packed without the
    super-edge family. The JAX package's `PadSizes` (:56) has it third."""

    def __init__(self, n_nodes, n_edges, n_proposals, n_gt, n_images,
                 n_super: int = 0):
        self.n_nodes = n_nodes
        self.n_edges = n_edges
        self.n_proposals = n_proposals
        self.n_gt = n_gt
        self.n_images = n_images
        self.n_super = n_super


class CompactFile:
    """A ProposalFile in packed-batch dtypes: edges dst-sorted, each
    proposal's node run padded to a multiple of POOL_BLOCK (masked rows
    carrying the run's bbox_idx), and the per-proposal root pointer
    materialised. With `super_family` also the super-edge clique family,
    dst-sorted with each dst run padded to SUPER_BLOCK rows, its per-node
    counts and the factored primitive level's fields (None otherwise)."""

    __slots__ = ("pos", "node_mask", "bbox_idx", "edge", "e_attr",
                 "dst_count", "prop_count", "labels", "bbox", "label_iou",
                 "label_iou_rel", "is_root_mask", "root_slot_local",
                 "n_proposals", "_dense", "edge_super", "e_attr_super",
                 "super_valid", "src_count", "super_dst_count", "sup_member",
                 "sup_rank", "sup_abar", "prop_first")

    def __init__(self, f, n_classes=None, super_family: bool = False):
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
        self._dense = None
        for name in ("edge_super", "e_attr_super", "super_valid", "src_count",
                     "super_dst_count", "sup_member", "sup_rank", "sup_abar",
                     "prop_first"):
            setattr(self, name, None)
        if super_family:
            self._super_family(f, old2new, n2, new_starts)

    def _super_family(self, f, old2new, n2: int, new_starts) -> None:
        """The super-edge family and what hangs on it (packing.py:177-235)."""
        self.src_count = np.bincount(
            self.edge[:, 0], minlength=n2).astype(np.float32)
        so = np.argsort(np.asarray(f.edge_super)[:, 1], kind="stable")
        es = np.ascontiguousarray(
            old2new[np.asarray(f.edge_super, np.int64)[so]], np.int32)
        ea = np.ascontiguousarray(
            np.asarray(f.e_attr_super)[so, 0:4], np.float32)
        self.edge_super, self.e_attr_super, self.super_valid = _align_runs(
            es, ea, SUPER_BLOCK)
        self.super_dst_count = np.bincount(
            es[:, 1], minlength=n2).astype(np.float32)
        member = np.zeros(n2, bool)
        member[es[:, 0]] = True
        member[es[:, 1]] = True
        self.sup_member = member
        # mean attribute of each node's incoming super edges
        abar = np.zeros((n2, 4), np.float32)
        if len(es):
            dst_r = es[:, 1].astype(np.int64)
            first = np.r_[0, np.flatnonzero(np.diff(dst_r)) + 1]
            cnts = np.diff(np.r_[first, len(dst_r)])
            sums = np.add.reduceat(ea, first, axis=0)
            abar[dst_r[first]] = sums / cnts[:, None]
        self.sup_abar = abar
        # rank of each member node among the preceding members of its
        # proposal (the factored primitive level's denominator)
        mem_idx = np.flatnonzero(member)
        rank = np.zeros(n2, np.float32)
        if len(mem_idx):
            grp = self.bbox_idx[mem_idx]
            starts = np.r_[0, np.flatnonzero(np.diff(grp)) + 1]
            lens = np.diff(np.r_[starts, len(mem_idx)])
            rank[mem_idx] = (np.arange(len(mem_idx))
                             - np.repeat(starts, lens)).astype(np.float32)
        self.sup_rank = rank
        # the first node row of every proposal
        self.prop_first = new_starts.astype(np.int32)

    def dense_table(self, d_max: int):
        """The file's dense neighbour table (nbr_idx, nbr_attr, nbr_mask)
        with file-local rows, kept for the next epoch. The edges are
        dst-sorted, so an edge's slot is its position in its dst run."""
        if self._dense is not None and self._dense[0] == d_max:
            return self._dense[1]
        e, n = len(self.edge), len(self.pos)
        dst = self.edge[:, 1].astype(np.int64)
        indeg = self.dst_count.astype(np.int64)
        need = int(indeg.max()) if e else 1
        if need > d_max:
            raise ValueError(f"d_max={d_max} < max in-degree {need}")
        run_start = np.concatenate([[0], np.cumsum(indeg)[:-1]])
        pos_in_run = np.arange(e) - run_start[dst]
        nbr_idx = np.zeros((n, d_max), np.int32)
        nbr_attr = np.zeros((n, d_max, self.e_attr.shape[1]), np.float32)
        nbr_mask = np.zeros((n, d_max), bool)
        nbr_idx[dst, pos_in_run] = self.edge[:, 0]
        nbr_attr[dst, pos_in_run] = self.e_attr
        nbr_mask[dst, pos_in_run] = True
        self._dense = (d_max, (nbr_idx, nbr_attr, nbr_mask))
        return self._dense[1]


def _align_runs(edge: np.ndarray, attr: np.ndarray, block: int):
    """Pad a dst-sorted edge list so that every dst run's length is a
    multiple of `block`. Pad rows carry the run's dst (the list stays
    sorted), src = dst, zero attributes, valid False.
    -> (edge2, attr2, valid) (packing.py:317-345)."""
    s = len(edge)
    if s == 0:
        return edge, attr, np.zeros(0, bool)
    dst = edge[:, 1].astype(np.int64)
    first = np.empty(s, bool)
    first[0] = True
    np.not_equal(dst[1:], dst[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    uniq = dst[starts]
    cnts = np.diff(np.append(starts, s))
    acnt = ((cnts + block - 1) // block) * block
    s2 = int(acnt.sum())
    new_starts = np.concatenate([[0], np.cumsum(acnt)[:-1]])
    run = np.cumsum(first) - 1
    new_row = new_starts[run] + (np.arange(s) - starts[run])
    edge2 = np.empty((s2, 2), np.int32)
    edge2[:, 1] = np.repeat(uniq, acnt).astype(np.int32)
    edge2[:, 0] = edge2[:, 1]
    attr2 = np.zeros((s2, attr.shape[1]), attr.dtype)
    valid = np.zeros(s2, bool)
    edge2[new_row] = edge
    attr2[new_row] = attr
    valid[new_row] = True
    return edge2, attr2, valid


def aligned_super_count(f) -> int:
    """Super-edge rows of `f` after CompactFile's run alignment
    (packing.py:348-359)."""
    if isinstance(f, CompactFile):
        return len(f.edge_super)
    dst = np.asarray(f.edge_super)[:, 1]
    if len(dst) == 0:
        return 0
    cnts = np.unique(dst, return_counts=True)[1]
    return int((((cnts + SUPER_BLOCK - 1) // SUPER_BLOCK) * SUPER_BLOCK).sum())


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
               edge_window: bool = True, ew_transpose: bool = False,
               super_family: bool = False, sew_plan: str = "own") -> dict:
    """Concatenate CompactFiles into one padded flat batch (numpy).

    Real edge rows fill the END of the edge buffer (padding rows keep dst 0
    at the front), so per-file dst-sorted lists concatenate into a globally
    dst-sorted batch. Attaches the aligned pool plan and, with
    `edge_window`, the edge-window plan; `ew_transpose` adds the part of it
    that the trainable window ops and YOLaT++'s curve level read
    (`ops.plans.EW_TRAIN_KEYS`). `super_family` (files made with it, a
    `pad` with `n_super`) adds the super-edge family, `src_count` and the
    factored fields and, by `sew_plan`, that family's banded plan `sew_*`:
    'own' (sorted by dst, what serving reads), 'transpose' (also its
    transpose by src, for the banded training route) or 'none'.
    """
    if sew_plan not in ("none", "own", "transpose"):
        raise ValueError(f"sew_plan {sew_plan!r}: none, own or transpose")
    B = pad.n_images
    if len(files) > B:
        raise ValueError(f"{len(files)} files for {B} image slots")
    E_tot = sum(len(f.edge) for f in files)
    N_tot = sum(len(f.pos) for f in files)
    P_tot = sum(f.n_proposals for f in files)
    if N_tot > pad.n_nodes or E_tot > pad.n_edges or P_tot > pad.n_proposals:
        raise ValueError("pad sizes too small for batch contents")
    if super_family:
        if any(f.edge_super is None for f in files):
            raise ValueError("super_family needs CompactFile(f, "
                             "super_family=True) files")
        S_tot = sum(len(f.edge_super) for f in files)
        if S_tot > pad.n_super:
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
    if super_family:
        batch.update({
            "edge_super": np.zeros((pad.n_super, 2), np.int32),
            "e_attr_super": np.zeros((pad.n_super, 4), np.float32),
            "super_mask": np.zeros(pad.n_super, bool),
            "src_count": np.zeros(pad.n_nodes, np.float32),
            "super_dst_count": np.zeros(pad.n_nodes, np.float32),
            "sup_member": np.zeros(pad.n_nodes, bool),
            "sup_rank": np.zeros(pad.n_nodes, np.float32),
            "sup_abar": np.zeros((pad.n_nodes, 4), np.float32),
            "prop_first_row": np.zeros(pad.n_proposals, np.int32),
        })
        s_off = pad.n_super - S_tot

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
        if super_family:
            sn = len(f.edge_super)
            np.add(f.edge_super, np.int32(n_off),
                   out=batch["edge_super"][s_off:s_off + sn])
            batch["e_attr_super"][s_off:s_off + sn] = f.e_attr_super
            batch["super_mask"][s_off:s_off + sn] = f.super_valid
            batch["src_count"][n_off:n_off + n] = f.src_count
            batch["super_dst_count"][n_off:n_off + n] = f.super_dst_count
            batch["sup_member"][n_off:n_off + n] = f.sup_member
            batch["sup_rank"][n_off:n_off + n] = f.sup_rank
            batch["sup_abar"][n_off:n_off + n] = f.sup_abar
            np.add(f.prop_first, np.int32(n_off),
                   out=batch["prop_first_row"][p_off:p_off + p])
            s_off += sn
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
    if super_family:
        # padding proposal slots point at the first padding node row
        batch["prop_first_row"][p_off:] = n_off
        np.minimum(batch["prop_first_row"], pad.n_nodes - 1,
                   out=batch["prop_first_row"])
        # front pad rows carry dst 0 and every file's region is a multiple
        # of SUPER_BLOCK rows, so the buffer is block-aligned when its
        # length is; a buffer that is not gets no plan (packing.py:523-528)
        try:
            sup = pool_plan(batch["edge_super"][:, 1], pad.n_nodes,
                            block=SUPER_BLOCK, cap=0)
            batch.update({"sup_" + k: v for k, v in sup.items()})
        except ValueError:
            pass
        if sew_plan != "none":
            plan = banded_plan(batch["edge_super"], batch["super_mask"],
                               batch["e_attr_super"], pad.n_nodes, sortby=1,
                               transpose=sew_plan == "transpose")
            batch.update({"sew_" + k: v for k, v in plan.items()})
    if edge_window:
        batch.update(edge_window_plan(batch["edge"], batch["edge_mask"],
                                      batch["e_attr"], pad.n_nodes,
                                      transpose=ew_transpose))
    return batch


def dense_width(max_indegree: int) -> int:
    """Neighbour slots per node for a maximum in-degree: the next power of
    two, at least 4 (`yolat_tpu/data/dataset.py:285-293`)."""
    return max(4, int(2 ** np.ceil(np.log2(max(max_indegree, 1)))))


def add_dense_neighbors(batch: dict, d_max: int | None = None,
                        files: list | None = None) -> dict:
    """The batch with its dense neighbour table: nbr_idx [N, D] i32 (the
    sources j of node i's in-edges (j, i), in edge order), nbr_attr
    [N, D, 4] f32, nbr_mask [N, D] bool; unused slots are 0 / False.

    With `files` (the CompactFiles the batch was packed from, in pack
    order) and `d_max`, the table is copied from the files' cached tables
    with row offsets; otherwise it is built from the batch's real edges,
    with D = `dense_width` of its largest in-degree unless `d_max` is given.
    """
    n_nodes = batch["pos"].shape[0]
    if files is not None and d_max is not None and len(files):
        nbr_idx = np.zeros((n_nodes, d_max), np.int32)
        nbr_attr = np.zeros((n_nodes, d_max, batch["e_attr"].shape[1]),
                            np.float32)
        nbr_mask = np.zeros((n_nodes, d_max), bool)
        n_off = 0
        for f in files:
            n = len(f.pos)
            ti, ta, tm = f.dense_table(d_max)
            # masked slots stay 0, as in the batch-level build
            np.multiply(ti + np.int32(n_off), tm,
                        out=nbr_idx[n_off:n_off + n], casting="unsafe")
            nbr_attr[n_off:n_off + n] = ta
            nbr_mask[n_off:n_off + n] = tm
            n_off += n
        return {**batch, "nbr_idx": nbr_idx, "nbr_attr": nbr_attr,
                "nbr_mask": nbr_mask}

    emask = np.asarray(batch["edge_mask"], bool)
    src, dst = batch["edge"][emask][:, 0], batch["edge"][emask][:, 1]
    attr = batch["e_attr"][emask]
    indeg = np.bincount(dst, minlength=n_nodes)
    need = int(indeg.max()) if len(dst) else 1
    if d_max is None:
        d_max = dense_width(need)
    elif need > d_max:
        raise ValueError(f"d_max={d_max} < max in-degree {need}")
    order = np.argsort(dst, kind="stable")
    dst_s, src_s, attr_s = dst[order], src[order], attr[order]
    starts = np.concatenate([[0], np.cumsum(indeg)[:-1]])
    pos_in_run = np.arange(len(dst_s)) - starts[dst_s]
    nbr_idx = np.zeros((n_nodes, d_max), np.int32)
    nbr_attr = np.zeros((n_nodes, d_max, attr.shape[1]), np.float32)
    nbr_mask = np.zeros((n_nodes, d_max), bool)
    nbr_idx[dst_s, pos_in_run] = src_s
    nbr_attr[dst_s, pos_in_run] = attr_s
    nbr_mask[dst_s, pos_in_run] = True
    return {**batch, "nbr_idx": nbr_idx, "nbr_attr": nbr_attr,
            "nbr_mask": nbr_mask}


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
    probability, and each used slot of a dense neighbour table with a draw
    of its own (packing.py:616-620); the caller removes the stale pack-time
    counts and plans first.
    """
    pos = batch["pos"]
    if drop_edge > 0.0:
        keep = torch.rand(batch["edge_mask"].shape, generator=generator,
                          device=pos.device) >= drop_edge
        batch = {**batch, "edge_mask": batch["edge_mask"] & keep}
        if "nbr_mask" in batch:
            keep2 = torch.rand(batch["nbr_mask"].shape, generator=generator,
                               device=pos.device) >= drop_edge
            batch = {**batch, "nbr_mask": batch["nbr_mask"] & keep2}
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
