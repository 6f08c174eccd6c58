# Frozen copy of yolat_tpu_torch/geom/proposals.py at commit 8dc2b5b (the
# benchmark's yardstick: later changes to the program do not reach it).
# Only the imports differ: they point into benchmark.ref.geom, and the host
# library's entry points are stubs that return None, so every call takes
# the numpy path (the program's `_native.disabled()` oracle).
"""Grid-sweep proposal generation over connected components.

Behavioural counterpart of SESYDFloorPlan._get_proposal
(Datasets/graph_dict3.py:309-789):

For every (merged) connected component, sweep a bbox_sampling_step x
bbox_sampling_step grid over the CC's extent and enumerate every
grid-aligned rectangle spanning >=2 distinct x and >=2 distinct y point
coordinates. Each rectangle's contained point set is a proposal candidate;
candidates are deduplicated by point set. A candidate survives if it has at
least one induced shape edge, its extent exceeds 1e-4 in both axes, and it
contributes at least one node-angle (graph_dict3.py:597,621,681). Labels:
best-IoU GT class if IoU>0.7 else background; has_obj flag from
intersection-over-smaller>0.7 (:625-641). 13-dim stats features (:644-705).
Positions are normalised to the proposal box (:707-714).

Rectangle enumeration here is a re-derivation of the reference's
prefix-set-difference walk: the set of distinct rectangles it produces is
exactly {[x_lo, x_hi] x [y_lo, y_hi]} where lo indices are
searchsorted(values, grid, 'left') and hi indices are
searchsorted(values, grid, 'right')-1 over the grid boundaries, hi>lo —
verified against a brute-force port in tests/test_proposals.py.

The reference's per-CC idxTree (root proposal = argmax area, children = the
rest; graph_dict3.py:743-768) is flattened to index ranges: slice arrays
per proposal plus (cc_slice, root_of_cc) — everything the two-pass predictor
needs, with no Python object trees.

Training-time mixup (graph_dict3.py:791-907) pairs every CC with a random
CC side by side before the sweep; the mixed graph then goes through the
same window pipeline.

Port of `yolat_tpu/geom/proposals.py:1-742`.
Each CC's windows go through the host library's window pipeline
(`geom/_native.py`, `csrc/geomcore.cpp`) in one call, consumed in bulk;
the per-window numpy loop below is the oracle (`_native.disabled()`) and
the path of the pipeline's per-call numpy cases (a degenerate grid).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.ref.geom import _numpy_only as _native

IOU_LABEL_TH = 0.7
IOS_OBJ_TH = 0.7
MIN_EXTENT = 1e-4
ANGLE_TH = 1e-2
N_STAT_FEATS = 13


@dataclass
class ProposalFile:
    """Flat per-file proposal arrays (the `_bb.pkl` contract, flattened)."""

    pos: np.ndarray          # [N, 2] float64, proposal-normalised
    is_super: np.ndarray     # [N] bool
    edge: np.ndarray         # [E, 2] int64, global proposal-node ids
    edge_super: np.ndarray   # [Es, 2] int64
    e_attr: np.ndarray       # [E, 6]
    e_attr_super: np.ndarray # [Es, 6]
    labels: np.ndarray       # [P] int64
    bbox: np.ndarray         # [P, 4] proposal geometry boxes (normalised)
    bbox_targets: np.ndarray # [P, 4] matched GT box or zeros
    bbox_idx: np.ndarray     # [N] int64 node -> proposal id
    stat_feats: np.ndarray   # [P, 13]
    has_obj: np.ndarray      # [P] int64
    slice_pos: np.ndarray    # [P+1] node ranges per proposal
    slice_edge: np.ndarray   # [P+1]
    slice_super: np.ndarray  # [P+1]
    cc_slice: np.ndarray     # [C+1] proposal ranges per CC
    root_of_cc: np.ndarray   # [C] global proposal index of each CC's root

    @property
    def n_proposals(self) -> int:
        return len(self.labels)

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}

    @classmethod
    def from_dict(cls, d: dict) -> "ProposalFile":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__})


def _iou_ios(box: np.ndarray, boxes: np.ndarray):
    """IoU and intersection-over-smaller of one box vs many
    (utils/det_util.py:311-341, no +1 convention)."""
    ix0 = np.maximum(box[0], boxes[:, 0])
    iy0 = np.maximum(box[1], boxes[:, 1])
    ix1 = np.minimum(box[2], boxes[:, 2])
    iy1 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    iou = inter / (a1 + a2 - inter + 1e-16)
    ios = inter / a2
    return iou, ios


def _iou_ios_many(boxes: np.ndarray, gt: np.ndarray):
    """Vectorised _iou_ios: [P, 4] proposals x [G, 4] GT -> [P, G] each."""
    ix0 = np.maximum(boxes[:, None, 0], gt[None, :, 0])
    iy0 = np.maximum(boxes[:, None, 1], gt[None, :, 1])
    ix1 = np.minimum(boxes[:, None, 2], gt[None, :, 2])
    iy1 = np.minimum(boxes[:, None, 3], gt[None, :, 3])
    inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
    a1 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    a2 = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    iou = inter / (a1[:, None] + a2[None, :] - inter + 1e-16)
    ios = inter / a2[None, :]
    return iou, ios


def _intersecting_gt(box_cc: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Indices of GT boxes strictly intersecting the CC box
    (det_util.intersect_bb_idx:343-362)."""
    ix0 = np.maximum(box_cc[0], gt[:, 0])
    iy0 = np.maximum(box_cc[1], gt[:, 1])
    ix1 = np.minimum(box_cc[2], gt[:, 2])
    iy1 = np.minimum(box_cc[3], gt[:, 3])
    return np.where((ix1 > ix0) & (iy1 > iy0))[0]


def _grid_boundaries(vmin: float, vmax: float, step_count: int) -> np.ndarray:
    """Grid boundaries per graph_dict3.py:459-469: arange(min, max,
    extent/step_count) with max appended."""
    step = (vmax - vmin) / step_count
    if step > 0:
        return np.append(np.arange(vmin, vmax, step), vmax)
    return np.array([vmax])


def _walk_starts(values: np.ndarray, grids: np.ndarray):
    """Stateful start-index walk (move_endpoint_close, graph_dict3.py:482-497).

    Per boundary g: advance to the first index >= prev+1 whose value is >= g,
    i.e. max(first_index_with_value>=g, prev+1). When boundaries outpace the
    value list this *forces* one-index advancement per boundary — those extra
    starts are part of the reference's proposal vocabulary, so they are kept.
    Returns [(start_index, boundary_position)] for in-range starts.
    """
    out = []
    prev = -1
    n = len(values)
    for gi, g in enumerate(grids):
        x = prev + 1
        while x < n and values[x] < g:
            x += 1
        s = x  # == max(first_index_geq(g), prev+1)
        if s == prev:
            continue
        prev = s
        if s < n:
            out.append((s, gi))
    return out


def _walk_ends(values: np.ndarray, grids: np.ndarray, gi0: int, start: int):
    """End-index walk (move_endpoint, graph_dict3.py:472-480,510-523): for
    each boundary after gi0, the last index with value <= boundary, skipped
    unless it advances past the previous end (so every span covers >=2
    distinct values)."""
    out = []
    prev = start
    n = len(values)
    for g in grids[gi0 + 1 :]:
        x = prev + 1
        while x < n and values[x] <= g:
            x += 1
        e = x - 1
        if e == prev:
            continue
        prev = e
        out.append(e)
    return out


def _sweep_rects(pos_cluster: np.ndarray, step_count: int):
    """(xi, yi, rects) for one CC: point value-indices and every rect's
    inclusive index bounds, in the reference's nested-loop order (first-seen
    dedup order is part of determinism)."""
    x_values = np.unique(pos_cluster[:, 0])
    y_values = np.unique(pos_cluster[:, 1])
    if len(x_values) < 2 or len(y_values) < 2:
        return None

    xi = np.searchsorted(x_values, pos_cluster[:, 0])
    yi = np.searchsorted(y_values, pos_cluster[:, 1])

    x_grids = _grid_boundaries(x_values[0], x_values[-1], step_count)
    y_grids = _grid_boundaries(y_values[0], y_values[-1], step_count)

    native = _native.sweep_rects_native(x_values, y_values, x_grids, y_grids)
    if native is not None:
        return (xi, yi, native) if len(native) else None

    x_starts = _walk_starts(x_values, x_grids)
    y_starts = _walk_starts(y_values, y_grids)
    x_ends_of = {(x0, gix): _walk_ends(x_values, x_grids, gix, x0)
                 for x0, gix in x_starts}
    y_ends_of = {(y0, giy): _walk_ends(y_values, y_grids, giy, y0)
                 for y0, giy in y_starts}

    rects = []
    for y0, giy in y_starts:
        for x0, gix in x_starts:
            for y1 in y_ends_of[(y0, giy)]:
                for x1 in x_ends_of[(x0, gix)]:
                    rects.append((x0, x1, y0, y1))
    if not rects:
        return None
    return xi, yi, np.asarray(rects, dtype=np.int32)


def _enumerate_subclusters(pos_cluster: np.ndarray, step_count: int):
    """All distinct rectangle-induced point-index sets of one CC.

    Returns a list of sorted local-index arrays, first-seen (deterministic)
    order. Parity with the reference walk is oracle-tested in
    tests/test_proposals.py.
    """
    swept = _sweep_rects(pos_cluster, step_count)
    if swept is None:
        return []
    xi, yi, rects = swept

    native = _native.enumerate_rect_sets_native(xi, yi, rects)
    if native is not None:
        return native

    seen = set()
    out = []
    for x0, x1, y0, y1 in rects:
        m = (xi >= x0) & (xi <= x1) & (yi >= y0) & (yi <= y1)
        ids = np.where(m)[0]
        if len(ids) == 0:
            continue
        key = ids.tobytes()
        if key in seen:
            continue
        seen.add(key)
        out.append(ids)
    return out


def _cc_proposal_cores(pos_cluster, step_count, edges_cl, supers_cl):
    """Per distinct window: (local point ids, induced shape-edge rows,
    induced super-edge rows), where edge rows index the CC-local edge
    arrays. One native pass, or the set enumeration induced with boolean
    masks.
    """
    swept = _sweep_rects(pos_cluster, step_count)
    if swept is None:
        return []
    xi, yi, rects = swept
    native = _native.build_rect_proposals_native(xi, yi, rects, edges_cl,
                                                 supers_cl)
    if native is not None:
        return native

    out = []
    n = len(pos_cluster)
    sel = np.zeros(n, dtype=bool)
    for local_ids in _enumerate_subclusters(pos_cluster, step_count):
        sel[local_ids] = True
        em = np.where(sel[edges_cl[:, 0]] & sel[edges_cl[:, 1]])[0] \
            if len(edges_cl) else np.zeros(0, np.int64)
        sm = np.where(sel[supers_cl[:, 0]] & sel[supers_cl[:, 1]])[0] \
            if len(supers_cl) else np.zeros(0, np.int64)
        out.append((local_ids, em, sm))
        sel[local_ids] = False
    return out


def _angle_stats(n_local: int, edges_local: np.ndarray, pos_local: np.ndarray):
    """Node-angle statistics over induced shape edges
    (graph_dict3.py:649-688). Returns None if no angle pair exists (such a
    proposal is skipped). Angles are raw dot products of neighbour offset
    vectors; neighbour sets are deduplicated per anchor."""
    native = _native.angle_stats_native(edges_local, pos_local, ANGLE_TH)
    if native is not None:
        return None if native.get("empty") else native
    neighbors = [set() for _ in range(n_local)]
    for a, b in edges_local:
        neighbors[a].add(b)
        neighbors[b].add(a)

    dots = []
    n_less90 = n_90 = n_more90 = 0
    for anchor, ns in enumerate(neighbors):
        ns = list(ns)
        pa = pos_local[anchor]
        for i in range(len(ns)):
            for j in range(i + 1, len(ns)):
                v0 = pos_local[ns[i]] - pa
                v1 = pos_local[ns[j]] - pa
                dot = v0[0] * v1[0] + v0[1] * v1[1]
                if dot <= -ANGLE_TH:
                    n_more90 += 1
                elif dot >= ANGLE_TH:
                    n_less90 += 1
                elif abs(dot) < ANGLE_TH:
                    n_90 += 1
                dots.append(dot)
    if not dots:
        return None
    dots = np.asarray(dots)
    return dict(
        n_90=n_90,
        n_less90=n_less90,
        n_more90=n_more90,
        mean=dots.mean(),
        max=dots.max(),
        min=dots.min(),
        std=dots.std(),
    )


def generate_proposals(
    graph: dict,
    gt_bbox: np.ndarray,
    gt_labels: np.ndarray,
    n_classes: int,
    bbox_sampling_step: int = 10,
    do_mixup: bool = False,
    rng: np.random.Generator | None = None,
) -> ProposalFile:
    """Generate the per-file proposal set from a built graph dict."""
    cc = graph["cc"]
    pos = np.asarray(graph["pos"], dtype=np.float64)
    edge = np.asarray(graph["edge"]["shape"], dtype=np.int64).reshape(-1, 2)
    edge_super = np.asarray(graph["edge"]["super"], dtype=np.int64).reshape(-1, 2)
    e_attr = np.asarray(graph["edge_attr"]["shape"], dtype=np.float64)
    e_attr_super = np.asarray(graph["edge_attr"]["super"], dtype=np.float64)
    is_control = np.asarray(graph["attr"]["is_control"]).reshape(-1) > 0.5
    is_super = np.asarray(graph["attr"]["is_super"]).reshape(-1).astype(bool)

    # strip control nodes and reindex (graph_dict3.py:324-352); shape and
    # super edges connect only non-control nodes by construction
    o2n = np.cumsum(~is_control) - 1
    edge = o2n[edge]
    edge_super = o2n[edge_super]
    cc = [[int(o2n[i]) for i in cluster] for cluster in cc]
    pos = pos[~is_control]
    is_super = is_super[~is_control]

    if do_mixup:
        if rng is None:
            rng = np.random.default_rng()
        cc, pos, edge, edge_super, e_attr, e_attr_super, is_super = mixup(
            cc, pos, edge, edge_super, e_attr, e_attr_super, is_super, rng
        )

    n_nodes = len(pos)

    acc = _Accumulator()
    for cluster in cc:
        cluster = np.asarray(cluster, dtype=np.int64)
        pos_cluster = pos[cluster]
        bbox_cc = np.array(
            [
                pos_cluster[:, 0].min(),
                pos_cluster[:, 1].min(),
                pos_cluster[:, 0].max(),
                pos_cluster[:, 1].max(),
            ]
        )
        gt_valid = _intersecting_gt(bbox_cc, gt_bbox) if len(gt_bbox) else np.zeros(0, np.int64)

        # CC-incident edges (both endpoints in CC), remapped to CC-local
        # point indices so the sweep can induce by index-range tests
        in_cc = np.zeros(n_nodes, dtype=bool)
        in_cc[cluster] = True
        cc_edge_ids = np.where(in_cc[edge[:, 0]] & in_cc[edge[:, 1]])[0]
        cc_super_ids = np.where(in_cc[edge_super[:, 0]] & in_cc[edge_super[:, 1]])[0]
        edges_cl = np.searchsorted(cluster, edge[cc_edge_ids])
        supers_cl = np.searchsorted(cluster, edge_super[cc_super_ids])

        # the whole window pipeline (enumeration, dedup, filters, features,
        # labels) in one native call, consumed in bulk
        swept = _sweep_rects(pos_cluster, bbox_sampling_step)
        bulk = None
        if swept is not None:
            xi, yi, rects = swept
            bulk = _native.window_pipeline_native(
                xi, yi, pos_cluster, rects, edges_cl, supers_cl,
                e_attr[cc_edge_ids], e_attr_super[cc_super_ids],
                is_super[cluster],
                gt_bbox[gt_valid] if len(gt_valid) else np.zeros((0, 4)),
                gt_labels[gt_valid] if len(gt_valid) else np.zeros(0, np.int64),
                n_classes - 1, IOU_LABEL_TH, IOS_OBJ_TH,
                ANGLE_TH, MIN_EXTENT, normalize_pos=True,
            )
        if bulk is not None:
            if bulk["n_distinct"] == 0:
                continue
            if len(gt_bbox) and gt_valid.shape[0] == 0:
                raise ValueError(
                    "connected component intersects no ground-truth box")
            _consume_bulk(acc, bulk)
            continue

        cores = _cc_proposal_cores(pos_cluster, bbox_sampling_step,
                                   edges_cl, supers_cl)
        if not cores:
            continue
        if len(gt_bbox) and gt_valid.shape[0] == 0:
            raise ValueError("connected component intersects no ground-truth box")

        n_before = acc.n_proposals()
        for local_ids, edge_rows, super_rows in cores:
            if len(edge_rows) == 0:
                continue
            node_ids = cluster[local_ids]

            pos_bbox = pos_cluster[local_ids]
            min_x, min_y = pos_bbox[:, 0].min(), pos_bbox[:, 1].min()
            max_x, max_y = pos_bbox[:, 0].max(), pos_bbox[:, 1].max()
            if max_x - min_x < MIN_EXTENT or max_y - min_y < MIN_EXTENT:
                continue

            edges_local = np.searchsorted(local_ids, edges_cl[edge_rows])
            e_attr_bbox = e_attr[cc_edge_ids[edge_rows]]

            stats = _angle_stats(len(node_ids), edges_local, pos_bbox)
            if stats is None:
                continue

            if len(super_rows):
                supers_local = np.searchsorted(local_ids, supers_cl[super_rows])
                e_attr_super_bbox = e_attr_super[cc_super_ids[super_rows]]
            else:
                supers_local = np.zeros((0, 2), np.int64)
                e_attr_super_bbox = np.zeros((0, 6))

            proposal_box = np.array([min_x, min_y, max_x, max_y])
            if len(gt_valid):
                iou, ios = _iou_ios(proposal_box, gt_bbox[gt_valid])
                idx_gt = int(np.argmax(iou))
                if iou[idx_gt] > IOU_LABEL_TH:
                    label = int(gt_labels[gt_valid[idx_gt]])
                    bbox_target = gt_bbox[gt_valid[idx_gt]]
                else:
                    label = n_classes - 1
                    bbox_target = np.zeros(4)
                has_obj = 1 if ios[idx_gt] > IOS_OBJ_TH else 0
            else:
                label = n_classes - 1
                bbox_target = np.zeros(4)
                has_obj = 0

            w, h = max_x - min_x, max_y - min_y
            stat_feat = np.array(
                [
                    len(node_ids),
                    len(edge_rows),
                    stats["n_90"],
                    stats["n_less90"],
                    stats["n_more90"],
                    w,
                    h,
                    stats["mean"],
                    stats["max"],
                    stats["min"],
                    stats["std"],
                    e_attr_bbox[:, -1].mean(),
                    e_attr_bbox[:, -1].std(),
                ]
            )

            pos_bbox = (pos_bbox - [min_x, min_y]) / [w, h]

            acc.add(
                pos_bbox,
                is_super[node_ids],
                edges_local,
                supers_local,
                e_attr_bbox,
                e_attr_super_bbox,
                label,
                proposal_box,
                bbox_target,
                stat_feat,
                has_obj,
            )

        acc.close_cc(n_before)

    return acc.finish()


def _consume_bulk(acc, bulk):
    """Epilogue of the native window pipeline: one bulk accumulator append
    for the whole CC, the arrays the per-window loop would emit."""
    if bulk["n_w"] == 0:
        return
    feats = bulk["feats"]
    acc.add_cc_bulk(
        bulk["pos"], bulk["issuper"], bulk["id_off"],
        bulk["eloc"], bulk["eid_off"], bulk["eattr"],
        bulk["sloc"], bulk["sid_off"], bulk["sattr"],
        bulk["labels"], feats[:, :4], bulk["targets"], feats[:, 4:],
        bulk["hasobj"],
    )


def _cat1(parts, dtype):
    if not parts:
        return np.zeros(0, dtype)
    return np.concatenate(
        [np.atleast_1d(np.asarray(p, dtype)) for p in parts]
    )


class _Accumulator:
    """Flat concatenation bookkeeping for proposals (graph_dict3.py:359-379,
    717-768)."""

    def __init__(self):
        self.pos = []
        self.is_super = []
        self.edge = []
        self.edge_super = []
        self.e_attr = []
        self.e_attr_super = []
        self.labels = []
        self.bbox = []
        self.bbox_targets = []
        self.stat_feats = []
        self.has_obj = []
        self.bbox_idx = []
        self.slice_pos = [0]
        self.slice_edge = [0]
        self.slice_super = [0]
        self.cc_slice = [0]
        self.root_of_cc = []
        self.offset = 0
        self.n = 0  # proposal count (labels holds blocks, not rows)

    def n_proposals(self) -> int:
        return self.n

    def add(self, pos, is_super, edges_local, supers_local, e_attr, e_attr_super,
            label, box, target, stats, has_obj):
        pid = self.n
        self.n += 1
        self.pos.append(pos)
        self.is_super.append(is_super)
        self.edge.append(edges_local + self.offset)
        self.edge_super.append(supers_local + self.offset)
        self.e_attr.append(e_attr)
        self.e_attr_super.append(e_attr_super)
        self.labels.append(label)
        self.bbox.append(box)
        self.bbox_targets.append(target)
        self.stat_feats.append(stats)
        self.has_obj.append(has_obj)
        self.bbox_idx.append(np.full(len(pos), pid, dtype=np.int64))
        self.offset += len(pos)
        self.slice_pos.append(self.offset)
        self.slice_edge.append(self.slice_edge[-1] + len(edges_local))
        self.slice_super.append(self.slice_super[-1] + len(supers_local))

    def add_cc_bulk(self, pos_rows, is_super_rows, id_off, eloc, eid_off,
                    e_attr_rows, sloc, sid_off, e_attr_super_rows, labels,
                    boxes, targets, stats, has_obj):
        """Append one CC's windows at once (the native pipeline), with
        close_cc's bookkeeping (root = the largest-area window)."""
        n_w = len(labels)
        if n_w == 0:
            return
        pid0 = self.n
        self.n += n_w
        counts = np.diff(id_off)
        self.pos.append(pos_rows)
        self.is_super.append(np.asarray(is_super_rows, dtype=bool))
        # eloc / sloc are CC-local member rows (the pipeline already offset
        # each window's local ranks by its member start)
        self.edge.append(eloc + self.offset)
        self.edge_super.append(sloc + self.offset)
        self.e_attr.append(e_attr_rows.reshape(-1, 6))
        self.e_attr_super.append(e_attr_super_rows.reshape(-1, 6))
        self.labels.append(np.asarray(labels, dtype=np.int64))
        self.bbox.append(np.asarray(boxes, dtype=np.float64))
        self.bbox_targets.append(np.asarray(targets, dtype=np.float64))
        self.stat_feats.append(np.asarray(stats, dtype=np.float64))
        self.has_obj.append(np.asarray(has_obj, dtype=np.int64))
        self.bbox_idx.append(np.repeat(np.arange(pid0, pid0 + n_w), counts))
        self.slice_pos.extend((self.offset + id_off[1:]).tolist())
        self.slice_edge.extend((self.slice_edge[-1] + eid_off[1:]).tolist())
        self.slice_super.extend((self.slice_super[-1] + sid_off[1:]).tolist())
        self.offset += int(id_off[-1])
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        self.root_of_cc.append(pid0 + int(np.argmax(area)))
        self.cc_slice.append(pid0 + n_w)

    def close_cc(self, n_before: int):
        n_after = self.n
        if n_after == n_before:
            return
        allb = np.concatenate(
            [np.asarray(p, np.float64).reshape(-1, 4) for p in self.bbox]
        )
        boxes = allb[n_before:n_after]
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        self.root_of_cc.append(n_before + int(np.argmax(area)))
        self.cc_slice.append(n_after)

    def finish(self) -> ProposalFile:
        def cat(parts, width, dtype=np.float64):
            if not parts:
                return np.zeros((0, width), dtype=dtype)
            if len(parts) == 1:
                # single-CC files (floorplans after containment merging):
                # np.concatenate copies even a single input — asarray is a
                # view when the block already has the target dtype
                return np.ascontiguousarray(
                    np.asarray(parts[0], dtype=dtype).reshape(-1, width))
            return np.concatenate([np.asarray(p, dtype=dtype).reshape(-1, width)
                                   for p in parts], axis=0)

        return ProposalFile(
            pos=cat(self.pos, 2),
            is_super=np.concatenate(self.is_super).astype(bool)
            if self.is_super else np.zeros(0, bool),
            edge=cat(self.edge, 2, np.int64),
            edge_super=cat(self.edge_super, 2, np.int64),
            e_attr=cat(self.e_attr, 6),
            e_attr_super=cat(self.e_attr_super, 6),
            labels=_cat1(self.labels, np.int64),
            bbox=cat(self.bbox, 4),
            bbox_targets=cat(self.bbox_targets, 4),
            bbox_idx=np.concatenate(self.bbox_idx)
            if self.bbox_idx else np.zeros(0, np.int64),
            stat_feats=cat(self.stat_feats, N_STAT_FEATS),
            has_obj=_cat1(self.has_obj, np.int64),
            slice_pos=np.asarray(self.slice_pos, dtype=np.int64),
            slice_edge=np.asarray(self.slice_edge, dtype=np.int64),
            slice_super=np.asarray(self.slice_super, dtype=np.int64),
            cc_slice=np.asarray(self.cc_slice, dtype=np.int64),
            root_of_cc=np.asarray(self.root_of_cc, dtype=np.int64),
        )


# ---------------------------------------------------------------------------
# mixup (graph_dict3.py:791-907)
# ---------------------------------------------------------------------------


def _normalize_pos_aspect(p: np.ndarray) -> np.ndarray:
    """Aspect-preserving unit normalisation (mixup.normalize_pos,
    graph_dict3.py:818-828): divide both axes by the larger extent."""
    min_x, max_x = p[:, 0].min(), p[:, 0].max()
    min_y, max_y = p[:, 1].min(), p[:, 1].max()
    s = max(max_x - min_x, max_y - min_y)
    s = s if s > 0 else 1.0
    return (p - [min_x, min_y]) / s


def mixup(cc, pos, edge, edge_super, e_attr, e_attr_super, is_super,
          rng: np.random.Generator):
    """Pair every CC with a random CC side-by-side; new merged CCs carry
    fully-bipartite super edges with zeroed attributes."""
    n = len(pos)
    cc_of = np.zeros(n, dtype=np.int64)
    for ci, cluster in enumerate(cc):
        cc_of[np.asarray(cluster, dtype=np.int64)] = ci

    edge_cc = cc_of[edge[:, 0]] if len(edge) else np.zeros(0, np.int64)
    super_cc = cc_of[edge_super[:, 0]] if len(edge_super) else np.zeros(0, np.int64)

    new_cc, new_pos, new_edge, new_super = [], [], [], []
    new_e_attr, new_e_attr_super, new_is_super = [], [], []
    offset = n

    for ci in range(len(cc)):
        cj = int(rng.integers(len(cc)))
        a = np.asarray(cc[ci], dtype=np.int64)
        b = np.asarray(cc[cj], dtype=np.int64)

        pa = _normalize_pos_aspect(pos[a])
        pb = _normalize_pos_aspect(pos[b])
        if rng.random() < 0.5:
            pb = pb + [1 + rng.random() * 0.1, rng.random()]
        else:
            pb = pb + [rng.random(), 1 + 0.1 * rng.random()]

        idx_a = offset + np.arange(len(a))
        idx_b = offset + len(a) + np.arange(len(b))

        remap = np.full(n, -1, dtype=np.int64)
        remap[a] = idx_a
        remap_b = np.full(n, -1, dtype=np.int64)
        remap_b[b] = idx_b

        ea_ids = np.where(edge_cc == ci)[0]
        eb_ids = np.where(edge_cc == cj)[0]
        sa_ids = np.where(super_cc == ci)[0]
        sb_ids = np.where(super_cc == cj)[0]

        bipartite = np.stack(
            np.meshgrid(idx_a, idx_b, indexing="ij"), axis=-1
        ).reshape(-1, 2)

        new_pos.append(np.concatenate([pa, pb], axis=0))
        new_is_super.append(np.concatenate([is_super[a], is_super[b]]))
        new_cc.append(list(idx_a) + list(idx_b))
        new_edge.append(np.concatenate([remap[edge[ea_ids]], remap_b[edge[eb_ids]]], axis=0))
        new_super.append(
            np.concatenate(
                [remap[edge_super[sa_ids]], remap_b[edge_super[sb_ids]], bipartite], axis=0
            )
        )
        new_e_attr.append(np.concatenate([e_attr[ea_ids], e_attr[eb_ids]], axis=0))
        new_e_attr_super.append(
            np.zeros((len(sa_ids) + len(sb_ids) + len(bipartite), 6))
        )
        offset += len(a) + len(b)

    cc = cc + new_cc
    pos = np.concatenate([pos] + new_pos, axis=0)
    is_super = np.concatenate([is_super] + new_is_super)
    edge = np.concatenate([edge] + new_edge, axis=0).astype(np.int64)
    edge_super = np.concatenate([edge_super] + new_super, axis=0).astype(np.int64)
    e_attr = np.concatenate([e_attr] + new_e_attr, axis=0)
    e_attr_super = np.concatenate([e_attr_super] + new_e_attr_super, axis=0)
    return cc, pos, edge, edge_super, e_attr, e_attr_super, is_super
