"""Legacy dataset variants (graphs 'bezier', 'shape', 'bezier_edge_attr').

Counterpart of `yolat_tpu/data/legacy.py:1-282`, numpy as there, over the
port's own geometry (`yolat_tpu_torch.geom`) and `SESYDDataset(cache=False)`:
the reference's Datasets/svg.py, svg2.py, svg3.py, the on-the-fly
node-classification datasets that fed the reference's absent centernet-style
architectures (SURVEY.md: keep as registry entries). Provided for surface
completeness:

  * build_graph_v1: per-shape Bezier graphs merged, original stroke
    attributes kept (unlike the canonical offline build, which forces
    black/6 — build_graph_bbox.py:322-327), edge attrs truncated to the
    4-dim v1 layout [c1-start, c2-end] (svg_parser.py:557-561);
  * node_ground_truth: per-node GT box/class/object by point-in-gt-box test
    with 1e-3 slack, ties resolved by nearest top-left corner, control
    nodes inheriting from a control-edge endpoint neighbour
    (svg.py gen_y:131-212, graph_dict3.refine_gt:153-234);
  * strip_control_nodes: the svg3 variant (svg3.py:297-320);
  * shape_features: the svg2 per-primitive 17-dim feature table + proximity
    edges (SVGGraphBuilderShape, svg_parser.py:338-460).
"""

from __future__ import annotations

import numpy as np

from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.geom.bezier import shape_to_cubics
from yolat_tpu_torch.geom.graph_build import cubics_to_graph, merge_nodes
from yolat_tpu_torch.geom.svg_io import (ARC, SVGDocument, parse_path_d,
                                         read_ground_truth_boxes)


def build_graph_v1(doc: SVGDocument, v1_edge_attr: bool = True) -> dict:
    """Per-shape graphs concatenated then merged (buildGraph,
    svg_parser.py:303-336), without split_cross."""
    offset = 0
    all_pos, all_color, all_sw, all_ic = [], [], [], []
    all_shape, all_control, all_attr = [], [], []
    for shape in doc.shapes:
        cubics = shape_to_cubics(shape)
        g = cubics_to_graph(
            cubics, doc.width, doc.height,
            stroke=shape.get("stroke", "black"),
            stroke_width=float(shape.get("stroke-width", 3.0)),
        )
        n = len(g["pos"])
        all_pos.append(g["pos"])
        all_color.append(g["attr"]["color"])
        all_sw.append(g["attr"]["stroke_width"])
        all_ic.append(g["attr"]["is_control"])
        all_shape.append(g["edge"]["shape"] + offset)
        all_control.append(g["edge"]["control"] + offset)
        all_attr.append(g["edge_attr"]["shape"])
        offset += n

    raw = {
        "pos": np.concatenate(all_pos, axis=0),
        "attr": {
            "color": np.concatenate(all_color, axis=0),
            "stroke_width": np.concatenate(all_sw, axis=0),
            "is_control": np.concatenate(all_ic, axis=0),
        },
        "edge": {
            "shape": np.concatenate(all_shape, axis=0),
            "control": np.concatenate(all_control, axis=0),
        },
        "edge_attr": {"shape": np.concatenate(all_attr, axis=0)},
    }
    g = merge_nodes(raw)
    if v1_edge_attr:
        g["edge_attr"]["shape"] = g["edge_attr"]["shape"][:, 0:4]
    return g


def node_ground_truth(graph: dict, gt_bbox: np.ndarray, gt_labels: np.ndarray,
                      th: float = 1e-3, strict: bool = True,
                      background: int | None = None):
    """Per-node (gt_box [N,4], gt_cls [N], gt_obj [N]).

    strict=True hard-errors on a node outside every GT box (the reference's
    invariant, svg.py:131-212); strict=False labels such nodes `background`
    with gt_obj = -1 (needed on scenes whose GT does not cover every
    stroke)."""
    pos = np.asarray(graph["pos"], dtype=np.float64)
    is_control = np.asarray(graph["attr"]["is_control"]).reshape(-1) > 0.5
    n = len(pos)

    gt_bb = np.zeros((n, 4))
    gt_cls = np.zeros(n, dtype=np.int64)
    gt_obj = np.zeros(n, dtype=np.int64)

    for i in range(n):
        if is_control[i]:
            continue
        p = pos[i]
        inside = (
            (p[0] - gt_bbox[:, 0] >= -th)
            & (p[1] - gt_bbox[:, 1] >= -th)
            & (p[0] - gt_bbox[:, 2] <= th)
            & (p[1] - gt_bbox[:, 3] <= th)
        ) if len(gt_bbox) else np.zeros(0, bool)
        idx = np.where(inside)[0]
        if len(idx) == 0:
            if strict:
                raise ValueError(f"node {p} outside all ground-truth boxes")
            gt_cls[i] = -1 if background is None else background
            gt_obj[i] = -1
            continue
        if len(idx) > 1:
            d = np.linalg.norm(gt_bbox[idx, 0:2] - p[None, :], axis=1)
            idx = idx[np.argsort(d, kind="stable")]
        gt_bb[i] = gt_bbox[idx[0]]
        gt_cls[i] = gt_labels[idx[0]]
        gt_obj[i] = idx[0]

    # control nodes inherit from a non-control neighbour over control edges
    owner = np.full(n, -1, dtype=np.int64)
    for a, b in np.asarray(graph["edge"]["control"], dtype=np.int64):
        if not is_control[a] and is_control[b] and owner[b] < 0:
            owner[b] = a
        elif not is_control[b] and is_control[a] and owner[a] < 0:
            owner[a] = b
    for i in np.where(is_control)[0]:
        if owner[i] >= 0:
            gt_bb[i] = gt_bb[owner[i]]
            gt_cls[i] = gt_cls[owner[i]]
            gt_obj[i] = gt_obj[owner[i]]
    return gt_bb, gt_cls, gt_obj


def strip_control_nodes(graph: dict):
    """Drop control nodes, reindex shape edges (svg3.py:297-320)."""
    is_control = np.asarray(graph["attr"]["is_control"]).reshape(-1) > 0.5
    o2n = np.cumsum(~is_control) - 1
    edges = np.asarray(graph["edge"]["shape"], dtype=np.int64).reshape(-1, 2)
    keep_rows = ~is_control[edges[:, 0]] & ~is_control[edges[:, 1]] \
        if len(edges) else np.zeros(0, bool)
    e_attr = np.asarray(graph["edge_attr"]["shape"])
    out = {
        "pos": graph["pos"][~is_control],
        "attr": {k: np.asarray(v).reshape(len(is_control), -1)[~is_control]
                 for k, v in graph["attr"].items()},
        "edge": {"shape": o2n[edges[keep_rows]]},
        "edge_attr": {**graph["edge_attr"],
                      "shape": e_attr[keep_rows] if len(e_attr) == len(edges)
                      else e_attr},
    }
    return out, ~is_control


def shape_features(doc: SVGDocument):
    """Per-primitive 17-dim feature table + centre positions (the svg2
    'shape' graph; SVGGraphBuilderShape.buildGraph, svg_parser.py:377-460).

    Layout: [0:4] line x1 y1 x2 y2; [4:13] arc params; [13:17] circle
    cx cy rx ry — all normalised by image size.
    """
    feats, centers = [], []
    w, h = doc.width, doc.height
    for shape in doc.shapes:
        f = np.zeros(17)
        name = shape["shape_name"]
        if name == "line":
            x1, y1 = float(shape["x1"]) / w, float(shape["y1"]) / h
            x2, y2 = float(shape["x2"]) / w, float(shape["y2"]) / h
            f[0:4] = (x1, y1, x2, y2)
            centers.append(((x1 + x2) / 2, (y1 + y2) / 2))
        elif name == "circle":
            cx, cy = float(shape["cx"]) / w, float(shape["cy"]) / h
            r = float(shape["r"])
            f[13:17] = (cx, cy, r / w, r / h)
            centers.append((cx, cy))
        elif name == "path":
            segs = parse_path_d(shape["d"])
            placed = False
            for kind, p in segs:
                if kind == ARC:
                    x0, y0, x1, y1, rx, ry, rot, fa, fs = p
                    f[4:13] = (x0 / w, y0 / h, x1 / w, y1 / h,
                               rx / w, ry / h, rot, fa, fs)
                    centers.append(((x0 / w + x1 / w) / 2, (y0 / h + y1 / h) / 2))
                    placed = True
                    break
            if not placed:
                continue
        else:
            continue
        feats.append(f)
    return (np.asarray(feats).reshape(-1, 17),
            np.asarray(centers).reshape(-1, 2))


class LegacySVGDataset:
    """Manifest-driven on-the-fly legacy dataset — the Datasets/svg.py
    ('bezier'), svg2.py ('shape'), svg3.py ('bezier_edge_attr': v1 graph
    with control nodes stripped) surface, returning per-node classification
    targets (the node-GT regime of the reference's absent centernet archs).

    Each item is a dict of numpy arrays:
      pos [N,2], x [N,F] (graph-variant features), edge [E,2],
      e_attr [E,4] (bezier variants) / edge_weight [E] (shape variant),
      gt_bbox_node [N,4], gt_cls [N], gt_obj [N], gt_bbox [G,4],
      gt_labels [G], wh (2,).
    """

    def __init__(self, root: str, partition: str = "train",
                 graph: str = "bezier", mode: str | None = None,
                 class_dict: dict | None = None, strict: bool = False):
        if graph not in ("bezier", "shape", "bezier_edge_attr"):
            raise NotImplementedError(f"legacy graph {graph}")
        self._base = SESYDDataset(root, partition, cache=False, mode=mode,
                                  class_dict=class_dict)
        self.graph = graph
        self.strict = strict
        self.n_classes = self._base.n_classes

    def __len__(self):
        return len(self._base)

    def __getitem__(self, idx: int) -> dict:
        path = self._base.files[idx]
        doc = SVGDocument.from_file(path)
        w, h = doc.width, doc.height
        gt_bbox, gt_labels = read_ground_truth_boxes(
            path.replace(".svg", ".xml"), w, h, self._base.class_dict
        )
        background = self.n_classes - 1

        if self.graph == "shape":
            x, pos = shape_features(doc)
            edge, weight = proximity_edges(pos)
            g = {
                "pos": pos,
                "attr": {"is_control": np.zeros((len(pos), 1))},
                "edge": {"control": np.zeros((0, 2), np.int64)},
            }
            gt_bb, gt_cls, gt_obj = node_ground_truth(
                g, gt_bbox, gt_labels, strict=self.strict,
                background=background,
            )
            return dict(pos=pos, x=x, edge=edge, edge_weight=weight,
                        gt_bbox_node=gt_bb, gt_cls=gt_cls, gt_obj=gt_obj,
                        gt_bbox=gt_bbox, gt_labels=gt_labels,
                        wh=np.array([w, h]))

        g = build_graph_v1(doc, v1_edge_attr=True)
        gt_bb, gt_cls, gt_obj = node_ground_truth(
            g, gt_bbox, gt_labels, strict=self.strict, background=background
        )
        if self.graph == "bezier_edge_attr":
            g, keep = strip_control_nodes(g)
            gt_bb, gt_cls, gt_obj = gt_bb[keep], gt_cls[keep], gt_obj[keep]
        pos = np.asarray(g["pos"])
        x = np.concatenate(
            [pos,
             np.asarray(g["attr"]["color"]).reshape(len(pos), -1),
             np.asarray(g["attr"]["is_control"]).reshape(len(pos), 1)],
            axis=1,
        )
        return dict(pos=pos, x=x, edge=np.asarray(g["edge"]["shape"]),
                    e_attr=np.asarray(g["edge_attr"]["shape"])[:, 0:4],
                    gt_bbox_node=gt_bb, gt_cls=gt_cls, gt_obj=gt_obj,
                    gt_bbox=gt_bbox, gt_labels=gt_labels,
                    wh=np.array([w, h]))


def proximity_edges(pos: np.ndarray, th: float = 5e-3):
    """Distance-thresholded edges with 1-dist weights row-normalised
    (buildPosEdge, svg_parser.py:348-375; includes the reference's
    self-loop-permitting semantics for the shape variant)."""
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    edges, weights = [], []
    for i in range(len(pos)):
        close = np.where(d[i] < th)[0]
        ws = 1.0 - d[i, close]
        total = ws.sum()
        for j, wv in zip(close, ws):
            edges.append((i, int(j)))
            weights.append(wv / total if total > 0 else 0.0)
    return (np.asarray(edges, dtype=np.int64).reshape(-1, 2),
            np.asarray(weights))
