"""Hierarchical (YOLaT++) graph construction.

Counterpart of utils/svg_utils/build_graph_hierarchical.py: on top of the
merged Bezier graph, add one *real* super node per connected component
(position = CC centroid, colour = member mean), with

  * super-shape edges: (super_i, member node) for every member
    (:207-209 in the reference's getSuperNode),
  * intra-CC clique shape-shape edges (:210-212),
  * super-super edges: parent -> DIRECT child from the transitive reduction
    of the bbox-containment DAG (:230-283).

This is the primitive/curve/point hierarchy YOLaT++ consumes
(README.md:55-59); the reference ships no model for it, so the model here
(nn/yolat_pp.py) is designed from the paper description.

Port of `yolat_tpu/geom/hierarchical.py:1-108` over the port's
`geom/graph_build` helpers; `cli/preprocess --hierarchical` writes its
result beside each SVG.
"""

from __future__ import annotations

import numpy as np

from yolat_tpu_torch.geom.graph_build import (
    _cc_bboxes,
    _containment_matrix,
    connected_components,
)


def transitive_reduction(contained: np.ndarray) -> np.ndarray:
    """parent->child adjacency with indirect (grand)children removed."""
    n = len(contained)
    reach = contained.copy()
    # transitive closure (n is the CC count — tiny)
    for k in range(n):
        reach |= reach[:, k : k + 1] & reach[k : k + 1, :]
    indirect = contained @ reach  # parent -> child via an intermediate
    return contained & ~(indirect.astype(bool))


def build_hierarchical_graph(graph: dict) -> dict:
    """Augment a merged graph dict with super nodes and hierarchy edges.

    Returns a new dict with pos/attr extended by the super nodes and the
    edge families: shape, control, shape_shape (intra-CC clique),
    super_shape (super->member), super_super (parent->direct child).
    """
    pos = np.asarray(graph["pos"], dtype=np.float64)
    color = np.asarray(graph["attr"]["color"], dtype=np.float64)
    ccs = connected_components(graph)
    n = len(pos)
    c = len(ccs)

    super_pos = np.zeros((c, 2))
    super_color = np.zeros((c, 3))
    super_shape = []
    clique = []
    for i, cluster in enumerate(ccs):
        idx = np.asarray(cluster, dtype=np.int64)
        super_pos[i] = pos[idx].mean(axis=0)
        super_color[i] = color[idx].mean(axis=0)
        super_shape.append(
            np.stack([np.full(len(idx), n + i, dtype=np.int64), idx], axis=1)
        )
        if len(idx) > 1:
            ii, jj = np.triu_indices(len(idx), k=1)
            clique.append(np.stack([idx[ii], idx[jj]], axis=1))

    boxes = _cc_bboxes(pos, ccs)
    contained = _containment_matrix(boxes)
    direct = transitive_reduction(contained)
    pi, ci = np.where(direct)
    super_super = np.stack([n + pi, n + ci], axis=1) if len(pi) else \
        np.zeros((0, 2), dtype=np.int64)

    out = {
        "pos": np.concatenate([pos, super_pos], axis=0),
        "attr": {
            "color": np.concatenate([color, super_color], axis=0),
            "stroke_width": np.concatenate(
                [np.asarray(graph["attr"]["stroke_width"]).reshape(n, -1),
                 np.zeros((c, 1))], axis=0
            ),
            "is_control": np.concatenate(
                [np.asarray(graph["attr"]["is_control"]).reshape(n, -1),
                 np.zeros((c, 1))], axis=0
            ),
            "is_super": np.concatenate(
                [np.zeros((n, 1), bool), np.ones((c, 1), bool)], axis=0
            ),
        },
        "edge": {
            "shape": np.asarray(graph["edge"]["shape"], dtype=np.int64),
            "control": np.asarray(graph["edge"]["control"], dtype=np.int64),
            "shape_shape": np.concatenate(clique, axis=0)
            if clique else np.zeros((0, 2), np.int64),
            "super_shape": np.concatenate(super_shape, axis=0)
            if super_shape else np.zeros((0, 2), np.int64),
            "super_super": super_super,
        },
        "edge_attr": dict(graph["edge_attr"]),
        "cc": ccs,
        "n_base_nodes": n,
        "n_super_nodes": c,
    }
    for k in ("img_width", "img_height"):
        if k in graph:
            out[k] = graph[k]
    return out
