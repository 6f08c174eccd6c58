"""Bezier path -> attributed graph, node merging, CC merging.

Counterparts (behavioural, not structural) of:
  * SVGGraphBuilderBezier2.bezierPath2Graph   (Datasets/svg_parser.py:49-145)
  * SVGGraphBuilderBezier2.mergeNode          (Datasets/svg_parser.py:147-268)
  * getConnnectedComponent / mergeCC          (utils/svg_utils/build_graph_bbox.py:53-213)
  * the __main__ assembly of the per-file graph dict
                                              (utils/svg_utils/build_graph_bbox.py:302-375)
  * mergeCluster for the diagrams variant     (utils/svg_utils/build_graph_bbox_diagram.py:110-176)

Everything is vectorised numpy + union-find instead of O(N^2) Python BFS;
outputs are deterministic (edges lexicographically sorted) where the
reference's set-iteration order was arbitrary. Downstream consumers are
order-insensitive (per-edge attribute mean-pooling, adjacency lookups), so
this changes representation order only, not semantics.

Graph dict schema (the reference's per-file .pkl contract):
  pos         [N, 2]   positions normalised by image width/height
  attr.color  [N, 3], attr.stroke_width [N, 1], attr.is_control [N, 1],
  attr.is_super [N, 1]
  edge.shape  [E, 2], edge.control [Ec, 2], edge.super [Es, 2]
  edge_attr.shape [E, 6], edge_attr.super [Es, 6]
  img_width, img_height, cc (list of node-id lists)

Port of `yolat_tpu/geom/graph_build.py:1-521`. The CC merge runs in the
host library (`geom/_native.py` merge_cc); its numpy body stays as
`_merge_connected_components_py`, the oracle.
"""

from __future__ import annotations

import numpy as np

from yolat_tpu_torch.geom import _native
from yolat_tpu_torch.geom.bezier import primitives_to_cubics
from yolat_tpu_torch.geom.split_cross import split_cross
from yolat_tpu_torch.geom.svg_io import SVGDocument, UnsupportedSVGError

STROKE_COLORS = {
    "black": (0.0, 0.0, 0.0),
    "red": (1.0, 0.0, 0.0),
    "green": (0.0, 1.0, 0.0),
    "blue": (0.0, 0.0, 1.0),
}

MERGE_POS_TH = 1e-3  # node coincidence radius (svg_parser.py:151)
MERGE_ATTR_TH = 1e-8  # attribute equality radius (svg_parser.py:158)
CONTAIN_TH = 0.9  # CC containment ratio (build_graph_bbox.py:145)


# ---------------------------------------------------------------------------
# union-find
# ---------------------------------------------------------------------------


class UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, i: int) -> int:
        p = self.parent
        root = i
        while p[root] != root:
            root = p[root]
        while p[i] != root:  # path compression
            p[i], i = root, p[i]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # keep the smaller id as root so labels-by-first-seen fall out
            if ra < rb:
                self.parent[rb] = ra
            else:
                self.parent[ra] = rb

    def labels(self) -> np.ndarray:
        """Cluster labels numbered by first occurrence in node order.

        union() keeps the smaller id as root, so every root is its
        cluster's smallest member: root r first occurs at index r itself,
        and ascending root id == first-occurrence order. Pointer-jump the
        parent array to its fixpoint (vectorised path compression), then
        rank the roots.
        """
        p = self.parent
        while True:
            pp = p[p]
            if np.array_equal(pp, p):
                break
            p = pp
        self.parent = p  # keep the compressed forest
        _, labels = np.unique(p, return_inverse=True)
        return labels.astype(np.int64, copy=False)


# ---------------------------------------------------------------------------
# cubic segments -> raw graph
# ---------------------------------------------------------------------------


def _edge_geometry_attr(p_start: np.ndarray, p_end: np.ndarray) -> np.ndarray:
    """(angle, squared distance) attr tail shared by shape and super edges
    (svg_parser.py:111-112, build_graph_bbox.py:196-197)."""
    d = p_start - p_end
    d2 = d[:, 0] ** 2 + d[:, 1] ** 2
    angle = d[:, 0] / (np.sqrt(d2) + 1e-7)
    return np.stack([angle, d2], axis=1)


def cubics_to_graph(cubics: np.ndarray, width: float, height: float,
                    stroke: str = "black", stroke_width: float = 6.0) -> dict:
    """Emit the 4-nodes/6-edges-per-segment raw graph.

    For each cubic (start, c1, c2, end): four nodes with is_control pattern
    (0,1,1,0); one shape edge (start,end); five control edges; a 6-dim shape
    edge attribute [c1-start, c2-end, angle, dist^2]
    (svg_parser.py:49-145). Positions are normalised by image size.
    """
    if stroke not in STROKE_COLORS:
        raise UnsupportedSVGError(f"unsupported stroke color: {stroke}")
    S = len(cubics)
    pts = np.asarray(cubics, dtype=np.float64) / np.array([width, height])
    pos = pts.reshape(S * 4, 2)

    color = np.tile(np.asarray(STROKE_COLORS[stroke]), (S * 4, 1))
    sw = np.full((S * 4, 1), (float(stroke_width) - 3.0) / 3.0)
    is_control = np.tile(np.array([[0], [1], [1], [0]], dtype=np.int64), (S, 1))

    base = 4 * np.arange(S, dtype=np.int64)
    shape_edges = np.stack([base, base + 3], axis=1)
    if S:
        # the 5 control edges of each segment appear consecutively, matching
        # the reference append order (svg_parser.py:121-125)
        control_edges = np.stack(
            [
                np.stack([base, base + 1], axis=1),
                np.stack([base, base + 2], axis=1),
                np.stack([base + 3, base + 2], axis=1),
                np.stack([base + 3, base + 1], axis=1),
                np.stack([base + 1, base + 2], axis=1),
            ],
            axis=1,
        ).reshape(S * 5, 2)
    else:
        control_edges = np.zeros((0, 2), dtype=np.int64)

    start, c1, c2, end = pts[:, 0], pts[:, 1], pts[:, 2], pts[:, 3]
    tail = _edge_geometry_attr(start, end)
    edge_attr = np.concatenate([c1 - start, c2 - end, tail], axis=1) if S else np.zeros((0, 6))

    return {
        "pos": pos,
        "attr": {
            "color": color,
            "stroke_width": sw,
            "is_control": is_control.astype(np.float64),
        },
        "edge": {"shape": shape_edges, "control": control_edges},
        "edge_attr": {"shape": edge_attr},
    }


# ---------------------------------------------------------------------------
# node merge
# ---------------------------------------------------------------------------


def _closure_labels(n: int, pairs: np.ndarray) -> np.ndarray:
    """Transitive-closure cluster labels numbered by first occurrence in
    node order (== UnionFind.labels over the same pairs; the scipy
    csgraph path is vectorised C, the UnionFind loop is the fallback)."""
    if len(pairs) == 0:
        return np.arange(n, dtype=np.int64)
    try:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        m = coo_matrix(
            (np.ones(len(pairs), dtype=np.int8), (pairs[:, 0], pairs[:, 1])),
            shape=(n, n),
        )
        _, comp = connected_components(m, directed=False)
        # relabel by first occurrence: rank components by smallest member
        first = np.full(int(comp.max()) + 1, n, dtype=np.int64)
        np.minimum.at(first, comp, np.arange(n, dtype=np.int64))
        rank = np.empty(len(first), dtype=np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(len(first))
        return rank[comp]
    except ImportError:  # pragma: no cover
        uf = UnionFind(n)
        for x, y in pairs:
            uf.union(int(x), int(y))
        return uf.labels()


def merge_nodes(graph: dict) -> dict:
    """Merge coincident (<1e-3) non-control nodes with equal attributes.

    Same closure semantics as the reference mergeNode BFS
    (svg_parser.py:147-268): the merge relation is transitively closed;
    merged node attributes are cluster means; shape-edge attributes are
    mean-pooled over parallel merged edges; self-loops vanish.
    """
    pos = np.asarray(graph["pos"], dtype=np.float64)
    n = len(pos)
    attrs = graph["attr"]
    if n == 0:  # geometry-free SVG: pass the empty graph through
        return {
            "pos": pos.reshape(0, 2),
            "attr": {k: np.asarray(v, np.float64).reshape(0, max(np.asarray(v).shape[-1] if np.asarray(v).ndim > 1 else 1, 1))
                     for k, v in attrs.items()},
            "edge": {k: np.zeros((0, 2), np.int64) for k in graph["edge"]},
            "edge_attr": {k: np.zeros((0, 6)) for k in graph["edge_attr"]},
        }
    is_control = np.asarray(attrs["is_control"]).reshape(-1) > 0.5

    # [n, sum_widths] attr matrix, built once and reused for the equality
    # test and the cluster means
    attr_mats = {key: np.asarray(attrs[key], dtype=np.float64).reshape(n, -1)
                 for key in attrs}

    merge_pairs = np.zeros((0, 2), dtype=np.int64)
    non_control = np.where(~is_control)[0]
    if len(non_control) > 1:
        try:
            from scipy.spatial import cKDTree

            tree = cKDTree(pos[non_control])
            pairs = tree.query_pairs(r=MERGE_POS_TH, output_type="ndarray")
        except ImportError:  # pragma: no cover
            sub = pos[non_control]
            d = np.linalg.norm(sub[:, None] - sub[None, :], axis=-1)
            ii, jj = np.where(np.triu(d < MERGE_POS_TH, k=1))
            pairs = np.stack([ii, jj], axis=1)
        if len(pairs):
            a = non_control[pairs[:, 0]]
            b = non_control[pairs[:, 1]]
            # attribute equality across every attr key (svg_parser.py:155-160)
            ok = np.ones(len(a), dtype=bool)
            for mat in attr_mats.values():
                ok &= np.linalg.norm(mat[a] - mat[b], axis=1) < MERGE_ATTR_TH
            merge_pairs = np.stack([a[ok], b[ok]], axis=1)

    labels = _closure_labels(n, merge_pairs)
    n_cluster = int(labels.max()) + 1 if n else 0

    merged = {"pos": _segment_mean(pos, labels, n_cluster), "attr": {}, "edge": {}, "edge_attr": {}}
    for key, mat in attr_mats.items():
        merged["attr"][key] = _segment_mean(mat, labels, n_cluster)

    # shape edges: remap, drop self-loops, dedupe, mean-pool attrs
    se = np.asarray(graph["edge"]["shape"], dtype=np.int64).reshape(-1, 2)
    sa = np.asarray(graph["edge_attr"]["shape"], dtype=np.float64).reshape(len(se), -1)
    me = labels[se]
    keep = me[:, 0] != me[:, 1]
    me, sa = me[keep], sa[keep]
    me = np.sort(me, axis=1)
    if len(me):
        uniq, inv = _unique_pairs(me, n_cluster)
        pooled = _segment_mean(sa, inv, len(uniq))
        merged["edge"]["shape"] = uniq
        merged["edge_attr"]["shape"] = pooled
    else:
        merged["edge"]["shape"] = np.zeros((0, 2), dtype=np.int64)
        merged["edge_attr"]["shape"] = np.zeros((0, sa.shape[1] if sa.size else 6))

    # other edge families: remap, drop self-loops, dedupe
    for key in graph["edge"]:
        if key == "shape":
            continue
        e = np.asarray(graph["edge"][key], dtype=np.int64).reshape(-1, 2)
        e = labels[e]
        e = e[e[:, 0] != e[:, 1]]
        e = np.sort(e, axis=1)
        merged["edge"][key] = (_unique_pairs(e, n_cluster)[0] if len(e)
                               else np.zeros((0, 2), dtype=np.int64))

    return merged


def _segment_mean(values: np.ndarray, seg: np.ndarray, n_seg: int) -> np.ndarray:
    # per-column bincount beats np.add.at (a slow ufunc.at) ~20x at these
    # widths (<= 6 columns)
    values = values.reshape(len(values), -1)
    out = np.stack(
        [np.bincount(seg, weights=values[:, c], minlength=n_seg)
         for c in range(values.shape[1])], axis=1,
    ) if values.shape[1] else np.zeros((n_seg, 0))
    counts = np.bincount(seg, minlength=n_seg).astype(np.float64)
    counts[counts == 0] = 1.0
    return out / counts[:, None]


def _unique_pairs(pairs: np.ndarray, n: int):
    """np.unique(pairs, axis=0, return_inverse=True) for [E, 2] int pairs
    with entries < n, via packed 1-D keys (same lexicographic order,
    much faster than the axis=0 structured-view path)."""
    key = pairs[:, 0] * np.int64(n) + pairs[:, 1]
    uk, inv = np.unique(key, return_inverse=True)
    return np.stack([uk // n, uk % n], axis=1), inv


# ---------------------------------------------------------------------------
# connected components + CC merging
# ---------------------------------------------------------------------------


def connected_components(graph: dict) -> list:
    """CCs over shape edges, control nodes excluded; clusters ordered by
    smallest member id, members sorted ascending
    (getConnnectedComponent, build_graph_bbox.py:53-85; the reference's
    within-cluster BFS order is not semantically load-bearing downstream)."""
    pos = graph["pos"]
    is_control = np.asarray(graph["attr"]["is_control"]).reshape(-1) > 0.5
    n = len(pos)
    uf = UnionFind(n)
    for a, b in np.asarray(graph["edge"]["shape"], dtype=np.int64).reshape(-1, 2):
        uf.union(int(a), int(b))
    labels = uf.labels()
    clusters: dict = {}
    for i in range(n):
        if is_control[i]:
            continue
        clusters.setdefault(labels[i], []).append(i)
    # order by smallest member
    return [sorted(v) for _, v in sorted(clusters.items(), key=lambda kv: kv[1][0])]


def _cc_bboxes(pos: np.ndarray, ccs: list) -> np.ndarray:
    boxes = np.empty((len(ccs), 4), dtype=np.float64)
    for i, c in enumerate(ccs):
        p = pos[c]
        boxes[i] = (p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max())
    return boxes


def _containment_matrix(boxes: np.ndarray) -> np.ndarray:
    """is_parent_child[i, j]: CC j's bbox is >=90% inside CC i's bbox,
    including the degenerate zero-width/height conventions
    (build_graph_bbox.py:130-160)."""
    n = len(boxes)
    px0, py0, px1, py1 = (boxes[:, k][:, None] for k in range(4))
    cx0, cy0, cx1, cy1 = (boxes[:, k][None, :] for k in range(4))

    ix0 = np.maximum(px0, cx0)
    iy0 = np.maximum(py0, cy0)
    ix1 = np.minimum(px1, cx1)
    iy1 = np.minimum(py1, cy1)

    cw = cx1 - cx0
    ch = cy1 - cy0
    child_area = cw * ch

    inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
    out = np.zeros((n, n), dtype=bool)

    pos_area = child_area > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        out |= pos_area & (inter / np.where(pos_area, child_area, 1.0) > CONTAIN_TH)

    zero_w = cw == 0
    out |= zero_w & (ix1 - ix0 == 0) & (np.maximum(iy1 - iy0, 0) > CONTAIN_TH * ch)
    zero_h = ch == 0
    out |= zero_h & (np.maximum(ix1 - ix0, 0) > CONTAIN_TH * cw) & (iy1 - iy0 == 0)

    np.fill_diagonal(out, False)
    return out


def merge_connected_components(graph: dict) -> dict:
    """Build intra-CC clique ("super") edges, cross-CC containment edges,
    their attributes, and the merged CC list (mergeCC,
    build_graph_bbox.py:87-213).

    Returns dict with keys: shape_shape_edges, cross_shape_edges,
    shape_shape_attr, cross_attr, cc (merged clusters, each sorted).

    Dispatches to the host library (csrc/geomcore.cpp merge_cc); the numpy
    path, `_merge_connected_components_py`, runs under `_native.disabled()`
    and where the library's capacity retry is exhausted."""
    native = _native.merge_cc_native(
        np.asarray(graph["pos"], dtype=np.float64),
        np.asarray(graph["edge"]["shape"], dtype=np.int64),
        np.asarray(graph["attr"]["is_control"]).reshape(-1) > 0.5,
        CONTAIN_TH,
    )
    if native is not None:
        return native
    return _merge_connected_components_py(graph)


def _merge_connected_components_py(graph: dict) -> dict:
    pos = np.asarray(graph["pos"], dtype=np.float64)
    ccs = connected_components(graph)
    boxes = _cc_bboxes(pos, ccs)

    # intra-CC cliques
    clique = []
    for c in ccs:
        idx = np.asarray(c, dtype=np.int64)
        if len(idx) > 1:
            ii, jj = np.triu_indices(len(idx), k=1)
            clique.append(np.stack([idx[ii], idx[jj]], axis=1))
    shape_shape = (
        np.unique(np.sort(np.concatenate(clique, axis=0), axis=1), axis=0)
        if clique
        else np.zeros((0, 2), dtype=np.int64)
    )

    contained = _containment_matrix(boxes)
    same_cc = contained | contained.T

    cross = []
    for i, j in zip(*np.where(contained)):
        a = np.asarray(ccs[i], dtype=np.int64)
        b = np.asarray(ccs[j], dtype=np.int64)
        aa, bb = np.meshgrid(a, b, indexing="ij")
        cross.append(np.stack([aa.ravel(), bb.ravel()], axis=1))
    cross_edges = (
        np.unique(np.sort(np.concatenate(cross, axis=0), axis=1), axis=0)
        if cross
        else np.zeros((0, 2), dtype=np.int64)
    )

    # transitively merge contained CCs
    uf = UnionFind(len(ccs))
    for i, j in zip(*np.where(same_cc)):
        uf.union(int(i), int(j))
    labels = uf.labels() if len(ccs) else np.zeros(0, dtype=np.int64)
    merged: dict = {}
    for i, c in enumerate(ccs):
        merged.setdefault(labels[i], []).extend(c)
    new_cc = [sorted(v) for _, v in sorted(merged.items(), key=lambda kv: min(kv[1]))]

    def super_attr(edges):
        if len(edges) == 0:
            return np.zeros((0, 6))
        tail = _edge_geometry_attr(pos[edges[:, 0]], pos[edges[:, 1]])
        return np.concatenate([np.zeros((len(edges), 4)), tail], axis=1)

    return {
        "shape_shape_edges": shape_shape,
        "cross_shape_edges": cross_edges,
        "shape_shape_attr": super_attr(shape_shape),
        "cross_attr": super_attr(cross_edges),
        "cc": new_cc,
    }


def merge_cluster_diagram(pos: np.ndarray, ccs: list, width: float, height: float,
                          expand_px: float = 40.0) -> list:
    """Diagrams-variant CC grouping: expand each CC bbox by `expand_px`
    pixels and merge overlapping CCs (mergeCluster,
    build_graph_bbox_diagram.py:110-176 with the 40px expansion at :198).
    Symbols in diagrams are disconnected strokes, so proximity grouping
    replaces pure connectivity."""
    if not ccs:
        return []
    boxes = _cc_bboxes(pos, ccs)
    ex = expand_px / width
    ey = expand_px / height
    boxes = boxes + np.array([-ex, -ey, ex, ey])
    # the reference clamps the expanded boxes to the unit image and counts
    # touching extents as overlapping (<=), which matters exactly at the
    # borders where clamping pins both boxes to 0/1
    # (build_graph_bbox_diagram.py:126-144)
    boxes[:, 0:2] = np.maximum(boxes[:, 0:2], 0.0)
    boxes[:, 2:4] = np.minimum(boxes[:, 2:4], 1.0)

    x0a, y0a, x1a, y1a = (boxes[:, k][:, None] for k in range(4))
    x0b, y0b, x1b, y1b = (boxes[:, k][None, :] for k in range(4))
    overlap = (
        (np.minimum(x1a, x1b) >= np.maximum(x0a, x0b))
        & (np.minimum(y1a, y1b) >= np.maximum(y0a, y0b))
    )

    uf = UnionFind(len(ccs))
    for i, j in zip(*np.where(overlap)):
        uf.union(int(i), int(j))
    labels = uf.labels()
    merged: dict = {}
    for i, c in enumerate(ccs):
        merged.setdefault(labels[i], []).extend(c)
    return [sorted(v) for _, v in sorted(merged.items(), key=lambda kv: min(kv[1]))]


# ---------------------------------------------------------------------------
# end-to-end per-file build
# ---------------------------------------------------------------------------


def build_svg_graph(doc: SVGDocument, mode: str = "floorplan") -> dict:
    """Full offline build for one SVG document -> graph dict (.pkl schema).

    Counterpart of build_graph_bbox.py __main__ (:302-375): split_cross,
    forced stroke attributes (black, width 6), graph build, node merge, CC
    merge, super-edge assembly. mode='diagram' additionally applies the
    proximity CC grouping of build_graph_bbox_diagram.py.
    """
    prims = split_cross(doc.shapes)
    cubics = primitives_to_cubics(prims)
    raw = cubics_to_graph(cubics, doc.width, doc.height, stroke="black", stroke_width=6.0)
    graph = merge_nodes(raw)

    cc_info = merge_connected_components(graph)
    cc = cc_info["cc"]
    if mode == "diagram":
        cc = merge_cluster_diagram(graph["pos"], cc, doc.width, doc.height)

    n = len(graph["pos"])
    edge_super = np.concatenate(
        [cc_info["shape_shape_edges"], cc_info["cross_shape_edges"]], axis=0
    )
    e_attr_super = np.concatenate([cc_info["shape_shape_attr"], cc_info["cross_attr"]], axis=0)

    graph["edge"]["super"] = edge_super.astype(np.int64)
    graph["edge_attr"]["super"] = e_attr_super
    graph["attr"]["is_super"] = np.zeros((n, 1), dtype=bool)
    graph["img_width"] = doc.width
    graph["img_height"] = doc.height
    graph["cc"] = cc
    return graph
