"""The port's `data/legacy.py` against yolat_tpu's.

Every function gives the JAX package's arrays, exactly (dtype, shape and
values; the graph features are float64 on both sides): `build_graph_v1`
(with and without the v1 edge attributes), `node_ground_truth` (the 1e-3
slack, ties broken by the nearest top-left corner, control nodes taking
a control-edge neighbour's target, `strict`), `strip_control_nodes` (its
`keep` mask and the re-indexed edges), `shape_features` and
`proximity_edges` (self-loops kept, weights row-normalised in float64) on
the synthetic floorplans and on the hand-built cases of
tests/test_breadth_models.py; `LegacySVGDataset` item for item in all
three graphs. The trainer's refusal of a legacy graph names this module.
"""

import os

import numpy as np
import pytest

from yolat_tpu.data import legacy as jl
from yolat_tpu.geom.bezier import line_to_cubic as jax_line_to_cubic
from yolat_tpu.geom.graph_build import cubics_to_graph as jax_cubics_to_graph
from yolat_tpu.geom.graph_build import merge_nodes as jax_merge_nodes
from yolat_tpu.geom.svg_io import SVGDocument as JaxSVGDocument
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data import legacy as pl
from yolat_tpu_torch.data.synthetic import FLOORPLAN_CLASSES
from yolat_tpu_torch.geom.bezier import line_to_cubic
from yolat_tpu_torch.geom.graph_build import cubics_to_graph, merge_nodes
from yolat_tpu_torch.geom.svg_io import SVGDocument, read_ground_truth_boxes
from yolat_tpu_torch.train.trainer import run_training


def _same(a, b, what=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module")
def files(synthetic_root):
    """(port doc, JAX doc, gt boxes, gt labels) of each train floorplan."""
    with open(os.path.join(synthetic_root, "train_list.txt")) as f:
        paths = [os.path.join(synthetic_root, line.strip()) for line in f
                 if line.strip()]
    out = []
    for path in paths:
        doc = SVGDocument.from_file(path)
        gt, lab = read_ground_truth_boxes(path.replace(".svg", ".xml"),
                                          doc.width, doc.height,
                                          FLOORPLAN_CLASSES)
        out.append((doc, JaxSVGDocument.from_file(path), gt, lab))
    return out


@pytest.mark.parametrize("v1_edge_attr", [True, False])
def test_build_graph_v1(files, v1_edge_attr):
    for doc, jdoc, _, _ in files:
        g = pl.build_graph_v1(doc, v1_edge_attr=v1_edge_attr)
        _same(g, jl.build_graph_v1(jdoc, v1_edge_attr=v1_edge_attr), "g")
        assert g["edge_attr"]["shape"].shape[1] == (4 if v1_edge_attr else 6)


def test_node_ground_truth_and_strip_on_floorplans(files):
    n_bg = 0
    for doc, jdoc, gt, lab in files:
        g, jg = pl.build_graph_v1(doc), jl.build_graph_v1(jdoc)
        got = pl.node_ground_truth(g, gt, lab, strict=False, background=16)
        want = jl.node_ground_truth(jg, gt, lab, strict=False, background=16)
        for a, b in zip(got, want):
            _same(a, b, "node_ground_truth")
        n_bg += int((got[2] == -1).sum())
        # walls lie outside every symbol box: the strict form refuses both
        for mod, graph in ((pl, g), (jl, jg)):
            with pytest.raises(ValueError, match="outside all"):
                mod.node_ground_truth(graph, gt, lab, strict=True)
        (s, keep), (js, jkeep) = (pl.strip_control_nodes(g),
                                  jl.strip_control_nodes(jg))
        _same(keep, jkeep, "keep")
        _same(s, js, "stripped")
        assert len(s["pos"]) == int(keep.sum()) < len(g["pos"])
        assert (s["edge"]["shape"] < len(s["pos"])).all()
        # the keep mask re-indexes the GT arrays as the dataset does
        _same(got[1][keep], want[1][jkeep], "gt_cls[keep]")
    assert n_bg > 0


def _square(line, cubics_to_graph_, merge, x0=10.0, s=30.0):
    x1 = x0 + s
    cubics = np.concatenate([line(x0, x0, x1, x0), line(x1, x0, x1, x1),
                             line(x1, x1, x0, x1), line(x0, x1, x0, x0)])
    return merge(cubics_to_graph_(cubics, 100.0, 100.0))


def test_node_ground_truth_hand_built_cases():
    g = _square(line_to_cubic, cubics_to_graph, merge_nodes)
    jg = _square(jax_line_to_cubic, jax_cubics_to_graph, jax_merge_nodes)
    _same(g, jg, "square")
    is_control = g["attr"]["is_control"].reshape(-1) > 0.5
    assert is_control.any()
    cases = {
        # one box covering every node: control nodes inherit it
        "cover": (np.array([[0.1, 0.1, 0.4, 0.4]]), np.array([7])),
        # inside within the 1e-3 slack only
        "slack": (np.array([[0.1005, 0.1005, 0.3995, 0.3995]]),
                  np.array([3])),
        # two boxes hold every node: the nearer top-left corner wins, and
        # equal distances keep the first box (stable order)
        "tie": (np.array([[0.1, 0.1, 0.4, 0.4], [0.05, 0.05, 0.45, 0.45],
                          [0.1, 0.1, 0.4, 0.4]]), np.array([1, 2, 5])),
        # a box that misses half the square: the rest is background
        "partial": (np.array([[0.1, 0.1, 0.25, 0.45]]), np.array([4])),
    }
    for name, (gt, lab) in cases.items():
        for strict in (True, False):
            try:
                want = jl.node_ground_truth(jg, gt, lab, strict=strict,
                                            background=9)
            except ValueError as e:
                with pytest.raises(ValueError, match="outside all"):
                    pl.node_ground_truth(g, gt, lab, strict=strict,
                                         background=9)
                assert strict and name == "partial", e
                continue
            got = pl.node_ground_truth(g, gt, lab, strict=strict,
                                       background=9)
            for a, b in zip(got, want):
                _same(a, b, name)
            if name == "cover":
                assert (got[1] == 7).all()
                np.testing.assert_array_equal(got[0],
                                              np.tile(gt, (len(got[0]), 1)))
            if name == "tie":
                assert (got[1][~is_control] == 1).all()


def test_shape_features_and_proximity_edges(files):
    n_arcs = 0
    for doc, jdoc, _, _ in files:
        got, want = pl.shape_features(doc), jl.shape_features(jdoc)
        for a, b in zip(got, want):
            _same(a, b, "shape_features")
        n_arcs += int(got[0][:, 4:13].any(axis=1).sum())
        pos = got[1]
        e, w = pl.proximity_edges(pos, th=0.05)
        je, jw = jl.proximity_edges(pos, th=0.05)
        _same(e, je, "edges")
        _same(w, jw, "weights")
        assert w.dtype == np.float64 and (e[:, 0] == e[:, 1]).sum() == len(pos)
    rng = np.random.default_rng(4)
    pos = rng.random((40, 2)) * 0.02
    pos[5] = pos[6]  # a zero distance besides the self-loop
    for th in (5e-3, 1e-2):
        (e, w), (je, jw) = pl.proximity_edges(pos, th), jl.proximity_edges(
            pos, th)
        _same(e, je, "edges")
        _same(w, jw, "weights")
    empty = pl.proximity_edges(np.zeros((0, 2)))
    _same(empty[0], jl.proximity_edges(np.zeros((0, 2)))[0], "empty")
    assert n_arcs > 0


@pytest.mark.parametrize("graph", ["bezier", "shape", "bezier_edge_attr"])
def test_legacy_dataset_matches_jax(synthetic_root, graph):
    ds = pl.LegacySVGDataset(synthetic_root, "train", graph=graph)
    jds = jl.LegacySVGDataset(synthetic_root, "train", graph=graph)
    assert len(ds) == len(jds) > 0 and ds.n_classes == jds.n_classes
    for i in range(len(ds)):
        _same(ds[i], jds[i], f"item {i}")
    item = ds[0]
    if graph == "bezier_edge_attr":
        assert (item["x"][:, -1] == 0).all()
    with pytest.raises(NotImplementedError):
        pl.LegacySVGDataset(synthetic_root, graph="hierarchical")


def test_trainer_refusal_names_the_legacy_module(tmp_path):
    with pytest.raises(NotImplementedError,
                       match="yolat_tpu_torch/data/legacy.py"):
        run_training(Config(graph="bezier", data_dir=str(tmp_path)), "cpu",
                     exp_dir=str(tmp_path))
