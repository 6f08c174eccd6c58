"""The port's diagram and chart datasets against yolat_tpu's.

The writers are copies: the same documents byte for byte, diagrams at two
seeds, charts with and without bars. The diagram-mode graph build (the
proximity CC grouping, `merge_cluster_diagram`) and `SESYDDataset.load` on
both datasets are held to the JAX package with the host tests' tolerance
(integers equal, floats within rtol 1e-9 / atol 1e-8), on the host library
and under `_native.disabled()`. Packed batches are bitwise equal to the
JAX packer's with both host stages on their numpy paths: a diagram batch,
and a chart batch with the YOLaT++ super-edge family, whose `sew_` plan
(another layout than the TPU's) is held to its definition and to the real
edges of the JAX plan.
"""

import contextlib
import filecmp
import os

import numpy as np
import pytest

import yolat_tpu.geom._native as jax_native
from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.synthetic import write_chart_dataset as jax_write_chart
from yolat_tpu.data.synthetic import write_diagram_dataset as jax_write_diagram
from yolat_tpu.geom.bezier import primitives_to_cubics
from yolat_tpu.geom.graph_build import build_svg_graph as jax_build_graph
from yolat_tpu.geom.graph_build import cubics_to_graph
from yolat_tpu.geom.graph_build import \
    merge_cluster_diagram as jax_merge_cluster
from yolat_tpu.geom.graph_build import \
    merge_connected_components as jax_merge_ccs
from yolat_tpu.geom.graph_build import merge_nodes as jax_merge_nodes
from yolat_tpu.geom.split_cross import split_cross
from yolat_tpu.geom.svg_io import SVGDocument as JaxDocument
from yolat_tpu.ops.banded_message import banded_plan as jax_banded_plan
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.synthetic import (CHART_CLASSES, DIAGRAM_CLASSES,
                                            write_chart_dataset,
                                            write_diagram_dataset)
from yolat_tpu_torch.geom import _native
from yolat_tpu_torch.geom.graph_build import (build_svg_graph,
                                              merge_cluster_diagram)
from yolat_tpu_torch.geom.svg_io import SVGDocument
from yolat_tpu_torch.ops.plans import EW_BATCH_KEYS, SEW_KEYS

# the small chart of tests/test_charts.py
CHART_KW = dict(width=900.0, height=700.0, n_series=1, points_per_series=4)


@pytest.fixture(scope="module")
def diagram_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_diagrams")
    write_diagram_dataset(str(root), n_train=3, n_test=2, seed=0)
    return str(root)


@pytest.fixture(scope="module")
def chart_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_charts")
    write_chart_dataset(str(root), n_train=3, n_test=1, seed=3, **CHART_KW)
    return str(root)


@pytest.fixture
def numpy_host_stage(monkeypatch):
    """The JAX package's host stage on its numpy paths."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)


def _assert_tree_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_tree_close(a, b, f"{path}[{i}]")
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-8,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)


def _assert_same(got: dict, want: dict, keys):
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _same_files(port_root, jax_root) -> int:
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(jax_root)
    assert names == files(port_root)
    _, mismatch, errors = filecmp.cmpfiles(port_root, jax_root, names,
                                           shallow=False)
    assert not mismatch and not errors
    return len(names)


@pytest.mark.parametrize("seed", [0, 11])
def test_diagram_writer_matches_jax(tmp_path, seed):
    kw = dict(n_train=3, n_test=2, seed=seed)
    write_diagram_dataset(str(tmp_path / "port"), **kw)
    jax_write_diagram(str(tmp_path / "jax"), **kw)
    # 5 SVGs, 5 XMLs and the two lists
    assert _same_files(tmp_path / "port", tmp_path / "jax") == 12
    ds = SESYDDataset(str(tmp_path / "port"), "train")
    assert ds.mode == "diagram" and ds.class_dict == DIAGRAM_CLASSES


@pytest.mark.parametrize("bar_fraction", [0.0, 1.0])
def test_chart_writer_matches_jax(tmp_path, bar_fraction):
    kw = dict(n_train=2, n_test=1, seed=3, bar_fraction=bar_fraction,
              **CHART_KW)
    write_chart_dataset(str(tmp_path / "port"), **kw)
    jax_write_chart(str(tmp_path / "jax"), **kw)
    assert _same_files(tmp_path / "port", tmp_path / "jax") == 8
    xml = open(tmp_path / "port" / "charts-syn" / "file_train_0.xml").read()
    assert ('label="bar"' in xml) == (bar_fraction == 1.0)
    ds = SESYDDataset(str(tmp_path / "port"), "train")
    assert ds.mode == "chart" and ds.class_dict == CHART_CLASSES


def test_diagram_graph_build_matches_jax(diagram_root):
    ds = SESYDDataset(diagram_root, "train", cache=False)
    for path in ds.files:
        doc, jdoc = SVGDocument.from_file(path), JaxDocument.from_file(path)
        got = build_svg_graph(doc, mode="diagram")
        _assert_tree_close(got, jax_build_graph(jdoc, mode="diagram"))
        # the proximity grouping itself, on the JAX package's CCs
        raw = cubics_to_graph(primitives_to_cubics(split_cross(jdoc.shapes)),
                              jdoc.width, jdoc.height, stroke="black",
                              stroke_width=6.0)
        g = jax_merge_nodes(raw)
        ccs = jax_merge_ccs(g)["cc"]
        groups = []
        for expand in (40.0, 400.0):
            merged = merge_cluster_diagram(g["pos"], ccs, jdoc.width,
                                           jdoc.height, expand_px=expand)
            assert merged == jax_merge_cluster(g["pos"], ccs, jdoc.width,
                                               jdoc.height, expand_px=expand)
            groups.append(len(merged))
        # the default reach joins a glyph's strokes into one group, and a
        # wide reach joins glyphs
        assert groups[1] < groups[0] == len(got["cc"]) < len(ccs)


@pytest.mark.parametrize("host", ["native", "numpy"])
@pytest.mark.parametrize("data", ["diagram", "chart"])
def test_dataset_load_matches_jax(diagram_root, chart_root, host, data):
    root, step = ((diagram_root, 5) if data == "diagram"
                  else (chart_root, 10))
    with _native.disabled() if host == "numpy" else contextlib.nullcontext():
        for partition in ("train", "test"):
            ds = SESYDDataset(root, partition, bbox_sampling_step=step,
                              cache=False)
            jds = JaxDataset(root, partition, bbox_sampling_step=step,
                             cache=False)
            assert ds.files == jds.files and ds.mode == jds.mode == data
            assert ds.class_dict == jds.class_dict
            for i in range(len(ds)):
                (pf, gt, wh), (jpf, jgt, jwh) = ds.load(i), jds.load(i)
                assert pf.n_proposals == jpf.n_proposals > 0
                _assert_tree_close(pf.to_dict(), jpf.to_dict())
                _assert_tree_close(list(gt), list(jgt))
                assert wh == jwh


def test_diagram_batch_matches_jax(diagram_root, numpy_host_stage):
    ds = SESYDDataset(diagram_root, "train", bbox_sampling_step=5,
                      cache=False)
    jds = JaxDataset(diagram_root, "train", bbox_sampling_step=5,
                     cache=False)
    with _native.disabled():
        loader = PackedLoader(ds, batch_size=4, prefetch=0, dense=True)
        got = list(loader)
    jax_loader = JaxLoader(jds, batch_size=4, shuffle=False, prefetch=0,
                           dense=True)
    want = [{k: v[0] for k, v in b.items()} for b in jax_loader]
    assert loader.d_max == jax_loader.d_max
    assert len(got) == len(want) == 1
    b, w = got[0], want[0]
    assert int(b["n_images"]) == 3 and b["proposal_mask"].sum() > 100
    _assert_same(b, w, [k for k in b if k not in EW_BATCH_KEYS])


def _check_plan(plan, edge, mask, attr, n):
    """The plan holds exactly the real edges, stably sorted by dst, with
    per-node offsets."""
    idx = np.nonzero(mask)[0]
    order = idx[np.argsort(edge[idx, 1], kind="stable")]
    np.testing.assert_array_equal(plan["own"], edge[order, 1])
    np.testing.assert_array_equal(plan["oth"], edge[order, 0])
    np.testing.assert_array_equal(plan["attr"], attr[order])
    np.testing.assert_array_equal(np.diff(plan["nptr"]),
                                  np.bincount(edge[order, 1], minlength=n))


def test_chart_batch_with_super_family_matches_jax(chart_root,
                                                   numpy_host_stage):
    ds = SESYDDataset(chart_root, "train", bbox_sampling_step=10,
                      cache=False)
    jds = JaxDataset(chart_root, "train", bbox_sampling_step=10, cache=False)
    with _native.disabled():
        loader = PackedLoader(ds, batch_size=2, prefetch=0,
                              super_family=True, sew_plan="own")
        got = list(loader)
    jax_loader = JaxLoader(jds, batch_size=2, shuffle=False, prefetch=0)
    want = [{k: v[0] for k, v in b.items()} for b in jax_loader]
    assert loader.pad.n_super == jax_loader.pad.n_super > 0
    assert len(got) == len(want) == 2
    for b, w in zip(got, want):
        assert b["super_mask"].sum() > 10000
        _assert_same(b, w, [k for k in b
                            if k not in EW_BATCH_KEYS + SEW_KEYS])
        n = b["pos"].shape[0]
        fam = (b["edge_super"], b["super_mask"], b["e_attr_super"])
        plan = {k[4:]: b[k] for k in SEW_KEYS}
        _check_plan(plan, *fam, n)
        # the JAX plan's real edges, where its block layout holds them
        jplan = jax_banded_plan(*fam, n, sortby=1, wn=128, pad=64, eblk=128)
        if jplan is not None:
            wn, pad = jplan["bm_wn_tag"].shape[0], jplan["bm_pad_tag"].shape[0]
            blk, col = np.nonzero(jplan["bm_maskf"] > 0)
            base = jplan["bm_win"][blk].astype(np.int64) * wn
            np.testing.assert_array_equal(plan["own"],
                                          base + jplan["bm_own"][blk, col])
            np.testing.assert_array_equal(
                plan["oth"], base + jplan["bm_oth"][blk, col] - pad)
