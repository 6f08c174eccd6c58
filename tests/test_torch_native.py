"""The port's host library (yolat_tpu_torch.geom._native over
yolat_tpu_torch/csrc/geomcore.cpp) against the JAX package's binding and
against the port's own numpy paths.

The source is a byte-for-byte copy of csrc/geomcore.cpp built with the same
flags on the same host, so every wrapper is bit-equal to the JAX
package's on the inputs tests/test_native.py builds. The port's loads and
CompactFiles through the library equal its numpy paths
(`_native.disabled()`): integers exactly, floats within the tolerance the
JAX package holds its own native-vs-numpy loads to (rtol 1e-9, atol
1e-8; the angle statistics' std is a one-pass variance in C++), the
CompactFiles byte for byte. A failed build raises, and the library is
built under build/, never beside its source.
"""

import filecmp
import importlib
import os

import numpy as np
import pytest

import yolat_tpu.geom._native as jax_native
from tests.test_torch_host import _assert_tree_close
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.geom import graph_build as jax_gb
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.packing import CompactFile
from yolat_tpu_torch.geom import _native
from yolat_tpu_torch.geom import graph_build as gb
from yolat_tpu_torch.geom import proposals as pr

# the packages' geom/__init__ export a function of the same name
jax_sc = importlib.import_module("yolat_tpu.geom.split_cross")
sc = importlib.import_module("yolat_tpu_torch.geom.split_cross")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_lib():
    lib = jax_native.load_library()
    assert lib is not None, "the JAX package's native build failed"
    return lib


def _assert_identical(got, want, path=""):
    """Same structure, dtypes and bits."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_identical(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_identical(a, b, f"{path}[{i}]")
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_source_is_a_copy():
    assert filecmp.cmp(os.path.join(REPO, "csrc", "geomcore.cpp"),
                       _native.SOURCE, shallow=False)


def test_library_is_built_under_build():
    _native.load_library()
    so = _native.library_path()
    assert os.path.exists(so)
    assert os.path.commonpath([so, os.path.join(REPO, "build")]) == \
        os.path.join(REPO, "build")
    csrc = os.path.dirname(_native.SOURCE)
    assert not [n for n in os.listdir(csrc) if n.endswith(".so")]


def test_broken_compiler_raises(tmp_path, monkeypatch, synthetic_root):
    """A failed build raises with the compiler's output; nothing falls back
    to the numpy paths."""
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "CXX_FLAGS",
                        _native.CXX_FLAGS + ("-fno-such-option",))
    with pytest.raises(RuntimeError, match="no-such-option"):
        _native.load_library()
    ds = SESYDDataset(synthetic_root, "train", cache=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ds.load(0)
    assert not any(n.endswith(".so") for _, _, fs in os.walk(tmp_path)
                   for n in fs)
    monkeypatch.setattr(_native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        _native.load_library()
    # the numpy oracle still runs where it is asked for
    with _native.disabled():
        assert ds.load(0)[0].n_proposals > 0


# ---- each wrapper against the JAX package's, on test_native.py's inputs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_angle_stats_matches_jax(jax_lib, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 30))
    e = int(rng.integers(2, 60))
    pos = rng.uniform(0, 1, size=(n, 2))
    edges = rng.integers(0, n, size=(e, 2)).astype(np.int64)
    edges = edges[edges[:, 0] != edges[:, 1]]
    for ed, p in ((edges, pos),
                  (np.array([[0, 1]], np.int64), pos[:2]),
                  (np.array([[0, 1], [0, 1], [0, 2]], np.int64), pos[:3])):
        _assert_identical(_native.angle_stats_native(ed, p, pr.ANGLE_TH),
                          jax_native.angle_stats_native(ed, p, pr.ANGLE_TH))


def _random_graph(rng, n_ccs=4, degenerate=False):
    """tests/test_native.py's multi-CC graph, zero-extent CCs optional."""
    pos, edges, ctrl = [], [], []
    base = 0
    for c in range(n_ccs):
        k = int(rng.integers(3, 9))
        center = rng.uniform(0.1, 0.9, 2)
        scale = rng.uniform(0.02, 0.3)
        pts = center + scale * rng.uniform(-1, 1, (k, 2))
        if degenerate and c % 3 == 1:
            pts[:, 0] = pts[0, 0]
        if degenerate and c % 3 == 2:
            pts[:, 1] = pts[0, 1]
        pos.append(pts)
        for i in range(k - 1):
            edges.append([base + i, base + i + 1])
        is_c = np.zeros(k, dtype=np.float64)
        if k > 4:
            is_c[rng.integers(1, k - 1)] = 1.0
        ctrl.append(is_c)
        base += k
    return {
        "pos": np.concatenate(pos, axis=0),
        "edge": {"shape": np.asarray(edges, dtype=np.int64)},
        "attr": {"is_control": np.concatenate(ctrl).reshape(-1, 1)},
    }


@pytest.mark.parametrize("seed", range(8))
def test_merge_cc_matches_jax_and_numpy(jax_lib, seed):
    rng = np.random.default_rng(seed)
    g = _random_graph(rng, n_ccs=3 + seed % 4, degenerate=seed % 2 == 1)
    args = (g["pos"], g["edge"]["shape"],
            np.asarray(g["attr"]["is_control"]).reshape(-1) > 0.5,
            gb.CONTAIN_TH)
    got = _native.merge_cc_native(*args)
    _assert_identical(got, jax_native.merge_cc_native(*args))
    with _native.disabled():
        assert _native.merge_cc_native(*args) is None
        want = gb.merge_connected_components(g)
    _assert_identical(want, jax_gb._merge_connected_components_py(g))
    for k in ("shape_shape_edges", "cross_shape_edges", "shape_shape_attr",
              "cross_attr"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["cc"] == want["cc"]


def _sweep_inputs(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(4, 40))
    pts = rng.uniform(0, 1, (n, 2))
    if seed % 3 == 0:  # duplicated coordinate values stress the walks
        pts[:, 0] = np.round(pts[:, 0] * 7) / 7
        pts[:, 1] = np.round(pts[:, 1] * 5) / 5
    return pts, [1, 3, 10][seed % 3]


@pytest.mark.parametrize("seed", range(6))
def test_sweep_rects_matches_jax_and_numpy(jax_lib, seed):
    pts, step = _sweep_inputs(seed)
    xv, yv = np.unique(pts[:, 0]), np.unique(pts[:, 1])
    xg = pr._grid_boundaries(xv[0], xv[-1], step)
    yg = pr._grid_boundaries(yv[0], yv[-1], step)
    got = _native.sweep_rects_native(xv, yv, xg, yg)
    _assert_identical(got, jax_native.sweep_rects_native(xv, yv, xg, yg))
    swept = pr._sweep_rects(pts, step)
    with _native.disabled():
        want = pr._sweep_rects(pts, step)
    _assert_identical(swept, want)
    np.testing.assert_array_equal(got, want[2])


@pytest.mark.parametrize("seed", range(6))
def test_rect_sets_and_cores_match_jax_and_numpy(jax_lib, seed):
    """enumerate_rect_sets and build_rect_proposals on one CC of the sweep
    inputs, with a chain of shape edges and a clique of super edges."""
    pts, step = _sweep_inputs(seed)
    n = len(pts)
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    ii, jj = np.triu_indices(n, k=1)
    supers = np.stack([ii, jj], axis=1)
    xi, yi, rects = pr._sweep_rects(pts, step)
    _assert_identical(_native.enumerate_rect_sets_native(xi, yi, rects),
                      jax_native.enumerate_rect_sets_native(xi, yi, rects))
    _assert_identical(
        _native.build_rect_proposals_native(xi, yi, rects, edges, supers),
        jax_native.build_rect_proposals_native(xi, yi, rects, edges, supers))
    sets = pr._enumerate_subclusters(pts, step)
    cores = pr._cc_proposal_cores(pts, step, edges, supers)
    with _native.disabled():
        _assert_identical(sets, pr._enumerate_subclusters(pts, step))
        _assert_identical(cores, pr._cc_proposal_cores(pts, step, edges,
                                                       supers))
    assert _native.enumerate_rect_sets_native(xi, yi, rects[:0]) is None


@pytest.mark.parametrize("seed", range(20))
def test_split_lines_matches_jax_and_numpy(jax_lib, seed):
    rng = np.random.default_rng(300 + seed)
    n_l = int(rng.integers(2, 30))
    lines = rng.integers(0, 80, (n_l, 4)).astype(np.float64)
    if seed % 2:
        lines[::3, 2] = lines[::3, 0]  # vertical lines
    if seed % 3 == 0 and n_l > 2:
        lines[1] = lines[0]
    pts = lines.reshape(-1, 2)
    extra = pts[: max(1, len(pts) // 3)] + rng.normal(0, 2.0, 1)
    pts = np.concatenate([pts, extra], axis=0)
    got = _native.split_lines_native(lines, pts, sc.LINE_TH, sc.MERGE_TH)
    _assert_identical(got, jax_native.split_lines_native(
        lines, pts, jax_sc.LINE_TH, jax_sc.MERGE_TH))
    np.testing.assert_array_equal(sc.split_line(pts, lines), got)
    with _native.disabled():
        want = sc.split_line(pts, lines)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("block", [1, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_sort_align_matches_jax(jax_lib, seed, block):
    rng = np.random.default_rng(seed)
    n_old, S = 50, 400
    edge = rng.integers(0, n_old, size=(S, 2)).astype(np.int64)
    attr = rng.normal(size=(S, 6))  # > 4 columns: the first 4 are taken
    old2new = np.cumsum(rng.integers(1, 4, size=n_old)).astype(np.int64)
    n_new = int(old2new[-1]) + 1
    _assert_identical(
        _native.compact_sort_align_native(edge, attr, old2new, block),
        jax_native.compact_sort_align_native(edge, attr, old2new, block))
    _assert_identical(
        _native.compact_sort_align_stats_native(edge, attr, old2new, block,
                                                n_new),
        jax_native.compact_sort_align_stats_native(edge, attr, old2new,
                                                   block, n_new))
    empty = _native.compact_sort_align_native(
        np.zeros((0, 2), np.int64), np.zeros((0, 4)),
        np.arange(5, dtype=np.int64), block)
    assert empty[0].shape == (0, 2) and empty[2].shape == (0,)


def _pipeline_calls(monkeypatch, root):
    """The arguments of every window_pipeline call of one port load."""
    calls = []
    orig = _native.window_pipeline_native

    def spy(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    monkeypatch.setattr(_native, "window_pipeline_native", spy)
    SESYDDataset(root, "train", bbox_sampling_step=5, cache=False).load(0)
    monkeypatch.undo()
    assert calls
    return calls


def test_window_pipeline_matches_jax(jax_lib, synthetic_root, monkeypatch):
    calls = _pipeline_calls(monkeypatch, synthetic_root)
    for a, k in calls:
        want = jax_native.window_pipeline_native(*a, **k)
        _assert_identical(_native.window_pipeline_native(*a, **k), want)
    # the counting retry: undersized buffers, then the exact totals
    a, k = calls[0]
    _assert_identical(
        _native.window_pipeline_native(*a, **k, initial_caps=(8, 8, 8)),
        jax_native.window_pipeline_native(*a, **k))


# ---- the port's loads and CompactFiles: library against numpy paths


@pytest.mark.parametrize("partition", ["train", "test"])
def test_load_and_compact_file_native_vs_numpy(synthetic_root, partition):
    ds = SESYDDataset(synthetic_root, partition, bbox_sampling_step=10,
                      cache=False)
    _native.reset_counts()
    native = [ds.load(i) for i in range(len(ds))]
    files = {sf: [CompactFile(f, n_classes=ds.n_classes, super_family=sf)
                  for f, _, _ in native] for sf in (False, True)}
    used = dict(_native.native_calls)
    for e in ("merge_cc", "split_lines", "sweep_rects", "window_pipeline",
              "compact_sort_align_stats"):
        assert used[e] > 0, used
    assert sum(_native.numpy_cases.values()) == 0
    with _native.disabled():
        oracle = [ds.load(i) for i in range(len(ds))]
        ofiles = {sf: [CompactFile(f, n_classes=ds.n_classes,
                                   super_family=sf) for f, _, _ in oracle]
                  for sf in (False, True)}
    assert _native.native_calls == used  # nothing native under disabled()
    for (pf, gt, wh), (opf, ogt, owh) in zip(native, oracle):
        assert pf.n_proposals == opf.n_proposals > 0
        _assert_tree_close(pf.to_dict(), opf.to_dict())
        _assert_tree_close(list(gt), list(ogt))
        assert wh == owh
    for sf in (False, True):
        for cf, ocf in zip(files[sf], ofiles[sf]):
            for k in CompactFile.__slots__:
                if k != "_dense":
                    _assert_identical(getattr(cf, k), getattr(ocf, k), k)


@pytest.mark.parametrize("partition", ["train", "test"])
def test_native_load_matches_jax(jax_lib, synthetic_root, partition):
    ds = SESYDDataset(synthetic_root, partition, bbox_sampling_step=5,
                      cache=False)
    jds = JaxDataset(synthetic_root, partition, bbox_sampling_step=5,
                     cache=False)
    for i in range(len(ds)):
        (pf, gt, wh), (jpf, jgt, jwh) = ds.load(i), jds.load(i)
        _assert_tree_close(pf.to_dict(), jpf.to_dict())
        _assert_tree_close(list(gt), list(jgt))
        assert wh == jwh
