"""Port packing (yolat_tpu_torch.ops.plans, .data.packing, .data.loader)
against yolat_tpu's.

The pool plan and every batch key the canonical serving path reads are
bitwise equal. The edge-window plan has another layout (the CUDA kernel's:
a flat dst-sorted list of the real edges with window offsets, where the
TPU's pads windows to a capacity and addresses a 3-window band), so it is
held equal to the JAX plan's real edges read back from the TPU layout,
and it exists for every edge list, where the JAX plan gives up.

Both loaders run their host stage with the numpy paths (the JAX package's
optional native helper is switched off and caches are off), so the
proposal sets, and so the packed batches, are bitwise equal.
"""

import numpy as np
import pytest

import yolat_tpu.geom._native as jax_native
from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.ops.edge_window import edge_window_plan as jax_ew_plan
from yolat_tpu.ops.segment import pool_plan as jax_pool_plan
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.packing import (CompactFile, PadSizes, pack_files,
                                          round_up)
from yolat_tpu_torch.ops.plans import (EW_BATCH_KEYS, edge_window_plan,
                                       ew_of, plan_of, pool_plan)


@pytest.fixture
def numpy_host_stage(monkeypatch):
    """The JAX package's host stage on its numpy paths."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)


def _assert_same(got: dict, want: dict, keys=None):
    for k in keys or got:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("cap", [None, 0])
def test_pool_plan_matches_jax(cap):
    rng = np.random.default_rng(0)
    if cap == 0:  # block-aligned runs
        seg = np.repeat(np.arange(40), rng.integers(1, 5, 40) * 8)
    else:
        seg = np.sort(rng.integers(0, 40, 640))
    n = len(seg) // 8 * 8
    _assert_same(pool_plan(seg[:n], 40, cap=cap),
                 jax_pool_plan(seg[:n], 40, cap=cap))


def _local_graph(seed, n=1024, e=1400, span=30):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    src = np.clip(dst + rng.integers(-span, span + 1, e), 0, n - 1)
    edge = np.stack([src.astype(np.int32), dst], axis=1)
    return edge, rng.random(e) < 0.85, rng.normal(size=(e, 4)).astype(np.float32)


def _jax_plan_edges(plan, n):
    """(src, dst, attr) of the real edges of a JAX (TPU-layout) plan, in
    window-then-slot order."""
    wn = plan["ew_wn_tag"].shape[0]
    nw = n // wn
    k, slot = np.nonzero(plan["ew_maskf"] > 0)
    sr = plan["ew_src_rel"][k, slot]
    band = np.stack([np.maximum(np.arange(nw) - 1, 0), np.arange(nw),
                     np.minimum(np.arange(nw) + 1, nw - 1)], axis=1)
    src = band[k, sr // wn] * wn + sr % wn
    dst = k * wn + plan["ew_dst_loc"][k, slot]
    return src, dst, plan["ew_attr"][k, slot]


def _check_plan(got, edge, mask, attr, n, wn):
    """The plan holds exactly the real edges, stably dst-sorted, with
    window offsets ceil(n / wn) + 1 long."""
    assert set(got) == set(EW_BATCH_KEYS)
    idx = np.nonzero(mask)[0]
    order = idx[np.argsort(edge[idx, 1], kind="stable")]
    np.testing.assert_array_equal(got["ew_src"], edge[order, 0])
    np.testing.assert_array_equal(got["ew_dst"], edge[order, 1])
    np.testing.assert_array_equal(got["ew_attr"], attr[order])
    wptr = got["ew_wptr"]
    assert wptr.shape == (-(-n // wn) + 1,) and wptr[0] == 0
    assert wptr[-1] == len(order)
    for k in range(len(wptr) - 1):
        d = got["ew_dst"][wptr[k]:wptr[k + 1]]
        assert ((d >= k * wn) & (d < (k + 1) * wn)).all()


@pytest.mark.parametrize("case", ["ok", "two_windows", "capacity", "band",
                                  "ragged"])
def test_edge_window_plan_matches_jax(case):
    edge, mask, attr = _local_graph(1)
    n, kw = 1024, dict(wn=128)
    if case == "two_windows":
        kw = dict(wn=512)
    elif case == "capacity":  # more edges into one window than the TPU's EB
        kw = dict(wn=128, eb=8)
    elif case == "band":  # a source three windows away
        r = np.nonzero(mask & (edge[:, 1] >= 768))[0][0]
        edge = edge.copy()
        edge[r, 0] = 0
    elif case == "ragged":  # N not a multiple of the window
        n = 1000
        keep = (edge < n).all(axis=1)
        edge, mask, attr = edge[keep], mask[keep], attr[keep]
    got = edge_window_plan(edge, mask, attr, n, wn=kw["wn"])
    _check_plan(got, edge, mask, attr, n, kw["wn"])
    want = jax_ew_plan(edge, mask, attr, n, **kw)
    # the JAX plan gives up exactly where the TPU layout has its limits
    assert (want is None) == (case in ("capacity", "band", "ragged"))
    if want is not None:
        src, dst, a = _jax_plan_edges(want, n)
        np.testing.assert_array_equal(got["ew_src"], src)
        np.testing.assert_array_equal(got["ew_dst"], dst)
        np.testing.assert_array_equal(got["ew_attr"], a)


@pytest.mark.parametrize("case", ["unsorted", "out_of_range"])
def test_edge_window_plan_sorts_and_checks_edges(case):
    edge, mask, attr = _local_graph(2, n=512, e=900, span=200)
    perm = np.random.default_rng(3).permutation(len(edge))
    edge, mask, attr = edge[perm], mask[perm], attr[perm]
    if case == "out_of_range":
        edge = edge.copy()
        edge[np.nonzero(mask)[0][5], 0] = 512
        with pytest.raises(ValueError, match="outside"):
            edge_window_plan(edge, mask, attr, 512, wn=128)
        return
    # an unsorted list gets the plan of its stable dst sort
    _check_plan(edge_window_plan(edge, mask, attr, 512, wn=128), edge, mask,
                attr, 512, 128)


@pytest.mark.parametrize("partition", ["train", "test"])
def test_pack_files_matches_jax(synthetic_root, numpy_host_stage, partition):
    ds = SESYDDataset(synthetic_root, partition, bbox_sampling_step=10,
                      cache=False)
    jds = JaxDataset(synthetic_root, partition, bbox_sampling_step=10,
                     cache=False)
    loader = PackedLoader(ds, batch_size=4, prefetch=0)
    jax_loader = JaxLoader(jds, batch_size=4, shuffle=False, prefetch=0)
    assert (loader.pad.n_nodes, loader.pad.n_edges, loader.pad.n_proposals,
            loader.pad.n_gt) == (jax_loader.pad.n_nodes,
                                 jax_loader.pad.n_edges,
                                 jax_loader.pad.n_proposals,
                                 jax_loader.pad.n_gt)
    got = list(loader)
    want = [{k: v[0] for k, v in b.items()} for b in jax_loader]
    assert len(got) == len(want) == 1
    b, w = got[0], want[0]
    assert ew_of(b) is not None and plan_of(b) is not None
    assert b["pool_bnd_rows"].shape == (0,)
    # every other key the port emits, the pool plan included, equals
    # yolat_tpu's; the edge-window plan holds the JAX plan's edges
    _assert_same(b, w, [k for k in b if k not in EW_BATCH_KEYS])
    n = b["pos"].shape[0]
    plan = {k: w[k] for k in w if k.startswith("ew_")}
    src, dst, a = _jax_plan_edges(plan, n)
    np.testing.assert_array_equal(b["ew_src"], src)
    np.testing.assert_array_equal(b["ew_dst"], dst)
    np.testing.assert_array_equal(b["ew_attr"], a)


def test_pack_files_small_pad_and_no_window(synthetic_root):
    ds = SESYDDataset(synthetic_root, "test", bbox_sampling_step=10,
                      cache=False)
    f, gt, wh = ds.load(0)
    cf = CompactFile(f)
    pad = PadSizes(round_up(len(cf.pos), 512), round_up(len(cf.edge), 512),
                   round_up(cf.n_proposals, 64), round_up(len(gt[0]), 16), 1)
    b = pack_files([cf], [gt], [wh], pad, edge_window=False)
    assert ew_of(b) is None and plan_of(b) is not None
    # node runs are 8-aligned, edges dst-sorted with padding at the front
    assert len(cf.pos) % 8 == 0
    dst = b["edge"][:, 1]
    assert (np.diff(dst[b["edge_mask"]]) >= 0).all()
    assert not b["edge_mask"][: pad.n_edges - len(cf.edge)].any()
    small = PadSizes(pad.n_nodes - 512, pad.n_edges, pad.n_proposals,
                     pad.n_gt, 1)
    with pytest.raises(ValueError):
        pack_files([cf], [gt], [wh], small)
