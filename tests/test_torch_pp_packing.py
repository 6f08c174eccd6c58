"""The super-edge family of the port's packing against yolat_tpu's.

Every key `pack_files(super_family=True)` adds (the clique family, its
counts, the factored primitive level's fields, the aligned `sup_pool_*`
plan) is bitwise equal to `yolat_tpu.data.packing.pack_files` on the same
files; a batch packed without the option keeps the keys and bytes it had.
The banded plans have another layout than the TPU's (flat real edges sorted
by the summed-at endpoint, absolute rows, per-node offsets, node cuts for
the thread blocks): they are held to their definition, to the real edges of
the JAX plan read back from its block layout, and they exist where
`banded_plan` of the JAX package returns None.

Both host stages run their numpy paths (the JAX package's native helper is
switched off, caches are off).
"""

import numpy as np
import pytest
import torch

import yolat_tpu.geom._native as jax_native
from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.packing import CompactFile as JaxCompactFile
from yolat_tpu.data.packing import _aligned_super_count as jax_aligned_count
from yolat_tpu.data.toy import random_packed_batch
from yolat_tpu.ops.banded_message import banded_plan as jax_banded_plan
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader, extra_plans_for
from yolat_tpu_torch.data.packing import (CompactFile, aligned_super_count,
                                          to_device)
from yolat_tpu_torch.ops.plans import (EW_BATCH_KEYS, SEW_KEYS, SUPER_BLOCK,
                                       banded_plan, bm_of, sup_plan_of)

SUPER_KEYS = ("edge_super", "e_attr_super", "super_mask", "src_count",
              "super_dst_count", "sup_member", "sup_rank", "sup_abar",
              "prop_first_row", "sup_pool_blk_first", "sup_pool_blk_full",
              "sup_pool_bnd_rows", "sup_pool_bnd_seg", "sup_pool_bnd_mask")


@pytest.fixture
def numpy_host_stage(monkeypatch):
    """The JAX package's host stage on its numpy paths."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)


def _assert_same(got: dict, want: dict, keys):
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _check_plan(plan, edge, mask, attr, n, sortby=1):
    """The plan holds exactly the real edges, stably sorted by `sortby`,
    with per-node offsets and node cuts that cover [0, n) in order."""
    idx = np.nonzero(mask)[0]
    order = idx[np.argsort(edge[idx, sortby], kind="stable")]
    np.testing.assert_array_equal(plan["own"], edge[order, sortby])
    np.testing.assert_array_equal(plan["oth"], edge[order, 1 - sortby])
    np.testing.assert_array_equal(plan["attr"], attr[order])
    assert plan["own"].dtype == plan["oth"].dtype == np.int32
    assert plan["nptr"].dtype == plan["cnode"].dtype == np.int32
    np.testing.assert_array_equal(
        np.diff(plan["nptr"]), np.bincount(edge[order, sortby], minlength=n))
    cn = plan["cnode"]
    assert cn[0] == 0 and cn[-1] == n and (np.diff(cn) > 0).all()


@pytest.mark.parametrize("partition", ["train", "test"])
def test_super_family_matches_jax(synthetic_root, numpy_host_stage, partition):
    ds = SESYDDataset(synthetic_root, partition, bbox_sampling_step=10,
                      cache=False)
    jds = JaxDataset(synthetic_root, partition, bbox_sampling_step=10,
                     cache=False)
    opts = extra_plans_for(Config(arch="yolat_pp"))
    assert opts == {"super_family": True, "ew_transpose": True}
    assert extra_plans_for(Config()) == {}
    loader = PackedLoader(ds, batch_size=4, prefetch=0, **opts)
    jax_loader = JaxLoader(jds, batch_size=4, shuffle=False, prefetch=0)
    assert loader.pad.n_super == jax_loader.pad.n_super > 0
    got = list(loader)
    want = [{k: v[0] for k, v in b.items()} for b in jax_loader]
    assert len(got) == len(want) == 1
    b, w = got[0], want[0]
    assert b["super_mask"].sum() > 100
    # every key but the two plans in the CUDA kernels' layout
    keys = [k for k in b if k not in EW_BATCH_KEYS + SEW_KEYS]
    assert set(SUPER_KEYS) <= set(keys)
    _assert_same(b, w, keys)
    assert sup_plan_of(b) is not None and b["sup_pool_bnd_rows"].shape == (0,)
    # pad rows: src = dst, zero attributes, not counted
    pad_rows = ~b["super_mask"]
    assert (b["edge_super"][pad_rows, 0] == b["edge_super"][pad_rows, 1]).all()
    assert not b["e_attr_super"][pad_rows].any()
    np.testing.assert_array_equal(
        b["super_dst_count"],
        np.bincount(b["edge_super"][b["super_mask"], 1],
                    minlength=b["pos"].shape[0]).astype(np.float32))
    # the sew_ plan: the real super edges in stable dst order
    n = b["pos"].shape[0]
    _check_plan({k[4:]: b[k] for k in SEW_KEYS}, b["edge_super"],
                b["super_mask"], b["e_attr_super"], n)
    tb = to_device(b, "cpu")
    sew, cwd, cws = (bm_of(tb, p) for p in ("sew_", "cwd_", "cws_"))
    assert sew.n_edges == int(b["super_mask"].sum())
    assert cwd.n_edges == cws.n_edges == int(b["edge_mask"].sum())
    # the curve family's two plans are views of the edge-window plan
    assert cwd.own is tb["ew_dst"] and cws.own is tb["ew_src"]
    own, oth, attr = cws.rows()
    assert (own[1:] >= own[:-1]).all()
    real = b["edge"][b["edge_mask"]]
    order = np.argsort(real[:, 0], kind="stable")
    np.testing.assert_array_equal(own.numpy(), real[order, 0])
    np.testing.assert_array_equal(oth.numpy(), real[order, 1])
    np.testing.assert_array_equal(attr.numpy(),
                                  b["e_attr"][b["edge_mask"]][order])
    # stale plans: a batch padded again after packing
    grown = {**tb, "pos": torch.zeros(n + 512, 2)}
    assert all(bm_of(grown, p) is None for p in ("sew_", "cwd_", "cws_"))
    with pytest.raises(ValueError, match="family"):
        bm_of(tb, "xyz_")


def test_canonical_batch_is_unchanged(synthetic_root):
    """Without the option a batch has the keys it had, and the shared keys
    do not depend on the option."""
    ds = SESYDDataset(synthetic_root, "test", bbox_sampling_step=10)
    plain = next(iter(PackedLoader(ds, batch_size=2, prefetch=0)))
    full = next(iter(PackedLoader(ds, batch_size=2, prefetch=0,
                                  super_family=True)))
    assert not set(plain) & (set(SUPER_KEYS) | set(SEW_KEYS))
    assert set(full) - set(plain) == set(SUPER_KEYS) | set(SEW_KEYS)
    _assert_same(full, plain, list(plain))
    assert bm_of(to_device(plain, "cpu"), "sew_") is None
    assert sup_plan_of(plain) is None


def test_compact_file_fields_match_jax(synthetic_root, numpy_host_stage):
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10,
                      cache=False)
    jds = JaxDataset(synthetic_root, "train", bbox_sampling_step=10,
                     cache=False)
    f, _, _ = ds.load(0)
    jf, _, _ = jds.load(0)
    got = CompactFile(f, n_classes=ds.n_classes, super_family=True)
    want = JaxCompactFile(jf, n_classes=ds.n_classes)
    for name in ("edge_super", "e_attr_super", "super_valid", "src_count",
                 "super_dst_count", "sup_member", "sup_rank", "sup_abar",
                 "prop_first"):
        _assert_same({name: getattr(got, name)}, {name: getattr(want, name)},
                     [name])
    assert len(got.edge_super) % SUPER_BLOCK == 0
    assert aligned_super_count(f) == aligned_super_count(got) \
        == jax_aligned_count(jf) == len(got.edge_super)
    bare = CompactFile(f, n_classes=ds.n_classes)
    assert bare.edge_super is None and bare.src_count is None


def _jax_plan_rows(plan):
    """(own, oth) absolute rows of the real edges of a JAX banded plan, in
    block order."""
    wn, pad = plan["bm_wn_tag"].shape[0], plan["bm_pad_tag"].shape[0]
    blk, col = np.nonzero(plan["bm_maskf"] > 0)
    base = plan["bm_win"][blk].astype(np.int64) * wn
    return (base + plan["bm_own"][blk, col],
            base + plan["bm_oth"][blk, col] - pad)


@pytest.mark.parametrize("sortby", [1, 0])
def test_banded_plan_holds_the_jax_plan_edges(sortby):
    batch, _ = random_packed_batch(seed=11, n_images=16)
    n = batch["pos"].shape[0]
    fam = (batch["edge_super"], batch["super_mask"], batch["e_attr_super"])
    got = banded_plan(*fam, n, sortby=sortby)
    _check_plan(got, *fam, n, sortby=sortby)
    want = jax_banded_plan(*fam, n, sortby=sortby, wn=128, pad=64, eblk=128)
    assert want is not None
    own, oth = _jax_plan_rows(want)
    np.testing.assert_array_equal(got["own"], own)
    np.testing.assert_array_equal(got["oth"], oth)


@pytest.mark.parametrize("case", ["band", "odd_n", "empty", "skewed"])
def test_banded_plan_exists_where_the_jax_plan_gives_up(case):
    rng = np.random.default_rng(3)
    n = 2048
    if case == "band":  # an edge across the whole batch
        edge = np.array([[0, 2047], [2047, 0], [5, 6]], np.int32)
    elif case == "skewed":  # one node with more edges than a block's share
        edge = np.stack([rng.integers(0, n, 3000),
                         np.where(rng.random(3000) < 0.7, 77,
                                  rng.integers(0, n, 3000))], 1).astype(np.int32)
    else:
        edge = rng.integers(0, 1000, (64, 2)).astype(np.int32)
    mask = np.ones(len(edge), bool)
    if case == "empty":
        mask[:] = False
    if case == "odd_n":
        n = 2051
    attr = rng.normal(size=(len(edge), 4)).astype(np.float32)
    want = jax_banded_plan(edge, mask, attr, n, wn=512, pad=128)
    assert (want is None) == (case in ("band", "odd_n", "skewed"))
    got = banded_plan(edge, mask, attr, n)
    _check_plan(got, edge, mask, attr, n)
    if case == "empty":
        assert got["own"].shape == (0,) and not got["nptr"].any()
    if case == "skewed":
        # ranges never split a node: the heavy node's range ends with it
        # and holds less than one more block's share beside it
        cn = got["cnode"]
        assert 78 in cn
        per_block = np.diff(got["nptr"][cn])
        heavy = np.diff(got["nptr"])[77]
        assert heavy > 512 and heavy <= per_block.max() < heavy + 512
        assert np.median(per_block) < 512
    with pytest.raises(ValueError, match="outside"):
        banded_plan(np.array([[0, n]], np.int32), np.ones(1, bool),
                    attr[:1], n)
