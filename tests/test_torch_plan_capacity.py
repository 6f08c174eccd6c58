"""Plans at capacity (`ops.plans.pad_plans`) on the CPU: every batch of a
loader gets one shape signature, the pad rows are inert by construction,
and the plain routes of kernels 1, 5, 6 and 7-10 give bit-identical
outputs and gradients on a padded plan and on the unpadded one (a per-row
output is compared on the real rows; the pad rows' gradients are 0).
BatchNorm over a mask of all real rows is bit-identical to BatchNorm with
no mask, forward and backward, so an unpadded batch trains as before.
This file imports no jax.
"""

import numpy as np
import pytest
import torch

from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import (PackedLoader, extra_plans_for,
                                         train_plans_for)
from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.data.staging import batch_signature
from yolat_tpu_torch.nn.layers import MaskedBatchNorm
from yolat_tpu_torch.ops import banded_train as bt
from yolat_tpu_torch.ops.banded_message import (banded_message_sum,
                                                banded_message_sum_both)
from yolat_tpu_torch.ops.edge_window import edge_window_message_sum
from yolat_tpu_torch.ops.edge_window_train import (ew_pair_features,
                                                   ew_window_segment_sum_n)
from yolat_tpu_torch.ops.plans import (bm_of, ew_of, ew_train_of, pad_plans,
                                       real_rows, sew_cnode_cap)

H = 64


@pytest.fixture(scope="module")
def packed(synthetic_root):
    """Batches of one image each, with every plan: the serving loader's
    (ew_ with its transpose, sew_ own) and the banded train loader's with
    the window layout's (both with their transposes)."""
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    pp = Config(arch="yolat_pp", n_classes=ds.n_classes)
    serve = list(PackedLoader(ds, batch_size=1, prefetch=0,
                              **extra_plans_for(pp)))
    train = list(PackedLoader(ds, batch_size=1, prefetch=0, ew_transpose=True,
                              **train_plans_for(
                                  pp.replace(pp_banded_super=True))))
    return serve, train


def test_one_signature_per_loader(packed):
    for batches in packed:
        sigs = {batch_signature(b) for b in batches}
        assert len(sigs) == len(batches) > 1  # content-shaped plans
        padded = [pad_plans(b) for b in batches]
        assert len({batch_signature(b) for b in padded}) == 1
        for b in padded:  # idempotent
            assert batch_signature(pad_plans(b)) == batch_signature(b)


def test_pad_rows_are_inert(packed):
    for b in packed[0] + packed[1]:
        p = pad_plans(b)
        n = b["pos"].shape[0]
        e, cap = b["ew_src"].shape[0], b["edge"].shape[0]
        assert p["ew_src"].shape[0] == cap > e
        for k in ("ew_src", "ew_dst"):
            np.testing.assert_array_equal(p[k][:e], b[k])
            assert (p[k][e:] == n - 1).all()
        assert not p["ew_attr"][e:].any()
        if "ew_sperm" in b:
            np.testing.assert_array_equal(p["ew_sperm"][e:],
                                          np.arange(e, cap))
        for k in ("ew_wptr", "ew_dptr", "ew_sptr"):  # pointers unchanged
            if k in b:
                np.testing.assert_array_equal(p[k], b[k])
                assert p[k][-1] == e
        s, scap = b["sew_own"].shape[0], b["edge_super"].shape[0]
        assert p["sew_own"].shape[0] == scap > s
        assert (p["sew_own"][s:] == n - 1).all() and not p["sew_attr"][s:].any()
        assert b["sew_nptr"][-1] == s
        cn = p["sew_cnode"]
        assert cn.shape[0] == sew_cnode_cap(scap, n) >= b["sew_cnode"].shape[0]
        assert (cn[b["sew_cnode"].shape[0]:] == n).all()
        if "sew_tperm" in b:
            np.testing.assert_array_equal(p["sew_tperm"][s:],
                                          np.arange(s, scap))


def _params(seed, c, na=4, two=True):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.3):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32))

    sc = torch.from_numpy(np.stack([rng.uniform(0.5, 1.5, H),
                                    rng.normal(size=H) * 0.1])
                          .astype(np.float32))
    return t(c, H), t(c, H), t(na, H), sc, (t(H, H) if two else None), sc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_kernels_plain_routes_bit_identical(packed, dtype):
    """Kernels 1, 5 (the sew_ plan) and 6 (the ew_ plan with its
    transpose) on a padded and an unpadded plan."""
    for b in packed[0]:
        pads = to_device(pad_plans(b), "cpu")
        bb = to_device(b, "cpu")
        n, c = b["pos"].shape[0], 8
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(n, c)).astype(np.float32)).to(dtype)
        wo, wh, wa, sc1, w2, sc2 = _params(1, c)
        w1 = torch.cat([wo, wh, wa])
        got = edge_window_message_sum(x, ew_of(pads), w1, sc1, w2, sc2)
        want = edge_window_message_sum(x, ew_of(bb), w1, sc1, w2, sc2)
        assert torch.equal(got, want)
        got = banded_message_sum(x, bm_of(pads, "sew_"), wo, wh, wa, sc1, w2,
                                 sc2)
        want = banded_message_sum(x, bm_of(bb, "sew_"), wo, wh, wa, sc1, w2,
                                  sc2)
        assert torch.equal(got, want)
        for prefix in ("cwd_", "cws_"):
            got = banded_message_sum_both(x, bm_of(pads, prefix), wo, wh, wa,
                                          sc1)
            want = banded_message_sum_both(x, bm_of(bb, prefix), wo, wh, wa,
                                           sc1)
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def _run(ops, x, plan, rows_of):
    """Forward through the op pair, a fixed cotangent of the real rows ->
    (per-row output on the real rows, summed output, d x, d rows)."""
    x = x.clone().requires_grad_(True)
    rows, total = ops(x, plan)
    e = rows_of(plan)
    rows.retain_grad()
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=tuple(total.shape)).astype(np.float32))
    (total * g).sum().backward()
    return rows[:e].detach(), total.detach(), x.grad, rows.grad


def test_train_ops_plain_routes_bit_identical(packed):
    """Kernels 9 and 10 (window layout) and 7 and 8 (banded route) with
    their backward (9b, 10b, 7b, 8b): forward and gradients equal on a
    padded and an unpadded plan; the pad rows get no gradient."""
    def window(x, ewt):
        g = ew_pair_features(x, ewt)
        return g, ew_window_segment_sum_n(g * 1.5, ewt, x.shape[0])

    def banded(x, bm):
        own, oth = bt.banded_gather(x, bm)
        rows = torch.cat([own, oth - own], dim=1)
        return rows, bt.banded_scatter_own(rows * 1.5, bm, x.shape[0])

    for b in packed[1]:
        pads = to_device(pad_plans(b), "cpu")
        bb = to_device(b, "cpu")
        n = b["pos"].shape[0]
        x = torch.from_numpy(np.random.default_rng(2).normal(
            size=(n, 8)).astype(np.float32))
        for ops, of, rows_of in (
                (window, ew_train_of, lambda p: int(p[2][-1])),
                (banded, lambda t: bm_of(t, "sew_"),
                 lambda p: int(p.nptr[-1]))):
            got = _run(ops, x, of(pads), rows_of)
            want = _run(ops, x, of(bb), rows_of)
            for gv, wv in zip(got[:3], want[:3]):
                assert torch.equal(gv, wv)
            e = want[3].shape[0]
            assert torch.equal(got[3][:e], want[3])
            assert not got[3][e:].any() and got[3].shape[0] > e


def test_masked_batchnorm_with_all_rows_is_unmasked():
    """The window layout and the banded route now pass BatchNorm the real
    rows' mask: with no padding it is all True, and the statistics, the
    output and the gradient are bit-identical to the unmasked ones."""
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1000, 16)).astype(np.float32))
    out = []
    for mask in (None, torch.ones(1000, dtype=torch.bool)):
        bn = MaskedBatchNorm(16).train()
        xi = x.clone().requires_grad_(True)
        y = bn(xi, mask)
        (y * torch.linspace(-1, 1, 16)).sum().backward()
        out.append((y.detach(), xi.grad, bn.running_mean.clone(),
                    bn.running_var.clone()))
    assert all(torch.equal(a, b) for a, b in zip(*out))
    ptr = torch.tensor([0, 3, 7], dtype=torch.int32)
    assert real_rows(ptr, 10).tolist() == [True] * 7 + [False] * 3
