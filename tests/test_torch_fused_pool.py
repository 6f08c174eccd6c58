"""The fused training pool head on the CPU: the port's plain routes
against yolat_tpu's Pallas kernels in interpret mode, mirroring
tests/test_fused_pool_train.py (n = 1024, Cin 128, H 256, with and without
a fully masked proposal).

Inputs are made with numpy from a seed and given to both packages.
Tolerances:
  * block max (kernel 3's plain version vs the Pallas kernel): the same
    f32 product with sums in another order — rtol/atol 1e-5.
  * FusedPoolTrain vs JAX fused_pool_train: stats rtol 1e-5 (the same
    Gram moments); pooled rtol/atol 2e-4 and the five gradients rtol 2e-3
    with an absolute floor of 2e-3 of the gradient's scale — the JAX
    test's own tolerances (the closed-form BN algebra amplifies summation
    noise; db is structurally zero, held against the floor 1e-4).
  * fused route vs the port's unfused composition (Linear -> masked BN
    -> ReLU -> segment max, torch autograd): the same tolerances.
  * bf16: the gradient through the winner masks agrees in direction
    (cosine > 0.98) and size (norm ratio in 0.8-1.25) with the bf16
    unfused composition — the check that a bf16 winner compare finds
    winners at all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.ops.fused_pool_train import fused_pool_train as jax_fused
from yolat_tpu.ops.pallas_kernels import folded_mlp_block_max as jax_block_max
from yolat_tpu_torch.nn import model as port_model
from yolat_tpu_torch.nn.layers import MLP, FusedPoolFusion
from yolat_tpu_torch.ops.block_max import folded_mlp_block_max_plain
from yolat_tpu_torch.ops.fused_pool_train import (fused_pool_available,
                                                  fused_pool_train)
from yolat_tpu_torch.ops.plans import pool_plan
from yolat_tpu_torch.ops.segment import segment_max

NAMES = ("x", "w", "b", "gamma", "beta")


def _setup(seed=0, n=1024, ci=128, h=256, empty_last=False):
    rng = np.random.default_rng(seed)
    lens, left = [], n
    while left > 0:
        take = min(int(rng.integers(1, 7)) * 8, left)
        lens.append(take)
        left -= take
    seg = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    n_prop = len(lens)
    mask = rng.random(n) > 0.15
    if empty_last:
        mask[seg == n_prop - 1] = False
    arrs = dict(
        x=rng.normal(size=(n, ci)).astype(np.float32),
        w=(rng.normal(size=(ci, h)) / np.sqrt(ci)).astype(np.float32),
        b=(rng.normal(size=h) * 0.1).astype(np.float32),
        gamma=(1.0 + 0.2 * rng.normal(size=h)).astype(np.float32),
        beta=(rng.normal(size=h) * 0.1).astype(np.float32))
    cot = rng.normal(size=(n_prop, h)).astype(np.float32)
    plan = pool_plan(seg, n_prop, cap=0)
    return arrs, mask, seg, plan, n_prop, cot


def _port(arrs, mask, plan, n_prop, cot, dtype=torch.float32):
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in arrs.items()}
    maskf = torch.from_numpy(mask.astype(np.float32))[:, None]
    pooled, mean, var, cnt = fused_pool_train(
        leaves["x"].to(dtype), maskf, leaves["w"].to(dtype), leaves["b"],
        leaves["gamma"], leaves["beta"],
        torch.from_numpy(plan["pool_blk_first"]), n_prop)
    (pooled.float() * torch.from_numpy(cot)).sum().backward()
    return pooled, mean, var, cnt, [leaves[k].grad.numpy() for k in NAMES]


def _close_grads(got, want):
    for name, a, w in zip(NAMES, got, want):
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(a, w, rtol=2e-3,
                                   atol=max(2e-3 * scale, 1e-4), err_msg=name)


def test_block_max_plain_matches_pallas():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1024, 128)).astype(np.float32)
    w = (rng.normal(size=(128, 256)) * 0.1).astype(np.float32)
    sc = np.stack([rng.uniform(0.5, 1.5, 256),
                   rng.normal(size=256) * 0.1]).astype(np.float32)
    m = (rng.random(1024) > 0.2).astype(np.float32)[:, None]
    m[:8] = 0.0  # a fully masked block
    want = jax_block_max(jnp.asarray(x), jnp.asarray(m), jnp.asarray(w),
                         jnp.asarray(sc), interpret=True)
    got = folded_mlp_block_max_plain(torch.from_numpy(x), torch.from_numpy(m),
                                     torch.from_numpy(w), torch.from_numpy(sc))
    assert got.shape == (128, 256) and (got[0] <= -1e30 / 2).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("empty_last", [False, True])
def test_fused_head_matches_jax(empty_last):
    arrs, mask, seg, plan, n_prop, cot = _setup(seed=7, empty_last=empty_last)
    blk_first = jnp.asarray(plan["pool_blk_first"])
    maskf = jnp.asarray(mask.astype(np.float32))[:, None]

    def loss(x, w, b, gamma, beta):
        out = jax_fused(x, maskf, w, b, gamma, beta, blk_first, n_prop, True)
        return jnp.sum(out[0] * cot), out

    (_, (wp, wmean, wvar, wcnt)), wg = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *[jnp.asarray(arrs[k]) for k in NAMES])
    pooled, mean, var, cnt, grads = _port(arrs, mask, plan, n_prop, cot)
    np.testing.assert_allclose(mean.numpy(), np.asarray(wmean), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(wvar), rtol=1e-5,
                               atol=1e-5)
    assert float(cnt) == float(wcnt) == mask.sum()
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(wp),
                               rtol=2e-4, atol=2e-4)
    if empty_last:
        assert (pooled[-1] == 0).all()
    _close_grads(grads, [np.asarray(g) for g in wg])


def _unfused(arrs, mask, seg, n_prop, cot, dtype=torch.float32):
    """Linear -> masked train-mode BN -> ReLU -> segment max, on the
    port's own modules (torch autograd, compare-form max backward)."""
    mlp = MLP([arrs["x"].shape[1], arrs["w"].shape[1]]).train()
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in arrs.items()}
    params = {"0.weight": leaves["w"].t(), "0.bias": leaves["b"],
              "1.weight": leaves["gamma"], "1.bias": leaves["beta"]}
    tm = torch.from_numpy(mask)
    xm = leaves["x"].to(dtype) * tm[:, None].to(dtype)
    p = {k: (v.to(dtype) if k.startswith("0.") else v)
         for k, v in params.items()}
    a = torch.func.functional_call(mlp, p, (xm, tm))
    pooled = segment_max(a, torch.from_numpy(seg), n_prop, mask=tm)
    (pooled.float() * torch.from_numpy(cot)).sum().backward()
    return pooled, mlp, [leaves[k].grad.numpy() for k in NAMES]


@pytest.mark.parametrize("empty_last", [False, True])
def test_fused_route_matches_unfused_composition(empty_last):
    arrs, mask, seg, plan, n_prop, cot = _setup(seed=3, empty_last=empty_last)
    pooled, mean, var, _, grads = _port(arrs, mask, plan, n_prop, cot)
    want, mlp, wgrads = _unfused(arrs, mask, seg, n_prop, cot)
    np.testing.assert_allclose(pooled.detach().numpy(),
                               want.detach().numpy(), rtol=2e-4, atol=2e-4)
    _close_grads(grads, wgrads)
    # the BN running statistics move the same way through both routes
    fused = FusedPoolFusion(arrs["x"].shape[1], arrs["w"].shape[1]).train()
    assert set(fused.state_dict()) == set(mlp.state_dict())
    with torch.no_grad():
        fused[0].weight.copy_(torch.from_numpy(arrs["w"]).t())
        fused[0].bias.copy_(torch.from_numpy(arrs["b"]))
    fused.pool(torch.from_numpy(arrs["x"]), torch.from_numpy(mask),
               torch.from_numpy(plan["pool_blk_first"]), n_prop)
    np.testing.assert_allclose(fused[1].running_mean.numpy(),
                               mlp[1].running_mean.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(fused[1].running_var.numpy(),
                               mlp[1].running_var.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_bf16_gradients_find_the_winners():
    arrs, mask, seg, plan, n_prop, cot = _setup(seed=11)
    _, _, _, _, g16 = _port(arrs, mask, plan, n_prop, cot,
                            dtype=torch.bfloat16)
    _, _, gref = _unfused(arrs, mask, seg, n_prop, cot, dtype=torch.bfloat16)
    for name, g, r in zip(NAMES, g16, gref):
        if name == "b":  # structurally zero: noise on both sides
            continue
        assert np.isfinite(g).all(), name
        cos = float((g * r).sum() / max(np.linalg.norm(g) * np.linalg.norm(r),
                                        1e-9))
        assert cos > 0.98, (name, cos)
        assert 0.8 < np.linalg.norm(g) / max(np.linalg.norm(r), 1e-9) < 1.25


def test_available_predicate_and_cpu_fallback(synthetic_root):
    arrs, mask, seg, plan, n_prop, cot = _setup(seed=5)
    p = tuple(torch.from_numpy(plan[k]) for k in
              ("pool_blk_first", "pool_blk_full", "pool_bnd_rows",
               "pool_bnd_seg", "pool_bnd_mask"))
    assert fused_pool_available(1024, p)
    assert not fused_pool_available(1000, p)
    assert not fused_pool_available(1024, None)
    unaligned = pool_plan(seg, n_prop)  # boundary rows: not aligned
    assert not fused_pool_available(1024, tuple(
        torch.from_numpy(unaligned[k]) for k in
        ("pool_blk_first", "pool_blk_full", "pool_bnd_rows", "pool_bnd_seg",
         "pool_bnd_mask")))

    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import PackedLoader
    from yolat_tpu_torch.data.packing import finalize_batch, to_device

    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    cfg = Config(n_classes=ds.n_classes, n_filters=8, fused_head_train=True)
    model = port_model.build_model(cfg).train()
    batch = finalize_batch(to_device(next(iter(PackedLoader(ds, 2))), "cpu"))
    model(batch)
    assert model.cls_net.fused_fallbacks == 0
    no_plan = {k: v for k, v in batch.items() if not k.startswith("pool_")}
    model(no_plan)  # a CPU batch falls back to the unfused route, counted
    assert model.cls_net.fused_fallbacks == 1
