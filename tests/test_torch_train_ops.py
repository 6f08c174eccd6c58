"""The port's training ops against yolat_tpu's on the CPU: segment
reduction gradients (the compare-form max backward, the plan-sum VJP),
MaskedBatchNorm in train mode and the masked MLP.

Inputs are made with numpy from a seed and given to both packages.
Tolerances:
  * segment gradients: the same gathers and compares — max is exact;
    sum/mean rtol 1e-6 (the mean divides in f32 in both).
  * MaskedBatchNorm / MLP at f32: the same f32 moments with sums in
    another order — rtol/atol 1e-5 on outputs and running statistics.
    At bf16 input both normalise in f32 and round the output to bf16
    once — outputs within one bf16 ulp (rtol 8e-3), statistics f32
    (rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from yolat_tpu.nn.layers import MLP as JaxMLP
from yolat_tpu.nn.layers import MaskedBatchNorm as JaxBN
from yolat_tpu.ops import segment as jseg
from yolat_tpu_torch.nn.layers import MLP, MaskedBatchNorm
from yolat_tpu_torch.ops import segment as seg
from yolat_tpu_torch.ops.plans import pool_plan

PLAN_KEYS = ("pool_blk_first", "pool_blk_full", "pool_bnd_rows",
             "pool_bnd_seg", "pool_bnd_mask")


def _segments(seed, n_seg=12, aligned=True):
    """Sorted segment ids with one empty segment (id 3) and one fully
    masked segment (id 5); data with exact ties inside segments."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 5, n_seg) * (8 if aligned else 1)
    if not aligned:
        lens = lens + rng.integers(1, 8, n_seg)
    lens[3] = 0
    ids = np.repeat(np.arange(n_seg), lens).astype(np.int32)
    n = len(ids)
    pad = (-n) % 8
    ids = np.concatenate([ids, np.full(pad, n_seg - 1, np.int32)])
    n = len(ids)
    mask = rng.random(n) > 0.2
    mask[ids == 5] = False
    mask[n - pad:] = False
    data = rng.normal(size=(n, 6)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(lens)])
    for s in (0, 7, 9):  # duplicated rows: exact ties on every column
        if lens[s] >= 2:
            data[starts[s] + 1] = data[starts[s]]
            mask[starts[s]:starts[s] + 2] = True
    data[starts[10]:starts[10] + 2, 0] = 0.0  # a tie in one column only
    mask[starts[10]:starts[10] + 2] = True
    cot = rng.normal(size=(n_seg, 6)).astype(np.float32)
    plan = pool_plan(ids, n_seg, cap=0 if aligned else None)
    return data, ids, mask, n_seg, cot, plan


def _jax_grad(fn, data, ids, mask, n_seg, cot, plan, use_plan):
    jplan = (tuple(jnp.asarray(plan[k]) for k in PLAN_KEYS)
             if use_plan else None)

    def loss(d):
        out = fn(d, jnp.asarray(ids), n_seg, mask=jnp.asarray(mask),
                 indices_are_sorted=True, plan=jplan)
        return jnp.sum(out * cot), out

    (_, out), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(data))
    return np.asarray(out), np.asarray(g)


def _port_grad(fn, data, ids, mask, n_seg, cot, plan, use_plan):
    tplan = (tuple(torch.from_numpy(plan[k]) for k in PLAN_KEYS)
             if use_plan else None)
    d = torch.from_numpy(data).requires_grad_(True)
    out = fn(d, torch.from_numpy(ids), n_seg, mask=torch.from_numpy(mask),
             plan=tplan)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), d.grad.numpy()


@pytest.mark.parametrize("op", ["max", "sum", "mean"])
@pytest.mark.parametrize("layout", ["none", "aligned", "unaligned"])
def test_segment_gradients_match_jax(op, layout):
    data, ids, mask, n_seg, cot, plan = _segments(
        seed=4, aligned=layout != "unaligned")
    use_plan = layout != "none"
    jfn = {"max": jseg.segment_max, "sum": jseg.segment_sum,
           "mean": jseg.segment_mean}[op]
    pfn = {"max": seg.segment_max, "sum": seg.segment_sum,
           "mean": seg.segment_mean}[op]
    wo, wg = _jax_grad(jfn, data, ids, mask, n_seg, cot, plan, use_plan)
    go, gg = _port_grad(pfn, data, ids, mask, n_seg, cot, plan, use_plan)
    if op == "max":
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(gg, wg)
        # every tied row gets the full cotangent; empty and fully masked
        # segments give 0 and send nothing back
        r0 = np.flatnonzero(ids == 0)[:2]
        hit = data[r0[0]] == wo[0]
        np.testing.assert_array_equal(gg[r0[0]][hit], cot[0][hit])
        np.testing.assert_array_equal(gg[r0[1]][hit], cot[0][hit])
        assert (go[3] == 0).all() and (go[5] == 0).all()
        assert (gg[ids == 5] == 0).all()
    else:
        np.testing.assert_allclose(go, wo, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gg, wg, rtol=1e-6, atol=1e-7)
    assert (gg[~mask] == 0).all()


def test_segment_max_ties_get_the_full_cotangent():
    """torch's own scatter_reduce('amax') backward would split it."""
    d = torch.tensor([[1.0], [1.0], [0.5]], requires_grad=True)
    out = seg.segment_max(d, torch.tensor([0, 0, 0]), 1)
    out.sum().backward()
    assert d.grad.flatten().tolist() == [1.0, 1.0, 0.0]


def test_segment_broadcast_matches_jax():
    data, ids, mask, n_seg, cot, plan = _segments(seed=2)
    want = jseg.segment_broadcast(
        jnp.asarray(cot), jnp.asarray(ids), len(ids),
        plan=tuple(jnp.asarray(plan[k]) for k in PLAN_KEYS))
    got = seg.segment_broadcast(
        torch.from_numpy(cot), torch.from_numpy(ids), len(ids),
        plan=tuple(torch.from_numpy(plan[k]) for k in PLAN_KEYS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        seg.segment_broadcast(torch.from_numpy(cot), torch.from_numpy(ids),
                              len(ids)).numpy(), cot[ids])


def _jax_apply(module, params_stats, x, mask):
    out, mut = module.apply(params_stats, x, mask=mask, train=True,
                            mutable=["batch_stats"])
    return out, unfreeze(mut)["batch_stats"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_batchnorm_train_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(300, 24)) * 3 + 1).astype(np.float32)
    mask = rng.random(300) > 0.3
    scale = (1 + 0.2 * rng.normal(size=24)).astype(np.float32)
    bias = (0.1 * rng.normal(size=24)).astype(np.float32)
    mean0 = rng.normal(size=24).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 24).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    want, stats = _jax_apply(JaxBN(24), variables, jx, jnp.asarray(mask))

    bn = MaskedBatchNorm(24).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = bn(tx, torch.from_numpy(mask))
    assert got.dtype == tx.dtype
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    rtol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=rtol)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5, atol=1e-6)


def test_masked_batchnorm_all_masked_and_eval():
    bn = MaskedBatchNorm(4).train()
    x = torch.randn(16, 4, generator=torch.Generator().manual_seed(0))
    out = bn(x, torch.zeros(16, dtype=torch.bool))
    # count clamps at 1: mean 0, var 0 -> the input scaled by 1/sqrt(eps)
    torch.testing.assert_close(out, x * (1e-5) ** -0.5)
    assert torch.equal(bn.running_mean, torch.zeros(4))
    bn.eval()
    torch.testing.assert_close(bn(x), x / (0.9 + 0.1 * 0.0 + 1e-5) ** 0.5,
                               rtol=1e-6, atol=1e-6)


def test_masked_mlp_train_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, 12)).astype(np.float32)
    mask = rng.random(200) > 0.25
    jm = JaxMLP([12, 20, 8], act="relu", norm="batch")
    variables = jm.init(jax.random.key(0), jnp.asarray(x),
                        mask=jnp.asarray(mask), train=False)
    want, stats = _jax_apply(jm, variables, jnp.asarray(x), jnp.asarray(mask))

    from yolat_tpu_torch.nn.state_dict import _export_mlp

    sd = _export_mlp(jax.tree.map(np.asarray, variables["params"]),
                     jax.tree.map(np.asarray, variables["batch_stats"]), "m")
    mlp = MLP([12, 20, 8]).train()
    mlp.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                         for k, v in sd.items()}, strict=True)
    assert set(mlp.state_dict()) == {k[2:] for k in sd}
    got = mlp(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for i, name in ((1, "bn_0"), (4, "bn_1")):
        np.testing.assert_allclose(mlp[i].running_mean.numpy(),
                                   np.asarray(stats[name]["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mlp[i].running_var.numpy(),
                                   np.asarray(stats[name]["var"]),
                                   rtol=1e-5, atol=1e-6)


def test_mlp_dropout_needs_a_generator_and_keeps_its_keys():
    mlp = MLP([8, 8], drop=0.5).train()
    assert set(mlp.state_dict()) == set(MLP([8, 8]).state_dict())
    x = torch.ones(64, 8)
    with pytest.raises(ValueError, match="Generator"):
        mlp(x)
    out = mlp(x, generator=torch.Generator().manual_seed(0))
    assert (out == 0).any()
    plain = MLP([8, 8])
    plain.load_state_dict(mlp.state_dict())
    # eval: no dropout
    torch.testing.assert_close(mlp.eval()(x), plain.eval()(x))
