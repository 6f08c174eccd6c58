"""The fused training pool head's plain route in float64, on the CPU: the
reference `chip_smoke.py` holds the card's bf16 routes of kernels 3 and 11
to (`_head_vs_f64`). On float64 inputs `_stats`, `_scale_shift`, the
block max and the backward's plain version accumulate in float64; the
result is held to torch autograd through Linear -> masked BatchNorm
(batch statistics, biased variance) -> ReLU -> per-proposal max in
float64, at rtol 1e-9 (the closed-form moments and backward against
autograd's sums: float64 rounding only). f32 inputs keep the f32
accumulation.
"""

import numpy as np
import pytest
import torch

from yolat_tpu_torch.ops.fused_pool_train import BN_EPS, fused_pool_train

N, CI, H, P, BLOCK = 512, 16, 128, 8, 8


def _inputs(dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(N, CI))).to(dtype)
    mask = torch.from_numpy(rng.random(N) > 0.2)
    w = torch.from_numpy(rng.normal(size=(CI, H)) / CI ** 0.5).to(dtype)
    b, g, be = (torch.from_numpy(rng.normal(size=H) * s).to(dtype)
                for s in (0.1, 0.2, 0.1))
    g = g + 1.0
    # each proposal owns N / P consecutive rows: N / (P * BLOCK) blocks
    blk_first = torch.arange(P).repeat_interleave(N // (P * BLOCK))
    cot = torch.from_numpy(rng.normal(size=(P, H))).to(dtype)
    return x, mask, w, b, g, be, blk_first, cot


def _autograd(x, mask, w, b, g, be, cot):
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b, g, be)]
    x, w, b, g, be = leaves
    m = mask[:, None].to(x.dtype)
    z = (x * m) @ w + b
    n = m.sum()
    mean = (z * m).sum(0) / n
    var = (((z - mean) ** 2) * m).sum(0) / n
    y = torch.relu((z - mean) / torch.sqrt(var + BN_EPS) * g + be)
    y = torch.where(mask[:, None], y, torch.full_like(y, -1e30))
    pooled = y.reshape(P, N // P, H).amax(dim=1).clamp(min=0.0)
    (pooled * cot).sum().backward()
    return (pooled.detach(), mean.detach(), var.detach(),
            [t.grad for t in leaves])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_fused_head_matches_autograd(dtype):
    x, mask, w, b, g, be, blk_first, cot = _inputs(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b, g, be)]
    pooled, mean, var, _ = fused_pool_train(
        leaves[0], mask.float()[:, None], *leaves[1:], blk_first, P,
        route="plain")
    (pooled * cot).sum().backward()
    assert pooled.dtype == mean.dtype == var.dtype == dtype
    want = _autograd(*(t.double() for t in (x,)), mask,
                     *(t.double() for t in (w, b, g, be, cot)))
    tol = dict(rtol=1e-9, atol=1e-12) if dtype == torch.float64 else dict(
        rtol=2e-4, atol=2e-5)
    for got, ref in zip((pooled, mean, var), want[:3]):
        np.testing.assert_allclose(got.detach().double().numpy(),
                                   ref.numpy(), **tol)
    for name, leaf, ref in zip(("dx", "dW", "db", "dgamma", "dbeta"),
                               leaves, want[3]):
        assert leaf.grad.dtype == dtype, name
        scale = float(want[3][4].abs().max()) if name == "db" else float(
            ref.abs().max())
        np.testing.assert_allclose(leaf.grad.double().numpy(), ref.numpy(),
                                   rtol=tol["rtol"],
                                   atol=tol["rtol"] * scale + tol["atol"],
                                   err_msg=name)
