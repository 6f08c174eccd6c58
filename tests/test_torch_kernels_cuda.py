"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips (through the `cuda_device` fixture) where
no CUDA device is present. This file imports no jax, so it also runs on a
machine without it:

  python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances, kernel vs plain version on the same card and inputs:
  * f32 (TF32 off): sums in another order — rtol/atol 1e-4.
  * bf16: both round at the TPU kernel's points; another f32 summation
    order can flip a bf16 rounding of h1/h2 (edge window) — max error
    <= 5e-3 * max|out|; the block max rounds only its output — rtol 1e-2.
  * the fused head at bf16, kernel route vs plain route: relative
    Frobenius error 5e-4 per output and gradient; another f32 order can
    flip a winner at a bf16 boundary (these inputs read <= 8.5e-6 on an
    H100), while a kernel 11 that keeps s = u*sc0 in f32 instead of
    rounding it to bf16 reads 2.6e-3 in dx and dW (a planted fault, run
    once on the same card).
"""

import numpy as np
import pytest
import torch

from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.block_max import (folded_mlp_block_max,
                                           folded_mlp_block_max2,
                                           folded_mlp_block_max2_plain,
                                           folded_mlp_block_max_plain)
from yolat_tpu_torch.ops.edge_window import (edge_window_message_sum,
                                             edge_window_message_sum_plain)
from yolat_tpu_torch.ops.fused_pool_train import (fused_pool_train,
                                                  fused_pool_train_bwd)
from yolat_tpu_torch.ops.plans import EW_KEYS, edge_window_plan, pool_plan


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ew_inputs(seed, ci, dev, n=4096, wn=256, e=3500, layout="banded"):
    """layout 'banded': sources within 40 rows of their dst, window 2
    without edges; 'wide': sources anywhere, 900 more edges into window 1
    (past the TPU layout's capacity of 512 per window), list shuffled."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    if layout == "banded":
        dst = dst[(dst < 2 * wn) | (dst >= 3 * wn)]  # window 2 has no edge
        src = np.clip(dst + rng.integers(-40, 41, len(dst)), 0, n - 1)
    else:
        dst = np.concatenate([dst, rng.integers(wn, 2 * wn, 900)]).astype(np.int32)
        src = rng.integers(0, n, len(dst))
    edge = np.stack([src.astype(np.int32), dst], axis=1)
    mask = rng.random(len(dst)) < 0.85
    attr = rng.normal(size=(len(dst), 4)).astype(np.float32)
    if layout == "wide":
        perm = rng.permutation(len(dst))
        edge, mask, attr = edge[perm], mask[perm], attr[perm]
    plan = edge_window_plan(edge, mask, attr, n, wn=wn)
    h = 64
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    ew = tuple(torch.from_numpy(plan[k]).to(dev) for k in EW_KEYS) + (wn,)
    return (t(rng.normal(size=(n, ci))), ew,
            t(rng.normal(size=(2 * ci + 4, h)) * 0.3),
            t(np.stack([rng.uniform(0.5, 1.5, h), rng.normal(size=h) * 0.1])),
            t(rng.normal(size=(h, h)) * 0.3),
            t(np.stack([rng.uniform(0.5, 1.5, h), rng.normal(size=h) * 0.1])))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci,layout", [(5, "banded"), (64, "banded"),
                                       (64, "wide")])
def test_edge_window_kernel_matches_plain(cuda_device, ci, layout, dtype):
    x, ew, w1, sc1, w2, sc2 = _ew_inputs(ci, ci, cuda_device, layout=layout)
    x = x.to(dtype)
    _build.reset_launch_counts()
    got = edge_window_message_sum(x, ew, w1, sc1, w2, sc2)
    again = edge_window_message_sum(x, ew, w1, sc1, w2, sc2)
    want = edge_window_message_sum_plain(x, ew, w1, sc1, w2, sc2)
    torch.cuda.synchronize()
    assert _build.launch_counts["edge_window_message_sum"] == 2
    assert torch.equal(got, again)  # no atomics: bit-identical runs
    if layout == "banded":
        assert (got[512:768] == 0).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = (got - want).abs().max().item()
        assert err <= 5e-3 * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_max2_kernel_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(0)
    n, ci, h = 4096, 128, 1024
    dev = cuda_device
    x = torch.from_numpy(rng.normal(size=(n, ci)).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.normal(size=(ci, h)) * 0.1).astype(np.float32)).to(dev)
    sc = torch.from_numpy(np.stack([rng.uniform(0.5, 1.5, h),
                                    rng.normal(size=h) * 0.1]).astype(np.float32)).to(dev)
    mask = rng.random(n) < 0.8
    mask[:16] = False
    m = torch.from_numpy(mask.astype(np.float32)[:, None]).to(dev)
    _build.reset_launch_counts()
    gh, gx = folded_mlp_block_max2(x, m, w, sc)
    wh, wx = folded_mlp_block_max2_plain(x, m, w, sc)
    torch.cuda.synchronize()
    assert _build.launch_counts["folded_mlp_block_max2"] == 1
    assert gh.dtype == gx.dtype == dtype
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(gh.float(), wh.float(), rtol=rtol, atol=1e-4)
    assert torch.equal(gx, wx)
    assert (gh[:2].float() <= -1e30 / 2).all()


@pytest.mark.cuda
def test_wrappers_reject_unsupported_inputs(cuda_device):
    x, ew, w1, sc1, w2, sc2 = _ew_inputs(1, 5, cuda_device)
    with pytest.raises(TypeError):
        edge_window_message_sum(x.half(), ew, w1, sc1, w2, sc2)
    with pytest.raises(ValueError):
        edge_window_message_sum(x, ew, w1[:, :32], sc1[:, :32], w2[:32, :32],
                                sc2[:, :32])
    with pytest.raises(ValueError):
        folded_mlp_block_max2(x[:100], x[:100, :1], w1[:5], sc1)
    with pytest.raises(ValueError):
        folded_mlp_block_max(x[:100], x[:100, :1], w1[:5], sc1)
    m = torch.ones(4096, 1, device=cuda_device)
    wb = torch.zeros(136, 128, device=cuda_device)
    with pytest.raises(ValueError):  # Cin 136 > 128
        fused_pool_train_bwd(torch.zeros(4096, 136, device=cuda_device), m,
                             wb, wb[:2], torch.zeros(512, 128, device=cuda_device),
                             torch.zeros(512, 128, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_max_kernel_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(1)
    n, ci, h = 4096, 128, 1024
    dev = cuda_device
    x = torch.from_numpy(rng.normal(size=(n, ci)).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.normal(size=(ci, h)) * 0.1).astype(np.float32)).to(dev)
    sc = torch.from_numpy(np.stack([rng.uniform(0.5, 1.5, h),
                                    rng.normal(size=h) * 0.1]).astype(np.float32)).to(dev)
    mask = rng.random(n) < 0.8
    mask[:16] = False
    m = torch.from_numpy(mask.astype(np.float32)[:, None]).to(dev)
    _build.reset_launch_counts()
    got = folded_mlp_block_max(x, m, w, sc)
    want = folded_mlp_block_max_plain(x, m, w, sc)
    torch.cuda.synchronize()
    assert _build.launch_counts["folded_mlp_block_max"] == 1
    assert _build.launch_counts["folded_mlp_block_max2"] == 0
    assert got.dtype == dtype and got.shape == (n // 8, h)
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-4)
    assert (got[:2].float() <= -1e30 / 2).all()
    # the serving form's first output is the same kernel's
    gh, _ = folded_mlp_block_max2(x, m, w, sc)
    assert torch.equal(gh, got)


def _head_inputs(dev, seed=0, n=4096, ci=128, h=1024, quantized=True):
    """Fused-head inputs on 8-aligned proposal runs, one proposal fully
    masked; quantized: x in 1/16 steps, W in 1/64 steps (exact sums)."""
    rng = np.random.default_rng(seed)
    lens, left = [], n
    while left > 0:
        take = min(int(rng.integers(1, 7)) * 8, left)
        lens.append(take)
        left -= take
    seg = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    n_prop = len(lens) + 3  # trailing proposals without rows
    blk_first = pool_plan(seg, n_prop, cap=0)["pool_blk_first"]
    mask = rng.random(n) > 0.15
    mask[seg == 2] = False
    x = rng.normal(size=(n, ci))
    w = rng.normal(size=(ci, h)) / np.sqrt(ci)
    if quantized:
        x, w = np.round(x * 16) / 16, np.round(w * 64) / 64
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return dict(x=t(x), maskf=t(mask[:, None]), w=t(w),
                b=t(rng.normal(size=h) * 0.1),
                gamma=t(1.0 + 0.2 * rng.normal(size=h)),
                beta=t(rng.normal(size=h) * 0.1),
                blk_first=torch.from_numpy(blk_first).to(dev), n_prop=n_prop,
                cot=t(rng.normal(size=(n_prop, h))))


def _head_route(inp, dtype, route):
    leaves = {k: inp[k].clone().requires_grad_(True)
              for k in ("x", "w", "b", "gamma", "beta")}
    x = leaves["x"].to(dtype)
    w = leaves["w"].to(dtype)
    pooled, mean, var, cnt = fused_pool_train(
        x, inp["maskf"], w, leaves["b"], leaves["gamma"], leaves["beta"],
        inp["blk_first"], inp["n_prop"], route)
    (pooled.float() * inp["cot"]).sum().backward()
    out = {"pooled": pooled.float(), "mean": mean, "var": var}
    out.update({f"d{k}": v.grad for k, v in leaves.items()})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_head_kernel_route_matches_plain_route(cuda_device, dtype):
    inp = _head_inputs(cuda_device, quantized=dtype == torch.float32)
    _build.reset_launch_counts()
    got = _head_route(inp, dtype, "kernel")
    torch.cuda.synchronize()
    assert _build.launch_counts["folded_mlp_block_max"] == 1
    assert _build.launch_counts["fused_pool_train_bwd"] == 1
    want = _head_route(inp, dtype, "plain")
    assert _build.launch_counts["fused_pool_train_bwd"] == 1
    assert (got["pooled"][2] == 0).all() and (got["pooled"][-3:] == 0).all()
    assert got["dw"].abs().max() > 0  # winners were found
    errs = {}
    for k, v in want.items():
        g = got[k]
        assert torch.isfinite(g).all(), k
        ref = want["dbeta"] if k == "db" else v
        if dtype == torch.float32:
            scale = max(ref.abs().max().item(), 1e-6)
            rtol = 1e-5 if k == "pooled" else 1e-4
            torch.testing.assert_close(g, v, rtol=rtol, atol=rtol * scale,
                                       msg=k)
        else:
            errs[k] = ((g.float() - v.float()).norm()
                       / max(ref.float().norm(), 1e-9)).item()
    assert all(e <= 5e-4 for e in errs.values()), errs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_head_backward_kernel_is_deterministic(cuda_device, dtype):
    inp = _head_inputs(cuda_device, seed=3, quantized=False)
    x = (inp["x"] * inp["maskf"]).to(dtype)
    w = inp["w"].to(dtype)
    sc = torch.stack([inp["gamma"], inp["beta"]])
    bred = folded_mlp_block_max(x, inp["maskf"], w, sc)
    gp_b = inp["cot"][inp["blk_first"].long()]
    first = fused_pool_train_bwd(x, inp["maskf"], w, sc, bred, gp_b)
    again = fused_pool_train_bwd(x, inp["maskf"], w, sc, bred, gp_b)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    # the block maxima are their own pooled values: every block has winners
    assert (first[2] > 0).any() or (first[2] < 0).any()
