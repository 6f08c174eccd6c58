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
  * kernels 9 and 10: the gathers (9 forward, 10 backward) are copies and
    one rounded difference — exact. The sums (9 backward, 10 forward) add
    a node's few terms in f32 in the plan's order, the plain versions with
    float atomics in any order: f32 rtol/atol 1e-5; at bf16 (9 backward
    rounds its f32 sum to bf16) one output ulp, rtol 2^-7 over atol 1e-5.
  * kernel 12, the decomposition variants of kernel 1: bit-identical to
    kernel 1 on the variant's inputs (same code, same order), and to
    itself on a second run.
  * kernel 4: f32 rtol/atol 1e-4; bf16 max error <= 5e-3 * max|out| (a
    flipped bf16 rounding of s_i, h1 or h2, as for the edge window).
  * kernels 5 and 6: the kernel adds a node's terms in the plan's order,
    the plain version with float atomics in any order, and another order
    of the products' f32 sums can flip a bf16 rounding of an endpoint
    product or of h: max error <= 1e-5 * max|out| at f32, 5e-4 * max|out|
    at bf16 (an H100 reads <= 2e-7 and <= 1e-4). Kernel 6's own-endpoint
    sum is kernel 5's bit for bit.
  * kernels 7 and 8: the gathers (7 forward, 8 backward) are copies, or one
    rounding of an f32 value to bf16 — exact. The sums (8 forward, 7
    backward) add a node's terms in f32 in the plan's order, the plain
    versions with float atomics in any order, over runs of up to 1500 rows:
    f32 |err| <= 1e-5 * (1 + |ref|) * sqrt(longest run); at bf16 7 backward
    rounds its f32 sum once — one output ulp (2^-7) over the same floor.
    The same at an odd width (C = 5, the kernels' narrow route).
"""

import numpy as np
import pytest
import torch

from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops import banded_train as bt
from yolat_tpu_torch.ops import edge_window_train as ewt
from yolat_tpu_torch.ops.banded_message import (banded_message_sum,
                                                banded_message_sum_both,
                                                banded_message_sum_both_plain,
                                                banded_message_sum_plain,
                                                plan_tensors)
from yolat_tpu_torch.ops.block_max import (folded_mlp_block_max,
                                           folded_mlp_block_max2,
                                           folded_mlp_block_max2_plain,
                                           folded_mlp_block_max_plain)
from yolat_tpu_torch.ops.dense_message import (fused_dense_message,
                                               fused_dense_message_plain)
from yolat_tpu_torch.ops.edge_window import (decomp_inputs,
                                             edge_window_decomp,
                                             edge_window_decomp_plain,
                                             edge_window_message_sum,
                                             edge_window_message_sum_plain)
from yolat_tpu_torch.ops.fused_pool_train import (fused_pool_train,
                                                  fused_pool_train_bwd)
from yolat_tpu_torch.ops.plans import (EW_KEYS, EW_TRAIN_KEYS, banded_plan,
                                       bm_of, edge_window_plan, pool_plan)


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
@pytest.mark.parametrize("variant", ["full", "noband", "noonehot"])
def test_edge_window_decomp_is_kernel1_on_its_inputs(cuda_device, variant,
                                                     dtype):
    x, ew, w1, sc1, w2, sc2 = _ew_inputs(3, 64, cuda_device, layout="wide")
    x = x.to(dtype)
    w = (w1, sc1, w2, sc2)
    _build.reset_launch_counts()
    got = edge_window_decomp(x, ew, *w, variant)
    again = edge_window_decomp(x, ew, *w, variant)
    k1 = edge_window_message_sum(*decomp_inputs(x, ew, variant), *w)
    want = edge_window_decomp_plain(x, ew, *w, variant)
    torch.cuda.synchronize()
    assert _build.launch_counts["edge_window_decomp"] == 2
    assert _build.launch_counts["edge_window_message_sum"] == 1
    assert torch.equal(got, k1) and torch.equal(got, again)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = (got - want).abs().max().item()
        assert err <= 5e-3 * want.abs().max().item(), err
    with pytest.raises(ValueError):
        edge_window_decomp(x, ew, *w, "nogather")


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


def _train_plan(seed, dev, n=4096, e=3500, wide=False):
    """(src, dst, dptr, sperm, sptr) on `dev`: sources near their dst, or
    anywhere with 900 more edges into 256 nodes (long out- and in-runs)."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    if wide:
        dst = np.concatenate([dst, rng.integers(256, 512, 900)]).astype(np.int32)
        src = rng.integers(0, n // 8, len(dst))
    else:
        src = np.clip(dst + rng.integers(-40, 41, len(dst)), 0, n - 1)
    edge = np.stack([src.astype(np.int32), dst], axis=1)
    mask = rng.random(len(dst)) < 0.85
    attr = np.zeros((len(dst), 4), np.float32)
    plan = edge_window_plan(edge, mask, attr, n, transpose=True)
    return n, tuple(torch.from_numpy(plan[k]).to(dev)
                    for k in ("ew_src", "ew_dst") + EW_TRAIN_KEYS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,wide", [(5, False), (64, False), (64, True)])
def test_pair_features_kernels_match_plain(cuda_device, c, wide, dtype):
    n, plan = _train_plan(c, cuda_device, wide=wide)
    e = plan[0].shape[0]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(n, c, device=cuda_device, generator=gen).to(dtype)
    dg = torch.randn(e, 2 * c, device=cuda_device, generator=gen).to(dtype)
    _build.reset_launch_counts()
    outs = []
    for _ in range(2):
        xt = x.clone().requires_grad_(True)
        g = ewt.ew_pair_features(xt, plan)
        g.backward(dg)
        outs.append((g.detach(), xt.grad))
    outs.append((ewt.pair_fwd_plain(x, plan[0], plan[1]),
                 ewt.pair_bwd_plain(dg, plan[0], plan[1], n)))
    torch.cuda.synchronize()
    assert _build.launch_counts["ew_pair_features"] == 2
    assert _build.launch_counts["ew_pair_features_bwd"] == 2
    (g1, dx1), (g2, dx2), (gp, dxp) = outs
    assert g1.dtype == dx1.dtype == dtype and g1.shape == (e, 2 * c)
    assert torch.equal(g1, g2) and torch.equal(dx1, dx2)  # no atomics
    assert torch.equal(g1, gp)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(dx1.float(), dxp.float(), rtol=rtol, atol=1e-5)
    assert dx1.float().abs().max() > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,wide", [(1, False), (64, False), (64, True)])
def test_window_segment_sum_kernels_match_plain(cuda_device, c, wide, dtype):
    n, plan = _train_plan(c + 1, cuda_device, wide=wide)
    e = plan[0].shape[0]
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    h = torch.randn(e, c, device=cuda_device, generator=gen).to(dtype)
    cot = torch.randn(n, c, device=cuda_device, generator=gen)
    _build.reset_launch_counts()
    outs = []
    for _ in range(2):
        ht = h.clone().requires_grad_(True)
        s = ewt.ew_window_segment_sum_n(ht, plan, n)
        s.backward(cot)
        outs.append((s.detach(), ht.grad))
    outs.append((ewt.wsum_fwd_plain(h, plan[1], n),
                 ewt.wsum_bwd_plain(cot, plan[1], dtype)))
    torch.cuda.synchronize()
    assert _build.launch_counts["ew_window_segment_sum"] == 2
    assert _build.launch_counts["ew_window_segment_sum_bwd"] == 2
    (s1, dh1), (s2, dh2), (sp, dhp) = outs
    assert s1.dtype == torch.float32 and dh1.dtype == dtype
    assert torch.equal(s1, s2) and torch.equal(dh1, dh2)
    assert torch.equal(dh1, dhp)
    torch.testing.assert_close(s1, sp, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci,n", [(5, 4096), (64, 4096), (64, 1000)])
def test_dense_message_kernel_matches_plain(cuda_device, ci, n, dtype):
    rng = np.random.default_rng(ci + n)
    d, h, dev = 4, 64, cuda_device
    deg = rng.integers(0, d + 1, n)
    deg[-40:] = 0  # padding nodes
    deg[64:96] = np.minimum(deg[64:96], 2)  # a tile with unused slots
    mask = np.arange(d)[None, :] < deg[:, None]
    idx = np.where(mask, rng.integers(0, n, (n, d)), 0).astype(np.int32)
    attr = np.where(mask[..., None], rng.normal(size=(n, d, 4)), 0.0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    sc = lambda: t(np.stack([rng.uniform(0.5, 1.5, h),
                             rng.normal(size=h) * 0.1]))
    args = (t(rng.normal(size=(n, ci))).to(dtype),
            torch.from_numpy(idx).to(dev), t(attr),
            torch.from_numpy(mask).to(dev), t(rng.normal(size=(2 * ci + 4, h)) * 0.3),
            sc(), t(rng.normal(size=(h, h)) * 0.3), sc(),
            t(rng.normal(size=(ci, h)) * 0.3), t(rng.normal(size=h) * 0.1))
    _build.reset_launch_counts()
    got = fused_dense_message(*args)
    again = fused_dense_message(*args)
    want = fused_dense_message_plain(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_dense_message"] == 2
    assert got.dtype == torch.float32 and got.shape == (n, h)
    assert torch.equal(got, again)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = (got - want).abs().max().item()
        assert err <= 5e-3 * want.abs().max().item(), err
    with pytest.raises(TypeError):
        fused_dense_message(args[0], args[1].long(), *args[2:])
    with pytest.raises(ValueError):
        fused_dense_message(*args[:4], args[4][:, :32], *args[5:])
    with pytest.raises(TypeError):
        ewt.pair_fwd(args[0].half(), args[1][:, 0], args[1][:, 0])
    with pytest.raises(TypeError):
        ewt.pair_fwd(args[0], args[1][:, 0].long(), args[1][:, 0])


def _banded_inputs(seed, dev, n=4096, layout="cliques"):
    """layout 'cliques': all-pairs edges over short node runs, dense next
    to empty stretches, and one node with 1500 edges (more than a thread
    block's share); 'wide': endpoints anywhere; 'empty': no real edge.
    -> (x f32, edge, mask, attr, weights tuple) with numpy edge arrays."""
    rng = np.random.default_rng(seed)
    if layout == "cliques":
        edges, lo = [], 0
        while lo < n - 600:
            m = int(rng.integers(2, 24))
            ids = np.arange(lo, lo + m)
            a, b = np.meshgrid(ids, ids)
            edges.append(np.stack([a[a != b], b[a != b]], axis=1))
            lo += m + int(rng.integers(0, 60))
        edges.append(np.stack([rng.integers(0, n, 1500),
                               np.full(1500, n - 300)], axis=1))
        edge = np.concatenate(edges).astype(np.int32)
    else:
        edge = rng.integers(0, n, (5000, 2)).astype(np.int32)
    edge = edge[rng.permutation(len(edge))]
    mask = rng.random(len(edge)) < (0.0 if layout == "empty" else 0.9)
    attr = rng.normal(size=(len(edge), 4)).astype(np.float32)
    c = h = 64
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    sc = lambda: t(np.stack([rng.uniform(0.5, 1.5, h),
                             rng.normal(size=h) * 0.1]))
    w = (t(rng.normal(size=(c, h)) * 0.2), t(rng.normal(size=(c, h)) * 0.2),
         t(rng.normal(size=(4, h)) * 0.2), sc(), t(rng.normal(size=(h, h)) * 0.2),
         sc())
    return t(rng.normal(size=(n, c))), edge, mask, attr, w


def _banded_close(got, want, dtype):
    tol = 1e-5 if dtype == torch.float32 else 5e-4
    err = (got - want).abs().max().item()
    assert err <= tol * max(want.abs().max().item(), 1e-30), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("two_stage", [False, True])
@pytest.mark.parametrize("layout,sortby", [("cliques", 1), ("cliques", 0),
                                           ("wide", 1), ("empty", 1)])
def test_banded_kernel_matches_plain(cuda_device, layout, sortby, two_stage,
                                     dtype):
    dev = cuda_device
    x, edge, mask, attr, w = _banded_inputs(3, dev, layout=layout)
    n = x.shape[0]
    bm = plan_tensors(banded_plan(edge, mask, attr, n, sortby=sortby), dev)
    x = x.to(dtype)
    args = w if two_stage else w[:4]
    _build.reset_launch_counts()
    got = banded_message_sum(x, bm, *args)
    again = banded_message_sum(x, bm, *args)
    want = banded_message_sum_plain(x, bm, *args)
    torch.cuda.synchronize()
    assert _build.launch_counts["banded_message_sum"] == 2
    assert _build.launch_counts["banded_message_sum_both"] == 0
    assert got.dtype == torch.float32 and got.shape == (n, 64)
    assert torch.equal(got, again)  # no atomics: bit-identical runs
    deg = torch.bincount(bm.own.long(), minlength=n)
    assert not got[deg == 0].any()  # every row is written, edge or not
    if layout == "empty":
        assert bm.n_edges == 0 and not got.any()
    _banded_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["cliques", "wide", "empty"])
def test_banded_both_kernel_matches_plain_and_kernel5(cuda_device, layout,
                                                      dtype):
    dev = cuda_device
    x, edge, mask, attr, w = _banded_inputs(5, dev, layout=layout)
    n = x.shape[0]
    bm = plan_tensors(banded_plan(edge, mask, attr, n, transpose=True), dev)
    bm_t = plan_tensors(banded_plan(edge, mask, attr, n, sortby=0), dev)
    x = x.to(dtype)
    w = w[:4]
    _build.reset_launch_counts()
    own, oth = banded_message_sum_both(x, bm, *w)
    own2, oth2 = banded_message_sum_both(x, bm, *w)
    assert _build.launch_counts["banded_message_sum_both"] == 2
    assert _build.launch_counts["banded_message_sum"] == 0
    want_own, want_oth = banded_message_sum_both_plain(x, bm, *w)
    k5 = banded_message_sum(x, bm, *w)
    k5_t = banded_message_sum(x, bm_t, w[1], w[0], w[2], w[3])
    torch.cuda.synchronize()
    assert torch.equal(own, own2) and torch.equal(oth, oth2)
    assert torch.equal(own, k5)
    _banded_close(own, want_own, dtype)
    _banded_close(oth, want_oth, dtype)
    _banded_close(oth, k5_t, dtype)
    with pytest.raises(ValueError, match="transpose"):
        banded_message_sum_both(x, bm_t, *w)


@pytest.mark.cuda
def test_banded_kernels_read_the_edge_window_plan(cuda_device):
    """The curve family's plans are the edge-window plan and its transpose
    (`bm_of` 'cwd_' / 'cws_'): windows of wn nodes instead of node cuts,
    and for the src-sorted side a row permutation."""
    dev = cuda_device
    x, edge, mask, attr, w = _banded_inputs(7, dev, layout="wide")
    n = x.shape[0]
    plan = edge_window_plan(edge, mask, attr, n, transpose=True)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in plan.items()}
    batch["pos"] = torch.zeros(n, 2, device=dev)
    cwd, cws = bm_of(batch, "cwd_"), bm_of(batch, "cws_")
    assert cwd.cnode is None and cws.perm is not None
    w = w[:4]
    for bm, args in ((cwd, w), (cws, (w[1], w[0], w[2], w[3]))):
        got = banded_message_sum(x, bm, *args)
        _banded_close(got, banded_message_sum_plain(x, bm, *args),
                      torch.float32)
    own, oth = banded_message_sum_both(x, cwd, *w)
    assert torch.equal(own, banded_message_sum(x, cwd, *w))
    assert torch.equal(oth, banded_message_sum(x, cws, w[1], w[0], w[2], w[3]))


@pytest.mark.cuda
def test_banded_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    dev = cuda_device
    x, edge, mask, attr, w = _banded_inputs(9, dev, layout="wide")
    bm = plan_tensors(banded_plan(edge, mask, attr, x.shape[0]), dev)
    w = w[:4]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        banded_message_sum(x.half(), bm, *w)
    with pytest.raises(ValueError, match="needs H == 64"):
        banded_message_sum(x, bm, w[0][:, :32], w[1][:, :32], w[2][:, :32],
                           w[3][:, :32])
    with pytest.raises(TypeError, match="nptr"):
        banded_message_sum(x[:-1], bm, *w)
    cpu_plan = plan_tensors(banded_plan(edge, mask, attr, x.shape[0]))
    with pytest.raises(TypeError, match="own"):
        banded_message_sum(x, cpu_plan, *w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,c", [("cliques", 64), ("wide", 64),
                                      ("cliques", 6), ("empty", 64)])
def test_banded_train_kernels_match_plain(cuda_device, layout, c, dtype):
    """Kernels 7, 7b, 8, 8b through the two autograd Functions, twice, and
    their plain versions; C 6 takes the gather's element-wise copy."""
    dev = cuda_device
    x, edge, mask, attr, _ = _banded_inputs(13, dev, layout=layout)
    n = x.shape[0]
    bm = plan_tensors(banded_plan(edge, mask, attr, n, transpose=True), dev)
    e = bm.n_edges
    gen = torch.Generator(device=dev).manual_seed(2)
    x = x[:, :c].contiguous().to(dtype)
    g_own = torch.randn(e, c, device=dev, generator=gen).to(dtype)
    g_oth = torch.randn(e, c, device=dev, generator=gen).to(dtype)
    rows = torch.randn(e, c, device=dev, generator=gen).to(dtype)
    cot = torch.randn(n, c, device=dev, generator=gen)
    _build.reset_launch_counts()
    outs = []
    for _ in range(2):
        xt = x.clone().requires_grad_(True)
        x_own, x_oth = bt.banded_gather(xt, bm)
        torch.autograd.backward([x_own, x_oth], [g_own, g_oth])
        rt = rows.clone().requires_grad_(True)
        total = bt.banded_scatter_own(rt, bm, n)
        total.backward(cot)
        outs.append((x_own.detach(), x_oth.detach(), xt.grad, total.detach(),
                     rt.grad))
    torch.cuda.synchronize()
    launched = 0 if layout == "empty" else 2
    for k in ("banded_gather", "banded_gather_bwd", "banded_scatter_own",
              "banded_scatter_own_bwd"):
        assert _build.launch_counts[k] == launched, k
    for a, b in zip(*outs):
        assert torch.equal(a, b)  # no atomics: bit-identical runs
    x_own, x_oth, dx, total, d_rows = outs[0]
    assert x_own.dtype == x_oth.dtype == dx.dtype == d_rows.dtype == dtype
    assert total.dtype == torch.float32
    assert x_own.shape == (e, c) and dx.shape == (n, c) == total.shape
    p_own, p_oth = bt.gather_plain(x, bm.own, bm.oth)
    assert torch.equal(x_own, p_own) and torch.equal(x_oth, p_oth)
    assert torch.equal(d_rows, bt.scatter_own_bwd_plain(cot, bm.own, dtype))
    if layout == "empty":
        assert e == 0 and not dx.any() and not total.any()
        return
    run = max(int(torch.bincount(bm.own.long()).max()),
              int(torch.bincount(bm.oth.long()).max()))
    want = bt.scatter_own_plain(rows, bm.own, n)
    lim = 1e-5 * (1 + want.abs()) * run ** 0.5
    assert bool(((total - want).abs() <= lim).all())
    want = bt.gather_bwd_plain(g_own, g_oth, bm.own, bm.oth, n).float()
    lim = 1e-5 * (1 + want.abs()) * run ** 0.5
    if dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * want.abs()
    assert bool(((dx.float() - want).abs() <= lim).all())
    assert dx.float().abs().max() > 1.0 and total.abs().max() > 1.0
    deg = torch.bincount(bm.own.long(), minlength=n)
    assert not total[deg == 0].any()  # every row is written, edge or not


@pytest.mark.cuda
def test_banded_train_wrappers_refuse_what_the_kernels_do_not_take(
        cuda_device):
    dev = cuda_device
    x, edge, mask, attr, _ = _banded_inputs(15, dev, layout="wide")
    n = x.shape[0]
    bm = plan_tensors(banded_plan(edge, mask, attr, n, transpose=True), dev)
    no_t = plan_tensors(banded_plan(edge, mask, attr, n), dev)
    bt.banded_gather(x, no_t)  # forward only: no transpose needed
    with pytest.raises(ValueError, match="transpose"):
        bt.banded_gather(x.clone().requires_grad_(True), no_t)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bt.banded_gather(x.half(), bm)
    with pytest.raises(TypeError, match="own"):
        bt.gather_fwd(x, bm.own.long(), bm.oth)
    # an odd width is taken, as the JAX kernels take it: kernel 8 and 7b
    # (their narrow route) against their plain versions
    rows = torch.randn(bm.n_edges, 5, device=dev)
    run = max(int(torch.bincount(bm.own.long()).max()),
              int(torch.bincount(bm.oth.long()).max())) ** 0.5
    want = bt.scatter_own_plain(rows, bm.own, n)
    total = bt.banded_scatter_own(rows, bm, n)
    assert bool(((total - want).abs() <= 1e-5 * (1 + want.abs()) * run).all())
    g_oth = torch.randn_like(rows)
    dx = bt.gather_bwd(rows, g_oth, bm.own, bm.oth, bm.nptr, bm.tperm,
                       bm.tptr, n)
    want = bt.gather_bwd_plain(rows, g_oth, bm.own, bm.oth, n)
    assert bool(((dx - want).abs() <= 1e-5 * (1 + want.abs()) * run).all())
    with pytest.raises(TypeError, match="nptr"):
        bt.banded_scatter_own(rows[:, :4].contiguous(), bm, n + 1)
    cpu_plan = plan_tensors(banded_plan(edge, mask, attr, n, transpose=True))
    with pytest.raises(TypeError, match="own"):
        bt.banded_gather(x, cpu_plan)
