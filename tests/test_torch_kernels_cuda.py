"""The two CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips (through the `cuda_device` fixture) where
no CUDA device is present. This file imports no jax, so it also runs on a
machine without it:

  python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances, kernel vs plain version on the same card and inputs:
  * f32 (TF32 off): sums in another order — rtol/atol 1e-4.
  * bf16: both round at the TPU kernel's points; another f32 summation
    order can flip a bf16 rounding of h1/h2 (edge window) — max error
    <= 5e-3 * max|out|; the block max rounds only its output — rtol 1e-2.
"""

import numpy as np
import pytest
import torch

from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.block_max import (folded_mlp_block_max2,
                                           folded_mlp_block_max2_plain)
from yolat_tpu_torch.ops.edge_window import (edge_window_message_sum,
                                             edge_window_message_sum_plain)
from yolat_tpu_torch.ops.plans import EW_KEYS, edge_window_plan


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
