"""Plain PyTorch versions of the two ported kernels against the JAX Pallas
kernels (interpret mode on the CPU) and the JAX oracle.

Tolerances:
  * f32: the same math with sums in another order — rtol/atol 1e-5.
  * bf16, against the Pallas kernel: the plain version rounds where the
    TPU kernel rounds (W1 split in bf16; x_i/x_j, h1, h2 rounded to bf16;
    f32 sums), but another f32 summation order can move an h1 or h2 value
    across a bf16 rounding boundary, one bf16 ulp (2^-8 relative) at a
    time (measured: at most 2.2e-4 of the output's max magnitude) — max
    error <= 2e-3 * max|out|.
  * bf16, against `_reference`, which neither splits W1 nor rounds h2:
    measured up to 3e-3 of max|out| — max error <= 1e-2 * max|out|.
  * the block max rounds only its output to bf16: one ulp, rtol 1e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.ops.edge_window import (edge_window_message_sum as jax_ew,
                                       edge_window_message_sum_reference)
from yolat_tpu.ops.edge_window import edge_window_plan as jax_ew_plan
from yolat_tpu.ops.pallas_kernels import folded_mlp_block_max2 as jax_bm2
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.block_max import (folded_mlp_block_max,
                                           folded_mlp_block_max2,
                                           folded_mlp_block_max2_plain,
                                           folded_mlp_block_max_plain)
from yolat_tpu_torch.ops.edge_window import (edge_window_message_sum,
                                             edge_window_message_sum_plain)
from yolat_tpu_torch.ops.fused_pool_train import (fused_pool_train_bwd,
                                                  fused_pool_train_bwd_plain)
from yolat_tpu_torch.ops.plans import EW_KEYS, edge_window_plan


def assert_close(got, want, dtype, bf16_frac):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got - want).max()
        assert err <= bf16_frac * np.abs(want).max(), (err, np.abs(want).max())


def _ew_inputs(seed, ci, h=64, n=512, wn=128, e=700, layout="banded"):
    """Inputs of both packages' edge-window sums. layout 'banded': sources
    within 30 rows of their dst and window 2 without edges (a graph the
    TPU layout takes at wn); 'wide': sources anywhere, 600 more edges into
    window 1 (past the TPU's capacity of wn + 256) and the list shuffled —
    the TPU layout takes it only as one window of all nodes."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    if layout == "banded":
        dst = dst[(dst < 2 * wn) | (dst >= 3 * wn)]
        src = np.clip(dst + rng.integers(-30, 31, len(dst)), 0, n - 1)
    else:
        dst = np.concatenate([dst, rng.integers(wn, 2 * wn, 600)]).astype(np.int32)
        src = rng.integers(0, n, len(dst))
    edge = np.stack([src.astype(np.int32), dst], axis=1)
    mask = rng.random(len(dst)) < 0.85
    attr = rng.normal(size=(len(dst), 4)).astype(np.float32)
    if layout == "wide":
        perm = rng.permutation(len(dst))
        edge, mask, attr = edge[perm], mask[perm], attr[perm]
    plan = edge_window_plan(edge, mask, attr, n, wn=wn)
    port_ew = tuple(plan[k] for k in EW_KEYS) + (wn,)
    # the JAX plan wants dst-sorted edges; stable, so per-node order holds
    o = np.argsort(edge[:, 1], kind="stable")
    jplan = (jax_ew_plan(edge[o], mask[o], attr[o], n, wn=wn)
             if layout == "banded"
             else jax_ew_plan(edge[o], mask[o], attr[o], n, wn=n, eb=len(o)))
    assert jplan is not None
    jax_ew_args = tuple(jplan[k] for k in ("ew_src_rel", "ew_dst_loc",
                                           "ew_attr", "ew_maskf"))
    x = rng.normal(size=(n, ci)).astype(np.float32)
    w1 = (rng.normal(size=(2 * ci + 4, h)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(h, h)) * 0.3).astype(np.float32)
    sc1 = np.stack([rng.uniform(0.5, 1.5, h), rng.normal(size=h) * 0.1]
                   ).astype(np.float32)
    sc2 = np.stack([rng.uniform(0.5, 1.5, h), rng.normal(size=h) * 0.1]
                   ).astype(np.float32)
    return x, port_ew, jax_ew_args, (w1, sc1, w2, sc2)


def _port_ew(ew):
    return tuple(torch.from_numpy(a) for a in ew[:4]) + (ew[4],)


def _torch_ew(x, ew, w, dtype):
    w1, sc1, w2, sc2 = (torch.from_numpy(a) for a in w)
    return edge_window_message_sum_plain(
        torch.from_numpy(x).to(dtype), _port_ew(ew), w1.to(dtype), sc1,
        w2.to(dtype), sc2).numpy()


def _jax_args(x, jew, w, dtype):
    jdt = jnp.dtype(dtype)
    w1, sc1, w2, sc2 = w
    return (jnp.asarray(x, jdt), tuple(map(jnp.asarray, jew)),
            jnp.asarray(w1, jdt), jnp.asarray(sc1), jnp.asarray(w2, jdt),
            jnp.asarray(sc2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ci", [5, 64])
def test_edge_window_plain_matches_pallas(ci, dtype):
    x, ew, jew, w = _ew_inputs(ci, ci)
    want = np.asarray(jax_ew(*_jax_args(x, jew, w, dtype), interpret=True))
    got = _torch_ew(x, ew, w, getattr(torch, dtype))
    assert got.dtype == np.float32
    assert_close(got, want, dtype, 2e-3)
    # the node rows of the edge-free window are exactly 0
    assert (got[256:384] == 0).all() and (want[256:384] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["banded", "wide"])
def test_edge_window_plain_matches_reference(layout, dtype):
    x, ew, jew, w = _ew_inputs(11, 16, layout=layout)
    want = np.asarray(edge_window_message_sum_reference(
        *_jax_args(x, jew, w, dtype)))
    got = _torch_ew(x, ew, w, getattr(torch, dtype))
    assert_close(got, want, dtype, 1e-2)


def _bm_inputs(seed, n=1024, ci=24, h=256):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, ci)).astype(np.float32)
    w = (rng.normal(size=(ci, h)) * 0.3).astype(np.float32)
    sc = np.stack([rng.uniform(0.5, 1.5, h), rng.normal(size=h) * 0.1]
                  ).astype(np.float32)
    mask = rng.random(n) < 0.8
    mask[:16] = False  # two fully masked blocks
    return x, mask.astype(np.float32)[:, None], w, sc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_max2_plain_matches_pallas(dtype):
    x, m, w, sc = _bm_inputs(0)
    jdt = jnp.dtype(dtype)
    wh, wx = jax_bm2(jnp.asarray(x, jdt), jnp.asarray(m), jnp.asarray(w, jdt),
                     jnp.asarray(sc), interpret=True)
    tdt = getattr(torch, dtype)
    gh, gx = folded_mlp_block_max2_plain(torch.from_numpy(x).to(tdt),
                                         torch.from_numpy(m),
                                         torch.from_numpy(w).to(tdt),
                                         torch.from_numpy(sc))
    assert gh.dtype == gx.dtype == tdt
    gh, gx = gh.float().numpy(), gx.float().numpy()
    wh, wx = np.asarray(wh, np.float32), np.asarray(wx, np.float32)
    rtol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(gh, wh, rtol=rtol, atol=1e-5)
    np.testing.assert_array_equal(gx, wx)  # a max of copied values: exact
    assert (gh[:2] <= -1e30 / 2).all() and (gx[:2] <= -1e30 / 2).all()


def test_cpu_tensors_take_the_plain_versions():
    """The wrappers route CPU tensors to the plain versions and count no
    kernel launch."""
    _build.reset_launch_counts()
    x, ew, _, w = _ew_inputs(2, 5)
    t = torch.from_numpy
    args = (t(x), _port_ew(ew)) + tuple(t(a) for a in w)
    assert torch.equal(edge_window_message_sum(*args),
                       edge_window_message_sum_plain(*args))
    bx, bm, bw, bsc = (t(a) for a in _bm_inputs(1))
    for a, b in zip(folded_mlp_block_max2(bx, bm, bw, bsc),
                    folded_mlp_block_max2_plain(bx, bm, bw, bsc)):
        assert torch.equal(a, b)
    bh = folded_mlp_block_max(bx, bm, bw, bsc)
    assert torch.equal(bh, folded_mlp_block_max_plain(bx, bm, bw, bsc))
    gp_b = torch.ones_like(bh, dtype=torch.float32)
    for a, b in zip(fused_pool_train_bwd(bx, bm, bw, bsc, bh, gp_b),
                    fused_pool_train_bwd_plain(bx, bm, bw, bsc, bh, gp_b)):
        assert torch.equal(a, b)
    assert {"edge_window_message_sum", "folded_mlp_block_max2",
            "folded_mlp_block_max", "fused_pool_train_bwd"
            } <= set(_build.launch_counts)
    assert not any(_build.launch_counts.values())
