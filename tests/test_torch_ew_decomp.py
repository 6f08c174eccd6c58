"""The edge-window decomposition probe (kernel 12): the plain versions of
`ops.edge_window.edge_window_decomp` against the JAX Pallas kernel in
interpret mode, and the probe's entry point on the CPU.

The JAX probe (`scripts/ew_kernel_decomp.py`) builds its variants inside
`main` on the TPU, so the variants are held to what they compute:
  * full: kernel 1's function; the JAX kernel run as the probe runs it,
    four windows per grid step (`gsz = 4`, :33).
  * noband: the probe sets `ohs = ohl` (:61-62) and contracts it with the
    own window (:67-69), so x_j = x_i: kernel 1's function over the same
    edges with src := dst, which the JAX kernel computes over the JAX plan
    of those edges.
  * noonehot: the probe's constant one-hot matrices (:58-60) make x_i and
    x_j 0.001-scaled window sums on the TPU; the port's variant reads x_i =
    x_j = 0.001 in x's type (a stated difference): kernel 1's plain
    version on x filled with 0.001, bit for bit.

Tolerances as tests/test_torch_kernels_plain.py:107-115: f32 rtol/atol
1e-5 (another summation order); bf16 max error <= 2e-3 * max|out| (both
round at the TPU kernel's points, and another f32 order can flip one bf16
rounding of h1 or h2).
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.ops.edge_window import edge_window_message_sum as jax_ew
from yolat_tpu.ops.edge_window import edge_window_plan as jax_ew_plan
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.edge_window import (VARIANTS, decomp_inputs,
                                             edge_window_decomp,
                                             edge_window_decomp_plain,
                                             edge_window_message_sum_plain)
from yolat_tpu_torch.ops.plans import EW_KEYS, edge_window_plan
from yolat_tpu_torch.scripts import ew_kernel_decomp

N, WN, H = 512, 128, 64


def _inputs(seed, ci):
    """Edges with sources within 30 rows of their dst (inside the TPU
    layout's 3-window band), 85% of them real; x and folded weights."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, N, 700)).astype(np.int32)
    src = np.clip(dst + rng.integers(-30, 31, len(dst)), 0, N - 1)
    edge = np.stack([src.astype(np.int32), dst], axis=1)
    mask = rng.random(len(dst)) < 0.85
    attr = rng.normal(size=(len(dst), 4)).astype(np.float32)
    x = rng.normal(size=(N, ci)).astype(np.float32)
    w = ((rng.normal(size=(2 * ci + 4, H)) * 0.3).astype(np.float32),
         np.stack([rng.uniform(0.5, 1.5, H), rng.normal(size=H) * 0.1]
                  ).astype(np.float32),
         (rng.normal(size=(H, H)) * 0.3).astype(np.float32),
         np.stack([rng.uniform(0.5, 1.5, H), rng.normal(size=H) * 0.1]
                  ).astype(np.float32))
    return x, edge, mask, attr, w


def _port(x, edge, mask, attr, w, dtype):
    plan = edge_window_plan(edge, mask, attr, N, wn=WN)
    ew = tuple(torch.from_numpy(plan[k]) for k in EW_KEYS) + (WN,)
    w1, sc1, w2, sc2 = (torch.from_numpy(a) for a in w)
    return torch.from_numpy(x).to(dtype), ew, (w1.to(dtype), sc1, w2.to(dtype), sc2)


def _jax(x, edge, mask, attr, w, dtype, group=None):
    jplan = jax_ew_plan(edge, mask, attr, N, wn=WN)
    assert jplan is not None
    jew = tuple(jnp.asarray(jplan[k]) for k in ("ew_src_rel", "ew_dst_loc",
                                                "ew_attr", "ew_maskf"))
    jdt = jnp.dtype(dtype)
    w1, sc1, w2, sc2 = w
    return np.asarray(jax_ew(jnp.asarray(x, jdt), jew, jnp.asarray(w1, jdt),
                             jnp.asarray(sc1), jnp.asarray(w2, jdt),
                             jnp.asarray(sc2), interpret=True, group=group))


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(got - want).max()
        assert err <= 2e-3 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ci", [5, 64])
def test_full_is_kernel1_and_matches_pallas(ci, dtype):
    x, edge, mask, attr, w = _inputs(ci, ci)
    px, ew, pw = _port(x, edge, mask, attr, w, getattr(torch, dtype))
    got = edge_window_decomp(px, ew, *pw, "full")
    assert torch.equal(got, edge_window_message_sum_plain(px, ew, *pw))
    _close(got.numpy(), _jax(x, edge, mask, attr, w, dtype, group=4), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ci", [5, 64])
def test_noband_matches_pallas_with_src_as_dst(ci, dtype):
    x, edge, mask, attr, w = _inputs(10 + ci, ci)
    px, ew, pw = _port(x, edge, mask, attr, w, getattr(torch, dtype))
    got = edge_window_decomp(px, ew, *pw, "noband")
    own = edge.copy()
    own[:, 0] = edge[:, 1]
    _close(got.numpy(), _jax(x, own, mask, attr, w, dtype), dtype)
    # the source rows matter: full differs
    assert not torch.equal(got, edge_window_decomp(px, ew, *pw, "full"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noonehot_is_full_on_constant_x(dtype):
    _build.reset_launch_counts()
    x, edge, mask, attr, w = _inputs(20, 64)
    px, ew, pw = _port(x, edge, mask, attr, w, dtype)
    got = edge_window_decomp(px, ew, *pw, "noonehot")
    c = torch.full_like(px, 0.001)
    assert c.dtype == dtype and c[0, 0].item() == torch.tensor(
        0.001, dtype=torch.float32).to(dtype).item()
    assert torch.equal(got, edge_window_decomp_plain(c, ew, *pw, "full"))
    assert torch.equal(decomp_inputs(px, ew, "noonehot")[0], c)
    # no row of x is read: any x gives the same output
    assert torch.equal(got, edge_window_decomp(-px, ew, *pw, "noonehot"))
    with pytest.raises(ValueError):
        edge_window_decomp(px, ew, *pw, "nogather")
    assert not any(_build.launch_counts.values())


def test_probe_main_on_the_cpu(capsys):
    res = ew_kernel_decomp.main(["--device", "cpu", "--n_svgs", "1",
                                 "--batch_size", "1", "--reps", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res
    assert res["wn"] == 256 and res["C"] == 64
    assert res["nw"] == -(-res["N"] // 256) and 0 < res["E"]
    for v in VARIANTS:
        assert math.isfinite(res[f"{v}_us"]) and res[f"{v}_us"] > 0
        assert res[f"{v}_bound_us"] > 0
        assert res[f"{v}_bound_by"] in ("bytes", "operations")
    assert res["gather_src_us"] == res["full_us"] - res["noband_us"]
    assert res["gather_both_us"] == res["full_us"] - res["noonehot_us"]
    assert res["device"].startswith("cpu")
    assert "eb" not in res and "gsz" not in res
