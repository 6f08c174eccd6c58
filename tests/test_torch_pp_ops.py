"""Kernels 5 and 6 of the port (the plain versions, which CPU tensors take)
against yolat_tpu's banded kernels in interpret mode, its jnp oracles and a
float64 gather oracle, on the same seeded inputs.

Tolerances: f32 sums differ from the float64 oracle and from the Pallas
interpreter by summation order only: 1e-5 of the output's scale (the JAX
package's own test, tests/test_banded.py, allows 2e-4). At bf16 the port
rounds where the TPU kernel rounds (each endpoint product and h to bf16,
sums in f32), so its sum is held to the float64 sum of the same rounded
terms at 1e-6 of scale; against the interpreter, which rounds partial
sums too, at 2 bf16 ulps of scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.ops.banded_message import (
    banded_message_sum as jax_sum, banded_message_sum_both as jax_both,
    banded_message_sum_both_reference as jax_both_ref,
    banded_message_sum_reference as jax_ref, banded_plan as jax_plan,
    bm_of as jax_bm_of)
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.banded_message import (banded_message_sum,
                                                banded_message_sum_both,
                                                message_rows_plain,
                                                plan_tensors)
from yolat_tpu_torch.ops.plans import banded_plan

N, WN, PAD, EBLK, C, H = 2048, 512, 128, 256, 64, 64


def _clique_family(rng, n=N, wn=WN, n_cliques=40, max_m=18, pad_e=8192):
    """Skewed clique edges over contiguous node runs, the super-edge
    shape, and an edge-free last window (tests/test_banded.py)."""
    edges, lo = [], 0
    for _ in range(n_cliques):
        m = int(rng.integers(2, max_m))
        lo = int(rng.integers(lo, lo + 40))
        if lo + m >= n - wn:
            break
        ids = np.arange(lo, lo + m)
        src, dst = np.meshgrid(ids, ids)
        keep = src != dst
        edges.append(np.stack([src[keep], dst[keep]], axis=1))
        lo += m
    e = np.concatenate(edges).astype(np.int32)
    edge = np.zeros((pad_e, 2), np.int32)
    mask = np.zeros(pad_e, bool)
    edge[:len(e)] = e
    mask[:len(e)] = True
    attr = rng.normal(size=(pad_e, 4)).astype(np.float32)
    attr[~mask] = 0.0
    return edge, mask, attr


def _weights(rng):
    w = {k: (rng.normal(size=s) * 0.2).astype(np.float32) for k, s in (
        ("w_own", (C, H)), ("w_halo", (C, H)), ("w_attr", (4, H)),
        ("w2", (H, H)))}
    for k in ("sc1", "sc2"):
        w[k] = np.stack([rng.uniform(0.5, 1.5, H),
                         rng.normal(size=H) * 0.1]).astype(np.float32)
    return w


def _oracle(x, edge, mask, attr, sortby, w, two_stage):
    """float64 gather / scatter of the definition."""
    e, a = edge[mask], attr[mask].astype(np.float64)
    own, oth = e[:, sortby], e[:, 1 - sortby]
    x = x.astype(np.float64)
    pre = x[own] @ w["w_own"] + x[oth] @ w["w_halo"] + a @ w["w_attr"]
    h = np.maximum(pre * w["sc1"][0] + w["sc1"][1], 0.0)
    if two_stage:
        h = np.maximum((h @ w["w2"]) * w["sc2"][0] + w["sc2"][1], 0.0)
    out = np.zeros((x.shape[0], H))
    oth_out = np.zeros((x.shape[0], H))
    np.add.at(out, own, h)
    np.add.at(oth_out, oth, h)
    return out, oth_out


def _jax_bm(edge, mask, attr, sortby):
    plan = jax_plan(edge, mask, attr, N, sortby=sortby, wn=WN, pad=PAD,
                    eblk=EBLK)
    assert plan is not None
    return jax_bm_of({**{k: jnp.asarray(v) for k, v in plan.items()},
                      "pos": jnp.zeros((N, 2))}, "")


def _setup(seed, sortby, transpose=False):
    rng = np.random.default_rng(seed)
    edge, mask, attr = _clique_family(rng)
    x = rng.normal(size=(N, C)).astype(np.float32)
    w = _weights(rng)
    bm = plan_tensors(banded_plan(edge, mask, attr, N, sortby=sortby),
                      transpose=transpose)
    return edge, mask, attr, x, w, bm


def _args(w, two_stage, conv):
    names = ("w_own", "w_halo", "w_attr", "sc1") + (
        ("w2", "sc2") if two_stage else ())
    return [conv(w[k]) for k in names]


@pytest.mark.parametrize("sortby", [1, 0])
@pytest.mark.parametrize("two_stage", [False, True])
def test_plain_kernel5_matches_jax_f32(sortby, two_stage):
    edge, mask, attr, x, w, bm = _setup(5, sortby)
    launched = dict(_build.launch_counts)
    got = banded_message_sum(torch.from_numpy(x), bm,
                             *_args(w, two_stage, torch.from_numpy)).numpy()
    assert _build.launch_counts == launched  # CPU tensors: the plain version
    want, _ = _oracle(x, edge, mask, attr, sortby, w, two_stage)
    scale = np.abs(want).max()
    assert scale > 1.0
    jbm = _jax_bm(edge, mask, attr, sortby)
    kern = np.asarray(jax_sum(jnp.asarray(x), jbm,
                              *_args(w, two_stage, jnp.asarray),
                              interpret=True))
    ref = np.asarray(jax_ref(jnp.asarray(x), jbm,
                             *_args(w, two_stage, jnp.asarray)))
    for other in (want, kern, ref):
        np.testing.assert_allclose(got, other, rtol=1e-5, atol=1e-5 * scale)
    # rows without an edge are exact zeros
    empty = np.bincount(edge[mask][:, sortby], minlength=N) == 0
    assert empty.any() and not got[empty].any()


@pytest.mark.parametrize("sortby", [1, 0])
@pytest.mark.parametrize("two_stage", [False, True])
def test_plain_kernel5_bf16_is_the_float64_sum_of_its_terms(sortby, two_stage):
    edge, mask, attr, x, w, bm = _setup(7, sortby)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    args = _args(w, two_stage, lambda a: torch.from_numpy(a).to(torch.bfloat16))
    got = banded_message_sum(xb, bm, *args)
    assert got.dtype == torch.float32
    rows, own, _ = message_rows_plain(xb, bm, *args)
    # every term is a bf16 value
    assert torch.equal(rows, rows.to(torch.bfloat16).float())
    want = torch.zeros(N, H, dtype=torch.float64).index_add_(
        0, own, rows.double())
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= 1e-6 * scale
    # the interpreter rounds bf16 partial sums as well: 2 ulps of scale
    jbm = _jax_bm(edge, mask, attr, sortby)
    kern = np.asarray(jax_sum(
        jnp.asarray(x).astype(jnp.bfloat16), jbm,
        *_args(w, two_stage, lambda a: jnp.asarray(a).astype(jnp.bfloat16)),
        interpret=True), np.float32)
    assert np.abs(got.numpy() - kern).max() <= 2 * 2.0 ** -8 * scale
    # and the f32 definition is within bf16's reach of it
    f64, _ = _oracle(x, edge, mask, attr, sortby, w, two_stage)
    assert np.abs(got.numpy() - f64).max() <= 0.03 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_kernel6_equals_two_pass(dtype):
    edge, mask, attr, x, w, bm = _setup(11, 1, transpose=True)
    xt = torch.from_numpy(x).to(dtype)
    args = _args(w, False, lambda a: torch.from_numpy(a).to(dtype))
    own_sum, oth_sum = banded_message_sum_both(xt, bm, *args)
    # the own endpoint's sum is kernel 5's, bit for bit
    assert torch.equal(own_sum, banded_message_sum(xt, bm, *args))
    # the other endpoint's: kernel 5 over the src-sorted plan, own and
    # other weights swapped; the same terms in another order
    bm_s = plan_tensors(banded_plan(edge, mask, attr, N, sortby=0))
    two = banded_message_sum(xt, bm_s, args[1], args[0], args[2], args[3])
    scale = float(two.abs().max())
    assert float((oth_sum - two).abs().max()) <= 1e-5 * scale
    if dtype == torch.float32:
        want_own, want_oth = _oracle(x, edge, mask, attr, 1, w, False)
        np.testing.assert_allclose(own_sum.numpy(), want_own, rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(oth_sum.numpy(), want_oth, rtol=1e-5,
                                   atol=1e-5 * scale)
        jbm = _jax_bm(edge, mask, attr, 1)
        jargs = _args(w, False, jnp.asarray)
        for fn, kw in ((jax_both, {"interpret": True}), (jax_both_ref, {})):
            jo, jt = fn(jnp.asarray(x), jbm, *jargs, **kw)
            np.testing.assert_allclose(own_sum.numpy(), np.asarray(jo),
                                       rtol=1e-5, atol=1e-5 * scale)
            np.testing.assert_allclose(oth_sum.numpy(), np.asarray(jt),
                                       rtol=1e-5, atol=1e-5 * scale)


def test_empty_family_and_band_violation():
    """An empty family gives zeros; an edge across the whole batch, for
    which the JAX package has no plan, is summed like any other."""
    rng = np.random.default_rng(2)
    w = _weights(rng)
    args = _args(w, False, torch.from_numpy)
    x = torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32))
    edge = np.zeros((256, 2), np.int32)
    attr = np.zeros((256, 4), np.float32)
    bm = plan_tensors(banded_plan(edge, np.zeros(256, bool), attr, N),
                      transpose=True)
    assert bm.n_edges == 0
    assert not banded_message_sum(x, bm, *args).any()
    assert not any(t.any() for t in banded_message_sum_both(x, bm, *args))
    edge = np.array([[0, N - 1], [N - 1, 0], [5, 6]], np.int32)
    mask = np.ones(3, bool)
    attr = rng.normal(size=(3, 4)).astype(np.float32)
    assert jax_plan(edge, mask, attr, N, wn=WN, pad=PAD) is None
    got = banded_message_sum(
        x, plan_tensors(banded_plan(edge, mask, attr, N)), *args).numpy()
    want, _ = _oracle(x.numpy(), edge, mask, attr, 1, w, False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (np.abs(got).sum(1) > 0).sum() == 3


def test_wrappers_route_by_device():
    """CPU tensors take the plain version, any device but cuda raises, and
    kernel 6 refuses a plan without its transpose."""
    *_, x, w, bm = _setup(3, 1)
    args = _args(w, False, torch.from_numpy)
    meta = torch.empty(N, C, device="meta")
    with pytest.raises(ValueError, match="no route"):
        banded_message_sum(meta, bm, *args)
    with pytest.raises(ValueError, match="no route"):
        banded_message_sum_both(meta, bm, *args)
    assert bm.tperm is None
    out = banded_message_sum_both(torch.from_numpy(x), bm, *args)
    assert out[0].shape == out[1].shape == (N, H)
