"""Kernels 7 and 8 of the port with their backwards (the plain versions,
which CPU tensors take) against yolat_tpu's `banded_gather` and
`banded_scatter_own` in interpret mode and against its jnp oracles, on the
same seeded inputs; the plan's transpose; the packer's `sew_plan` option.

The two plans order their rows differently: yolat_tpu's lays the edges out
in blocks of 256 rows per 512-node window with masked padding rows, the
port's holds the real edges sorted by `own`. The clique family has no
repeated (own, other) pair, so per-edge rows are compared through that
pair, and per-node sums and gradients of x directly.

Tolerances, as tests/test_banded_train.py holds the JAX kernels to their
oracles: forward values rtol/atol 1e-6 for the gathers (copies) and 1e-5
for the sums (another f32 order), gradients 2e-4. At bf16 the port rounds
where the TPU kernel rounds (terms in bf16, sums in f32), so a sum is held
to the float64 sum of the same bf16 terms: 1e-6 of scale for the f32
output of kernel 8, one bf16 rounding (2^-8 relative) for kernel 7's
backward, which rounds its sum once. The Pallas interpreter is not the
oracle at bf16 (it rounds partial sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.ops.banded_message import banded_plan as jax_plan
from yolat_tpu.ops.banded_message import bm_of as jax_bm_of
from yolat_tpu.ops.banded_train import (_plan_indices,
                                        banded_gather as jax_gather,
                                        banded_gather_reference,
                                        banded_scatter_own as jax_scatter,
                                        banded_scatter_reference)
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader, train_plans_for
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops import banded_train as bt
from yolat_tpu_torch.ops.banded_message import plan_tensors
from yolat_tpu_torch.ops.plans import (SEW_KEYS, SEW_TRAIN_KEYS, banded_plan,
                                       bm_of)

from tests.test_torch_pp_ops import C, EBLK, N, PAD, WN, _clique_family


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    edge, mask, attr = _clique_family(rng, pad_e=6144)
    jp = jax_plan(edge, mask, attr, N, sortby=1, wn=WN, pad=PAD, eblk=EBLK)
    assert jp is not None
    jbm = jax_bm_of({**{k: jnp.asarray(v) for k, v in jp.items()},
                     "pos": jnp.zeros((N, 2))}, "")
    bm = plan_tensors(banded_plan(edge, mask, attr, N, transpose=True))
    x = rng.normal(size=(N, C)).astype(np.float32)
    # the JAX plan's rows -> the port's rows, through the (own, other) pair
    j_own, j_oth, j_m = (np.asarray(a) for a in _plan_indices(jbm, N))
    real = j_m > 0
    key = bm.own.numpy().astype(np.int64) * N + bm.oth.numpy()
    assert len(np.unique(key)) == len(key) == int(real.sum()) == int(mask.sum())
    order = np.argsort(key)
    jkey = j_own[real].astype(np.int64) * N + j_oth[real]
    to_port = order[np.searchsorted(key[order], jkey)]  # per real JAX row
    assert np.array_equal(key[to_port], jkey)
    return dict(bm=bm, jbm=jbm, x=x, real=real, to_port=to_port,
                rows_jax=real.shape[0])


def _to_jax_rows(setup, rows):
    """Port-order per-edge rows [E, C] -> the JAX block layout (masked rows
    zero)."""
    out = np.zeros((setup["rows_jax"], rows.shape[1]), rows.dtype)
    out[setup["real"]] = rows[setup["to_port"]]
    return out


def test_plan_transpose_is_the_rows_sorted_by_the_other_endpoint(setup):
    bm = setup["bm"]
    own, oth = bm.own.numpy(), bm.oth.numpy()
    tperm, tptr = bm.tperm.numpy(), bm.tptr.numpy()
    assert np.all(np.diff(own) >= 0)
    assert np.array_equal(tperm, np.argsort(oth, kind="stable"))
    assert tptr[0] == 0 and tptr[-1] == len(oth) and len(tptr) == N + 1
    for v in (0, int(oth[0]), int(oth.max()), N - 1):
        run = tperm[tptr[v]:tptr[v + 1]]
        assert np.array_equal(np.sort(run), np.flatnonzero(oth == v))
        assert np.all(np.diff(run) > 0)  # ascending rows: a fixed order
    plain = banded_plan(*_clique_family(np.random.default_rng(7), pad_e=6144),
                        N)
    assert "tperm" not in plain and "tptr" not in plain


def test_gather_forward_matches_jax(setup):
    bm, x = setup["bm"], setup["x"]
    x_own, x_oth = bt.banded_gather(torch.from_numpy(x), bm)
    assert x_own.dtype == torch.float32 and x_own.shape == (bm.n_edges, C)
    for fn in (lambda: jax_gather(jnp.asarray(x), setup["jbm"], True),
               lambda: banded_gather_reference(jnp.asarray(x), setup["jbm"])):
        w_own, w_oth = (np.asarray(a) for a in fn())
        assert not w_own[~setup["real"]].any()  # masked rows are zero
        np.testing.assert_allclose(_to_jax_rows(setup, x_own.numpy()), w_own,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_to_jax_rows(setup, x_oth.numpy()), w_oth,
                                   rtol=1e-6, atol=1e-6)
    assert np.array_equal(x_own.numpy(), x[bm.own.numpy()])  # a copy: exact
    assert np.array_equal(x_oth.numpy(), x[bm.oth.numpy()])


def test_scatter_own_forward_matches_jax(setup):
    bm = setup["bm"]
    rows = np.random.default_rng(1).normal(size=(bm.n_edges, C)).astype(
        np.float32)
    got = bt.banded_scatter_own(torch.from_numpy(rows), bm, N)
    assert got.dtype == torch.float32 and got.shape == (N, C)
    jrows = jnp.asarray(_to_jax_rows(setup, rows))
    for want in (jax_scatter(jrows, setup["jbm"], N, True),
                 banded_scatter_reference(jrows, setup["jbm"], N)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert np.abs(got.numpy()).max() > 1.0


def test_gather_grad_matches_jax(setup):
    """The gradient of x through both endpoint gathers: both sums of the
    backward, the other-endpoint one through the transpose."""
    bm, x = setup["bm"], setup["x"]
    w = (np.random.default_rng(2).normal(size=(C, 8)) * 0.1).astype(np.float32)

    def jloss(gather):
        def f(xx):
            o, t = gather(xx)
            return (jnp.sum(jnp.tanh(o @ w)) + jnp.sum(jnp.tanh((t - o) @ w)))
        return f

    xt = torch.from_numpy(x).requires_grad_(True)
    o, t = bt.banded_gather(xt, bm)
    wt = torch.from_numpy(w)
    (torch.tanh(o @ wt).sum() + torch.tanh((t - o) @ wt).sum()).backward()
    for gather in (lambda xx: jax_gather(xx, setup["jbm"], True),
                   lambda xx: banded_gather_reference(xx, setup["jbm"])):
        want = jax.grad(jloss(gather))(jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
    assert np.abs(xt.grad.numpy()).max() > 0.1


def test_scatter_own_grad_matches_jax(setup):
    bm = setup["bm"]
    rows = np.random.default_rng(3).normal(size=(bm.n_edges, C)).astype(
        np.float32)
    rt = torch.from_numpy(rows).requires_grad_(True)
    torch.tanh(bt.banded_scatter_own(rt, bm, N)).sum().backward()
    jrows = jnp.asarray(_to_jax_rows(setup, rows))
    for scatter in (lambda r: jax_scatter(r, setup["jbm"], N, True),
                    lambda r: banded_scatter_reference(r, setup["jbm"], N)):
        want = np.asarray(jax.grad(
            lambda r: jnp.sum(jnp.tanh(scatter(r))))(jrows))
        np.testing.assert_allclose(_to_jax_rows(setup, rt.grad.numpy()),
                                   want, rtol=2e-4, atol=2e-4)


def test_end_to_end_conv_slice_grad_matches_jax(setup):
    """gather -> MLP -> sum -> mean + skip, as tests/test_banded_train.py
    chains them: the gradients of both weight matrices."""
    bm, x = setup["bm"], setup["x"]
    rng = np.random.default_rng(4)
    w1 = (rng.normal(size=(2 * C, 32)) * 0.1).astype(np.float32)
    wr = (rng.normal(size=(C, 32)) * 0.1).astype(np.float32)
    cnt = np.maximum(np.bincount(bm.own.numpy(), minlength=N), 1).astype(
        np.float32)

    def jnet(params):
        a, b = params
        o, t = jax_gather(jnp.asarray(x), setup["jbm"], True)
        h = jnp.maximum(jnp.concatenate([o, t - o], axis=1) @ a, 0.0)
        s = jax_scatter(h, setup["jbm"], N, True)
        return jnp.sum(jnp.tanh(s / jnp.asarray(cnt)[:, None]
                                + jnp.asarray(x) @ b))

    want = jax.grad(jnet)((jnp.asarray(w1), jnp.asarray(wr)))
    a = torch.from_numpy(w1).requires_grad_(True)
    b = torch.from_numpy(wr).requires_grad_(True)
    xt = torch.from_numpy(x)
    o, t = bt.banded_gather(xt, bm)
    h = torch.relu(torch.cat([o, t - o], dim=1) @ a)
    s = bt.banded_scatter_own(h, bm, N)
    torch.tanh(s / torch.from_numpy(cnt)[:, None] + xt @ b).sum().backward()
    for got, w in zip((a.grad, b.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=3e-4,
                                   atol=3e-4)


def test_bf16_sums_match_the_float64_sum_of_the_same_terms(setup):
    bm = setup["bm"]
    rng = np.random.default_rng(5)
    own, oth = bm.own.numpy(), bm.oth.numpy()

    def bf16(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(torch.bfloat16)

    rows, g_own, g_oth = (bf16((bm.n_edges, C)) for _ in range(3))
    got = bt.scatter_own_fwd(rows, bm.own, bm.nptr, N)
    want = np.zeros((N, C))
    np.add.at(want, own, rows.double().numpy())
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()

    dx = bt.gather_bwd(g_own, g_oth, bm.own, bm.oth, bm.nptr, bm.tperm,
                       bm.tptr, N)
    want = np.zeros((N, C))
    np.add.at(want, own, g_own.double().numpy())
    np.add.at(want, oth, g_oth.double().numpy())
    assert dx.dtype == torch.bfloat16
    assert np.all(np.abs(dx.double().numpy() - want)
                  <= 2.0 ** -8 * np.abs(want) + 1e-6)
    assert np.abs(want).max() > 4.0

    # the gathers at bf16: copies, and one rounding of the f32 cotangent
    x = bf16((N, C))
    x_own, x_oth = bt.gather_fwd(x, bm.own, bm.oth)
    assert x_own.dtype == torch.bfloat16
    assert torch.equal(x_own, x[bm.own.long()])
    assert torch.equal(x_oth, x[bm.oth.long()])
    g = torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32))
    d_rows = bt.scatter_own_bwd(g, bm.own, torch.bfloat16)
    assert torch.equal(d_rows, g.to(torch.bfloat16)[bm.own.long()])
    # through the Functions the cotangents come back in the inputs' types
    xt = x.clone().requires_grad_(True)
    a, b = bt.banded_gather(xt, bm)
    rt = rows.clone().requires_grad_(True)
    total = bt.banded_scatter_own(rt, bm, N)
    (a.float().sum() + 2 * b.float().sum() + total.sum()).backward()
    assert xt.grad.dtype == rt.grad.dtype == torch.bfloat16
    assert torch.equal(xt.grad, dx.new_tensor(
        np.bincount(own, minlength=N) + 2.0 * np.bincount(oth, minlength=N)
    )[:, None].expand(N, C))


def test_empty_family_for_all_four(setup):
    """E = 0: a batch without super edges."""
    edge = np.zeros((256, 2), np.int32)
    bm = plan_tensors(banded_plan(edge, np.zeros(256, bool),
                                  np.zeros((256, 4), np.float32), N,
                                  transpose=True))
    assert bm.n_edges == 0 and bm.tperm.shape == (0,)
    assert bm.tptr.shape == (N + 1,) and not bm.tptr.any()
    x = torch.from_numpy(setup["x"]).requires_grad_(True)
    x_own, x_oth = bt.banded_gather(x, bm)
    assert x_own.shape == x_oth.shape == (0, C)
    rows = torch.zeros(0, C, requires_grad=True)
    total = bt.banded_scatter_own(rows, bm, N)
    assert total.shape == (N, C) and not total.any()
    (x_own.sum() + x_oth.sum() + total.sum()).backward()
    assert x.grad.shape == (N, C) and not x.grad.any()
    assert rows.grad.shape == (0, C)
    assert not bt.gather_bwd(x_own.detach(), x_oth.detach(), bm.own, bm.oth,
                             bm.nptr, bm.tperm, bm.tptr, N).any()
    assert bt.scatter_own_bwd(torch.ones(N, C), bm.own,
                              torch.float32).shape == (0, C)


def test_wrappers_take_the_plain_route_on_the_cpu_and_check_the_plan(setup):
    bm, x = setup["bm"], torch.from_numpy(setup["x"])
    _build.reset_launch_counts()
    bt.banded_gather(x, bm)
    bt.banded_scatter_own(torch.zeros(bm.n_edges, C), bm, N)
    assert not any(_build.launch_counts.values())  # CPU: plain versions
    no_t = plan_tensors(banded_plan(
        *_clique_family(np.random.default_rng(7), pad_e=6144), N))
    bt.banded_gather(x, no_t)  # forward only
    with pytest.raises(ValueError, match="transpose"):
        bt.banded_gather(x.clone().requires_grad_(True), no_t)
    by_src = plan_tensors(banded_plan(
        *_clique_family(np.random.default_rng(7), pad_e=6144), N, sortby=0))
    permuted = type(by_src)(by_src[:3] + (by_src.own,) + by_src[4:])
    with pytest.raises(ValueError, match="sorted in place"):
        bt.banded_gather(x, permuted)
    with pytest.raises(ValueError, match="no route"):
        bt.gather_fwd(x.to("meta"), bm.own, bm.oth)


@pytest.mark.parametrize("sew_plan", ["none", "own", "transpose"])
def test_packer_sew_plan_option(synthetic_root, sew_plan):
    """The train loader's plans: the clique family's plan only where the
    step reads it, with its transpose for the banded route; every other key
    is what a serving batch holds, byte for byte."""
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    base = next(iter(PackedLoader(ds, batch_size=2, prefetch=0,
                                  super_family=True)))
    got = next(iter(PackedLoader(ds, batch_size=2, prefetch=0,
                                 super_family=True, sew_plan=sew_plan)))
    sew = {k for k in got if k.startswith("sew_")}
    want = {"none": set(), "own": set(SEW_KEYS),
            "transpose": set(SEW_KEYS) | set(SEW_TRAIN_KEYS)}[sew_plan]
    assert sew == want
    assert set(base) - set(SEW_KEYS) == set(got) - sew
    for k in set(got) & set(base):
        np.testing.assert_array_equal(got[k], base[k], err_msg=k)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in got.items()
          if np.asarray(v).ndim}
    bm = bm_of(tb, "sew_")
    if sew_plan == "none":
        assert bm is None
    else:
        assert (bm.tperm is not None) == (sew_plan == "transpose")
        assert bm.n_edges == int(got["super_mask"].sum())
    # what the trainer asks of its train loader
    assert train_plans_for(Config()) == {}
    assert train_plans_for(Config(arch="yolat_pp")) == {
        "super_family": True, "sew_plan": "none"}
    assert train_plans_for(Config(arch="yolat_pp", pp_banded_super=True)) == {
        "super_family": True, "sew_plan": "transpose"}
    with pytest.raises(ValueError, match="sew_plan"):
        next(iter(PackedLoader(ds, batch_size=2, prefetch=0,
                               super_family=True, sew_plan="both")))
