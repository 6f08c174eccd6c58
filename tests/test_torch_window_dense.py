"""The port's window and dense conv layouts against yolat_tpu's on the CPU:
the plain versions of kernels 9, 10 and 4 against the Pallas kernels in
interpret mode, the conv layer and the whole model in each layout, and the
folded engine's dense route.

Inputs are made with numpy from a seed (or packed from the synthetic
dataset by each package's own host stage); weights start in JAX at width 16
and cross through `load_jax_variables`, once for all three layouts. The
port's edge rows are the real edges in dst order; the JAX window layout
holds the same rows, in the same order, among its padding rows
(`ew_maskf`), so the JAX side is read at, and fed cotangents on, its real
rows only. Every comparison first asserts that the JAX batch really has
its edge-window plan (or its dense table), since the JAX model silently
takes the sparse branch without one.

Tolerances:
  * kernels 9 and 10 at f32: copies, one subtraction and sums of at most a
    few terms in another order — rtol/atol 1e-6. At bf16 the gathers
    (kernel 9 forward, kernel 10 backward) are exact: copies and one
    rounded difference. The bf16 sums (kernel 9 backward, kernel 10
    forward) are held to the float64 sum of the same bf16 terms, rounded
    once, to one output ulp (2^-7 relative, floor 1e-6). Against the Pallas
    kernels they are held only to 2^-7 of each output's sum of |terms|:
    the interpreter's CPU contraction rounds its partial sums of bf16
    inputs to bf16, which a TPU's f32 accumulation does not (measured: it
    misses the float64 sum by up to an ulp of the largest term at 13% of
    the outputs; the port's plain version misses it nowhere).
  * kernel 4 at f32: sums in another order, rtol/atol 1e-5; at bf16 against
    the Pallas kernel, which rounds at the same points, a flipped rounding
    of s_i, h1 or h2 moves an output by a bf16 ulp of a term: max error <=
    2e-3 of max|out|; against `_reference`, which neither rounds s_i nor
    h2: 1e-2 of max|out|.
  * the conv layer and the model at f32: outputs and loss rtol 1e-5 / 1e-4;
    BN running statistics rtol 1e-4, atol 1e-5; gradients rtol 1e-3 with an
    absolute floor of 5e-3 of each tensor's scale (train-mode BN divides by
    batch deviations and amplifies summation-order noise; the floor of
    tests/test_torch_train.py), Dense biases that feed a BatchNorm (a
    structurally zero gradient) at atol 1e-4 under the model's mean loss,
    and at 1e-4 of the BN shift's gradient under the conv test's summed
    loss.
  * the engine's dense route: f32 logits rtol/atol 1e-4; bf16 max error <=
    3e-2 of max|logit| (as tests/test_torch_model.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.packing import finalize_batch as jax_finalize
from yolat_tpu.eval.fast_forward import fast_forward as jax_fast_forward
from yolat_tpu.eval.fast_forward import fold_params as jax_fold
from yolat_tpu.nn.conv import AttrEdgeGP2 as JaxConv
from yolat_tpu.nn.model import SparseCADGCN as JaxModel
from yolat_tpu.nn.model import detection_loss as jax_loss
from yolat_tpu.ops.edge_window import edge_window_plan as jax_ew_plan
from yolat_tpu.ops.edge_window import ew_of as jax_ew_of
from yolat_tpu.ops.edge_window_train import ew_pair_features as jax_pair
from yolat_tpu.ops.edge_window_train import \
    ew_window_segment_sum_n as jax_wsum
from yolat_tpu.ops.pallas_kernels import (fused_dense_message as jax_dense,
                                          fused_dense_message_reference)
from yolat_tpu.train.import_reference import export_state_dict
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.packing import (add_dense_neighbors, finalize_batch,
                                          to_device)
from yolat_tpu_torch.eval import fast_forward as ff
from yolat_tpu_torch.nn.model import (SparseCADGCN, detection_loss,
                                      load_jax_variables)
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops import edge_window_train as ewt
from yolat_tpu_torch.ops.dense_message import (fused_dense_message,
                                               fused_dense_message_plain)
from yolat_tpu_torch.ops.plans import (EW_TRAIN_KEYS, edge_window_plan,
                                       ew_train_of)

WIDTH = 16
DENSE_KEYS = ("nbr_idx", "nbr_attr", "nbr_mask")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors (under xdist the
    default pool per worker oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# kernels 9 and 10: plain versions against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------


def _graph(seed, n=512, wn=128, e=700):
    """A dst-sorted edge list both plans take: sources within 30 rows of
    their dst, window 2 without edges, 15% of the rows masked out."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    dst = dst[(dst < 2 * wn) | (dst >= 3 * wn)]
    src = np.clip(dst + rng.integers(-30, 31, len(dst)), 0, n - 1)
    edge = np.stack([src.astype(np.int32), dst], axis=1)
    mask = rng.random(len(dst)) < 0.85
    attr = rng.normal(size=(len(dst), 4)).astype(np.float32)
    plan = edge_window_plan(edge, mask, attr, n, wn=wn, transpose=True)
    port = tuple(torch.from_numpy(plan[k]) for k in
                 ("ew_src", "ew_dst") + EW_TRAIN_KEYS)
    jplan = jax_ew_plan(edge, mask, attr, n, wn=wn)
    assert jplan is not None
    jew = tuple(jnp.asarray(jplan[k]) for k in
                ("ew_src_rel", "ew_dst_loc", "ew_attr", "ew_maskf"))
    real = np.asarray(jplan["ew_maskf"]).reshape(-1) > 0
    assert real.sum() == mask.sum() == len(plan["ew_src"])
    return n, port, jew, real


def _assert_sums_close(got, want, dtype, terms):
    """A summed output against the Pallas kernel's and, at bf16, against
    the float64 sum of the same terms. terms: [(index [T], values [T, C])]
    as the kernel sums them into its output rows."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    exact, mag = np.zeros(got.shape), np.zeros(got.shape)
    for idx, vals in terms:
        np.add.at(exact, idx, vals.astype(np.float64))
        np.add.at(mag, idx, np.abs(vals.astype(np.float64)))
    np.testing.assert_allclose(got, exact, rtol=2.0 ** -7, atol=1e-6)
    assert (np.abs(got - want) <= 2.0 ** -7 * mag + 1e-6).all()


def _window_rows(rows, real):
    """Real edge rows [E, C] -> the JAX window layout [NW * EB, C]."""
    out = np.zeros((len(real), rows.shape[1]), np.float32)
    out[real] = rows
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ci", [5, 16])
def test_pair_features_plain_matches_pallas(ci, dtype):
    n, port, jew, real = _graph(ci)
    rng = np.random.default_rng(1)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    x = rng.normal(size=(n, ci)).astype(np.float32)
    dg = rng.normal(size=(int(real.sum()), 2 * ci)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jax_pair(v, jew, interpret=True),
                        jnp.asarray(x, jdt))
    (want_dx,) = vjp(jnp.asarray(_window_rows(dg, real), jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = ewt.ew_pair_features(xt, port)
    got.backward(torch.from_numpy(dg).to(tdt))
    assert got.dtype == tdt and xt.grad.dtype == tdt
    np.testing.assert_array_equal(
        got.detach().float().numpy(), np.asarray(want, np.float32)[real])
    dgq = torch.from_numpy(dg).to(tdt)
    d_xi = (dgq[:, :ci] - dgq[:, ci:]).float().numpy()
    _assert_sums_close(xt.grad.float().numpy(), want_dx, dtype,
                       [(port[1].numpy(), d_xi),
                        (port[0].numpy(), dgq[:, ci:].float().numpy())])
    assert np.abs(np.asarray(want_dx, np.float32)).max() > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 16])
def test_window_segment_sum_plain_matches_pallas(c, dtype):
    n, port, jew, real = _graph(3)
    rng = np.random.default_rng(2)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    h = rng.normal(size=(int(real.sum()), c)).astype(np.float32)
    g = rng.normal(size=(n, c)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jax_wsum(v, jew, n, interpret=True),
                        jnp.asarray(_window_rows(h, real), jdt))
    (want_dh,) = vjp(jnp.asarray(g))
    ht = torch.from_numpy(h).to(tdt).requires_grad_(True)
    got = ewt.ew_window_segment_sum_n(ht, port, n)
    got.backward(torch.from_numpy(g))
    assert got.dtype == torch.float32 and ht.grad.dtype == tdt
    _assert_sums_close(got.detach().numpy(), want, dtype,
                       [(port[1].numpy(), ht.detach().float().numpy())])
    np.testing.assert_array_equal(ht.grad.float().numpy(),
                                  np.asarray(want_dh, np.float32)[real])
    assert (got.detach().numpy()[256:384] == 0).all()  # the edge-free window


def test_window_ops_route_by_device():
    """CPU tensors take the plain versions and count no launch; other
    devices raise."""
    n, port, _, _ = _graph(4)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(n, 8)).astype(np.float32))
    _build.reset_launch_counts()
    g = ewt.ew_pair_features(x, port)
    assert torch.equal(g, ewt.pair_fwd_plain(x, port[0], port[1]))
    s = ewt.ew_window_segment_sum_n(g, port, n)
    assert torch.equal(s, ewt.wsum_fwd_plain(g, port[1], n))
    assert not any(_build.launch_counts.values())
    with pytest.raises(ValueError, match="no route"):
        ewt.pair_fwd(x.to("meta"), port[0], port[1])
    with pytest.raises(ValueError, match="no route"):
        ewt.wsum_fwd(g.to("meta"), port[1], port[2], n)


# ---------------------------------------------------------------------------
# kernel 4: plain version against the Pallas kernel and its reference
# ---------------------------------------------------------------------------


def _dense_inputs(seed, ci, n=512, d=4, h=64):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, d + 1, n)
    deg[-40:] = 0  # padding nodes: every slot masked
    nbr_mask = np.arange(d)[None, :] < deg[:, None]
    nbr_idx = np.where(nbr_mask, rng.integers(0, n, (n, d)), 0).astype(np.int32)
    nbr_attr = np.where(nbr_mask[..., None], rng.normal(size=(n, d, 4)),
                        0.0).astype(np.float32)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    sc = lambda: np.stack([rng.uniform(0.5, 1.5, h), rng.normal(size=h) * 0.1]
                          ).astype(np.float32)
    return (f(n, ci), nbr_idx, nbr_attr, nbr_mask, f(2 * ci + 4, h) * 0.3,
            sc(), f(h, h) * 0.3, sc(), f(ci, h) * 0.3, f(h) * 0.1)


def _dense_plain(args, dtype):
    t = [torch.from_numpy(a) for a in args]
    t[0] = t[0].to(dtype)
    return fused_dense_message_plain(*t).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ci", [5, 64])
def test_dense_message_plain_matches_pallas(ci, dtype):
    args = _dense_inputs(ci, ci)
    want = np.asarray(jax_dense(*map(jnp.asarray, args), interpret=True,
                                bf16=dtype == "bfloat16"))
    got = _dense_plain(args, getattr(torch, dtype))
    assert got.dtype == np.float32 and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    # padding nodes come out as x @ wr + br
    x, wr, br = args[0], args[8], args[9]
    if dtype == "float32":
        np.testing.assert_allclose(got[-40:], x[-40:] @ wr + br, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_message_plain_matches_reference(dtype):
    args = _dense_inputs(7, 16, n=500)  # any N: no block multiple needed
    jdt = jnp.dtype(dtype)
    x, idx, attr, mask, w1, sc1, w2, sc2, wr, br = map(jnp.asarray, args)
    want = np.asarray(fused_dense_message_reference(
        x.astype(jdt), idx, attr.astype(jdt), mask, w1.astype(jdt), sc1,
        w2.astype(jdt), sc2, wr.astype(jdt), br), np.float32)
    got = _dense_plain(args, getattr(torch, dtype))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_dense_message_routes_by_device():
    args = [torch.from_numpy(a) for a in _dense_inputs(1, 5, n=64)]
    _build.reset_launch_counts()
    assert torch.equal(fused_dense_message(*args),
                       fused_dense_message_plain(*args))
    assert _build.launch_counts["fused_dense_message"] == 0
    with pytest.raises(ValueError, match="no route"):
        fused_dense_message(args[0].to("meta"), *args[1:])


# ---------------------------------------------------------------------------
# the conv layer and the model in each layout
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup(synthetic_root):
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    jds = JaxDataset(synthetic_root, "train", bbox_sampling_step=10)
    jb = {k: v[0] for k, v in next(iter(JaxLoader(
        jds, batch_size=2, shuffle=False, dense=True))).items()}
    # the JAX plan is void for some graphs, and its model then takes the
    # sparse branch silently: these tests need it present
    assert jax_ew_of(jb) is not None and "nbr_idx" in jb
    pb = next(iter(PackedLoader(ds, batch_size=2, ew_transpose=True,
                                dense=True)))
    assert ew_train_of(pb) is not None and "nbr_idx" in pb
    jbatch = jax_finalize(jax.tree.map(jnp.asarray, jb))
    jm = JaxModel(n_classes=ds.n_classes, channels=WIDTH, sorted_edges=True)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda b: jm.init({"params": jax.random.key(0)}, b, train=True))(
            jbatch))
    return dict(n_classes=ds.n_classes, variables=variables, jbatch=jbatch,
                tbatch=finalize_batch(to_device(pb, "cpu")),
                mask=pb["proposal_mask"])


def _layout_batches(setup, layout):
    """Each package's batch as its train step would hand it to the model:
    the dense table only for the dense layout."""
    jbatch, tbatch = setup["jbatch"], setup["tbatch"]
    if layout != "dense":
        jbatch = {k: v for k, v in jbatch.items() if k not in DENSE_KEYS}
        tbatch = {k: v for k, v in tbatch.items() if k not in DENSE_KEYS}
    return jbatch, tbatch


def _models(setup, layout):
    window = layout == "window"
    jm = JaxModel(n_classes=setup["n_classes"], channels=WIDTH,
                  sorted_edges=True, window_edges=window)
    pm = load_jax_variables(
        SparseCADGCN(setup["n_classes"], channels=WIDTH, window_edges=window),
        setup["variables"])
    return jm, pm


def _assert_grads_close(got: dict, want: dict):
    for name, g in got.items():
        w = want[name]
        if np.abs(w).max() < 1e-4 and np.abs(g).max() < 1e-4:
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)
            continue
        np.testing.assert_allclose(g, w, rtol=1e-3,
                                   atol=5e-3 * np.abs(w).max(), err_msg=name)


def _conv_grads(tree):
    """A JAX AttrEdgeGP2 parameter (or gradient) tree under the port's
    state-dict names."""
    out = {}
    for mlp, pairs in (("nn", (("dense_0", 0), ("bn_0", 1), ("dense_1", 3),
                               ("bn_1", 4))),
                       ("mlp_node", (("dense_0", 0), ("bn_0", 1)))):
        for jname, idx in pairs:
            leaf = tree[mlp][jname]
            if "kernel" in leaf:
                out[f"{mlp}.{idx}.weight"] = np.asarray(leaf["kernel"]).T
            else:
                out[f"{mlp}.{idx}.weight"] = np.asarray(leaf["scale"])
            out[f"{mlp}.{idx}.bias"] = np.asarray(leaf["bias"])
    out["lin_r.weight"] = np.asarray(tree["lin_r"]["kernel"]).T
    out["lin_r.bias"] = np.asarray(tree["lin_r"]["bias"])
    return out


@pytest.mark.parametrize("layout", ["window", "dense"])
def test_conv_layer_matches_jax(setup, layout):
    """The second conv (16 -> 16) on a random input: train-mode outputs,
    BN statistics, and the gradients of x and of every parameter."""
    jbatch, tbatch = _layout_batches(setup, layout)
    _, pm = _models(setup, layout)
    conv = pm.cls_net.backbone[0].body.gconv.train()
    params = setup["variables"]["params"]["cls_net"]["AttrEdgeGP2_1"]
    stats = setup["variables"]["batch_stats"]["cls_net"]["AttrEdgeGP2_1"]
    n = tbatch["pos"].shape[0]
    x = np.random.default_rng(5).normal(size=(n, WIDTH)).astype(np.float32)
    node_mask = np.asarray(setup["tbatch"]["node_mask"])

    jkw = dict(edge=jbatch["edge"], e_attr=jbatch["e_attr"],
               edge_mask=jbatch["edge_mask"], node_mask=jbatch["node_mask"],
               dst_count=jbatch["dst_count"])
    if layout == "window":
        jkw["ew"] = jax_ew_of(jbatch)
        assert jkw["ew"] is not None
    else:
        jkw.update({k: jbatch[k] for k in DENSE_KEYS})
    jconv = JaxConv(in_channels=WIDTH, out_channels=WIDTH, sorted_edges=True)
    m = jnp.asarray(node_mask)[:, None]

    def run(xv, p, kw):
        (out, out_node), mut = jconv.apply(
            {"params": p, "batch_stats": stats}, xv, xv, train=True,
            mutable=["batch_stats"], **kw)
        return (jnp.sum(jnp.tanh(out) * m) + jnp.sum(out_node * m),
                (out, out_node, mut["batch_stats"]))

    # one jitted call, the batch an argument (closed over as a constant,
    # JAX's jitted gradient parts from its eager one: ROADMAP's stated
    # differences)
    (_, (jout, jnode, jstats)), (jdx, jdp) = jax.jit(jax.value_and_grad(
        run, argnums=(0, 1), has_aux=True))(jnp.asarray(x), params, jkw)

    xt = torch.from_numpy(x).requires_grad_(True)
    kw = dict(dst_count=tbatch["dst_count"])
    if layout == "window":
        kw.update(ew=ew_train_of(tbatch), ew_attr=tbatch["ew_attr"])
    else:
        kw["nbr"] = tuple(tbatch[k] for k in DENSE_KEYS)
    out, out_node = conv(xt, xt, tbatch["edge"], tbatch["e_attr"],
                         tbatch["edge_mask"], tbatch["node_mask"], **kw)
    tm = tbatch["node_mask"][:, None]
    (torch.sum(torch.tanh(out) * tm) + torch.sum(out_node * tm)).backward()

    np.testing.assert_allclose(out.detach().numpy()[node_mask],
                               np.asarray(jout)[node_mask], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out_node.detach().numpy()[node_mask],
                               np.asarray(jnode)[node_mask], rtol=1e-4,
                               atol=1e-5)
    for mlp, idx, bn in (("nn", 1, "bn_0"), ("nn", 4, "bn_1"),
                         ("mlp_node", 1, "bn_0")):
        mod = getattr(conv, mlp)[idx]
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   np.asarray(jstats[mlp][bn]["mean"]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(mod.running_var.numpy(),
                                   np.asarray(jstats[mlp][bn]["var"]),
                                   rtol=1e-4, atol=1e-5)
    _assert_grads_close({"x": xt.grad.numpy()}, {"x": np.asarray(jdx)})
    got_g = {k: v.grad.numpy() for k, v in conv.named_parameters()}
    want_g = _conv_grads(jdp)
    # a Dense bias that feeds a BatchNorm has a structurally zero gradient:
    # both sides hold summation noise, set against the BN shift's gradient
    for lin, bn in (("nn.0.bias", "nn.1.bias"), ("nn.3.bias", "nn.4.bias"),
                    ("mlp_node.0.bias", "mlp_node.1.bias")):
        scale = np.abs(want_g[bn]).max()
        assert scale > 1.0
        assert np.abs(got_g.pop(lin)).max() <= 1e-4 * scale
        assert np.abs(want_g.pop(lin)).max() <= 1e-4 * scale
    _assert_grads_close(got_g, want_g)
    assert np.abs(xt.grad.numpy()).max() > 1e-3


@pytest.mark.parametrize("layout", ["sparse", "window", "dense"])
def test_model_matches_jax_in_each_layout(setup, layout):
    """One set of JAX variables gives the JAX logits in every layout (eval
    mode), and the same loss, BN statistics and gradients in train mode."""
    jbatch, tbatch = _layout_batches(setup, layout)
    jm, pm = _models(setup, layout)
    assert (jax_ew_of(jbatch) is not None) and (
        ("nbr_idx" in jbatch) == (layout == "dense"))
    variables = setup["variables"]
    m = setup["mask"]

    want, _ = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables,
                                                                  jbatch)
    with torch.no_grad():
        got, _ = pm.eval()(tbatch)
    np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                               rtol=1e-4, atol=1e-4)

    def loss_fn(params, batch):
        (logits, _), mut = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, mutable=["batch_stats"])
        return jax_loss(logits, batch["labels"],
                        batch["proposal_mask"])["loss"], mut

    # jitted, the batch an argument (as the conv test above)
    (jloss, mut), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], jbatch)
    logits, _ = pm.train()(tbatch)
    loss = detection_loss(logits, tbatch["labels"],
                          tbatch["proposal_mask"])["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want_g = export_state_dict({
        "params": jax.tree.map(np.asarray, jgrads),
        "batch_stats": variables["batch_stats"]})
    got_g = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    assert len(got_g) > 40
    _assert_grads_close(got_g, want_g)
    stats = export_state_dict({
        "params": variables["params"],
        "batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
    for name, v in pm.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), stats[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)


def test_window_layout_needs_its_plan(setup):
    _, pm = _models(setup, "window")
    for drop in ("ew_sperm", "ew_wptr"):
        batch = {k: v for k, v in setup["tbatch"].items() if k != drop}
        with pytest.raises(ValueError, match="edge-window plan"):
            pm(batch)


def test_window_conv_counts_its_edges_without_dst_count(setup):
    """Without pack-time in-degrees the branch sums ones through kernel
    10's function (C = 1) and gives the same output."""
    _, tbatch = _layout_batches(setup, "window")
    _, pm = _models(setup, "window")
    no_count = {k: v for k, v in tbatch.items() if k != "dst_count"}
    with torch.no_grad():
        a, _ = pm.eval()(tbatch)
        b, _ = pm(no_count)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the folded engine's dense route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
def test_fast_forward_dense_route_matches_jax(setup, bf16):
    jbatch, tbatch = setup["jbatch"], setup["tbatch"]
    n = tbatch["pos"].shape[0]
    assert "nbr_idx" in jbatch and n % 256 == 0  # the Pallas kernel runs
    want, _ = jax_fast_forward(jax_fold(setup["variables"]), jbatch,
                               use_pallas=True, interpret=True, bf16=bf16,
                               edge_kernel=False)
    _, pm = _models(setup, "sparse")
    folded = ff.fold_params(pm.eval())
    dense = {k: v for k, v in tbatch.items() if not k.startswith("ew_")}
    _build.reset_launch_counts()
    with torch.no_grad():
        got, _ = ff.fast_forward(folded, dense, bf16=bf16)
        window, _ = ff.fast_forward(folded, tbatch, bf16=bf16)
        plain, _ = ff.fast_forward(folded, dense, bf16=bf16, plain=True)
    assert not any(_build.launch_counts.values())
    assert torch.equal(got, plain)  # CPU tensors: the same plain versions
    m = setup["mask"]
    got, want = got.numpy()[m], np.asarray(want)[m]
    if bf16:
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        # and the engine's two conv routes agree on the same batch
        np.testing.assert_allclose(got, window.numpy()[m], rtol=1e-4,
                                   atol=1e-4)


def test_fast_forward_names_both_routes_when_it_has_neither(setup):
    _, pm = _models(setup, "sparse")
    bare = {k: v for k, v in setup["tbatch"].items()
            if not k.startswith("ew_") and k not in DENSE_KEYS}
    with pytest.raises(ValueError, match="dense neighbour table"):
        ff.fast_forward(ff.fold_params(pm.eval()), bare)
    # a plan without in-degree counts is no window route: the table serves
    no_count = {k: v for k, v in setup["tbatch"].items() if k != "dst_count"}
    with torch.no_grad():
        a, _ = ff.fast_forward(ff.fold_params(pm), no_count)
        b, _ = ff.fast_forward(ff.fold_params(pm), {
            k: v for k, v in setup["tbatch"].items()
            if not k.startswith("ew_")})
    assert torch.equal(a, b)


def test_batch_level_dense_table_equals_the_per_file_one(setup):
    nb = {k: v.numpy() for k, v in setup["tbatch"].items()
          if isinstance(v, torch.Tensor) and k not in DENSE_KEYS}
    rebuilt = add_dense_neighbors(nb, d_max=setup["tbatch"]["nbr_idx"].shape[1])
    for k in DENSE_KEYS:
        np.testing.assert_array_equal(rebuilt[k], setup["tbatch"][k].numpy())
