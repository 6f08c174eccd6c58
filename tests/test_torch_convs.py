"""The port's conv zoo against yolat_tpu's, module by module, on the CPU:
`segment_softmax`, each `GenAggregation` mode and `MsgNorm`, the MLP under
each activation and norm, and each of the twelve convs of `make_conv`
besides attr_edge_gp2 alone, on the sparse edge list and, for the six
with one, on the dense neighbour table. Plus the import-and-forward of
these modules in a subprocess that refuses jax and yolat_tpu.

Inputs are made with numpy from a seed: a padded graph of 48 nodes (6
padding) and 160 edge rows (24 padding, at node 0 as the packer puts
them), a dense table of 6 slots with empty nodes, 16 channels. Weights
start in JAX and cross through the port's own export
(`nn.state_dict._export_conv` / `_export_mlp`), so the mapping is under
test too. Everything runs in train mode (masked batch statistics) and the
gradients are of sum(out * cot) for a fixed random cotangent.

Tolerances (f32; the same math with sums in another order):
  * outputs: rtol/atol 1e-4 (of the output's scale: atol 1e-4 * max|out|
    where outputs are large), the limit `tests/test_torch_model.py` holds
    the canonical model to;
  * gradients: rtol 1e-3 with an absolute floor of 5e-3 of each tensor's
    scale, `tests/test_torch_train.py`'s rule (train-mode BatchNorm
    divides by batch deviations and amplifies summation-order noise in
    near-zero entries); a tensor whose gradient is below 1e-4 on both
    sides (a Dense bias feeding a BatchNorm) is compared at atol 1e-4;
  * running statistics after the step: rtol 1e-4, atol 1e-5.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.nn.conv import make_conv as jax_make_conv
from yolat_tpu.nn.gen_conv import GenAggregation as JaxAggr
from yolat_tpu.nn.gen_conv import MsgNorm as JaxMsgNorm
from yolat_tpu.nn.layers import MLP as JaxMLP
from yolat_tpu.ops.segment import segment_softmax as jax_segment_softmax
from yolat_tpu_torch.nn.conv import DENSE_CONVS, make_conv
from yolat_tpu_torch.nn.gen_conv import GenAggregation, MsgNorm
from yolat_tpu_torch.nn.layers import MLP
from yolat_tpu_torch.nn.state_dict import _export_conv, _export_mlp
from yolat_tpu_torch.ops.segment import segment_softmax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 16
N, N_PAD, E, E_PAD, D = 48, 6, 160, 24, 6
CONVS = ("attr_edge", "multilayer_edge", "attr_edge_gp", "attr_edge_cf",
         "edge", "mr", "gcn", "gin", "sage", "rsage", "gat", "gen")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: under pytest-xdist
    with several workers on one host, torch's default thread pool per
    worker oversubscribes the cores (the CLI test of
    `tests/test_torch_conv_models.py` read 16 times its one-process time
    with six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    real = N - N_PAD
    edge = rng.integers(0, real, size=(E, 2)).astype(np.int32)
    edge[E - E_PAD:] = 0
    edge = edge[np.argsort(edge[:, 1], kind="stable")]
    edge_mask = np.ones(E, bool)
    edge_mask[:E_PAD] = False  # the padding rows, at node 0, sort first
    nbr_idx = rng.integers(0, real, size=(N, D)).astype(np.int32)
    nbr_mask = rng.random((N, D)) < 0.6
    nbr_mask[::7] = False  # nodes without a neighbour
    nbr_mask[real:] = False
    node_mask = np.arange(N) < real
    return dict(
        x=rng.normal(size=(N, C)).astype(np.float32),
        x2=rng.normal(size=(N, 2 * C)).astype(np.float32),
        pos=rng.random((N, 2)).astype(np.float32),
        edge=edge, edge_mask=edge_mask,
        e_attr=rng.normal(size=(E, 4)).astype(np.float32),
        node_mask=node_mask, nbr_idx=nbr_idx, nbr_mask=nbr_mask,
        nbr_attr=rng.normal(size=(N, D, 4)).astype(np.float32),
        cot=rng.normal(size=(N, C)).astype(np.float32))


def _close(got, want, what, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-4 * scale,
                               err_msg=what)


def _grad_close(got: dict, want: dict, what: str):
    """tests/test_torch_train.py's gradient rule, per tensor."""
    assert got, what
    for name, g in got.items():
        w = np.asarray(want[name]).reshape(g.shape)
        if np.abs(w).max() < 1e-4 and np.abs(g).max() < 1e-4:
            np.testing.assert_allclose(g, w, atol=1e-4,
                                       err_msg=f"{what} {name}")
            continue
        np.testing.assert_allclose(g, w, rtol=1e-3,
                                   atol=5e-3 * np.abs(w).max(),
                                   err_msg=f"{what} {name}")


def _stats_close(module, exported: dict, what: str):
    for name, v in module.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), exported[name], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{what} {name}")


def _fill(shapes, seed=5):
    """Numpy values for the ShapeDtypeStructs of a flax init (no compile):
    Kaiming-normal kernels, BatchNorm statistics and affine terms away from
    their init, GIN's eps and GEN's t near theirs."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name in ("kernel", "a_src", "a_dst"):
            return (rng.normal(size=shape)
                    * np.sqrt(2.0 / shape[-2])).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name in ("scale", "t"):
            return (1.0 + rng.normal(size=shape) * 0.1).astype(np.float32)
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _load(module, sd: dict):
    module.load_state_dict({k: torch.from_numpy(np.array(v, copy=True))
                            for k, v in sd.items()}, strict=True)
    return module


def test_segment_softmax_matches_jax():
    rng = np.random.default_rng(1)
    data = rng.normal(size=(40, 3)).astype(np.float32) * 4
    seg = np.sort(rng.integers(0, 12, size=40)).astype(np.int32)
    seg[seg == 5] = 6  # an empty segment
    mask = rng.random(40) < 0.8
    cot = rng.normal(size=(40, 3)).astype(np.float32)

    def f(d):
        return (jax_segment_softmax(d, jnp.asarray(seg), 12,
                                    mask=jnp.asarray(mask)) * cot).sum()

    want = jax_segment_softmax(jnp.asarray(data), jnp.asarray(seg), 12,
                               mask=jnp.asarray(mask))
    want_g = jax.grad(f)(jnp.asarray(data))
    d = torch.tensor(data, requires_grad=True)
    got = segment_softmax(d, torch.from_numpy(seg), 12,
                          mask=torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert np.all(got.detach().numpy()[~mask] == 0)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("aggr", ["softmax", "softmax_sg", "softmax_sum",
                                  "power", "power_sum"])
def test_gen_aggregation_matches_jax(aggr):
    """Learned t, p and y away from their defaults; messages as GENConv
    makes them, relu(x) + 1e-7, so many sit on the power clamp's lower
    bound (a tie whose gradient both packages split), and some above 10."""
    rng = np.random.default_rng(2)
    msg = (np.maximum(rng.normal(size=(60, 5)) * 6, 0) + 1e-7).astype(
        np.float32)
    seg = np.sort(rng.integers(0, 15, size=60)).astype(np.int32)
    mask = rng.random(60) < 0.85
    cot = rng.normal(size=(15, 5)).astype(np.float32)
    kw = dict(t=1.3, p=1.7, y=0.4)
    jm = JaxAggr(aggr=aggr, learn_t=True, learn_p=True, learn_y=True, **kw)
    args = (jnp.asarray(seg), 15)
    params = jm.init(jax.random.key(0), jnp.asarray(msg), *args,
                     mask=jnp.asarray(mask))["params"]

    def f(p, m):
        out = jm.apply({"params": p}, m, *args, mask=jnp.asarray(mask))
        return (out * cot).sum(), out

    (_, want), (gp, gm) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(params,
                                                           jnp.asarray(msg))
    pm = GenAggregation(aggr, learn_t=True, learn_p=True, learn_y=True, **kw)
    _load(pm, {k: np.asarray(v) for k, v in params.items()})
    m = torch.tensor(msg, requires_grad=True)
    got = pm(m, torch.from_numpy(seg), 15, mask=torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach().numpy(), want, aggr)
    _grad_close({"msg": m.grad.numpy()}, {"msg": gm}, aggr)
    _grad_close({n: p.grad.numpy() for n, p in pm.named_parameters()},
                {k: np.asarray(v) for k, v in gp.items()}, aggr)


def test_msg_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20, 8)).astype(np.float32)
    msg = rng.normal(size=(20, 8)).astype(np.float32)
    cot = rng.normal(size=(20, 8)).astype(np.float32)
    jm = JaxMsgNorm(learn_scale=True)
    params = {"scale": jnp.asarray([1.4], jnp.float32)}

    def f(p, a, b):
        out = jm.apply({"params": p}, a, b)
        return (out * cot).sum(), out

    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(msg))
    pm = _load(MsgNorm(learn_scale=True), {"scale": np.array([1.4])})
    a = torch.tensor(x, requires_grad=True)
    b = torch.tensor(msg, requires_grad=True)
    got = pm(a, b)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach().numpy(), want, "msg_norm")
    _grad_close({"scale": pm.scale.grad.numpy(), "x": a.grad.numpy(),
                 "msg": b.grad.numpy()},
                {"scale": grads[0]["scale"], "x": grads[1], "msg": grads[2]},
                "msg_norm")


@pytest.mark.parametrize("norm", ["batch", "layer", None])
@pytest.mark.parametrize("act", ["relu", "leakyrelu", "gelu", "none"])
def test_mlp_matches_jax(act, norm):
    """Two stages, masked rows; LayerNorm at flax's epsilon 1e-6 with its
    affine terms away from the identity; GELU in flax's tanh form."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(30, 8)).astype(np.float32)
    mask = np.arange(30) < 24
    cot = rng.normal(size=(30, 12)).astype(np.float32)
    jm = JaxMLP([8, 16, 12], act=act, norm=norm)
    variables = _fill(jax.eval_shape(lambda a, b: jm.init(
        jax.random.key(1), a, mask=b), jnp.asarray(x), jnp.asarray(mask)))
    params, stats = variables["params"], variables.get("batch_stats", {})

    def f(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats},
                            jnp.asarray(x), mask=jnp.asarray(mask),
                            train=True, mutable=["batch_stats"])
        return (out * cot).sum(), (out, mut)

    (_, (want, mut)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    has_act = act != "none"
    pm = _load(MLP([8, 16, 12], act=act, norm=norm).train(),
               {k[2:]: v for k, v in _export_mlp(params, stats, "m",
                                                 has_act).items()})
    got = pm(torch.from_numpy(x), torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    what = f"mlp {act} {norm}"
    _close(got.detach().numpy(), want, what)
    want_g = _export_mlp(jax.tree.map(np.asarray, grads), stats, "m", has_act)
    _grad_close({n: p.grad.numpy() for n, p in pm.named_parameters()},
                {k[2:]: v for k, v in want_g.items()}, what)
    if norm == "batch":
        _stats_close(pm, {k[2:]: v for k, v in _export_mlp(
            params, jax.tree.map(np.asarray, mut["batch_stats"]), "m",
            has_act).items()}, what)


def _conv_args(name, g, dense):
    """(JAX args, JAX kwargs, port args, port kwargs) of one conv call."""
    x = g["x2"] if name == "attr_edge_gp" else g["x"]
    base = [x, g["edge"], g["e_attr"], g["edge_mask"], g["node_mask"]]
    jkw, pkw = {}, {}
    if dense:
        nbr = (g["nbr_idx"], g["nbr_attr"], g["nbr_mask"])
        jkw.update(nbr_idx=nbr[0], nbr_attr=nbr[1], nbr_mask=nbr[2])
        pkw["nbr"] = tuple(torch.from_numpy(a) for a in nbr)
    jargs = list(base)
    if name == "attr_edge_cf":
        jargs.insert(1, g["pos"])
        pkw["pos"] = torch.from_numpy(g["pos"])
    return ([jnp.asarray(a) for a in jargs],
            {k: jnp.asarray(v) for k, v in jkw.items()},
            [torch.from_numpy(a) for a in base], pkw)


def _run_conv(name, dense, g):
    jargs, jkw, pargs, pkw = _conv_args(name, g, dense)
    cin = C
    jm = jax_make_conv(name, cin, C, act="relu", norm="batch")
    variables = _fill(jax.eval_shape(lambda *a: jm.init(
        jax.random.key(2), *a, train=True, **jkw), *jargs))
    params, stats = variables["params"], variables.get("batch_stats", {})
    cot = g["cot"]

    def f(p, x):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, x,
                            *jargs[1:], train=True, mutable=["batch_stats"],
                            **jkw)
        return (out * cot).sum(), (out, mut)

    (_, (want, mut)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jargs[0])
    pm = make_conv(name, cin, C, act="relu", norm="batch").train()
    strip = lambda sd: {k[2:]: v for k, v in sd.items()}  # noqa: E731
    _load(pm, strip(_export_conv(name, params, stats, "m", True)))
    x = pargs[0].clone().requires_grad_(True)
    got = pm(x, *pargs[1:], **pkw)
    (got * torch.from_numpy(cot)).sum().backward()
    what = f"{name} {'dense' if dense else 'sparse'}"
    _close(got.detach().numpy(), want, what)
    _grad_close({"x": x.grad.numpy()}, {"x": gx}, what)
    want_g = strip(_export_conv(name, jax.tree.map(np.asarray, gp), stats,
                                "m", True))
    _grad_close({n: p.grad.numpy() for n, p in pm.named_parameters()},
                want_g, what)
    _stats_close(pm, strip(_export_conv(
        name, params, jax.tree.map(np.asarray, mut.get("batch_stats", {})),
        "m", True)), what)
    return pm


@pytest.fixture(scope="module")
def graph():
    return _graph()


@pytest.mark.parametrize("name", CONVS)
def test_conv_sparse_matches_jax(name, graph):
    pm = _run_conv(name, False, graph)
    if name == "attr_edge_cf":  # every octant's MLP ran and was trained
        assert all(getattr(pm, f"mlp_{b}")[0].weight.grad.abs().max() > 0
                   for b in range(8))


@pytest.mark.parametrize("name", DENSE_CONVS)
def test_conv_dense_matches_jax(name, graph):
    _run_conv(name, True, graph)


def test_gat_splits_the_width_over_eight_heads():
    conv = make_conv("gat", 5, 64)
    assert (conv.heads, conv.out_channels) == (8, 8)
    assert tuple(conv.a_src.shape) == (1, 8, 8)
    assert conv.lin.bias is None and conv.bn is not None
    assert make_conv("gen", 5, 64).msg_norm is None


SCRIPT = textwrap.dedent("""
    import sys
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yolat_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, __REPO__)
    import torch
    from yolat_tpu_torch.nn import dynamic, gen_conv
    from yolat_tpu_torch.nn.conv import CONV_NAMES, DENSE_CONVS, make_conv
    from yolat_tpu_torch.ops.segment import segment_softmax

    g = torch.Generator().manual_seed(0)
    n, e = 30, 90
    edge = torch.randint(0, n, (e, 2), generator=g)
    args = (edge, torch.randn(e, 4, generator=g), torch.ones(e, dtype=bool),
            torch.ones(n, dtype=bool))
    nbr = (torch.randint(0, n, (n, 4), generator=g), torch.randn(n, 4, 4),
           torch.ones(n, 4, dtype=bool))
    for name in CONV_NAMES[1:]:
        conv = make_conv(name, 8, 16).train()
        x = torch.randn(n, 16 if name == "attr_edge_gp" else 8, generator=g)
        kw = {"pos": torch.rand(n, 2)} if name == "attr_edge_cf" else {}
        outs = [conv(x, *args, **kw)]
        if name in DENSE_CONVS:
            outs.append(conv(x, *args, nbr=nbr, **kw))
        assert all(o.shape == (n, 16) and bool(torch.isfinite(o).all())
                   for o in outs), name
    w = segment_softmax(torch.randn(e, 2), edge[:, 1], n)
    assert bool(torch.isfinite(w).all())
    bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not bad, bad
    print("NOJAX_OK", len(CONV_NAMES))
""")


def test_new_modules_run_without_jax():
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT.replace("__REPO__", repr(REPO))],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NOJAX_OK 13" in r.stdout
