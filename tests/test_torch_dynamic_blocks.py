"""The port's dynamic-graph blocks (`nn/dynamic.py`) and dense library
(`nn/dense_graph.py`) against yolat_tpu's, on the CPU, through the port's
weight conversion (`nn.state_dict.load_flax_module`).

Inputs are made with numpy from a seed: 48 nodes (6 of them padding) of
16 channels, 120 given edge rows (16 padding) with 4 attributes, and the
dense layout's 2 images of 24 rows (the second with 5 padding rows);
k = 4. Each module's JAX variables come from `jax.eval_shape` of its init
filled from a numpy seed (Kaiming-scale kernels, BatchNorm statistics and
affine terms away from their init), and one jitted JAX call (the inputs
as arguments) gives the train-mode output, the batch statistics after the
step, the gradients of sum(out * cot) with respect to the parameters and
x, and the eval-mode output. Tolerances:
  * outputs, train and eval mode: 1e-5 of the output's scale (max |out|);
  * running statistics after the step: rtol 1e-4, atol 1e-5;
  * gradients, `tests/test_torch_conv_models.py`'s rule: JAX's f32
    gradient and the port's own are each held to the port's float64
    gradient by the relative Frobenius error per tensor (GRAD_TOL); a
    tensor whose gradient is below 1e-4 on both sides (a Linear bias
    feeding a BatchNorm) at atol 1e-4. The float64 run scores its kNN in
    f32, as the f32 run does, so both run on one graph.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.nn import dense_graph as jdg
from yolat_tpu.nn import dynamic as jdy
from yolat_tpu.ops.knn import dilated as jax_dilated
from yolat_tpu.ops.knn import knn_graph as jax_knn_graph
from yolat_tpu_torch.nn import dense_graph as pdg
from yolat_tpu_torch.nn import dynamic as pdy
from yolat_tpu_torch.nn.state_dict import export_module, load_flax_module

C, N, N_PAD, E, E_PAD, K = 16, 48, 6, 120, 16, 4
B, NB = 2, 24
GRAD_TOL = 1e-4  # read <= 8.9e-7 (GIN's eps)
CONVS = ("edge", "mr", "gcn", "gin", "sage", "rsage", "gat", "gen")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (several xdist workers
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    real = N - N_PAD
    edge = rng.integers(0, real, size=(E, 2)).astype(np.int32)
    edge[:E_PAD] = 0
    edge_mask = np.arange(E) >= E_PAD
    dmask = np.ones((B, NB), bool)
    dmask[1, NB - 5:] = False
    return dict(
        x=rng.normal(size=(N, C)).astype(np.float32),
        node_mask=np.arange(N) < real, edge=edge, edge_mask=edge_mask,
        e_attr=rng.normal(size=(E, 4)).astype(np.float32),
        xd=rng.normal(size=(B, NB, C)).astype(np.float32), dmask=dmask)


def _fill(shapes, seed=5):
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


def _jax_args(kind, g):
    """(x, the other arguments) of a JAX call; the port's take the same
    arrays as tensors."""
    if kind == "dyn":
        return g["x"], (g["node_mask"],)
    if kind == "dense":
        return g["xd"], (g["dmask"],)
    edge, emask = g["edge"], g["edge_mask"]
    if kind == "graph":
        return g["x"], (edge, g["e_attr"], emask, g["node_mask"])
    # three families on the same nodes: the given edges, the kNN edges and
    # the kNN edges at dilation 2
    ei, em = (np.asarray(a) for a in jax_knn_graph(
        jnp.asarray(g["x"]), 2 * K, mask=jnp.asarray(g["node_mask"])))
    e1 = (ei[:, ::2].T.copy(), em[::2].copy())
    e2 = tuple(np.asarray(a) for a in jax_dilated(
        jnp.asarray(ei), jnp.asarray(em), K, 2))
    edges = [edge, e1[0], e2[0].T.copy()]
    attrs = [g["e_attr"], np.zeros((len(e1[0]), 4), np.float32),
             np.zeros((len(e2[1]), 4), np.float32)]
    return g["x"], (edges, attrs, [emask, e1[1], e2[1]], g["node_mask"])


def _jax_run(jm, variables, x, rest, cot):
    """(train output, batch_stats after the step, parameter gradients,
    x gradient, eval output) in one jitted call, inputs as arguments."""
    stats = variables.get("batch_stats", {})

    def loss(params, x, rest, cot):
        out, mut = jm.apply({"params": params, "batch_stats": stats}, x,
                            *rest, train=True, mutable=["batch_stats"])
        return (out * cot).sum(), (out, mut.get("batch_stats", {}))

    def run(params, x, rest, cot):
        (_, (out, new_stats)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, x, rest, cot)
        eval_out = jm.apply({"params": params, "batch_stats": stats}, x,
                            *rest, train=False)
        return out, new_stats, gp, gx, eval_out

    return jax.tree.map(np.asarray, jax.jit(run)(
        variables["params"], x, jax.tree.map(jnp.asarray, rest), cot))


def _tensors(tree, dtype=None):
    def conv(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return jax.tree.map(conv, tree)


def _port_grads(pm, x, rest, cot, dtype):
    """Train-mode output and {name: grad} (x as 'x') of sum(out * cot)."""
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    out = pm.train()(xt, *_tensors(rest, dtype))
    (out * torch.from_numpy(cot).to(dtype)).sum().backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in pm.named_parameters()}
    grads["x"] = xt.grad
    return out.detach(), {k: v.numpy() for k, v in grads.items()}


def _frob(a, ref) -> float:
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= 1e-5 * scale, (what, err, scale)


def _check(jm, pm, kind, g, what):
    x, rest = _jax_args(kind, g)
    out_shape = jax.eval_shape(lambda *a: jm.init(
        jax.random.key(0), *a, train=True), x, *rest)
    variables = _fill(out_shape)
    stats = variables.get("batch_stats", {})
    shape = jax.eval_shape(lambda *a: jm.apply(
        variables, *a, train=False), x, *rest).shape
    cot = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    out, new_stats, gp, gx, eval_out = _jax_run(jm, variables, x, rest, cot)

    load_flax_module(pm, jax.tree.map(np.asarray, variables))
    with torch.no_grad():
        _close(pm.eval()(*_tensors((x, *rest))).numpy(), eval_out,
               f"{what} eval")
    m64 = copy.deepcopy(pm).double()
    got, grads = _port_grads(pm, x, rest, cot, torch.float32)
    _close(got.numpy(), out, f"{what} train")
    _, grads64 = _port_grads(m64, x, rest, cot, torch.float64)

    want_stats = export_module(pm, variables["params"], new_stats)
    moved = 0
    for name, v in pm.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_stats[name], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{what} {name}")
            moved += 1
    assert moved == len([k for k in export_module(pm, variables["params"],
                                                  stats)
                         if k.endswith("running_var")]) * 2

    want = export_module(pm, gp, stats)
    want["x"] = gx
    assert set(grads) <= set(want), set(grads) - set(want)
    for name, g64 in grads64.items():
        w = want[name].reshape(g64.shape)
        if np.abs(w).max() < 1e-4 and np.abs(g64).max() < 1e-4:
            np.testing.assert_allclose(g64, w, atol=1e-4,
                                       err_msg=f"{what} {name}")
            continue
        assert _frob(w, g64) <= GRAD_TOL, (what, name, _frob(w, g64))
        assert _frob(grads[name], g64) <= GRAD_TOL, (
            what, name, _frob(grads[name], g64))
    return pm


@pytest.fixture(scope="module")
def g():
    return _inputs()


@pytest.mark.parametrize("conv", CONVS)
def test_dyn_conv_matches_jax(conv, g):
    """DynConv with each conv it takes, BatchNorm in the conv's MLPs."""
    _check(jdy.DynConv(C, C, K, 1, conv, norm="batch"),
           pdy.DynConv(C, C, K, 1, conv, norm="batch"), "dyn", g,
           f"DynConv {conv}")


BLOCKS = {
    "DynConv edge d2": (lambda m: m.DynConv(C, C, K, 2, "edge",
                                            norm="batch"), "dyn"),
    "PlainDynBlock mr": (lambda m: m.PlainDynBlock(C, K, 1, "mr",
                                                   norm="batch"), "dyn"),
    "ResDynBlock edge d2": (lambda m: m.ResDynBlock(C, K, 2, "edge"), "dyn"),
    "DenseDynBlock edge": (lambda m: m.DenseDynBlock(C, 8, K, 1, "edge",
                                                     norm="batch"), "dyn"),
    "ResGraphBlock attr_edge": (lambda m: m.ResGraphBlock(
        C, "attr_edge", norm="batch", res_scale=0.5), "graph"),
    "DenseGraphBlock edge": (lambda m: m.DenseGraphBlock(
        C, 8, "edge", norm="batch"), "graph"),
    "ResBlockMultiEdge edge": (lambda m: m.ResBlockMultiEdge(
        C, "edge", 3, norm="batch"), "multi"),
}


@pytest.mark.parametrize("name", BLOCKS)
def test_block_matches_jax(name, g):
    make, kind = BLOCKS[name]
    pm = _check(make(jdy), make(pdy), kind, g, name)
    if kind == "multi":
        assert [k for k in pm.state_dict() if k.endswith("nn.0.weight")] \
            == [f"gconvs.{i}.nn.0.weight" for i in range(3)]


DENSE = {
    "DynConv2d edge d1": lambda m: m.DynConv2d(C, C, K, 1, "edge"),
    "DynConv2d edge d2": lambda m: m.DynConv2d(C, C, K, 2, "edge"),
    "DynConv2d mr d1": lambda m: m.DynConv2d(C, C, K, 1, "mr"),
    "DynConv2d mr d2": lambda m: m.DynConv2d(C, C, K, 2, "mr"),
    "ResDynBlock2d edge": lambda m: m.ResDynBlock2d(C, K, 1, "edge",
                                                    res_scale=0.5),
    "DenseDynBlock2d mr d2": lambda m: m.DenseDynBlock2d(C, 8, K, 2, "mr"),
}


@pytest.mark.parametrize("name", DENSE)
def test_dense_module_matches_jax(name, g):
    pm = _check(DENSE[name](jdg), DENSE[name](pdg), "dense", g, name)
    keys = list(pm.state_dict())
    assert any(k.endswith("gconv.nn.1.running_var") for k in keys), keys


@pytest.mark.parametrize("conv", pdy.NO_DYN_CONVS)
def test_dyn_conv_refuses_convs_without_their_inputs(conv):
    with pytest.raises(ValueError, match=f"conv '{conv}'"):
        pdy.DynConv(C, C, K, 1, conv)
    for block in (pdy.PlainDynBlock, pdy.ResDynBlock):
        with pytest.raises(ValueError, match=f"conv '{conv}'"):
            block(C, K, 1, conv)


def test_graph_blocks_refuse_other_signatures():
    for conv in pdy.OTHER_SIGNATURE:
        with pytest.raises(ValueError, match=f"ResGraphBlock with conv '{conv}'"):
            pdy.ResGraphBlock(C, conv)
        with pytest.raises(ValueError, match="ResBlockMultiEdge"):
            pdy.ResBlockMultiEdge(C, conv)
    pdy.ResGraphBlock(C, "attr_edge_gp")  # takes e_attr: built


def test_graph_conv2d_takes_edge_and_mr_only():
    for conv in ("gcn", "gat", "attr_edge"):
        with pytest.raises(NotImplementedError, match=f"dense conv {conv}"):
            pdg.GraphConv2d(C, C, conv)
    assert isinstance(pdg.GraphConv2d(C, C, "mr").gconv, pdg.MRConv2d)


def test_dyn_conv_draws_only_in_training(g):
    """DynConv(stochastic=True): in eval mode the strided graph, in train
    mode one draw from the generator (epsilon 1: the random subset)."""
    pm = pdy.DynConv(C, C, K, 2, "edge", stochastic=True, epsilon=1.0)
    x = torch.from_numpy(g["x"])
    mask = torch.from_numpy(g["node_mask"])
    strided = pdy.DynConv(C, C, K, 2, "edge")
    strided.load_state_dict(pm.state_dict())
    with torch.no_grad():
        assert torch.equal(pm.eval()(x, mask, torch.Generator().manual_seed(1)),
                           strided.eval()(x, mask))
        a = pm.train()(x, mask, torch.Generator().manual_seed(1))
        b = pm.train()(x, mask, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
