"""YOLaT++ of the port under --act / --norm against yolat_tpu's, on the
CPU, at width 16: the eval-mode logits on the three routes through the
primitive level (per super edge, over the `sew_` plan with kernels 7 and
8's plain versions against the Pallas interpreter, factored), the weight
conversion and `.pth` round trips, three train steps, the CLIs, and the
refusals that stay.

The weights start in JAX (`model.init`, gates opened to 0.3 + 0.1 i,
BatchNorm statistics and the BatchNorm and LayerNorm affine terms
randomised from a numpy seed, so that a misnamed or transposed mapping
shows) and reach the port through `load_jax_variables`. The eval batch is
yolat_tpu's toy batch, the train batch one batch of the synthetic dataset
(tests/torch_pp_train_common.py). Tolerances: eval-mode logits rtol/atol
2e-4 at f32 (as tests/test_torch_pp_model.py); the train step at
tests/torch_pp_train_common.py's stated tolerances. Each JAX oracle is
computed once per module.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_pp_train_common import (_configs, _jax_state, batches, toy,
                                   train_step_parity)
from yolat_tpu.data.packing import finalize_batch as jax_finalize
from yolat_tpu.nn.yolat_pp import YOLaTPlusPlus as JaxPP
from yolat_tpu_torch.cli import detect, export_ckpt, infer
from yolat_tpu_torch.cli import test as test_cli
from yolat_tpu_torch.cli import train as train_cli
from yolat_tpu_torch.config import PP_GATES, Config, check_serve_mode
from yolat_tpu_torch.data.packing import finalize_batch, to_device
from yolat_tpu_torch.nn.layers import MaskedBatchNorm
from yolat_tpu_torch.nn.model import (build_model, check_model_config,
                                      load_jax_variables,
                                      load_reference_checkpoint)
from yolat_tpu_torch.nn.yolat_pp import YOLaTPlusPlus
from yolat_tpu_torch.train.checkpoint import save_reference_checkpoint

__all__ = ["batches", "toy"]  # the module fixtures the tests take

WIDTH = 16
TOL = dict(rtol=2e-4, atol=2e-4)
ACT_NORM = [("gelu", "layer"), ("leakyrelu", "batch"), ("relu", "none")]
ROUTE_KW = {"per_edge": {}, "banded": {"banded_super": True},
            "factored": {"factored_prim": True}}
HIERARCHY = ("point_pe_mlp", "curve_mlp", "super_node_mlp",
             "fusion_block", "fusion_block_super", "prediction_cls.0",
             "prediction_cls.1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors, as
    tests/test_torch_conv_models.py: under pytest-xdist torch's default
    pool per worker oversubscribes the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomised(path, v, rng):
    """BatchNorm statistics and the BatchNorm and LayerNorm affine terms
    drawn from `rng`; every other leaf as it is."""
    name, v = path[-1].key, np.asarray(v)
    parent = path[-2].key if len(path) > 1 else ""
    if name == "var":
        return (0.5 + rng.random(v.shape)).astype(np.float32)
    if name == "mean":
        return (0.2 * rng.normal(size=v.shape)).astype(np.float32)
    if parent.startswith(("bn_", "ln_")) and name == "scale":
        return (1 + 0.2 * rng.normal(size=v.shape)).astype(np.float32)
    if parent.startswith(("bn_", "ln_")) and name == "bias":
        return (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    return v


def _jax_variables(jmodel, jb, seed=0):
    var = jmodel.init({"params": jax.random.key(seed)}, jb, train=True)
    rng = np.random.default_rng(seed)
    var = jax.tree_util.tree_map_with_path(
        lambda p, v: _randomised(p, v, rng),
        jax.device_get({"params": var["params"],
                        "batch_stats": var.get("batch_stats", {})}))
    params = dict(var["params"])
    for i, g in enumerate(PP_GATES):
        params[g] = np.asarray(0.3 + 0.1 * i, np.float32)
    return {"params": params, "batch_stats": var["batch_stats"]}


def _cfg(act, norm, route, **kw):
    return Config(arch="yolat_pp", n_classes=17, n_filters=WIDTH, act=act,
                  norm=norm, pp_banded_super=route == "banded",
                  pp_factored_prim=route == "factored", **kw)


@pytest.fixture(scope="module")
def oracle(toy):
    """(act, norm, route) -> (JAX variables, JAX eval-mode logits), each
    computed once; and the finalized port batch."""
    jb_np, pb_np = toy
    jb = jax_finalize(jax.tree.map(jnp.asarray, jb_np))
    pb = finalize_batch(to_device(pb_np, "cpu"))
    cache = {}

    def get(act, norm, route):
        if (act, norm, route) not in cache:
            jmodel = JaxPP(n_classes=17, channels=WIDTH, act=act, norm=norm,
                           sorted_edges=True, **ROUTE_KW[route])
            # the banded route holds the per-edge route's parameters
            var = (get(act, norm, "per_edge")[0] if route == "banded"
                   else _jax_variables(jmodel, jb))
            logits, _ = jmodel.apply(var, jb, train=False)
            cache[act, norm, route] = (var, np.asarray(logits))
        return cache[act, norm, route]

    return get, pb


@pytest.mark.parametrize("route", list(ROUTE_KW))
@pytest.mark.parametrize("act,norm", ACT_NORM)
def test_eval_logits_match_jax(oracle, act, norm, route):
    get, pb = oracle
    var, want = get(act, norm, route)
    model = load_jax_variables(build_model(_cfg(act, norm, route)), var)
    assert isinstance(model, YOLaTPlusPlus)
    assert hasattr(model, "super_fact_mlp") == (route == "factored")
    with torch.no_grad():
        got, _ = model.eval()(pb)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the hierarchy, fusion and head MLPs take the flags; the convs do not
    norms = {"layer": torch.nn.LayerNorm, "batch": MaskedBatchNorm}
    for name in HIERARCHY:
        mlp = model.get_submodule(name)
        kinds = {type(m) for m in mlp}
        assert (norms.get(norm) in kinds) if norm != "none" else not (
            kinds & set(norms.values())), (name, kinds)
    for conv in model.convs:
        assert sum(isinstance(m, MaskedBatchNorm) for m in conv.modules()) \
            == 3
        assert not any(isinstance(m, torch.nn.LayerNorm)
                       for m in conv.modules())


@pytest.mark.parametrize("act,norm", ACT_NORM + [("none", "layer")])
def test_state_dict_and_pth_round_trip(oracle, tmp_path, act, norm):
    get, pb = oracle
    var, want = get(act, norm, "per_edge")
    model = load_jax_variables(build_model(_cfg(act, norm, "per_edge")), var)
    p = var["params"]
    if norm == "layer":
        # the randomised LayerNorm terms land on their own indices: under
        # --act none the Sequential closes up (Linear 0, LayerNorm 1, Linear
        # 2 of a two-stage MLP)
        for name, jname in (("point_pe_mlp.1", "point_pe_mlp"),
                            ("prediction_cls.1.1", "pred_1")):
            ln = model.get_submodule(name)
            assert isinstance(ln, torch.nn.LayerNorm) and ln.eps == 1e-6
            np.testing.assert_array_equal(ln.weight.detach().numpy(),
                                          p[jname]["ln_0"]["scale"])
            np.testing.assert_array_equal(ln.bias.detach().numpy(),
                                          p[jname]["ln_0"]["bias"])
        assert float(p["pred_1"]["ln_0"]["scale"].std()) > 0.1
    np.testing.assert_array_equal(
        model.curve_mlp[0].weight.detach().numpy(),
        p["curve_mlp"]["dense_0"]["kernel"].T)
    path = str(tmp_path / "pp.pth")
    save_reference_checkpoint(model, path)
    back = load_reference_checkpoint(build_model(_cfg(act, norm, "per_edge")),
                                     path)
    sd, sd_back = model.state_dict(), back.state_dict()
    assert set(sd) == set(sd_back)
    for k in sd:
        assert torch.equal(sd[k], sd_back[k]), k
    with torch.no_grad():
        got, _ = back.eval()(pb)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a model of another norm does not load it strictly
    other = "layer" if norm == "batch" else "batch"
    with pytest.raises(RuntimeError):
        load_reference_checkpoint(build_model(_cfg("relu", other,
                                                   "per_edge")), path)


def _randomise_layer_norms(state, seed=1):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (_randomised(p, v, rng) if len(p) > 1
                      and p[-2].key.startswith("ln_") else v),
        jax.device_get(state.params))
    return state.replace(params=jax.tree.map(jnp.asarray, params))


@pytest.mark.parametrize("act,norm,route,n_bn", [
    ("gelu", "layer", "banded", 6), ("leakyrelu", "batch", "factored", 14)])
def test_train_step_matches_jax(batches, act, norm, route, n_bn):
    jb, pb = batches
    jcfg, cfg = _configs(route, act=act, norm=norm)
    tx, state = _jax_state(jcfg, jb)
    if norm == "layer":
        state = _randomise_layer_norms(state)
    train_step_parity(jb, pb, route, jcfg, cfg, tx, state, n_bn=n_bn,
                      jit=True)


def test_clis_train_serve_and_export(tmp_path, synthetic_root):
    """cli.train (banded route, --act gelu --norm layer), its evaluation,
    cli.test --serve_mode flax to the same table, cli.export_ckpt, and
    cli.infer --serve_mode module and cli.detect --serve_mode flax on the
    export; the fast modes refuse."""
    flags = ["--arch", "yolat_pp", "--pp_banded_super", "true", "--act",
             "gelu", "--norm", "layer", "--n_filters", "8", "--device",
             "cpu"]
    res = train_cli.main(["--data_dir", synthetic_root, "--batch_size", "2",
                          "--max_steps", "2", "--root_dir", str(tmp_path),
                          "--print_freq", "1"] + flags)
    assert res["steps"] == 2 and all(np.isfinite(res["losses"]))
    ck = os.path.join(res["exp_dir"], "checkpoint")
    table = test_cli.main(["--data_dir", synthetic_root, "--phase", "test",
                           "--batch_size", "2", "--pretrained_model", ck,
                           "--serve_mode", "flax"] + flags)
    np.testing.assert_allclose(table["map_50"], res["map_50"], atol=1e-6)
    pth = str(tmp_path / "pp.pth")
    export_ckpt.main(["--pretrained_model", ck, "--n_classes", "17",
                      "--out", pth] + flags[:-2])
    model = load_reference_checkpoint(
        build_model(_cfg("gelu", "layer", "banded").replace(n_filters=8)),
        pth)
    assert isinstance(model.point_pe_mlp[1], torch.nn.LayerNorm)
    out = str(tmp_path / "det.jsonl")
    serve = ["--data_dir", synthetic_root, "--pretrained_model", pth,
             "--out", out, "--conf_th", "0.0", "--batch_size", "2",
             "--arch", "yolat_pp", "--act", "gelu", "--norm", "layer",
             "--n_filters", "8", "--device", "cpu"]
    infer.main(serve + ["--serve_mode", "module"])
    with open(out) as f:
        assert sum(1 for _ in f) == 2
    for mode in ("fast", "fast_bf16"):
        with pytest.raises(ValueError, match="--act gelu --norm layer"):
            infer.main(serve + ["--serve_mode", mode])
    # cli.detect's loop on the eval-mode module, one image a call
    drawn = []
    res = detect.detect(
        ["--data_dir", synthetic_root, "--pretrained_model", pth,
         "--serve_mode", "flax", "--conf_th", "0.0", "--out_dir",
         str(tmp_path / "overlays")] + serve[-10:],
        render=lambda svg, w, h, boxes, *a, **k: drawn.append(len(boxes)))
    assert len(drawn) == len(res["images"]) == 2 and sum(drawn) > 0


@pytest.mark.parametrize("act", ["relu", "leakyrelu", "gelu", "none"])
@pytest.mark.parametrize("norm", ["batch", "layer", "none"])
def test_config_refusals_that_stay(act, norm):
    cfg = Config(arch="yolat_pp", act=act, norm=norm)
    check_model_config(cfg)
    for serve_mode in ("fast", "fast_bf16"):
        if (act, norm) == ("relu", "batch"):
            check_serve_mode(cfg, serve_mode)
            continue
        with pytest.raises(ValueError,
                           match=f"--serve_mode {serve_mode} with --conv "
                                 f"attr_edge_gp2 --act {act} --norm {norm}"):
            check_serve_mode(cfg, serve_mode)
    check_serve_mode(cfg, "flax")
    if (act, norm) != ("relu", "batch"):
        with pytest.raises(ValueError, match=f"--fused_head_train true with "
                                             f"--act {act} --norm {norm}"):
            check_model_config(cfg.replace(fused_head_train=True))
    with pytest.raises(NotImplementedError,
                       match="--arch yolat_pp with --conv edge"):
        check_model_config(cfg.replace(conv="edge"))


@pytest.mark.parametrize("act", ["relu", "leakyrelu", "gelu"])
def test_activation_gradients_match_flax_at_the_kink(act):
    """Each activation and its gradient against yolat_tpu's `act_fn`,
    x = 0 included: flax's leaky_relu passes the whole gradient at 0
    (torch's F.leaky_relu the slope), and a GAT node with no incoming edge
    sits at its bias exactly, 0 at init."""
    from yolat_tpu.nn.layers import act_fn as jax_act
    from yolat_tpu_torch.nn.layers import act_layer

    x = np.array([-1.5, -1e-3, 0.0, 1e-3, 2.0], np.float32)
    want, vjp = jax.vjp(jax_act(act), jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    got = act_layer(act)(t)
    got.backward(torch.ones_like(got))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.ones_like(want))[0]),
                               rtol=1e-6, atol=1e-7)


def test_seeded_model_draws_layer_norms():
    """`seeded_model` draws the LayerNorms' affine terms as it draws the
    BatchNorms', so a smoke check under --norm layer sees a misplaced one;
    the gp2 convs keep their BatchNorms."""
    from yolat_tpu_torch.nn.model import seeded_model

    model = seeded_model(_cfg("gelu", "layer", "per_edge"), seed=1)
    lns = [m for m in model.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(lns) == 8  # one per hierarchy, fusion and head MLP
    for ln in lns:
        assert float((ln.weight - 1).abs().max()) > 0.05
        assert float(ln.bias.abs().max()) > 0.01
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    assert len(bns) == 6 and all(
        float((b.running_var - 1).abs().max()) > 0.05 for b in bns)
