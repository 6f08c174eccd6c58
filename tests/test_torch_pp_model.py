"""YOLaT++ of the port against yolat_tpu's, on the CPU: the eval-mode
module, the weight conversion, the fold and the folded engine, per-edge
and factored, on the same seeded toy batch and the same weights.

The weights start in JAX (`model.init`, gates opened to 0.3 + 0.1 i as
tests/test_fast_pp.py does, BatchNorm statistics and affine terms
randomised from a numpy seed so that folding is not the identity) and
reach the port through `load_jax_variables`. The batch is yolat_tpu's toy
batch (its own packer), to which each package adds its own plans.
Tolerance: logits rtol/atol 2e-4 at f32, as tests/test_fast_pp.py holds
the JAX engine to the JAX module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.data.packing import PadSizes as JaxPadSizes
from yolat_tpu.data.packing import finalize_batch as jax_finalize
from yolat_tpu.data.toy import random_packed_batch
from yolat_tpu.eval.fast_forward import fast_forward_pp as jax_engine
from yolat_tpu.eval.fast_forward import fold_params_pp as jax_fold
from yolat_tpu.nn.yolat_pp import YOLaTPlusPlus as JaxPP
from yolat_tpu.nn.yolat_pp import fourier_features as jax_fourier
from yolat_tpu.ops.banded_message import banded_plan as jax_banded_plan
from yolat_tpu.ops.edge_window import edge_window_plan as jax_ew_plan
from yolat_tpu_torch.config import PP_GATES, Config
from yolat_tpu_torch.data.packing import finalize_batch, to_device
from yolat_tpu_torch.eval.fast_forward import (fast_forward_pp,
                                               fold_params_for,
                                               fold_params_pp)
from yolat_tpu_torch.nn.model import (build_model, load_jax_variables,
                                      seeded_model)
from yolat_tpu_torch.nn.yolat_pp import YOLaTPlusPlus, fourier_features
from yolat_tpu_torch.ops.plans import banded_plan, edge_window_plan

TOL = dict(rtol=2e-4, atol=2e-4)


def _toy(seed, n_images=4):
    """yolat_tpu's toy batch with N a multiple of 512 (the fused pool head
    of both engines needs it) -> (numpy batch, JAX batch, port batch)."""
    _, pad = random_packed_batch(seed=seed, n_images=n_images)
    pad = JaxPadSizes(-(-pad.n_nodes // 512) * 512, pad.n_edges, pad.n_super,
                      pad.n_proposals, pad.n_gt, pad.n_images)
    b, _ = random_packed_batch(seed=seed, n_images=n_images, pad=pad)
    n = b["pos"].shape[0]
    plans = edge_window_plan(b["edge"], b["edge_mask"], b["e_attr"], n,
                             transpose=True)
    plans.update({"sew_" + k: v for k, v in banded_plan(
        b["edge_super"], b["super_mask"], b["e_attr_super"], n).items()})
    jb = jax_finalize(jax.tree.map(jnp.asarray, b))
    pb = finalize_batch(to_device({**b, **plans}, "cpu"))
    return b, jb, pb


def _jax_variables(jb, factored, seed=0):
    model = JaxPP(n_classes=17, sorted_edges=True, factored_prim=factored)
    var = model.init({"params": jax.random.key(seed)}, jb, train=True)
    rng = np.random.default_rng(seed)

    def bn(path, v):
        name = path[-1].key
        v = np.asarray(v)
        if name == "var":
            return (0.5 + rng.random(v.shape)).astype(np.float32)
        if name == "mean":
            return (0.2 * rng.normal(size=v.shape)).astype(np.float32)
        if name == "scale" and "bn_" in path[-2].key:
            return (1 + 0.2 * rng.normal(size=v.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        return v

    var = jax.tree_util.tree_map_with_path(bn, jax.device_get(
        {"params": var["params"], "batch_stats": var["batch_stats"]}))
    params = dict(var["params"])
    for i, g in enumerate(PP_GATES):
        params[g] = np.asarray(0.3 + 0.1 * i, np.float32)
    return model, {"params": params, "batch_stats": var["batch_stats"]}


def _port_model(var, factored):
    cfg = Config(arch="yolat_pp", n_classes=17, pp_factored_prim=factored)
    model = build_model(cfg)
    assert isinstance(model, YOLaTPlusPlus)
    return cfg, load_jax_variables(model, var).eval()


def test_fourier_features_match():
    pos = np.random.default_rng(0).random((64, 2)).astype(np.float32)
    np.testing.assert_allclose(
        fourier_features(torch.from_numpy(pos), 4).numpy(),
        np.asarray(jax_fourier(jnp.asarray(pos), 4)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("factored", [False, True])
def test_module_eval_logits_match_jax(factored):
    _, jb, pb = _toy(3)
    jmodel, var = _jax_variables(jb, factored)
    want, wb = jmodel.apply(var, jb, train=False)
    _, model = _port_model(var, factored)
    assert hasattr(model, "super_fact_mlp") == factored
    assert hasattr(model, "super_edge_mlp") != factored
    with torch.no_grad():
        got, gb = model(pb)
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    with pytest.raises(NotImplementedError, match="eval mode"):
        model.train()(pb)


@pytest.mark.parametrize("factored", [False, True])
def test_fold_matches_jax_array_for_array(factored):
    _, jb, _ = _toy(3)
    _, var = _jax_variables(jb, factored)
    want = jax_fold(var, n_blocks=2)
    cfg, model = _port_model(var, factored)
    got = fold_params_for(cfg, model)
    assert ("super_fact_mlp" in got) == factored
    assert ("super_edge_mlp" in got) != factored
    assert set(got) - {"n_blocks_out", "n_freqs"} == set(want)
    for i, (gc, wc) in enumerate(zip(got["convs"], want["convs"])):
        assert set(gc) == set(wc)
        for k in gc:
            np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{i}{k}")
    for name in set(want) - {"convs", "gates"}:
        for a, b in zip(got[name], want[name]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
    for g in PP_GATES:
        assert got["gates"][g].shape == ()
        assert float(got["gates"][g]) == float(want["gates"][g])


@pytest.mark.parametrize("factored", [False, True])
def test_engine_matches_jax_engine_and_module(factored):
    _, jb, pb = _toy(7)
    jmodel, var = _jax_variables(jb, factored, seed=1)
    cfg, model = _port_model(var, factored)
    folded = fold_params_pp(model)
    got, gb = fast_forward_pp(folded, pb)
    want, _ = jax_engine(jax_fold(var, n_blocks=2), jb, edge_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jm, _ = jmodel.apply(var, jb, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm), **TOL)
    with torch.no_grad():
        mod, _ = model(pb)
    np.testing.assert_allclose(got.numpy(), mod.numpy(), **TOL)
    assert torch.equal(gb, pb["bbox"])
    # the two-pass curve route (two launches of kernel 5) is the same sum
    two, _ = fast_forward_pp(folded, pb, curve_fused=False)
    np.testing.assert_allclose(two.numpy(), got.numpy(), **TOL)
    # bf16: the ranking serving needs (tests/test_fast_pp.py asks > 0.97 of
    # the JAX engine; the toy batch has few proposals, so hold the port to
    # what the JAX engine reaches on these inputs) and logits within 2% of
    # scale of the JAX engine's bf16 logits
    half, _ = fast_forward_pp(folded, pb, bf16=True)
    assert half.dtype == torch.float32
    jhalf, _ = jax_engine(jax_fold(var, n_blocks=2), jb, edge_kernel=False,
                          bf16=True)
    jhalf = np.asarray(jhalf, np.float32)
    m = pb["proposal_mask"].numpy()
    top = got.numpy().argmax(1)[m]
    agree = (half.numpy().argmax(1)[m] == top).mean()
    assert agree >= min(0.97, (jhalf.argmax(1)[m] == top).mean()) > 0.9
    scale = np.abs(got.numpy()[m]).max()
    assert np.abs(half.numpy() - jhalf)[m].max() <= 0.02 * scale


def test_engine_matches_jax_kernels_in_interpret_mode():
    """yolat_tpu's engine through its Pallas kernels (edge window, banded,
    fused pool head; interpret mode) against the port's engine."""
    b, _, pb = _toy(11, n_images=16)
    n = b["pos"].shape[0]
    extras = dict(jax_ew_plan(b["edge"], b["edge_mask"], b["e_attr"], n,
                              wn=128))
    for prefix, e, m, a, sb in (
            ("sew_", b["edge_super"], b["super_mask"], b["e_attr_super"], 1),
            ("cwd_", b["edge"], b["edge_mask"], b["e_attr"], 1),
            ("cws_", b["edge"], b["edge_mask"], b["e_attr"], 0)):
        p = jax_banded_plan(e, m, a, n, wn=128, pad=64, eblk=128, sortby=sb)
        assert p is not None, prefix
        extras.update({prefix + k: v for k, v in p.items()})
    jb = jax_finalize(jax.tree.map(jnp.asarray, {**b, **extras}))
    _, var = _jax_variables(jb, False, seed=2)
    want, _ = jax_engine(jax_fold(var, n_blocks=2), jb, edge_kernel=True,
                         interpret=True)
    _, model = _port_model(var, False)
    got, _ = fast_forward_pp(fold_params_pp(model), pb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_zero_gates_give_the_canonical_logits_bit_for_bit():
    _, _, pb = _toy(5)
    canon = seeded_model(Config(n_classes=17), seed=4)
    # a fresh model: the gates start at zero
    pp = build_model(Config(arch="yolat_pp", n_classes=17)).eval()
    assert all(float(getattr(pp, g).detach()) == 0.0 for g in PP_GATES)
    sd = {}
    for k, v in canon.state_dict().items():
        k = k.replace("cls_net.head.gconv", "convs.0")
        k = k.replace("cls_net.backbone.0.body.gconv", "convs.1")
        sd[k.replace("cls_net.", "")] = v
    missing, unexpected = pp.load_state_dict(sd, strict=False)
    assert not unexpected
    assert {m.split(".")[0] for m in missing} == {
        "point_pe_mlp", "curve_mlp", "super_edge_mlp", "super_node_mlp",
        *PP_GATES}
    with torch.no_grad():
        want, _ = canon(pb)
        got, _ = pp(pb)
    assert torch.equal(got, want)


@pytest.mark.parametrize("factored", [False, True])
def test_each_gate_reaches_the_logits(factored):
    _, _, pb = _toy(5)
    cfg = Config(arch="yolat_pp", n_classes=17, pp_factored_prim=factored)
    model = seeded_model(cfg, seed=3)
    assert [round(getattr(model, g).item(), 2) for g in PP_GATES] == [
        0.3, 0.4, 0.5, 0.6]
    folded = fold_params_pp(model)
    base, _ = fast_forward_pp(folded, pb)
    with torch.no_grad():
        base_m, _ = model(pb)
    for g in PP_GATES:
        closed = {**folded, "gates": {**folded["gates"],
                                      g: torch.zeros(())}}
        diff, _ = fast_forward_pp(closed, pb)
        assert float((diff - base).abs().max()) > 1e-3, g
        with torch.no_grad():
            keep = getattr(model, g).clone()
            getattr(model, g).zero_()
            diff_m, _ = model(pb)
            getattr(model, g).copy_(keep)
        assert float((diff_m - base_m).abs().max()) > 1e-3, g


def test_missing_pack_fields_raise():
    """A factored checkpoint on a batch without the factored fields, and
    any checkpoint on a batch without the plans, say what is missing."""
    _, _, pb = _toy(5, n_images=2)
    fact = seeded_model(Config(arch="yolat_pp", n_classes=17,
                               pp_factored_prim=True))
    strip = {k: v for k, v in pb.items() if k not in (
        "sup_member", "sup_rank", "sup_abar", "prop_first_row")}
    with pytest.raises(ValueError, match="factored pack fields"):
        fast_forward_pp(fold_params_pp(fact), strip)
    with pytest.raises(ValueError, match="factored pack fields"), \
            torch.no_grad():
        fact(strip)
    edge = seeded_model(Config(arch="yolat_pp", n_classes=17))
    folded = fold_params_pp(edge)
    no_sew = {k: v for k, v in pb.items() if not k.startswith("sew_")}
    with pytest.raises(ValueError, match="sew_"):
        fast_forward_pp(folded, no_sew)
    fast_forward_pp(fold_params_pp(fact), no_sew)  # reads no super plan
    no_t = {k: v for k, v in pb.items() if k != "ew_sperm"}
    with pytest.raises(ValueError, match="transpose"):
        fast_forward_pp(folded, no_t)
    with pytest.raises(NotImplementedError, match="arch"):
        build_model(Config(arch="resnet"))
    with pytest.raises(NotImplementedError, match="eval mode"):
        build_model(Config(arch="yolat_pp", fused_head_train=True))
