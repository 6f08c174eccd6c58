"""YOLaT++ training of the port against yolat_tpu's, on the CPU: the
train-mode module's banded route against its sparse route and yolat_tpu's,
the refusals of a batch without its plan, a fresh model as the canonical
detector, dropout's generator, the train step's repairs under edge dropout,
and the compute type of the super-edge attributes. The train step itself
(loss, gradients, 3 Adam steps) is held in tests/test_torch_pp_train_step.py,
the train CLI with evaluation, checkpoint and the test CLI in
tests/test_torch_pp_train_cli.py.
Inputs, helpers and the tolerances: tests/torch_pp_train_common.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_pp_train_common import (WIDTH, _by_name, _configs, _jax_forward,
                                   _jax_state, _port_model, batches, toy)
from yolat_tpu.data.packing import finalize_batch as jax_finalize
from yolat_tpu_torch.config import PP_GATES, Config
from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.nn.model import build_model
from yolat_tpu_torch.train.loop import forward_loss, prepare_batch
from yolat_tpu_torch.train.trainer import init_model, run_training

__all__ = ["batches", "toy"]  # the module fixtures the tests take


def _prim_run(model, fb, eval_too=True):
    """Train-mode prim_at_node, super_edge_mlp's running statistics after
    the forward, and the gradients of tanh(prim / 10).sum()."""
    model.train()
    probes = {}
    model(fb, probes=probes)
    prim = probes["prim_at_node"]
    model.zero_grad()
    torch.tanh(prim / 10.0).sum().backward()
    bn = model.super_edge_mlp[1]
    return (prim.detach().numpy(),
            (bn.running_mean.numpy().copy(), bn.running_var.numpy().copy()),
            {n: p.grad.numpy().copy() for n, p in model.named_parameters()
             if p.grad is not None})


def test_banded_route_matches_sparse_route_and_jax(toy):
    """The port's banded route against its sparse route and against
    yolat_tpu's banded route (its Pallas kernels in interpret mode), where
    the comparison is well posed (tests/test_banded_train.py:118-130)."""
    jb, pb = toy
    jcfg, cfg = _configs("banded")
    _, state = _jax_state(jcfg, jb)
    banded = _port_model(cfg, state)
    sparse = _port_model(cfg.replace(pp_banded_super=False), state)
    assert banded.banded_super and not sparse.banded_super
    fb = prepare_batch(cfg, to_device(pb, "cpu"))

    with torch.no_grad():
        le, _ = sparse.eval()(fb)
        lb, _ = banded.eval()(fb)
    np.testing.assert_allclose(lb.numpy(), le.numpy(), rtol=1e-5, atol=1e-5)
    assert np.abs(le.numpy()).max() > 0.1

    pa, sa, ga = _prim_run(sparse, fb)
    pb_, sb, gb = _prim_run(banded, fb)
    jbatch = jax_finalize(jax.tree.map(jnp.asarray, jb))
    _, jstats, jprim, jgrads = _jax_forward(
        jcfg, state, jbatch, loss_of=lambda p: jnp.tanh(p / 10.0).sum(),
        jit=True)
    jg = _by_name(jgrads, state.batch_stats)
    js = _by_name(state.params, jstats)
    scale = np.abs(pa).max()
    assert scale > 0.1
    for prim in (pa, jprim):
        np.testing.assert_allclose(pb_, prim, rtol=1e-4, atol=1e-4 * scale)
    for got, want in zip(sb, sa):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sb[0], js["super_edge_mlp.1.running_mean"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sb[1], js["super_edge_mlp.1.running_var"],
                               rtol=1e-4, atol=1e-4)
    gscale = max(np.abs(v).max() for v in ga.values())
    assert gscale > 1e-3 and set(ga) == set(gb) and len(gb) > 20
    for name, g in gb.items():
        for want in (ga[name], jg[name]):
            np.testing.assert_allclose(g, want, rtol=1e-3,
                                       atol=1e-4 * gscale, err_msg=name)
    # the conv stack below the gather got its gradient through kernel 7's
    # backward, the level's MLP through kernel 8's
    assert np.abs(gb["convs.1.nn.0.weight"]).max() > 0
    assert np.abs(gb["super_edge_mlp.0.weight"]).max() > 0


def test_banded_route_refuses_a_batch_without_its_plan(toy):
    _, pb = toy
    cfg = _configs("banded")[1]
    model = build_model(cfg)
    fb = prepare_batch(cfg, to_device(pb, "cpu"))
    no_plan = {k: v for k, v in fb.items() if not k.startswith("sew_")}
    with pytest.raises(ValueError, match="sew_"):
        model.train()(no_plan)
    no_t = {k: v for k, v in fb.items() if k not in ("sew_tperm", "sew_tptr")}
    with pytest.raises(ValueError, match="transpose"):
        model.train()(no_t)
    with torch.no_grad():  # forward only: evaluation batches carry no transpose
        model.eval()(no_t)
    with pytest.raises(ValueError, match="pp_banded_super with drop_edge"):
        run_training(cfg.replace(drop_edge=0.1), "cpu")
    with pytest.raises(NotImplementedError, match="window"):
        build_model(cfg.replace(train_layout="window"))


def test_fresh_model_is_the_canonical_detector_and_its_gates_learn(batches):
    jb, pb = batches
    canon_cfg = Config(n_classes=17, n_filters=WIDTH, data_aug=False)
    cfg = _configs("per_edge")[1]
    canon, pp = init_model(canon_cfg, "cpu"), init_model(cfg, "cpu")
    assert all(float(getattr(pp, g).detach()) == 0.0 for g in PP_GATES)
    fb = prepare_batch(cfg, to_device(pb, "cpu"))
    with torch.no_grad():
        assert torch.equal(pp.eval()(fb)[0], canon.eval()(fb)[0])
    want = forward_loss(canon_cfg, canon, fb)["loss"]
    got = forward_loss(cfg, pp, fb)["loss"]
    assert torch.equal(got, want)
    got.backward()
    want.backward()
    assert torch.equal(pp.convs[0].lin_r.weight.grad,
                       canon.cls_net.head.gconv.lin_r.weight.grad)

    # at gate zero the gates' own gradients are the hierarchy's only signal
    jcfg = _configs("per_edge")[0]
    _, state = _jax_state(jcfg, jb, open_gates=False)
    model = _port_model(cfg, state)
    jbatch = jax_finalize(jax.tree.map(jnp.asarray, jb))
    jloss, _, _, jgrads = _jax_forward(jcfg, state, jbatch, jit=True)
    loss = forward_loss(cfg, model, fb)["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    for g in PP_GATES:
        got_g = float(getattr(model, g).grad)
        assert abs(got_g) > 1e-5, g
        np.testing.assert_allclose(got_g, float(jgrads[g]), rtol=1e-3,
                                   atol=1e-6, err_msg=g)
    for name, p in model.named_parameters():
        if name.split(".")[0] in ("point_pe_mlp", "curve_mlp",
                                  "super_edge_mlp", "super_node_mlp"):
            assert not p.grad.any(), name  # behind a closed gate


def test_dropout_draws_from_the_generator(toy):
    _, pb = toy
    cfg = _configs("per_edge")[1].replace(dropout=0.5)
    model = init_model(cfg, "cpu").train()
    fb = prepare_batch(cfg, to_device(pb, "cpu"))
    with pytest.raises(ValueError, match="Generator"):
        model(fb)
    outs = [model(fb, torch.Generator().manual_seed(s))[0] for s in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


def test_edge_dropout_strips_the_stale_pack_fields_and_matches_jax(batches):
    """Under drop_edge > 0 a YOLaT++ train batch loses src_count,
    super_dst_count and the sew_ plan beside dst_count and the ew_ plan,
    and the loss is JAX's on the same kept edges."""
    jb, pb = batches
    jcfg, cfg = _configs("per_edge", drop_edge=0.3)
    _, state = _jax_state(jcfg, jb)
    model = _port_model(cfg, state)
    fb = prepare_batch(cfg, to_device(pb, "cpu"),
                       torch.Generator().manual_seed(0))
    gone = {"dst_count", "src_count", "super_dst_count"}
    assert gone <= set(pb) and not gone & set(fb)
    assert any(k.startswith("sew_") for k in pb)
    assert not any(k.startswith(("sew_", "ew_")) for k in fb)
    assert "prop_count" in fb and "sup_pool_blk_first" in fb
    kept = fb["edge_mask"].numpy()
    assert 0 < kept.sum() < pb["edge_mask"].sum()
    loss = forward_loss(cfg, model, fb)["loss"]
    # yolat_tpu's step on the same kept edges: its own stale-key rule
    # (train/loop.py:151-154), then the forward without a second draw
    stale = ("dst_count", "src_count", "super_dst_count")
    jbatch = {k: v for k, v in jb.items() if k not in stale
              and not k.startswith(("ew_", "sew_", "cwd_", "cws_"))}
    jbatch = jax_finalize(jax.tree.map(
        jnp.asarray, {**jbatch, "edge_mask": kept}))
    jloss, _, _, _ = _jax_forward(jcfg.replace(drop_edge=0.0), state, jbatch,
                                  jit=True)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    # with the stale counts left in, the means divide by the wrong numbers
    stale_fb = {**fb, **{k: torch.from_numpy(pb[k]) for k in gone}}
    wrong = forward_loss(cfg, model, stale_fb)["loss"]
    assert abs(wrong.item() - jloss) > 1e-4 * abs(jloss)


def test_e_attr_super_reaches_the_mlp_in_the_compute_type(toy):
    _, pb = toy
    cfg = _configs("per_edge")[1].replace(dtype="bfloat16")
    model = init_model(cfg, "cpu")
    seen = {}
    model.register_forward_pre_hook(
        lambda m, args: seen.update(batch=args[0]))
    model.super_edge_mlp.register_forward_pre_hook(
        lambda m, args: seen.update(x=args[0]))
    fb = prepare_batch(cfg, to_device(pb, "cpu"))
    assert fb["e_attr_super"].dtype == torch.float32
    loss = forward_loss(cfg, model, fb)["loss"]
    assert np.isfinite(loss.item())
    for k in ("x", "pos", "e_attr", "e_attr_super"):
        assert seen["batch"][k].dtype == torch.bfloat16, k
    assert seen["x"].dtype == torch.bfloat16
    assert seen["batch"]["sup_abar"].dtype == torch.float32
    loss.backward()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
