"""YOLaT++ training of the port against yolat_tpu's, on the CPU: the
train-mode module on its three routes through the primitive level (per
super edge over the padded buffer, the same level over the `sew_` plan with
kernels 7 and 8's plain versions, factored), the fused pool head under
YOLaT++, the train step's two repairs for YOLaT++ batches, and the train
CLI with evaluation, checkpoint and the test CLI.

Inputs: for the train step, one batch of the synthetic dataset packed by
each package's own loader (the same arrays but for the plans, which each
package lays out its own way); for the route comparisons yolat_tpu's toy
batch (its own packer, N rounded up to a multiple of 512), to which each
package adds its own plans. Every proposal of the toy batch is the same
square in its own normalised frame, so its proposal-level BatchNorms see
no variance and its logits carry no signal: the JAX package's own route
test reads `prim_at_node` there for that reason, and so do these. The
weights start in JAX at width 16 (`create_state`), the gates opened to 0.3
+ 0.1 i so that every level reaches the loss, and cross through
`load_jax_variables`. Tolerances at f32, per class of entry:
  * loss rtol 1e-5; eval-mode logits rtol/atol 2e-4 (as
    tests/test_torch_pp_model.py);
  * `prim_at_node` 1e-4 of its scale (the factored route 1e-3: its f32
    prefix sums round at the size of the running sum, in another order in
    each package), `super_edge_mlp`'s batch statistics
    rtol/atol 1e-4, gradients of a loss read off `prim_at_node` rtol 1e-3
    over 1e-4 of the largest gradient: what tests/test_banded_train.py
    holds yolat_tpu's banded route to against its sparse route, here also
    across the packages;
  * gradients of the detection loss. One ReLU pre-activation of 287744
    in the head lies within 5e-7 of zero on this batch, and the port's f32
    forward puts it on the other side than yolat_tpu's: a whole cotangent
    passes or not, which moves the head's Dense gradient by 1e-2 of its
    scale and the gradient of gate_point, a sum of 336k terms that cancel
    to 1e-3, by 10%. So the formulas are held tightly where no rounding
    decides a gate, and the f32 path loosely: the port's module run in
    float64 against yolat_tpu's f32 gradients at rtol 1e-3 over 5e-3 of
    each tensor's scale for all but 1e-3 of a tensor's entries, or one (yolat_tpu's
    own f32 forward flips a gate too: with the fused head one entry of
    1024 of the fusion BatchNorm's shift gradient is off by 1.6% of scale)
    and a relative Frobenius error of 1e-2, Dense biases feeding a
    BatchNorm at noise level (atol 1e-4), as tests/test_torch_train.py
    states and explains; the four gates' gradients as one vector (a gate's
    gradient is a sum that cancels; its scale is its siblings') at 5e-3,
    and 2e-2 on the factored route, where both packages' f32 prefix sums
    put 1e-3 of a feature of noise under every later gate (there both f32
    runs part from the float64 run alike, gate_point by 30%, and the
    tensors are held at 3e-2 of scale and 3e-2 in the Frobenius norm; read
    <= 1.4e-2); the port's
    f32 gradients against its float64 ones at a relative Frobenius error
    of 3e-2 per tensor (a flipped gate moves few entries), the gates'
    vector too;
  * the loss of steps 2 and 3 rtol 5e-4 (read <= 1.4e-4: the steps before
    moved noise-level entries by lr in directions the noise picks);
    parameters after 3 Adam steps: no entry parts by more than the 6 lr
    that three steps of opposite sign give (read <= 5.1 lr, in a Dense
    bias feeding a BatchNorm, whose gradient is noise); in the tensors
    whose gradient is set, all but 5e-3 of the entries within 2 lr (read
    <= 4.5e-3 of them beyond it); the running statistics, which move by
    0.1 to 2.4 and absorb those noise moves, within 2e-2 of their move in
    the Frobenius norm (read <= 6e-3); the gates within 0.1 lr (read <=
    0.02 lr); the entries whose step-1
    gradient is firmly set moved by lr/2 or more, with a median difference
    of 1e-4 = lr / 10 (read <= 6.5e-5) and a relative Frobenius error of
    the update of 8e-2 (read <= 5.3e-2), on the factored route 0.2 (read
    0.12: the prefix sums' noise); a step that is not applied reads 0.33
    (the canonical model's test holds 1e-5 and 2e-2; here a gate of the
    head flips between the packages, see above);
  * a fresh model: the gates are zero, the logits and the loss are the
    canonical detector's bit for bit, and the gates' own gradients match
    JAX's (rtol 1e-3 over 1e-6).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.packing import PadSizes as JaxPadSizes
from yolat_tpu.data.packing import finalize_batch as jax_finalize
from yolat_tpu.data.toy import random_packed_batch
from yolat_tpu.nn.model import detection_loss as jax_loss
from yolat_tpu.ops.banded_message import banded_plan as jax_banded_plan
from yolat_tpu.train.config import Config as JaxConfig
from yolat_tpu.train.loop import build_model as jax_build_model
from yolat_tpu.train.loop import create_state, make_train_step as jax_step
from yolat_tpu.train.optim import make_optimizer as jax_optimizer
from yolat_tpu.train.optim import steplr
from yolat_tpu_torch.cli import test as test_cli
from yolat_tpu_torch.cli import train as train_cli
from yolat_tpu_torch.config import PP_GATES, Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.nn.model import build_model, load_jax_variables
from yolat_tpu_torch.nn.state_dict import export_state_dict_pp
from yolat_tpu_torch.nn.yolat_pp import YOLaTPlusPlus
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.plans import (banded_plan, bm_of, edge_window_plan,
                                       sup_plan_of)
from yolat_tpu_torch.train.loop import (forward_loss, make_train_step,
                                        prepare_batch)
from yolat_tpu_torch.train.optim import make_optimizer, make_scheduler
from yolat_tpu_torch.train.trainer import init_model, run_training

WIDTH = 16
LR = 1e-3
ROUTES = {"per_edge": {}, "banded": {"pp_banded_super": True},
          "factored": {"pp_factored_prim": True, "iou_aware_loss": True,
                       "iou_aware_mode": "rel"}}


@pytest.fixture(scope="module")
def toy():
    """-> (JAX batch: numpy, with yolat_tpu's `sew_` plan; port batch:
    numpy, with the port's plans, the clique family's with its transpose)."""
    _, pad = random_packed_batch(seed=3, n_images=4)
    pad = JaxPadSizes(-(-pad.n_nodes // 512) * 512, pad.n_edges, pad.n_super,
                      pad.n_proposals, pad.n_gt, pad.n_images)
    b, _ = random_packed_batch(seed=3, n_images=4, pad=pad)
    n = b["pos"].shape[0]
    jplan = jax_banded_plan(b["edge_super"], b["super_mask"],
                            b["e_attr_super"], n, sortby=1)
    assert jplan is not None, "the super family must band on the toy batch"
    plans = edge_window_plan(b["edge"], b["edge_mask"], b["e_attr"], n,
                             transpose=True)
    plans.update({"sew_" + k: v for k, v in banded_plan(
        b["edge_super"], b["super_mask"], b["e_attr_super"], n,
        transpose=True).items()})
    return ({**b, **{"sew_" + k: v for k, v in jplan.items()}},
            {**b, **plans})


@pytest.fixture(scope="module")
def batches(synthetic_root):
    """One batch of 2 synthetic files from each package's loader -> (JAX
    batch with yolat_tpu's `sew_` plan, port batch with the port's)."""
    jds = JaxDataset(synthetic_root, "train", bbox_sampling_step=10)
    jb = next(iter(JaxLoader(jds, batch_size=2, shuffle=False,
                             extra_plans=("super",))))
    jb = {k: v[0] for k, v in jb.items()}
    assert "sew_bm_own" in jb, "the super family must band on this batch"
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    pb = next(iter(PackedLoader(ds, batch_size=2, super_family=True,
                                sew_plan="transpose")))
    for k in ("pos", "edge", "edge_super", "super_mask", "sup_rank"):
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    return jb, pb


def _configs(route, **kw):
    kw = dict(arch="yolat_pp", n_classes=17, n_filters=WIDTH, data_aug=False,
              lr=LR, **ROUTES[route], **kw)
    return JaxConfig(**kw), Config(**kw)


def _jax_state(jcfg, jb, open_gates=True):
    tx = jax_optimizer("adam", steplr(LR, jcfg.lr_adjust_freq,
                                      jcfg.lr_decay_rate, 1),
                       jcfg.weight_decay)
    state = create_state(jcfg, tx, jb, jax.random.key(0))
    if open_gates:
        params = dict(state.params)
        for i, g in enumerate(PP_GATES):
            params[g] = jnp.asarray(0.3 + 0.1 * i, jnp.float32)
        state = state.replace(params=params)
    return tx, state


def _port_model(cfg, state):
    model = build_model(cfg)
    assert isinstance(model, YOLaTPlusPlus)
    return load_jax_variables(model, jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))


def _by_name(params, stats):
    return export_state_dict_pp({"params": jax.tree.map(np.asarray, params),
                                 "batch_stats": jax.tree.map(np.asarray,
                                                             stats)})


def _jax_forward(jcfg, state, jbatch, loss_of=None):
    """value_and_grad of the detection loss (or of `loss_of(prim_at_node)`)
    -> (loss, batch stats after, prim_at_node, gradients)."""
    jm = jax_build_model(jcfg)
    field = ("label_iou_rel" if jcfg.iou_aware_loss else None)

    def fn(params):
        (logits, _), mut = jm.apply(
            {"params": params, "batch_stats": state.batch_stats}, jbatch,
            train=True, mutable=["batch_stats", "intermediates"])
        prim = mut["intermediates"]["prim_at_node"][0]
        if loss_of is not None:
            return loss_of(prim), (mut["batch_stats"], prim)
        loss = jax_loss(logits, jbatch["labels"], jbatch["proposal_mask"],
                        label_iou=jbatch[field] if field else None)["loss"]
        return loss, (mut["batch_stats"], prim)

    (loss, (stats, prim)), grads = jax.value_and_grad(fn, has_aux=True)(
        state.params)
    return float(loss), stats, np.asarray(prim), grads


def _gate_error(got, want) -> float:
    """Relative error of the four gates' gradients taken as one vector: a
    gate's own gradient is a sum of ~1e5 terms that cancel, its scale is
    its siblings'."""
    g, w = (np.array([float(d[k]) for k in PP_GATES]) for d in (got, want))
    assert np.all(np.sign(g) == np.sign(w)), (g, w)
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def _assert_grads_close(got, want, floor=5e-3, frob=1e-2):
    for name, g in got.items():
        w = want[name]
        if np.abs(w).max() < 1e-4 and np.abs(g).max() < 1e-4:
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)
        elif name in PP_GATES:
            continue
        else:
            out = np.abs(g - w) > 1e-3 * np.abs(w) + floor * np.abs(w).max()
            assert out.sum() <= max(1, 1e-3 * out.size), (name, out.sum())
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= frob, (name, err)


def _float64_grads(cfg, model, fb):
    """The detection loss's gradients with the module and the float batch
    fields in float64 (the weights are the f32 model's)."""
    m64 = copy.deepcopy(model).double()
    m64.zero_grad()
    fb64 = {k: (v.double() if torch.is_tensor(v) and v.dtype == torch.float32
                else v) for k, v in fb.items()}
    forward_loss(cfg, m64, fb64)["loss"].backward()
    return {n: p.grad.numpy() for n, p in m64.named_parameters()}


@pytest.mark.parametrize("route,fused", [
    ("per_edge", False), ("banded", False), ("factored", False),
    ("per_edge", True)])
def test_train_step_matches_jax(batches, route, fused):
    jb, pb = batches
    jcfg, cfg = _configs(route, fused_head_train=fused)
    tx, state = _jax_state(jcfg, jb)
    model = _port_model(cfg, state)
    assert hasattr(model, "super_fact_mlp") == (route == "factored")

    # loss, prim_at_node, BN statistics and step-1 gradients
    jbatch = jax_finalize(jax.tree.map(jnp.asarray, jb))
    jloss, jstats, jprim, jgrads = _jax_forward(jcfg, state, jbatch)
    fb = prepare_batch(cfg, to_device(pb, "cpu"))
    assert sup_plan_of(fb) is not None  # the aligned dst gather is on the path
    assert bm_of(fb, "sew_").tperm is not None
    _build.reset_launch_counts()
    probes = {}
    hook = model.register_forward_pre_hook(
        lambda m, args, kw: (args, {**kw, "probes": probes}),
        with_kwargs=True)
    loss = forward_loss(cfg, model, fb)["loss"]
    hook.remove()
    loss.backward()
    assert not any(_build.launch_counts.values())  # CPU: plain versions
    assert model.fused_fallbacks == 0
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    prim = probes["prim_at_node"].detach().numpy()
    assert np.abs(jprim).max() > 0.1
    ptol = 1e-3 if route == "factored" else 1e-4
    np.testing.assert_allclose(prim, jprim, rtol=ptol,
                               atol=ptol * np.abs(jprim).max())
    want = _by_name(jgrads, state.batch_stats)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    got64 = _float64_grads(cfg, model, fb)
    assert set(got) == set(got64) <= set(want) and len(got) > 60
    _assert_grads_close(got64, want,
                        *((3e-2, 3e-2) if route == "factored" else ()))
    assert _gate_error(got64, want) <= (2e-2 if route == "factored" else 5e-3)
    assert _gate_error(got, got64) <= 3e-2
    for name, g in got.items():
        if np.abs(got64[name]).max() >= 1e-4 and name not in PP_GATES:
            err = (np.linalg.norm(g - got64[name])
                   / np.linalg.norm(got64[name]))
            assert err <= 3e-2, (name, err)
    for g in PP_GATES:  # every level reaches the loss
        assert abs(float(got[g])) > 1e-5, g
    stats = _by_name(state.params, jstats)
    n_stats = 0
    for name, v in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), stats[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
            n_stats += 1
    assert n_stats == 2 * 14  # 3 per conv, 2 fusion, 2 head, 4 hierarchy

    # parameters after 3 steps of the same batch
    firm = {n: (np.abs(g) >= 1e-2 * np.abs(want[n]).max())
            & (np.abs(want[n]) >= 1e-2 * np.abs(want[n]).max())
            & (np.sign(g) == np.sign(want[n]))
            for n, g in got.items() if np.abs(want[n]).max() >= 1e-4}
    model = _port_model(cfg, state)
    start = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    opt = make_optimizer("adam", model.parameters(), LR, cfg.weight_decay)
    sched = make_scheduler(opt, LR, cfg.lr_adjust_freq, cfg.lr_decay_rate, 1)
    step = make_train_step(cfg, model, opt, sched)
    jstep = jax_step(jcfg, tx)
    stacked = {k: np.asarray(v)[None] for k, v in jb.items()}
    state0 = state
    for _ in range(3):
        got_loss = step(to_device(pb, "cpu"))["loss"]
        state, m = jstep(state, stacked, jax.random.key(1))
        np.testing.assert_allclose(float(got_loss), float(m["loss"]),
                                   rtol=5e-4)
    want = _by_name(state.params, state.batch_stats)
    first = _by_name(state0.params, state0.batch_stats)
    for name, v in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        diff = np.abs(v.numpy() - want[name])
        if name.endswith(("running_mean", "running_var")):
            moved = np.linalg.norm(want[name] - first[name])
            assert np.linalg.norm(diff) <= 2e-2 * moved, name
            continue
        assert np.all(diff <= 6 * LR + 1e-4 * np.abs(want[name])), name
        if name in firm:
            assert (diff > 2 * LR).mean() <= 5e-3, (name, diff.max())
    assert len(firm) > 30
    for name, mask in firm.items():
        moved = model.get_parameter(name).detach().numpy() - start[name]
        want_moved = want[name] - start[name]
        if name in PP_GATES:  # a scalar, whose gradient may change sign
            assert abs(moved - want_moved) <= 0.1 * LR, name
            continue
        assert np.abs(moved[mask]).mean() >= LR / 2, name
        diff = np.abs(moved - want_moved)[mask]
        assert np.median(diff) <= 1e-4, (name, np.median(diff))
        err = np.linalg.norm(diff) / np.linalg.norm(want_moved[mask])
        assert err <= (0.2 if route == "factored" else 8e-2), (name, err)


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
        jcfg, state, jbatch, loss_of=lambda p: jnp.tanh(p / 10.0).sum())
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
    jloss, _, _, jgrads = _jax_forward(jcfg, state, jbatch)
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
    jloss, _, _, _ = _jax_forward(jcfg.replace(drop_edge=0.0), state, jbatch)
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


@pytest.mark.parametrize("fused", ["false", "true"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_train_cli_trains_evaluates_and_the_test_cli_restores(
        tmp_path, synthetic_root, capsys, route, fused):
    flags = {"per_edge": ["--arch", "yolat_pp"],
             "banded": ["--arch", "yolat_pp", "--pp_banded_super", "true"],
             "factored": ["--profile", "yolat_pp_fast"]}[route]
    res = train_cli.main(["--data_dir", synthetic_root, "--device", "cpu",
                          "--n_filters", "8", "--batch_size", "2",
                          "--max_steps", "2", "--fused_head_train", fused,
                          "--root_dir", str(tmp_path), "--print_freq", "1"]
                         + flags)
    assert res["steps"] == 2 and len(res["losses"]) == 2
    assert all(np.isfinite(res["losses"])) and res["eval_batches"] == 1
    for k in ("map_50", "map_all", "top1_acc"):
        assert np.isfinite(res[k]), k
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "2 steps" in line and "banded_gather=0, banded_gather_bwd=0, " \
        "banded_scatter_own=0, banded_scatter_own_bwd=0" in line
    ck = os.path.join(res["exp_dir"], "checkpoint")
    assert os.path.exists(os.path.join(ck, "ckpt_1.pt"))
    table = test_cli.main(["--data_dir", synthetic_root, "--phase", "test",
                           "--device", "cpu", "--n_filters", "8",
                           "--batch_size", "2", "--pretrained_model", ck]
                          + flags)
    assert len(table["map_per_th"]) == 10
    np.testing.assert_allclose(table["map_50"], res["map_50"], atol=1e-6)
    if route == "per_edge" and fused == "false" \
            and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main(["--data_dir", synthetic_root] + flags)
