"""Inputs and helpers shared by the YOLaT++ training tests of the port
(tests/test_torch_pp_train.py and tests/test_torch_pp_train_step.py);
no test here. What those files hold against yolat_tpu's training, on
the CPU: the train-mode module on its three routes through the
primitive level (per super edge over the padded buffer, the same level
over the `sew_` plan with kernels 7 and 8's plain versions, factored),
the fused pool head under YOLaT++, the train step's two repairs for
YOLaT++ batches, and the train CLI with evaluation, checkpoint and the
test CLI.

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
from yolat_tpu.train.loop import build_model as jax_build_model
from yolat_tpu.train.loop import create_state
from yolat_tpu.train.loop import make_train_step as jax_step
from yolat_tpu.train.optim import make_optimizer as jax_optimizer
from yolat_tpu.train.optim import steplr
from yolat_tpu.train.config import Config as JaxConfig
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


def _by_name(params, stats, act="relu"):
    return export_state_dict_pp({"params": jax.tree.map(np.asarray, params),
                                 "batch_stats": jax.tree.map(np.asarray,
                                                             stats)},
                                act=act)


def _jax_forward(jcfg, state, jbatch, loss_of=None, jit=False):
    """value_and_grad of the detection loss (or of `loss_of(prim_at_node)`)
    -> (loss, batch stats after, prim_at_node, gradients); eager, or with
    `jit` one jitted call with the batch as an argument (closed over as a
    constant, JAX's jitted gradient parts from its eager one: ROADMAP's
    stated differences, PR 18)."""
    jm = jax_build_model(jcfg)
    field = ("label_iou_rel" if jcfg.iou_aware_loss else None)

    def fn(params, batch):
        (logits, _), mut = jm.apply(
            {"params": params, "batch_stats": state.batch_stats}, batch,
            train=True, mutable=["batch_stats", "intermediates"])
        prim = mut["intermediates"]["prim_at_node"][0]
        if loss_of is not None:
            return loss_of(prim), (mut["batch_stats"], prim)
        loss = jax_loss(logits, batch["labels"], batch["proposal_mask"],
                        label_iou=batch[field] if field else None)["loss"]
        return loss, (mut["batch_stats"], prim)

    grad_fn = jax.value_and_grad(fn, has_aux=True)
    (loss, (stats, prim)), grads = (jax.jit(grad_fn) if jit else grad_fn)(
        state.params, jbatch)
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


def train_step_parity(jb, pb, route, jcfg, cfg, tx, state, n_bn=14,
                      jit=False):
    """The port's train step against yolat_tpu's from the JAX `state`
    (crossed through `load_jax_variables`) on the batches (jb, pb): the
    loss, `prim_at_node`, the BatchNorm statistics (`n_bn` BatchNorms: 3
    per conv, 2 fusion, 2 head, 4 hierarchy under --norm batch) and the
    step-1 gradients (JAX's jitted with `jit`), then the parameters after
    3 Adam steps, at the tolerances of this module's docstring."""
    model = _port_model(cfg, state)
    assert hasattr(model, "super_fact_mlp") == (route == "factored")

    # loss, prim_at_node, BN statistics and step-1 gradients
    jbatch = jax_finalize(jax.tree.map(jnp.asarray, jb))
    jloss, jstats, jprim, jgrads = _jax_forward(jcfg, state, jbatch,
                                                jit=jit)
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
    want = _by_name(jgrads, state.batch_stats, cfg.act)
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
    stats = _by_name(state.params, jstats, cfg.act)
    n_stats = 0
    for name, v in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), stats[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
            n_stats += 1
    assert n_stats == 2 * n_bn

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
    want = _by_name(state.params, state.batch_stats, cfg.act)
    first = _by_name(state0.params, state0.batch_stats, cfg.act)
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

