"""The YOLaT++ train step of the port against yolat_tpu's, on the CPU, on
the three routes through the primitive level and with the fused pool head:
the loss, `prim_at_node`, the BatchNorm statistics and the step-1
gradients, then the parameters after 3 Adam steps on one batch of the
synthetic dataset packed by each package's own loader. Inputs, helpers and
the tolerances, with why each is what it is: tests/torch_pp_train_common.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_pp_train_common import (LR, _assert_grads_close, _by_name,
                                   _configs, _float64_grads, _gate_error,
                                   _jax_forward, _jax_state, _port_model,
                                   batches)
from yolat_tpu.data.packing import finalize_batch as jax_finalize
from yolat_tpu.train.loop import make_train_step as jax_step
from yolat_tpu_torch.config import PP_GATES
from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.plans import bm_of, sup_plan_of
from yolat_tpu_torch.train.loop import (forward_loss, make_train_step,
                                        prepare_batch)
from yolat_tpu_torch.train.optim import make_optimizer, make_scheduler

__all__ = ["batches"]  # the module fixture the test takes


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

