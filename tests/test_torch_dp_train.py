"""The port's data-parallel train step against yolat_tpu's on the CPU.

JAX runs `make_dp_train_step` on a 2-device slice of the 8-device CPU
mesh (tests/conftest.py); the port runs `make_dp_train_step` in 2 rank
processes over gloo (`parallel/launch.spawn_ranks`, a FileStore, a 60 s
group timeout, a 120 s join timeout: a hang fails this file, not the
run). Both take the synthetic train split (3 files) through their own
loaders at batch 1 over 2 devices, unshuffled: step 1 gives the ranks
distinct files, step 2 the third file to rank 0 and an empty window to
rank 1 (an all-masked batch that still steps). Weights start in JAX
(width 8, 2 blocks; the fusion width 1024 is fixed by the model) and
cross through `load_jax_variables`. data_aug off, dropout 0, f32.

Tolerances (no looser than tests/test_torch_train.py's single-device
step):
  * losses of both steps: rtol 1e-5.
  * SGD (lr 1e-2; Adam would turn noise-level gradients into +-lr moves,
    tests/test_model.py:155-160): the 2-step update of each parameter
    (state after minus state before, lr times the summed averaged
    gradients) within rtol 1e-3 and atol 5e-3 of the tensor's largest
    JAX update, the single-device test's gradient rule; a tensor whose
    updates stay below 2e-6 on both sides (lr times the 1e-4 noise floor
    of that rule, over 2 steps: the Dense biases feeding a BatchNorm,
    structurally zero) at atol 2e-6. The BatchNorm running statistics
    (from the moments summed over ranks) within rtol 1e-4, atol 1e-5.
  * Adam (lr 1e-3), one case, fused head on: the losses at rtol 1e-5
    and every entry within 2 * lr (4 * lr for the noise tensors and the
    running means), the single-device test's rule for entries that are
    not firmly set.
  * identical shards on 2 ranks against the port's single-device step,
    2 steps, and one rank (a group of rank 0 alone) against
    make_train_step: bit for bit, losses and state (but the running
    variances of identical shards: see that test).
A planted fault, a plain `dist.all_reduce` (no backward) in
MaskedBatchNorm, must fail the SGD comparison: the test sees the moments'
gradient path.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

import torch_dp_ranks
from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.train.config import Config as JaxConfig
from yolat_tpu.train.import_reference import export_state_dict
from yolat_tpu.train.loop import create_state
from yolat_tpu.train.loop import make_dp_train_step as jax_dp_step
from yolat_tpu.train.optim import make_optimizer as jax_optimizer
from yolat_tpu.train.optim import steplr
from yolat_tpu_torch.nn.model import SparseCADGCN, load_jax_variables
from yolat_tpu_torch.parallel.launch import spawn_ranks

WIDTH = 8
SGD_LR = 1e-2
ADAM_LR = 1e-3
STEPS = 2
WORLD = 2
JOIN_TIMEOUT_S = 120.0


def _export(variables) -> dict:
    return export_state_dict(jax.tree.map(np.asarray, variables))


def _variables(state) -> dict:
    return {"params": state.params, "batch_stats": state.batch_stats}


def _port_state(n_classes, variables, fused) -> dict:
    model = load_jax_variables(
        SparseCADGCN(n_classes, channels=WIDTH, fused_pool=fused),
        jax.tree.map(np.asarray, variables))
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


def _jax_setup(n_classes, jb, fused, optimizer):
    jcfg = JaxConfig(n_classes=n_classes, n_filters=WIDTH, data_aug=False,
                     fused_head_train=fused)
    if optimizer == "sgd":
        tx = optax.sgd(SGD_LR)
    else:
        tx = jax_optimizer("adam", steplr(ADAM_LR, jcfg.lr_adjust_freq,
                                          jcfg.lr_decay_rate, 1),
                           jcfg.weight_decay)
    state = create_state(jcfg, tx, {k: v[0] for k, v in jb.items()},
                         jax.random.key(0))
    return jcfg, tx, state


def _jax_run(jcfg, tx, state, jbs):
    """([losses], the state after STEPS steps in port names)."""
    step = jax_dp_step(jcfg, tx, Mesh(np.array(jax.devices()[:WORLD]),
                                      ("data",)))
    losses = []
    for jb in jbs[:STEPS]:
        state, m = step(state, jb, jax.random.key(1))
        losses.append(float(m["loss"]))
    return losses, _export(_variables(state))


SCENARIOS = {
    # name: (fused head, optimizer)
    "sgd_unfused": (False, "sgd"),
    "sgd_fused": (True, "sgd"),
    "adam_fused": (True, "adam"),
}


@pytest.fixture(scope="module")
def runs(synthetic_root):
    jds = JaxDataset(synthetic_root, "train", bbox_sampling_step=10)
    n_classes = jds.n_classes
    jbs = list(JaxLoader(jds, batch_size=1, n_devices=WORLD, shuffle=False,
                         prefetch=0))
    assert len(jbs) == STEPS and [int(n) for n in jbs[1]["n_images"]] == [1, 0]
    setups, states, scenarios = {}, {}, {}
    for name, (fused, opt) in SCENARIOS.items():
        setups[name] = _jax_setup(n_classes, jbs[0], fused, opt)
        states[name] = _port_state(n_classes, _variables(setups[name][2]),
                                   fused)
        scenarios[name] = dict(n_classes=n_classes, width=WIDTH, fused=fused,
                               optimizer=opt,
                               lr=SGD_LR if opt == "sgd" else ADAM_LR,
                               state=name, steps=STEPS)
    scenarios["fault_unfused"] = dict(scenarios["sgd_unfused"], fault=True)
    scenarios["identical_fused"] = dict(scenarios["sgd_fused"],
                                        identical=True)
    # the ranks run while JAX steps here
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn_ranks, torch_dp_ranks.train_scenarios, WORLD,
                           (synthetic_root, WORLD, scenarios, states,
                            scenarios["sgd_fused"]),
                           join_timeout_s=JOIN_TIMEOUT_S)
        jax_runs = {name: _jax_run(*setups[name], jbs) for name in SCENARIOS}
        ranks = port.result()
    return dict(jax=jax_runs, states=states, ranks=ranks)


def _hold_sgd(got: dict, want: dict, start: dict) -> None:
    """The SGD rule of the module docstring."""
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        g = got[name]
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
            continue
        du, dw = g - start[name], w - start[name]
        if np.abs(du).max() < 2e-6 and np.abs(dw).max() < 2e-6:
            np.testing.assert_allclose(du, dw, atol=2e-6, err_msg=name)
            continue
        np.testing.assert_allclose(du, dw, rtol=1e-3,
                                   atol=5e-3 * np.abs(dw).max(), err_msg=name)


@pytest.mark.parametrize("name", ["sgd_unfused", "sgd_fused"])
def test_dp_step_matches_jax(runs, name):
    want_losses, want = runs["jax"][name]
    for rank_out in runs["ranks"]:
        losses, got = rank_out[name]
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        _hold_sgd(got, want, runs["states"][name])


def test_dp_step_adam_matches_jax(runs):
    want_losses, want = runs["jax"]["adam_fused"]
    losses, got = runs["ranks"][0]["adam_fused"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    start = runs["states"]["adam_fused"]
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        noisy = name.endswith("running_mean") or (
            np.abs(w - start[name]).max() < 1e-6)
        np.testing.assert_allclose(got[name], w, rtol=1e-4,
                                   atol=(4 if noisy else 2) * ADAM_LR,
                                   err_msg=name)


def test_ranks_hold_one_state(runs):
    """Every rank steps to the same state (the averaged gradients and the
    global moments), bit for bit, in every scenario."""
    r0, r1 = runs["ranks"]
    for name in SCENARIOS:
        assert r0[name][0] == r1[name][0], name
        for k, v in r0[name][1].items():
            np.testing.assert_array_equal(v, r1[name][1][k], err_msg=k)


def test_empty_window_steps(runs):
    """Rank 1's second window is empty: it steps on an all-masked batch
    (its loss is the average over ranks), and the run above matched JAX's,
    whose second shard is empty too."""
    assert runs["ranks"][0]["n_images"] == [1, 1]
    assert runs["ranks"][1]["n_images"] == [1, 0]
    assert len(runs["ranks"][1]["sgd_fused"][0]) == STEPS


def test_identical_shards_equal_one_device(runs):
    """Every sum over 2 identical shards is twice the local one, exactly,
    and so is every count: the moments, their gradients and the averaged
    gradients are the single-device values, bit for bit (both runs in the
    rank process, with its thread count). The running variances take the
    unbiased correction of the global count, 2n / (2n - 1) for n / (n - 1),
    which moves the batch variance's 0.1 share by about 1 / 2n (n is a
    layer's row count in one image: tens of edge rows at the least): rtol
    1e-3."""
    losses, got = runs["ranks"][0]["identical_fused"]
    single, want = runs["ranks"][0]["one_rank"]["single"]
    assert losses == [loss for loss, _ in single]
    for k, v in want.items():
        if k.endswith("running_var"):
            np.testing.assert_allclose(got[k], v, rtol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_one_rank_is_the_train_step(runs):
    dp, single = (runs["ranks"][0]["one_rank"][arm]
                  for arm in ("dp", "single"))
    assert dp[0] == single[0]
    for k, v in single[1].items():
        np.testing.assert_array_equal(dp[1][k], v, err_msg=k)


def test_planted_plain_all_reduce_fails(runs):
    """The same SGD comparison on the faulted run must fail; on the true
    run it passes (test_dp_step_matches_jax)."""
    losses, got = runs["ranks"][0]["fault_unfused"]
    want_losses, want = runs["jax"]["sgd_unfused"]
    np.testing.assert_allclose(losses[0], want_losses[0], rtol=1e-5)
    with pytest.raises(AssertionError):
        _hold_sgd(got, want, runs["states"]["sgd_unfused"])
