"""The port's training slice against yolat_tpu's on the CPU: the
train-form batch epilogue, the loader's shuffled epoch order, the train
step (loss, gradients, parameters after 3 steps, with the fused pool head
on and off), checkpoints with resume, and the train CLI.

Inputs are made with numpy from a seed (or packed from the synthetic
dataset by each package's own host stage) and given to both packages;
weights start in JAX (narrow width 16; the fusion width 1024 is fixed by
the model) and cross through `load_jax_variables`. Tolerances:
  * augmentation: the same f32 rotation, scale and shift — rtol/atol 1e-6.
  * train step at f32: the loss rtol 1e-5; gradients rtol 1e-3 with an
    absolute floor of 5e-3 of each tensor's scale, the floor of JAX's own
    fused-vs-unfused model test (tests/test_fused_pool_train.py:262):
    train-mode BN divides by batch deviations and amplifies
    summation-order noise in near-zero entries; the Dense
    biases feeding a BatchNorm have a structurally zero gradient and are
    compared at noise level (atol 1e-4).
  * parameters after 3 Adam steps. Adam divides each gradient by its
    own running size, so an entry whose gradient is at noise level moves
    by up to lr per step in a direction the noise picks. Only the noise
    tensors (the Dense biases feeding a BatchNorm, step-1 gradient below
    1e-4) and the BN running means that absorb them are held at atol
    4 * lr. The noise moves of the other small-gradient entries perturb
    the next steps' forward, and entries whose later gradients pass near
    zero part by up to ~0.9 lr (measured), so every other entry is held
    at atol 2 * lr, and the entries whose step-1 gradient is firmly set
    (at least 1e-2 of the tensor's largest, same sign on both sides) are
    held, per tensor, to: a mean move of lr/2 or more (the step was
    applied); a median |difference| of 1e-5 (measured <= 5.4e-6; an
    update that is off by 1% of a step fails it); and a relative
    Frobenius error of the 3-step update of 2e-2 (measured <= 7.7e-3).
    On one batch the gradients barely change across the 3 steps, so
    Adam's bias-corrected update is ~lr * sign(g) whatever its betas:
    the betas, eps and the schedule are held by the optax test below.
  * the optimizers and the schedule against optax on the same
    gradients: rtol 1e-5, atol 1e-7 = 1e-4 * lr (f32 rounding of the
    same formulas in another order; gradients from 1e-9 to 1 so that eps
    matters, where a wrong eps moves an entry by ~lr). RAdam's rectified
    steps (6 on) at atol 1e-6: optax forms rho_t = rho_inf - 2t b2^t /
    (1 - b2^t) in f32, where the difference cancels (rho_6 5.955 against
    5.994 in float64), so its rectifier is 0.6-1.2% low; torch forms it
    in float64 (measured 2.4e-7 apart after 8 steps).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.packing import finalize_batch as jax_finalize
from yolat_tpu.nn.model import detection_loss as jax_loss
from yolat_tpu.train.config import Config as JaxConfig
from yolat_tpu.train.import_reference import export_state_dict
from yolat_tpu.train.loop import build_model as jax_build_model
from yolat_tpu.train.loop import create_state, make_train_step as jax_step
from yolat_tpu.train.optim import make_optimizer as jax_optimizer
from yolat_tpu.train.optim import steplr
from yolat_tpu_torch.cli import train as train_cli
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.packing import finalize_batch, to_device
from yolat_tpu_torch.nn.model import SparseCADGCN, load_jax_variables
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.train.checkpoint import (CheckpointManager,
                                              load_train_state, train_state)
from yolat_tpu_torch.train.loop import (forward_loss, make_train_step,
                                        prepare_batch)
from yolat_tpu_torch.train.optim import make_optimizer, make_scheduler
from yolat_tpu_torch.train.trainer import init_model, run_training

WIDTH = 16
LR = 1e-3


@pytest.fixture(scope="module")
def batches(synthetic_root):
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    jds = JaxDataset(synthetic_root, "train", bbox_sampling_step=10)
    pb = next(iter(PackedLoader(ds, batch_size=2)))
    jb = next(iter(JaxLoader(jds, batch_size=2, shuffle=False)))
    return ds.n_classes, pb, jb


def test_augmentation_matches_jax(batches):
    _, pb, jb = batches
    single = {k: v[0] for k, v in jb.items()}
    key = jax.random.key(3)
    want = jax_finalize(jax.tree.map(jnp.asarray, single), key=key,
                        data_aug=True)
    # the per-image draws of packing.py:624-628, from the same key
    b = single["gt_bbox"].shape[0]
    k_scale, k_angle, k_trans, k_flip = jax.random.split(key, 4)
    aug = (jax.random.uniform(k_scale, (b,), minval=-1.0, maxval=1.0) * 0.6
           + 1.0,
           jax.random.uniform(k_angle, (b,)) * 2.0 * jnp.pi,
           jax.random.uniform(k_trans, (b, 2), minval=-1.0, maxval=1.0) * 0.1,
           jax.random.bernoulli(k_flip, 0.5, (b, 2)))
    aug = tuple(torch.from_numpy(np.array(a)) for a in aug)
    got = finalize_batch(to_device(pb, "cpu"), data_aug=True, aug=aug)
    for k in ("pos", "bbox", "x"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert not np.allclose(got["pos"].numpy(), pb["pos"])
    # drawn from a generator: the same shapes and ranges
    drawn = finalize_batch(to_device(pb, "cpu"), data_aug=True,
                           generator=torch.Generator().manual_seed(0))
    assert drawn["bbox"].shape == got["bbox"].shape
    dropped = finalize_batch(to_device(pb, "cpu"), drop_edge=0.5,
                             generator=torch.Generator().manual_seed(0))
    assert 0 < int(dropped["edge_mask"].sum()) < int(pb["edge_mask"].sum())


def test_shuffled_epoch_order_matches_jax(synthetic_root):
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    jds = JaxDataset(synthetic_root, "train", bbox_sampling_step=10)
    port = PackedLoader(ds, batch_size=1, shuffle=True, seed=5, prefetch=0)
    jax_loader = JaxLoader(jds, batch_size=1, shuffle=True, seed=5,
                           prefetch=0)
    for _ in range(3):  # epochs
        got = [b["pos"] for b in port]
        want = [b["pos"][0] for b in jax_loader]
        assert len(got) == len(want) == len(ds)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(5 + 3)
    order = np.arange(len(ds))
    rng.shuffle(order)
    np.testing.assert_array_equal(port.epoch_order(), order)


def _jax_setup(n_classes, jb, fused):
    jcfg = JaxConfig(n_classes=n_classes, n_filters=WIDTH, data_aug=False,
                     fused_head_train=fused, lr=LR)
    tx = jax_optimizer("adam", steplr(LR, jcfg.lr_adjust_freq,
                                      jcfg.lr_decay_rate, 1),
                       jcfg.weight_decay)
    state = create_state(jcfg, tx, {k: v[0] for k, v in jb.items()},
                         jax.random.key(0))
    return jcfg, tx, state


def _port_model(n_classes, variables, fused):
    cfg = Config(n_classes=n_classes, n_filters=WIDTH, data_aug=False,
                 fused_head_train=fused, lr=LR)
    model = load_jax_variables(
        SparseCADGCN(n_classes, channels=WIDTH, fused_pool=fused),
        jax.tree.map(np.asarray, variables))
    return cfg, model


def _grads_by_name(grads, stats):
    return export_state_dict({"params": jax.tree.map(np.asarray, grads),
                              "batch_stats": jax.tree.map(np.asarray, stats)})


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_matches_jax(batches, fused):
    n_classes, pb, jb = batches
    jcfg, tx, state = _jax_setup(n_classes, jb, fused)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    cfg, model = _port_model(n_classes, variables, fused)

    # loss and step-1 gradients
    jbatch = jax_finalize(jax.tree.map(jnp.asarray,
                                       {k: v[0] for k, v in jb.items()}))
    jm = jax_build_model(jcfg)

    def loss_fn(params):
        (logits, _), mut = jm.apply(
            {"params": params, "batch_stats": state.batch_stats}, jbatch,
            train=True, mutable=["batch_stats"])
        return jax_loss(logits, jbatch["labels"],
                        jbatch["proposal_mask"])["loss"], mut

    (jloss, mut), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params)
    fb = prepare_batch(cfg, to_device(pb, "cpu"))
    _build.reset_launch_counts()
    loss = forward_loss(cfg, model, fb)["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _grads_by_name(jgrads, state.batch_stats)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    # entries whose step-1 gradient is firmly set on both sides
    firm = {n: (np.abs(g) >= 1e-2 * np.abs(want[n]).max())
            & (np.abs(want[n]) >= 1e-2 * np.abs(want[n]).max())
            & (np.sign(g) == np.sign(want[n]))
            for n, g in got.items() if np.abs(want[n]).max() >= 1e-4}
    assert set(got) <= set(want) and len(got) > 40
    for name, g in got.items():
        w = want[name]
        if np.abs(w).max() < 1e-4 and np.abs(g).max() < 1e-4:
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)
            continue
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=5e-3 * scale,
                                   err_msg=name)
    # the running statistics moved as JAX's did
    stats = export_state_dict({"params": jax.tree.map(np.asarray,
                                                      state.params),
                               "batch_stats": jax.tree.map(np.asarray,
                                                           mut["batch_stats"])})
    for name, v in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), stats[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    assert _build.launch_counts["folded_mlp_block_max"] == 0  # CPU: plain

    # parameters after 3 steps of the same batch
    cfg, model = _port_model(n_classes, variables, fused)
    start = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    opt = make_optimizer("adam", model.parameters(), LR, cfg.weight_decay)
    sched = make_scheduler(opt, LR, cfg.lr_adjust_freq, cfg.lr_decay_rate, 1)
    step = make_train_step(cfg, model, opt, sched)
    jstep = jax_step(jcfg, tx)
    for _ in range(3):
        got_loss = step(to_device(pb, "cpu"))["loss"]
        state, m = jstep(state, jb, jax.random.key(1))
        np.testing.assert_allclose(float(got_loss), float(m["loss"]),
                                   rtol=1e-4)
    want = export_state_dict({"params": jax.tree.map(np.asarray, state.params),
                              "batch_stats": jax.tree.map(np.asarray,
                                                          state.batch_stats)})
    for name, v in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        noisy = name.endswith("running_mean") or (
            name not in firm and not name.endswith("running_var"))
        np.testing.assert_allclose(v.numpy(), want[name], rtol=1e-4,
                                   atol=(4 if noisy else 2) * LR,
                                   err_msg=name)
    assert len(firm) > 20
    for name, mask in firm.items():
        moved = model.get_parameter(name).detach().numpy() - start[name]
        want_moved = want[name] - start[name]
        assert np.abs(moved[mask]).mean() >= LR / 2, name
        diff = np.abs(moved - want_moved)[mask]
        assert np.median(diff) <= 1e-5, (name, np.median(diff))
        err = np.linalg.norm(diff) / np.linalg.norm(want_moved[mask])
        assert err <= 2e-2, (name, err)


@pytest.mark.parametrize("name", ["adam", "adamw", "radam"])
def test_optimizer_and_schedule_match_optax(name):
    """8 steps on the same gradients, coupled (adam, radam) or decoupled
    (adamw) weight decay, StepLR halving every 2 epochs of 2 steps; RAdam
    rectifies from step 6 on."""
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=64).astype(np.float32)
    grads = (rng.normal(size=(8, 64)) * np.logspace(-9, 0, 64)
             ).astype(np.float32)
    tx = jax_optimizer(name, steplr(LR, 2, 0.5, 2), 1e-2)
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(name, [p], LR, 1e-2)
    sched = make_scheduler(opt, LR, 2, 0.5, 2)
    for t, g in enumerate(grads, 1):
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = jp + upd
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
        atol = 1e-6 if name == "radam" and t >= 6 else 1e-7
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=atol, err_msg=str(t))
    assert opt.param_groups[0]["lr"] == LR / 4  # decayed at steps 4 and 8
    assert np.abs(p.detach().numpy() - p0).min() > 0


def test_bf16_step_keeps_f32_master_weights_and_stats(batches):
    n_classes, pb, _ = batches
    cfg = Config(n_classes=n_classes, n_filters=8, dtype="bfloat16",
                 fused_head_train=True, data_aug=True)
    model = init_model(cfg, "cpu")
    opt = make_optimizer("adam", model.parameters(), LR)
    step = make_train_step(cfg, model, opt)
    loss = step(to_device(pb, "cpu"), torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss["loss"]))
    for name, t in model.state_dict().items():
        if t.is_floating_point():
            assert t.dtype == torch.float32, name
    assert model.cls_net.fusion_block[0].weight.grad.dtype == torch.float32
    assert model.cls_net.fusion_block[0].weight.grad.abs().max() > 0


def test_checkpoints_keep_best_and_restore(tmp_path, batches):
    n_classes, _, _ = batches
    cfg = Config(n_classes=n_classes, n_filters=8)
    model = init_model(cfg, "cpu")
    opt = make_optimizer("adam", model.parameters(), LR)
    sched = make_scheduler(opt, LR, 10, 0.5, 2)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    for epoch, value in ((1, 0.1), (2, 0.3), (3, 0.2), (4, 0.25)):
        with torch.no_grad():
            model.prediction_cls[2][0].bias.fill_(float(epoch))
        mgr.save(train_state(model, opt, sched, epoch * 10), epoch,
                 max(value, 0.3 if epoch > 2 else value), value >= 0.3)
    names = sorted(os.listdir(tmp_path / "ck"))
    assert "ckpt_1.pt" not in names and "meta_1.json" not in names
    assert {"ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt", "ckpt_best.pt"} <= set(names)
    state, epoch, best = mgr.restore("best")
    assert (epoch, best) == (2, 0.3)
    fresh = init_model(cfg, "cpu")
    assert load_train_state(state, fresh) == 20
    assert fresh.prediction_cls[2][0].bias[0].item() == 2.0
    with open(tmp_path / "ck" / "meta_4.json") as f:
        assert json.load(f) == {"epoch": 4, "best_value": 0.3}


def test_resume_continues_from_the_right_epoch(tmp_path, synthetic_root):
    cfg = Config(data_dir=synthetic_root, n_filters=8, batch_size=2,
                 total_epochs=1, data_aug=False, print_freq=1)
    _, first = run_training(cfg, "cpu", exp_dir=str(tmp_path / "a"))
    assert first["steps"] == 2  # 3 training files in batches of 2
    ck = tmp_path / "a" / "checkpoint"
    assert (ck / "ckpt_1.pt").exists() and (ck / "ckpt_best.pt").exists()
    resumed = cfg.replace(total_epochs=2,
                          pretrained_model=str(ck / "ckpt_1"))
    model, second = run_training(resumed, "cpu", exp_dir=str(tmp_path / "b"))
    assert second["steps"] == 2
    names = os.listdir(tmp_path / "b" / "checkpoint")
    assert "ckpt_2.pt" in names and "ckpt_1.pt" not in names
    state, epoch, _ = CheckpointManager(str(tmp_path / "b" / "checkpoint")
                                        ).restore(2)
    assert epoch == 2 and state["step"] == 4
    for k in ("map_50", "map_all", "top1_acc", "test_value"):
        assert np.isfinite(second[k])


def _jax_loss_means(losses, steps_per_epoch, print_freq):
    """The LossMean values the JAX trainer logs (yolat_tpu/train/trainer.py,
    `maybe_log` and the epoch's end) for these per-step losses: every
    print_freq steps of an epoch the mean of the meter, which then resets;
    an epoch's unlogged losses stay in the meter for the next log."""
    means, meter = [], []
    for e0 in range(0, len(losses), steps_per_epoch):
        pending = []
        for loss in losses[e0:e0 + steps_per_epoch]:
            pending.append(loss)
            if len(pending) >= print_freq:
                meter += pending
                pending = []
                means.append(sum(meter) / len(meter))
                meter = []
        meter += pending
    return means


def test_loss_mean_carries_an_epochs_remainder_as_jax_does(tmp_path,
                                                           synthetic_root):
    """Two epochs of 3 steps (3 training files, batch 1) logged every 2
    steps: the second epoch's LossMean holds the first epoch's third loss,
    as the JAX trainer's meter does."""
    cfg = Config(data_dir=synthetic_root, n_filters=8, batch_size=1,
                 total_epochs=2, data_aug=False, print_freq=2)
    exp = tmp_path / "exp"
    _, res = run_training(cfg, "cpu", exp_dir=str(exp))
    losses = res["losses"]
    assert res["steps"] == len(losses) == 6
    with open(exp / "exp.log") as f:
        logged = [line.split("LossMean:")[1].split()[0]
                  for line in f if "LossMean:" in line]
    want = _jax_loss_means(losses, 3, 2)
    assert logged == [f"{m:.4f}" for m in want]
    # the rule the port had: the second log without the first epoch's rest
    assert f"{(losses[3] + losses[4]) / 2:.4f}" != logged[1]


def test_train_cli_on_cpu(tmp_path, synthetic_root, capsys):
    res = train_cli.main(["--data_dir", synthetic_root, "--device", "cpu",
                          "--n_filters", "8", "--batch_size", "2",
                          "--max_steps", "2", "--fused_head_train", "true",
                          "--root_dir", str(tmp_path), "--print_freq", "1"])
    assert res["steps"] == 2 and len(res["losses"]) == 2
    assert all(np.isfinite(res["losses"]))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "2 steps" in line and "steps/s" in line and "images/s" in line
    assert "folded_mlp_block_max=0, fused_pool_train_bwd=0" in line
    ck = os.path.join(res["exp_dir"], "checkpoint")
    assert os.path.exists(os.path.join(ck, "ckpt_1.pt"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main(["--data_dir", synthetic_root])
