"""The port's multi-step train dispatch (`train/loop.make_scan_train_step`
and the trainer's chunking) on the CPU, where it runs the eager step
through the same staging that feeds the CUDA graph on the card (the
capture is checked by `chip_smoke.py` phase 19):

  * the trainer with `scan_steps=3` and with `scan_steps=1` gives the same
    losses and parameters after 6 steps, bit for bit, with augmentation
    and dropout drawing from the generator, on the sparse route and the
    YOLaT++ banded one (padded plans, masked BatchNorm);
  * `make_scan_train_step` over 3 batches against yolat_tpu's
    `make_scan_train_step` (augmentation and dropout off) under
    tests/test_torch_train.py's tolerances: the loss rtol 1e-4 per step,
    the parameters rtol 1e-4 with its absolute floor for noise-driven
    entries, 4 * lr (a BatchNorm running mean, which sums its Dense
    bias's noise moves over three distinct batches, 8 * lr);
  * the schedule fills a tensor learning rate in place (what a captured
    optimizer step reads) with the float route's values;
  * the staged keys leave out what the step drops and the 0-d leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.train.config import Config as JaxConfig
from yolat_tpu.train.import_reference import export_state_dict
from yolat_tpu.train.loop import create_state
from yolat_tpu.train.loop import make_scan_train_step as jax_scan_step
from yolat_tpu.train.optim import make_optimizer as jax_optimizer
from yolat_tpu.train.optim import steplr
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.nn.model import SparseCADGCN, load_jax_variables
from yolat_tpu_torch.ops.plans import pad_plans
from yolat_tpu_torch.train.loop import make_scan_train_step, train_batch_keys
from yolat_tpu_torch.train.optim import make_optimizer, make_scheduler
from yolat_tpu_torch.train.trainer import run_training

WIDTH = 16
LR = 1e-3


@pytest.mark.parametrize("route", [
    dict(dropout=0.2),
    dict(arch="yolat_pp", pp_banded_super=True)])
def test_scan_steps_3_equals_scan_steps_1(synthetic_root, tmp_path, route):
    out = []
    for scan in (1, 3):
        cfg = Config(data_dir=synthetic_root, n_filters=8, batch_size=1,
                     total_epochs=3, eval_start=100, print_freq=2,
                     scan_steps=scan, data_aug=True,
                     root_dir=str(tmp_path / f"log{scan}"), **route)
        model, res = run_training(cfg, "cpu", max_steps=6)
        assert res["steps"] == 6 and len(res["losses"]) == 6
        out.append((res["losses"], model.state_dict()))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(v, out[1][1][k]) for k, v in out[0][1].items())


def test_scan_train_step_matches_jax(synthetic_root):
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    jds = JaxDataset(synthetic_root, "train", bbox_sampling_step=10)
    batches = [pad_plans(b) for b in PackedLoader(ds, batch_size=1,
                                                  prefetch=0,
                                                  edge_window=False)]
    jbatches = list(JaxLoader(jds, batch_size=1, shuffle=False))
    assert len(batches) == len(jbatches) == 3
    jcfg = JaxConfig(n_classes=ds.n_classes, n_filters=WIDTH, data_aug=False,
                     lr=LR)
    tx = jax_optimizer("adam", steplr(LR, jcfg.lr_adjust_freq,
                                      jcfg.lr_decay_rate, 1),
                       jcfg.weight_decay)
    state = create_state(jcfg, tx, {k: v[0] for k, v in jbatches[0].items()},
                         jax.random.key(0))
    cfg = Config(n_classes=ds.n_classes, n_filters=WIDTH, data_aug=False,
                 lr=LR)
    model = load_jax_variables(
        SparseCADGCN(ds.n_classes, channels=WIDTH),
        jax.tree.map(np.asarray, {"params": state.params,
                                  "batch_stats": state.batch_stats}))
    opt = make_optimizer("adam", model.parameters(), LR, cfg.weight_decay)
    sched = make_scheduler(opt, LR, cfg.lr_adjust_freq, cfg.lr_decay_rate, 1)
    got = make_scan_train_step(cfg, model, opt, sched, 3)(batches)["loss"]
    stacked = {k: np.stack([b[k][0] for b in jbatches]) for k in jbatches[0]}
    state, m = jax.jit(jax_scan_step(jcfg, tx, 3))(
        state, jax.tree.map(jnp.asarray, stacked), jax.random.key(1))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(m["loss"]), rtol=1e-4)
    want = export_state_dict({"params": jax.tree.map(np.asarray, state.params),
                              "batch_stats": jax.tree.map(np.asarray,
                                                          state.batch_stats)})
    for name, v in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            # a running mean sums its Dense bias's noise moves over the 3
            # batches (measured 4.7e-3 on one of 512 entries): 8 * lr
            atol = (8 if name.endswith("running_mean") else 4) * LR
            np.testing.assert_allclose(v.numpy(), want[name], rtol=1e-4,
                                       atol=atol, err_msg=name)


def test_schedule_fills_a_tensor_rate_in_place():
    p = torch.nn.Parameter(torch.zeros(3))
    lr = torch.tensor(LR)
    opt = torch.optim.Adam([p], lr=lr, foreach=False)
    sched = make_scheduler(opt, LR, 2, 0.5, 2)
    ref = make_scheduler(make_optimizer("adam", [torch.nn.Parameter(
        torch.zeros(3))], LR), LR, 2, 0.5, 2)
    for _ in range(9):
        assert opt.param_groups[0]["lr"] is lr  # the same tensor, refilled
        assert float(lr) == np.float32(ref.optimizer.param_groups[0]["lr"])
        sched.step()
        ref.step()
    assert float(lr) == np.float32(LR / 4)  # decayed at steps 4 and 8
    restored = make_scheduler(opt, LR, 2, 0.5, 2)
    restored.load_state_dict(sched.state_dict())
    assert restored.last_epoch == 9 and float(lr) == np.float32(LR / 4)


def test_staged_keys(synthetic_root):
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    b = next(iter(PackedLoader(ds, batch_size=1, prefetch=0, dense=True)))
    keys = train_batch_keys(Config(), b)
    assert "n_images" not in keys and "nbr_idx" not in keys
    assert "pos" in keys and "ew_src" in keys
    assert "nbr_idx" in train_batch_keys(Config(train_layout="dense"), b)
    dropped = train_batch_keys(Config(drop_edge=0.1), b)
    assert "ew_src" not in dropped and "dst_count" not in dropped
