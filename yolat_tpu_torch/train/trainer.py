"""Training orchestration on one device.

Counterpart of `yolat_tpu/train/trainer.py:27-321` (`run_training`; the
reference's cad_recognition/train.py:173-321) for a single process on one
device: no mesh, no multi-host, no `scan_steps` chains, no buckets or
mixup. The loaders pack what cfg.train_layout's conv branch reads
('window' is refused together with edge dropout, which would leave its
plan stale). Epoch loop over the shuffled train loader, evaluation every epoch
from `eval_start` (and at the last epoch or when `max_steps` stops the
run), per-epoch checkpoints with a best-by-`test_value` copy, a scalar
log, and resume from a checkpoint directory, a `<dir>/ckpt_<tag>` path
or a reference `.pth` (weights only).

Randomness: the model is initialised from `torch.Generator` seeded with
cfg.seed (on the CPU, so every device starts from the same weights); the
augmentation and dropout draws come from a generator on the training
device seeded with cfg.seed + 1.
"""

from __future__ import annotations

import logging
import os
import time

import torch

from yolat_tpu_torch.config import PP_ARCHS
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.eval.runner import evaluate
from yolat_tpu_torch.nn.layers import init_weights
from yolat_tpu_torch.nn.model import build_model
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.train.checkpoint import (CheckpointManager,
                                              load_train_state,
                                              split_checkpoint_path,
                                              state_from_pth, train_state)
from yolat_tpu_torch.train.loop import make_train_step
from yolat_tpu_torch.train.optim import make_optimizer, make_scheduler
from yolat_tpu_torch.utils.experiment import (ScalarWriter, configure_logger,
                                              make_experiment_dir)
from yolat_tpu_torch.utils.meters import AverageMeter


def init_model(cfg, device) -> torch.nn.Module:
    """The canonical detector with the reference's init (Kaiming Linear
    weights, zero biases, BatchNorm at identity) from cfg.seed."""
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_training(cfg, device, exp_dir: str | None = None,
                 max_steps: int | None = None):
    """Train per cfg on `device`; returns (model, results). results holds
    the last evaluation's table plus best_value, exp_dir, steps, images,
    train_seconds (wall time of the train steps, synchronised), losses
    (every step's loss) and eval_batches (batches evaluated in all)."""
    device = torch.device(device)
    if cfg.arch in PP_ARCHS:
        raise NotImplementedError(
            f"arch {cfg.arch!r}: YOLaT++ is carried for serving (cli.infer, "
            "cli.test); its training path is not carried yet")
    if cfg.train_layout == "window" and cfg.drop_edge > 0.0:
        raise ValueError(
            "train_layout 'window' with drop_edge > 0: the edge-window plan "
            "is built at pack time from the full edge list, and edge dropout "
            "on the device makes it stale; train with train_layout 'sparse' "
            "or 'dense', or without edge dropout")
    train_ds = SESYDDataset(cfg.data_dir, "train",
                            bbox_sampling_step=cfg.bbox_sampling_step)
    test_ds = SESYDDataset(cfg.data_dir, "test",
                           bbox_sampling_step=cfg.bbox_sampling_step)
    cfg = cfg.replace(n_classes=train_ds.n_classes)
    if exp_dir is None:
        jobname = (f"{cfg.exp_name}-{cfg.conv}-n{cfg.n_blocks}-C{cfg.n_filters}"
                   f"-lr{cfg.lr}_B{cfg.batch_size}")
        exp_dir = make_experiment_dir(cfg.root_dir, jobname)["exp_dir"]
    os.makedirs(exp_dir, exist_ok=True)
    configure_logger(exp_dir)
    writer = ScalarWriter(exp_dir)
    ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoint"))

    # each layout packs what its conv branch reads: the edge-window plan
    # with its transpose, the dense neighbour table, or neither
    window = cfg.train_layout == "window"
    layout_kw = dict(edge_window=window, ew_transpose=window,
                     dense=cfg.train_layout == "dense")
    train_loader = PackedLoader(train_ds, batch_size=cfg.batch_size,
                                shuffle=True, seed=cfg.seed, **layout_kw)
    test_loader = PackedLoader(test_ds, batch_size=cfg.batch_size * 2,
                               **layout_kw)
    steps_per_epoch = max(len(train_loader), 1)

    model = init_model(cfg, device)
    optimizer = make_optimizer(cfg.optimizer, model.parameters(), cfg.lr,
                               cfg.weight_decay)
    scheduler = make_scheduler(optimizer, cfg.lr, cfg.lr_adjust_freq,
                               cfg.lr_decay_rate, steps_per_epoch)
    start_epoch, best_value, it = 0, -float("inf"), 0
    if cfg.pretrained_model:
        path = cfg.pretrained_model.rstrip("/")
        if path.endswith(".pth"):
            state_from_pth(model, path)
            logging.info("imported reference checkpoint %s", path)
        else:
            restore_dir, tag = split_checkpoint_path(path)
            state, start_epoch, best_value = CheckpointManager(
                restore_dir).restore(tag, map_location=device)
            it = load_train_state(state, model, optimizer, scheduler)
            logging.info("resumed from %s (tag %s) at epoch %d", restore_dir,
                         tag, start_epoch)
    # the loader's epoch counter follows the resumed epoch, so the file
    # order continues as an uninterrupted run's would
    train_loader.epoch = max(start_epoch, 0)

    if device.type == "cuda":
        _build.library()  # build the kernels as set-up, outside the timed loop
    step_fn = make_train_step(cfg, model, optimizer, scheduler)
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    losses = AverageMeter()
    test_value = 0.0
    results: dict = {}
    n_steps = n_images = n_eval_batches = 0
    train_seconds = 0.0
    history: list = []
    done = False
    for epoch in range(start_epoch + 1, cfg.total_epochs + 1):
        t_epoch = time.time()
        pending = []  # losses fetched every print_freq steps (no per-step sync)
        _sync(device)
        t0 = time.perf_counter()
        for batch in train_loader:
            m = step_fn(to_device(batch, device), generator)
            it += 1
            n_steps += 1
            n_images += int(batch["n_images"])
            pending.append((it, m["loss"]))
            if max_steps is not None and n_steps >= max_steps:
                done = True
            if len(pending) >= cfg.print_freq or done:
                for it_i, loss in pending:
                    losses.update(float(loss))
                    history.append(losses.val)
                    writer.add_scalar("loss", losses.val, it_i)
                    writer.add_scalar("test_value", test_value, it_i)
                pending = []
                logging.info("Epoch:%d Iter:%d LossMean:%.4f loss:%.4f",
                             epoch, it, losses.avg, losses.val)
                losses.reset()
            if done:
                break
        for it_i, loss in pending:
            history.append(float(loss))
            writer.add_scalar("loss", history[-1], it_i)
        _sync(device)
        train_seconds += time.perf_counter() - t0

        if epoch >= cfg.eval_start or done or epoch == cfg.total_epochs:
            results = evaluate(cfg, model, test_loader, max_det=cfg.max_det,
                               device=device)
            test_value = results["test_value"]
            n_eval_batches += len(test_loader)
            logging.info("Epoch:%d MAP@0.5:%.4f MAP@ALL:%.4f top1:%.4f (%.1fs)",
                         epoch, results["map_50"], results["map_all"],
                         results["top1_acc"], time.time() - t_epoch)
        is_best = test_value > best_value
        best_value = max(test_value, best_value)
        ckpt.save(train_state(model, optimizer, scheduler, it), epoch,
                  best_value, is_best)
        if done:
            break

    writer.close()
    results.update(best_value=best_value, exp_dir=exp_dir, steps=n_steps,
                   images=n_images, train_seconds=train_seconds,
                   losses=history, eval_batches=n_eval_batches)
    return model, results
