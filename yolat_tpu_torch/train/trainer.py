"""Training orchestration, on one device or data parallel.

Counterpart of `yolat_tpu/train/trainer.py:27-321` (`run_training`; the
reference's cad_recognition/train.py:173-321). The train split mixes up
its CCs under cfg.do_mixup > 0 (seeded with cfg.seed) and its loader packs
cfg.buckets size buckets; the test loader stays unbucketed, with the dense
neighbour table under cfg.dense_layout (the evaluation's module then takes
its dense branch). On one device the steps go through
`train/loop.make_scan_train_step` (on the card CUDA graph replays) in
chunks of `cfg.scan_steps` batches of one shape signature, the plans at
capacity (`ops.plans.pad_plans`), as the JAX trainer chunks them
(`yolat_tpu/train/trainer.py:216-288`); a chunk cut short by a new
signature, the epoch's end or `max_steps` runs as it is, and each chunk's
losses are fetched once. Each bucket, and each pad that mixup grows, is a
new signature, so one more eager first step and one more capture; a
signature that a grown pad supersedes never returns, and its graph and
buffers are freed when the bucket's next batch arrives (each capture holds
a private memory pool, so the step's memory would otherwise grow with
every growth). The results count the signatures met, the pad growths, the
graphs freed and the bytes the live graphs hold. The loaders pack what
cfg.train_layout's conv branch reads ('window' is refused together with
edge dropout, which would leave its plan stale) and, for a YOLaT++ arch,
the super-edge family: the train loader with the clique family's plan and
its transpose only under cfg.pp_banded_super (refused together with edge
dropout for the same reason), the test loader with what serving reads. Epoch loop over the
shuffled train loader, evaluation every epoch from `eval_start` (and at
the last epoch or when `max_steps` stops the run), per-epoch checkpoints with a best-by-`test_value` copy, a scalar
log, and resume from a checkpoint directory, a `<dir>/ckpt_<tag>` path
or a reference `.pth` (weights only).

Randomness: the model is initialised from `torch.Generator` seeded with
cfg.seed (on the CPU, so every device starts from the same weights); the
augmentation and dropout draws come from a generator on the training
device seeded with cfg.seed + 1.

Data parallel (`ranks`, a `parallel.distributed.Ranks`; the JAX trainer's
mesh and multi-host branch, :29-40, :106-118, :159-215): this process is
one rank. Every rank builds the same model from cfg.seed (then broadcast
from rank 0 as a guard: `parallel.replicate`), takes its windows of the
global step schedule (`PackedLoader(n_devices=, host_id=, n_hosts=,
rank=)`) and runs the eager DP step (`train/loop.make_dp_train_step`)
one batch per call: `--scan_steps` applies at one device only, as in
JAX (:216). Local rank 0 builds the kernels and warms the dataset caches
before the other ranks (a store barrier), and a store barrier stands
before the first step and before each evaluation. The evaluation runs
over all ranks, each on its windows of the test split, the AP table
gathered in the global image order (`eval/runner.evaluate(group=)`); the
JAX trainer evaluates on process 0's devices alone, with the same result.
Rank 0 alone writes checkpoints and makes the experiment directory; the
other ranks log (their LossMean too) under `<exp_dir>/rank<r>/`.
"""

from __future__ import annotations

import logging
import os
import time

import torch

from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import (PackedLoader, extra_plans_for,
                                         train_plans_for)
from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.data.staging import batch_signature
from yolat_tpu_torch.eval.runner import evaluate
from yolat_tpu_torch.nn.layers import init_weights
from yolat_tpu_torch.nn.model import build_model, check_model_config
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.plans import pad_plans
from yolat_tpu_torch.parallel.distributed import (coordination_barrier,
                                                  local_first)
from yolat_tpu_torch.parallel.mesh import replicate
from yolat_tpu_torch.train.checkpoint import (CheckpointManager,
                                              load_train_state,
                                              split_checkpoint_path,
                                              state_from_pth, train_state)
from yolat_tpu_torch.train.loop import (make_dp_train_step,
                                        make_scan_train_step)
from yolat_tpu_torch.train.optim import make_optimizer, make_scheduler
from yolat_tpu_torch.utils.experiment import (ScalarWriter, configure_logger,
                                              make_experiment_dir)
from yolat_tpu_torch.utils.meters import AverageMeter


def init_model(cfg, device) -> torch.nn.Module:
    """cfg's detector with the reference's init (Kaiming Linear weights,
    zero biases, BatchNorm at identity) from cfg.seed; YOLaT++'s gates
    stay at zero, so it starts as the canonical detector."""
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dp_chunk_fn(cfg, model, optimizer, scheduler, ranks, device):
    """The DP step behind make_scan_train_step's interface: run(batches,
    generator) -> {'loss', 'loss_cls'} [len(batches)], one step a batch;
    eager, so it holds no graph to release."""
    step = make_dp_train_step(cfg, model, optimizer, scheduler, ranks.group)

    def run(batches, generator=None) -> dict:
        ms = [step(to_device(b, device), generator) for b in batches]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    run.release = lambda sig: False
    run.stats = lambda: {"graphs": 0, "graph_bytes": 0}
    return run


def run_training(cfg, device, exp_dir: str | None = None,
                 max_steps: int | None = None, ranks=None):
    """Train per cfg on `device`; returns (model, results). results holds
    the last evaluation's table plus best_value, exp_dir, steps, images,
    train_seconds (wall time of the train steps, synchronised), losses
    (every step's loss) and eval_batches (batches evaluated in all).
    With `ranks` this process is one rank of a data-parallel run (module
    docstring); steps, images and eval_batches are then this rank's."""
    device = torch.device(device)
    is_main = ranks is None or ranks.is_main
    if cfg.graph != "bezier_cc_bb_iter":
        raise NotImplementedError(
            f"--graph {cfg.graph}: only the canonical 'bezier_cc_bb_iter' "
            "pipeline trains (as in yolat_tpu/train/trainer.py:42-49); the "
            "legacy graph builders live in yolat_tpu_torch/data/legacy.py")
    check_model_config(cfg)  # before any data is loaded
    if cfg.pp_banded_super and cfg.drop_edge > 0.0:
        raise ValueError(
            "pp_banded_super with drop_edge > 0: edge dropout strips the "
            "super-edge plan and its pack-time counts from the batch, and "
            "the step would train the sparse route under this flag's name; "
            "train without pp_banded_super, or without edge dropout")
    if cfg.train_layout == "window" and cfg.drop_edge > 0.0:
        raise ValueError(
            "train_layout 'window' with drop_edge > 0: the edge-window plan "
            "is built at pack time from the full edge list, and edge dropout "
            "on the device makes it stale; train with train_layout 'sparse' "
            "or 'dense', or without edge dropout")
    train_ds = SESYDDataset(cfg.data_dir, "train",
                            bbox_sampling_step=cfg.bbox_sampling_step,
                            do_mixup=cfg.do_mixup > 0, seed=cfg.seed)
    test_ds = SESYDDataset(cfg.data_dir, "test",
                           bbox_sampling_step=cfg.bbox_sampling_step)
    cfg = cfg.replace(n_classes=train_ds.n_classes)
    if exp_dir is None and is_main:
        jobname = (f"{cfg.exp_name}-{cfg.conv}-n{cfg.n_blocks}-C{cfg.n_filters}"
                   f"-lr{cfg.lr}_B{cfg.batch_size}")
        exp_dir = make_experiment_dir(cfg.root_dir, jobname)["exp_dir"]
    if ranks is not None:  # every rank under rank 0's directory
        if is_main:
            ranks.store.set("yolat_exp_dir", (exp_dir or "").encode())
        exp_dir = exp_dir or ranks.store.get("yolat_exp_dir").decode()
    log_dir = exp_dir if is_main else os.path.join(exp_dir,
                                                   f"rank{ranks.rank}")
    os.makedirs(log_dir, exist_ok=True)
    configure_logger(log_dir, tag="" if ranks is None
                     else f"[rank {ranks.rank}] ")
    # the scalar log as JSON lines only: the JAX trainer also tries a
    # TensorBoard event file, but torch.utils.tensorboard imports TensorFlow
    # where that is installed (ROADMAP.md queue 3, stated differences)
    writer = ScalarWriter(log_dir, use_tensorboard=False)
    try:
        ckpt = (CheckpointManager(os.path.join(exp_dir, "checkpoint"))
                if is_main else None)

        # each layout packs what its conv branch reads: the edge-window plan
        # with its transpose, the dense neighbour table, or neither
        window = cfg.train_layout == "window"
        layout_kw = dict(edge_window=window, ew_transpose=window,
                         dense=cfg.train_layout == "dense")
        # the train split in this rank's windows of the global schedule; the
        # test split over all ranks as one node, so every image is evaluated
        train_dp = test_dp = {}
        if ranks is not None:
            train_dp = dict(n_devices=ranks.local_world, host_id=ranks.node,
                            n_hosts=ranks.n_nodes, rank=ranks.local_rank)
            test_dp = dict(n_devices=ranks.world, rank=ranks.rank)

        def make_loaders():  # the host library's build and the dataset caches
            return (PackedLoader(train_ds, batch_size=cfg.batch_size,
                                 shuffle=True, seed=cfg.seed,
                                 buckets=cfg.buckets,
                                 **{**layout_kw, **train_plans_for(cfg),
                                    **train_dp}),
                    PackedLoader(test_ds, batch_size=cfg.batch_size * 2,
                                 **{**layout_kw, **extra_plans_for(cfg),
                                    **test_dp,
                                    "dense": layout_kw["dense"]
                                    or cfg.dense_layout}))

        train_loader, test_loader = local_first(ranks, "loaders", make_loaders)
        steps_per_epoch = max(len(train_loader), 1)

        model = init_model(cfg, device)
        if ranks is not None:
            replicate(model, ranks.group)
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
                logging.info("resumed from %s (tag %s) at epoch %d",
                             restore_dir, tag, start_epoch)
        # the loader's epoch counter follows the resumed epoch, so the file
        # order continues as an uninterrupted run's would
        train_loader.epoch = max(start_epoch, 0)

        if device.type == "cuda":
            # build the kernels as set-up, outside the timed loop
            local_first(ranks, "kernels", _build.library)
        if cfg.scan_steps < 1:
            raise ValueError(f"scan_steps {cfg.scan_steps}: at least 1")
        if ranks is None:
            chunk_len = cfg.scan_steps
            scan_fn = make_scan_train_step(cfg, model, optimizer, scheduler,
                                           cfg.scan_steps)
        else:
            if cfg.scan_steps > 1:
                logging.info("--scan_steps %d: the data-parallel step runs "
                             "one batch per call", cfg.scan_steps)
            chunk_len = 1
            scan_fn = _dp_chunk_fn(cfg, model, optimizer, scheduler, ranks,
                                   device)
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        losses = AverageMeter()
        test_value = 0.0
        results: dict = {}
        n_steps = n_images = n_eval_batches = n_released = 0
        signatures: set = set()
        bucket_sig: dict = {}  # bucket -> the signature of its last batch
        train_seconds = 0.0
        history: list = []
        done = False
        for epoch in range(start_epoch + 1, cfg.total_epochs + 1):
            t_epoch = time.time()
            # (first iteration, [K] device losses) of the chunks not yet
            # fetched
            pending: list = []

            def fetch_losses(log_test_value: bool) -> None:
                """One read-back for the pending chunks' losses."""
                if not pending:
                    return
                vals = torch.cat([v for _, v in pending]).tolist()
                its = [i0 + j for i0, v in pending for j in range(v.shape[0])]
                for it_i, loss in zip(its, vals):
                    losses.update(loss)
                    history.append(losses.val)
                    writer.add_scalar("loss", losses.val, it_i)
                    if log_test_value:
                        writer.add_scalar("test_value", test_value, it_i)
                pending.clear()

            def run_chunk(chunk) -> None:
                nonlocal it, n_steps, n_images
                m = scan_fn(chunk, generator)
                pending.append((it + 1, m["loss"]))
                it += len(chunk)
                n_steps += len(chunk)
                n_images += sum(int(b["n_images"]) for b in chunk)
                if sum(v.shape[0] for _, v in pending) >= cfg.print_freq:
                    fetch_losses(True)
                    logging.info("Epoch:%d Iter:%d LossMean:%.4f loss:%.4f",
                                 epoch, it, losses.avg, losses.val)
                    losses.reset()

            coordination_barrier(ranks, "train")
            _sync(device)
            t0 = time.perf_counter()
            chunk: list = []
            for bucket, batch in train_loader.iter_buckets():
                b = pad_plans(batch)
                sig = batch_signature(b)
                if chunk and sig != batch_signature(chunk[0]):
                    run_chunk(chunk)  # chunks never mix signatures
                    chunk = []
                old = bucket_sig.get(bucket, sig)
                bucket_sig[bucket] = sig
                if old != sig and old not in bucket_sig.values():
                    # a grown pad: its old signature never returns
                    n_released += scan_fn.release(old)
                signatures.add(sig)
                chunk.append(b)
                done = (max_steps is not None
                        and n_steps + len(chunk) >= max_steps)
                if len(chunk) == chunk_len or done:
                    run_chunk(chunk)
                    chunk = []
                if done:
                    break
            if chunk:
                run_chunk(chunk)
            if done and pending:
                fetch_losses(True)
                logging.info("Epoch:%d Iter:%d LossMean:%.4f loss:%.4f",
                             epoch, it, losses.avg, losses.val)
                losses.reset()
            # the epoch's unlogged losses go into the meter too, so the next
            # epoch's first LossMean holds them, as the JAX trainer's does
            fetch_losses(False)
            _sync(device)
            train_seconds += time.perf_counter() - t0

            if epoch >= cfg.eval_start or done or epoch == cfg.total_epochs:
                coordination_barrier(ranks, "eval")
                results = evaluate(cfg, model, test_loader,
                                   max_det=cfg.max_det, device=device,
                                   group=None if ranks is None
                                   else ranks.host_group)
                test_value = results["test_value"]
                n_eval_batches += len(test_loader)
                if is_main:
                    logging.info(
                        "Epoch:%d MAP@0.5:%.4f MAP@ALL:%.4f top1:%.4f (%.1fs)",
                        epoch, results["map_50"], results["map_all"],
                        results["top1_acc"], time.time() - t_epoch)
            is_best = test_value > best_value
            best_value = max(test_value, best_value)
            if ckpt is not None:
                ckpt.save(train_state(model, optimizer, scheduler, it), epoch,
                          best_value, is_best)
            if done:
                break
    finally:
        writer.close()  # flushes the event file, on every exit
    results.update(best_value=best_value, exp_dir=exp_dir, steps=n_steps,
                   images=n_images, train_seconds=train_seconds,
                   losses=history, eval_batches=n_eval_batches,
                   signatures=len(signatures),
                   pad_growths=train_loader.pad_growths,
                   graphs_released=n_released,
                   graph_bytes=scan_fn.stats()["graph_bytes"])
    return model, results
