"""Set up the system under test and drive its train step loop.

The system is the port's trainer, `yolat_tpu_torch.train.trainer.
run_training`, run through its public calls: `SESYDDataset` and
`PackedLoader(..., shuffle=True, seed=, **train_plans_for(cfg))` with its
`iter_buckets()`, `ops.plans.pad_plans`, `train.trainer.init_model`,
`train.optim.make_optimizer` / `make_scheduler` and
`train.loop.make_scan_train_step`'s `run(chunk, generator)`. `TrainLoop`
is a copy of the trainer's epoch loop (chunks of `scan_steps` batches of
one signature, the losses read back every `print_freq` steps and at each
epoch's end, a synchronise at each epoch's end), with epochs rolling over
until the window closes; evaluation and checkpoints are left out, as the
trainer leaves them out of `train_seconds`, and so is its scalar log.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from benchmark.roofline import model_flops, real_rows

# the fields of a batch whose True entries are the real rows of a
# population (`roofline.model_flops`)
POPULATIONS = {"nodes": "node_mask", "edges": "edge_mask",
               "proposals": "proposal_mask", "super_edges": "super_mask"}


def program_config(cell, seed: int, data_dir: str):
    """The port's Config for this cell and seed."""
    from yolat_tpu_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in cell.config.items() if k in fields}
    mix = cell.mix
    kw.update(seed=seed, data_dir=data_dir,
              batch_size=mix["batch_size"], buckets=mix["buckets"],
              scan_steps=mix["scan_steps"],
              bbox_sampling_step=mix["bbox_sampling_step"])
    return Config(**kw)


class Program:
    """The trainer's objects for one cell: dataset, loader, model with the
    benchmark's weights, optimizer, schedule, the train step and the
    augmentation generator."""

    def __init__(self, cell, seed: int, data_dir: str, weights: dict,
                 device):
        from yolat_tpu_torch.data.dataset import SESYDDataset
        from yolat_tpu_torch.data.loader import PackedLoader, train_plans_for
        from yolat_tpu_torch.ops import _build
        from yolat_tpu_torch.train.loop import make_scan_train_step
        from yolat_tpu_torch.train.optim import make_optimizer, make_scheduler
        from yolat_tpu_torch.train.trainer import init_model

        self.device = torch.device(device)
        self.phases = {}
        t0 = time.perf_counter()
        cfg = program_config(cell, seed, data_dir)
        # the corpus is made anew in every run: nothing reads a disk cache
        ds = SESYDDataset(data_dir, "train",
                          bbox_sampling_step=cfg.bbox_sampling_step,
                          mode="floorplan", cache=False, seed=cfg.seed)
        self.cfg = cfg = cfg.replace(n_classes=ds.n_classes)
        window = cfg.train_layout == "window"
        self.loader = PackedLoader(
            ds, batch_size=cfg.batch_size, shuffle=True, seed=cfg.seed,
            buckets=cfg.buckets,
            edge_window=window, ew_transpose=window,
            dense=cfg.train_layout == "dense", **train_plans_for(cfg))
        t1 = time.perf_counter()
        self.model = init_model(cfg, self.device)
        with torch.no_grad():
            names = {n for n, _ in self.model.named_parameters()}
            if names != set(weights):
                raise ValueError(
                    "the program's parameters are not the reference's: "
                    f"only in the program {sorted(names - set(weights))}, "
                    f"only in the reference {sorted(set(weights) - names)}")
            for n, p in self.model.named_parameters():
                p.copy_(weights[n])
        self.optimizer = make_optimizer(cfg.optimizer, self.model.parameters(),
                                        cfg.lr, cfg.weight_decay)
        self.scheduler = make_scheduler(
            self.optimizer, cfg.lr, cfg.lr_adjust_freq, cfg.lr_decay_rate,
            max(len(self.loader), 1))
        t2 = time.perf_counter()
        if self.device.type == "cuda":
            _build.library()
        self.phases.update(loader=t1 - t0, model=t2 - t1,
                           kernels=time.perf_counter() - t2)
        self.step = make_scan_train_step(cfg, self.model, self.optimizer,
                                         self.scheduler, cfg.scan_steps)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TrainLoop:
    """The trainer's step loop over one Program, with the window's
    records: steps, images, the losses, the time spent waiting on the
    loader, real and padded rows per population, the model's FLOPs."""

    def __init__(self, prog: Program, products: list):
        from yolat_tpu_torch.data.staging import batch_signature
        from yolat_tpu_torch.ops.plans import pad_plans

        self.prog, self.products = prog, products
        self._sig, self._pad = batch_signature, pad_plans
        self.it = None
        self.pending: list = []   # device losses not yet read back
        self.losses: list = []    # every step's loss, read back
        self.spans = None         # record_function, in a traced run
        self.on_batch = None      # called with each numpy batch
        self.step_rows = None     # a list for (real rows, blocks) per step
        self.reset()

    def reset(self) -> None:
        self.steps = self.images = 0
        self.wait_s = 0.0
        self.flops = 0.0
        self.real = dict.fromkeys(POPULATIONS, 0)
        self.padded = dict.fromkeys(POPULATIONS, 0)

    def _span(self, name):
        return (self.spans(name) if self.spans is not None
                else contextlib.nullcontext())

    def fetch(self) -> None:
        """Read the pending losses back (one synchronising copy)."""
        if self.pending:
            with self._span("bench.fetch_losses"):
                self.losses += torch.cat(self.pending).tolist()
            self.pending.clear()

    def _next(self):
        """The next padded batch of the schedule, or None at an epoch's
        end (the next call starts the next epoch)."""
        if self.it is None:
            self.it = self.prog.loader.iter_buckets()
        t0 = time.perf_counter()
        with self._span("bench.loader_wait"):
            item = next(self.it, None)
        self.wait_s += time.perf_counter() - t0
        if item is None:
            self.it = None
            return None
        return self._pad(item[1])

    def _count(self, b: dict) -> None:
        rows = {}
        for pop, key in POPULATIONS.items():
            if key in b:
                rows[pop] = int(np.count_nonzero(b[key]))
                self.real[pop] += rows[pop]
                self.padded[pop] += int(b[key].shape[0])
            else:
                rows[pop] = 0
        self.flops += model_flops(self.products, rows)
        self.images += int(b["n_images"])
        if self.step_rows is not None:
            self.step_rows.append(real_rows(b["node_mask"]))

    def run(self, n_steps: int | None = None, seconds: float | None = None,
            after_step=None) -> float:
        """Train until n_steps more steps have run or `seconds` have passed
        (checked after each chunk); read back and synchronise; return the
        wall seconds. `after_step(i)` is called after the i-th step of
        this call (chunks of one step then, as the cell's scan_steps)."""
        prog = self.prog
        k = prog.cfg.scan_steps
        t0 = time.perf_counter()
        done = 0
        chunk: list = []
        while True:
            b = self._next()
            if b is None:
                # the epoch's end, as the trainer's: its short chunk, then
                # the losses read back and a synchronise
                if chunk:
                    done += self._run_chunk(chunk)
                    chunk = []
                with self._span("bench.epoch_end"):
                    self.fetch()
                    sync(prog.device)
                continue
            if self.on_batch is not None:
                self.on_batch(b)
            if chunk and self._sig(b) != self._sig(chunk[0]):
                done += self._run_chunk(chunk)
                chunk = []
            chunk.append(b)
            if len(chunk) == k:
                done += self._run_chunk(chunk)
                chunk = []
                if after_step is not None:
                    after_step(done)
            if (n_steps is not None and done + len(chunk) >= n_steps) or (
                    seconds is not None
                    and time.perf_counter() - t0 >= seconds):
                break
        if chunk:
            done += self._run_chunk(chunk)
        self.fetch()
        sync(prog.device)
        return time.perf_counter() - t0

    def _run_chunk(self, chunk: list) -> int:
        prog = self.prog
        with self._span("bench.step"):
            m = prog.step(chunk, prog.generator)
        for b in chunk:
            self._count(b)
        self.pending.append(m["loss"])
        self.steps += len(chunk)
        if sum(v.shape[0] for v in self.pending) >= prog.cfg.print_freq:
            self.fetch()
        return len(chunk)

    def close(self) -> None:
        """Let the loader's packing thread run to the epoch's end."""
        if self.it is not None:
            for _ in self.it:
                pass
            self.it = None

