"""The single-device train step, eager and as a CUDA graph.

Counterpart of `yolat_tpu/train/loop.py:106-267` (`compute_dtype_of`,
`_step_body`, `make_train_step`, `make_scan_train_step`; `build_model` is
`yolat_tpu_torch.nn.model.build_model`): augmentation
epilogue -> forward in train mode (masked BatchNorm statistics, running
statistics moved in place) -> masked CE loss -> gradients -> optimizer
and schedule step.

Mixed precision (`cfg.dtype = bfloat16`) mirrors the JAX step: the float
batch fields of `_COMPUTE_KEYS` and every f32 parameter are cast to bf16
(`e_attr_super` among them: YOLaT++'s per-edge level reads it as it comes,
so this cast is the one place that sets its type) for the forward
(`torch.func.functional_call` over bf16 copies, so the
gradients come back to the f32 master weights through the casts), while
BatchNorm buffers and batch statistics stay f32. No torch.autocast: it
rounds at other points than the JAX step.

`make_train_step` is the eager step: the CPU path and the oracle.
`make_scan_train_step` runs K steps per call from one staged transfer; on
the card each step replays one CUDA graph (see its docstring).
`make_dp_train_step` is the data-parallel step over a process group
(`yolat_tpu/train/loop.py:269-304`), eager.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from yolat_tpu_torch.data.packing import finalize_batch
from yolat_tpu_torch.data.staging import (PackSpec, StagedBuffers,
                                          batch_signature)
from yolat_tpu_torch.nn.model import detection_loss
from yolat_tpu_torch.ops.plans import (EW_BATCH_KEYS, SEW_KEYS,
                                       SEW_TRAIN_KEYS)
from yolat_tpu_torch.parallel.mesh import set_sync_group
from yolat_tpu_torch.utils.cuda_graph import CapturedStep, side_stream

# float batch fields that feed matmuls: cast to the compute dtype
_COMPUTE_KEYS = ("x", "pos", "e_attr", "nbr_attr", "e_attr_super")
# the dense neighbour table, read by train_layout='dense' only
_DENSE_KEYS = ("nbr_idx", "nbr_attr", "nbr_mask")
# pack-time edge populations and plans, stale once edges drop on device
# (`yolat_tpu/train/loop.py:151-154`)
_EDGE_STALE_KEYS = (("dst_count", "src_count", "super_dst_count")
                    + EW_BATCH_KEYS + SEW_KEYS + SEW_TRAIN_KEYS)


def compute_dtype_of(cfg):
    """torch.bfloat16 for cfg.dtype bfloat16 / bf16, else None (f32)."""
    name = str(getattr(cfg, "dtype", "float32")).lower()
    return torch.bfloat16 if name in ("bfloat16", "bf16") else None


def iou_field(cfg):
    """None, or the packed quality field the IoU-aware loss trains on."""
    if not cfg.iou_aware_loss:
        return None
    return "label_iou_rel" if cfg.iou_aware_mode == "rel" else "label_iou"


def forward_loss(cfg, model, batch: dict, generator=None):
    """Train-mode forward of a finalized tensor batch -> loss dict (the
    loss keeps its graph). bf16 runs over bf16 copies of the f32
    parameters."""
    cdtype = compute_dtype_of(cfg)
    model.train()
    kw = {"generator": generator}
    if cdtype is not None:
        batch = {k: (v.to(cdtype) if k in _COMPUTE_KEYS else v)
                 for k, v in batch.items()}
        params = {n: (p.to(cdtype) if p.dtype == torch.float32 else p)
                  for n, p in model.named_parameters()}
        logits, _ = functional_call(model, params, (batch,), kw)
    else:
        logits, _ = model(batch, **kw)
    field = iou_field(cfg)
    return detection_loss(logits, batch["labels"], batch["proposal_mask"],
                          cfg.classifier,
                          label_iou=batch.get(field) if field else None,
                          pos_weight=cfg.pos_class_weight)


def prepare_batch(cfg, batch: dict, generator=None, aug=None) -> dict:
    """The step's epilogue on a tensor batch: drop the dense neighbour
    table unless the layout reads it (`yolat_tpu/train/loop.py:136-143`:
    a batch that carries one would take the conv's dense branch), drop the
    stale edge counts and plans under edge dropout, then augment and build
    x (`finalize_batch`)."""
    if cfg.train_layout != "dense":
        batch = {k: v for k, v in batch.items() if k not in _DENSE_KEYS}
    if cfg.drop_edge > 0.0:
        batch = {k: v for k, v in batch.items() if k not in _EDGE_STALE_KEYS}
    return finalize_batch(batch, generator=generator, data_aug=cfg.data_aug,
                          drop_edge=cfg.drop_edge, aug=aug)


def make_train_step(cfg, model, optimizer, scheduler=None):
    """step(batch, generator) -> {'loss', 'loss_cls'} (detached) for a
    tensor batch on the model's device; updates the model in place."""

    def step(batch: dict, generator=None, aug=None):
        fb = prepare_batch(cfg, batch, generator, aug)
        loss = forward_loss(cfg, model, fb, generator)
        # zeroed in place: a captured step keeps its gradients in buffers
        # that stay put (`make_scan_train_step`)
        optimizer.zero_grad(set_to_none=False)
        loss["loss"].backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {k: v.detach() for k, v in loss.items()}

    return step


def make_dp_train_step(cfg, model, optimizer, scheduler=None, group=None):
    """step(batch, generator) -> {'loss', 'loss_cls'} averaged over the
    ranks of `group` (the world group by default), for this rank's tensor
    batch; updates the model in place, identically on every rank. The
    counterpart of `make_dp_train_step` (`yolat_tpu/train/loop.py:269-304`,
    its pmean :192-194).

    The loss and backward are `make_train_step`'s, with the model's batch
    moments summed over the group (`parallel.set_sync_group`: every
    MaskedBatchNorm and the fused head). Then the gradients of every
    parameter (in `model.parameters()` order, a parameter without one as
    zeros) and the loss values cross in one flat f32 buffer: one
    all-reduce, then / W, which is pmean. Every rank must draw from the
    same generator state (JAX replicates one key to every shard), and
    every rank steps, an all-masked batch included. Eager: gloo cannot be
    captured in a CUDA graph (the JAX trainer's scan also runs at one
    device only). torch's DistributedDataParallel is not used: its
    bucket order and buffer broadcast are not pmean's."""
    if not dist.is_initialized():
        raise RuntimeError("make_dp_train_step needs an initialised process "
                           "group (parallel.distributed."
                           "initialize_from_config)")
    group = group or dist.group.WORLD
    set_sync_group(model, group)
    w = dist.get_world_size(group)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: dict, generator=None, aug=None):
        fb = prepare_batch(cfg, batch, generator, aug)
        loss = forward_loss(cfg, model, fb, generator)
        optimizer.zero_grad(set_to_none=False)
        loss["loss"].backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        keys = sorted(loss)
        flat = torch.cat([p.grad.reshape(-1).float() for p in params]
                         + [loss[k].detach().float().reshape(1)
                            for k in keys])
        dist.all_reduce(flat, group=group)
        flat /= w
        at = 0
        for p in params:
            p.grad.copy_(flat[at:at + p.numel()].view_as(p))
            at += p.numel()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {k: flat[at + i].to(loss[k].dtype) for i, k in enumerate(keys)}

    return step


def train_batch_keys(cfg, batch: dict) -> tuple:
    """The arrays of a numpy batch that the step reads: every array but
    the ones `prepare_batch` drops; 0-d leaves (n_images) stay on the
    host."""
    dropped = set(_DENSE_KEYS) if cfg.train_layout != "dense" else set()
    if cfg.drop_edge > 0.0:
        dropped |= set(_EDGE_STALE_KEYS)
    return tuple(sorted(k for k, v in batch.items()
                        if np.ndim(v) and k not in dropped))


def _eager_checked(fn):
    """fn() on a side stream with every host synchronisation an error: the
    capture that follows would fail on one, here it fails where it is."""
    stream = side_stream(torch.cuda.current_device())
    mode = torch.cuda.get_sync_debug_mode()
    stream.wait_stream(torch.cuda.current_stream())
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(stream):
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.current_stream().wait_stream(stream)
    return out


def make_scan_train_step(cfg, model, optimizer, scheduler, n_steps: int):
    """run(batches, generator) -> {'loss', 'loss_cls'}, each [len(batches)]
    on the model's device: 1 to n_steps train steps over numpy batches of
    one shape signature (plans at capacity: `ops.plans.pad_plans`), in
    order; the model and optimizer are updated in place. The counterpart
    of `make_scan_train_step` (`yolat_tpu/train/loop.py:228-267`), whose
    one dispatch runs K steps through `lax.scan`.

    The batches' arrays (`train_batch_keys`) cross in one transfer of a
    [n_steps, total] buffer (`data.staging`). On the card each step is one
    replay of a CUDA graph of the eager step (`make_train_step`: forward,
    loss, backward, optimizer), one graph per signature: the first step of a
    signature runs eagerly under `torch.cuda.set_sync_debug_mode('error')`
    (a hidden read-back raises there), then the step is captured with the
    generator registered, so augmentation and dropout draw what the eager
    step would. Between replays the batch row is copied into the graph's
    input buffer and the schedule writes the next rate; nothing is read
    back inside a chunk. The optimizer must be capturable
    (`train.optim.make_optimizer` on CUDA parameters). On the CPU the same
    staging runs the eager step (`make_train_step`).

    `run.captured` maps each signature to its entry, whose "bytes" is the
    device memory its graph's private pool holds after the capture;
    `run.stats()` gives the live graphs and the bytes they hold;
    `run.release(sig)` frees a signature's graph and buffers, for a
    signature that will not return (a bucket whose pads grew), and says
    whether there was one.
    """
    step = make_train_step(cfg, model, optimizer)  # the schedule steps here
    device = next(model.parameters()).device
    graphs: dict = {}

    def run(batches, generator=None) -> dict:
        sig = batch_signature(batches[0])
        if any(batch_signature(b) != sig for b in batches[1:]):
            raise ValueError("a scan chunk mixes batch shape signatures")
        ent = graphs.get(sig)
        if ent is None:
            spec = PackSpec(batches[0], train_batch_keys(cfg, batches[0]))
            ent = graphs[sig] = {
                "spec": spec, "staged": StagedBuffers(spec, n_steps, device),
                "row": (torch.empty(spec.total, dtype=torch.uint8,
                                    device=device)
                        if device.type == "cuda" else None),
                "graph": None, "generator": generator, "bytes": 0}
        spec, buf, row = ent["spec"], ent["staged"].stage(batches), ent["row"]
        metrics = []
        for r in range(len(batches)):
            if row is None:
                metrics.append(step(spec.unpack(buf[r]), generator))
            elif ent["graph"] is None:
                row.copy_(buf[r])
                metrics.append(_eager_checked(
                    lambda: step(spec.unpack(row), generator)))
                ent["graph"] = CapturedStep(
                    lambda: step(spec.unpack(row), generator),
                    generators=() if generator is None else (generator,),
                    warmup=False)
                ent["bytes"] = ent["graph"].pool_bytes()
            elif generator is not ent["generator"]:
                raise ValueError("a captured train step draws from the "
                                 "generator it was captured with")
            else:
                row.copy_(buf[r])
                metrics.append({k: v.clone()
                                for k, v in ent["graph"].replay().items()})
            if scheduler is not None:
                scheduler.step()
        return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    def release(sig) -> bool:
        return graphs.pop(sig, None) is not None

    def stats() -> dict:
        return {"graphs": sum(e["graph"] is not None for e in graphs.values()),
                "graph_bytes": sum(e["bytes"] for e in graphs.values())}

    run.captured = graphs  # per signature; its "graph" is the CapturedStep
    run.release, run.stats = release, stats
    return run
