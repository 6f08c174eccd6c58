"""The single-device train step.

Counterpart of `yolat_tpu/train/loop.py:106-225` (`compute_dtype_of`,
`_step_body`, `make_train_step`; `build_model` is
`yolat_tpu_torch.nn.model.build_model`): augmentation
epilogue -> forward in train mode (masked BatchNorm statistics, running
statistics moved in place) -> masked CE loss -> gradients -> optimizer
and schedule step.

Mixed precision (`cfg.dtype = bfloat16`) mirrors the JAX step: the float
batch fields of `_COMPUTE_KEYS` and every f32 parameter are cast to bf16
for the forward (`torch.func.functional_call` over bf16 copies, so the
gradients come back to the f32 master weights through the casts), while
BatchNorm buffers and batch statistics stay f32. No torch.autocast: it
rounds at other points than the JAX step.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from yolat_tpu_torch.data.packing import finalize_batch
from yolat_tpu_torch.nn.model import detection_loss
from yolat_tpu_torch.ops.plans import EW_BATCH_KEYS

# float batch fields that feed matmuls: cast to the compute dtype
_COMPUTE_KEYS = ("x", "pos", "e_attr", "nbr_attr")
# the dense neighbour table, read by train_layout='dense' only
_DENSE_KEYS = ("nbr_idx", "nbr_attr", "nbr_mask")
# pack-time edge populations and plans, stale once edges drop on device
_EDGE_STALE_KEYS = ("dst_count",) + EW_BATCH_KEYS


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
        optimizer.zero_grad(set_to_none=True)
        loss["loss"].backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return {k: v.detach() for k, v in loss.items()}

    return step
