"""Optimizers and the LR schedule.

Counterpart of `yolat_tpu/train/optim.py:19-58`: the reference's own
optimizer, torch.optim.Adam with coupled L2 weight decay
(cad_recognition/train.py:212-214; optax add_decayed_weights before
scale_by_adam), AdamW (decoupled decay) and RAdam (coupled decay), and
the epoch-granular StepLR lr * decay^(epoch // adjust_freq), stepped once
per iteration as optax's schedule counts steps.
"""

from __future__ import annotations

import torch


def steplr(base_lr: float, adjust_freq: int, decay_rate: float,
           steps_per_epoch: int):
    """lr at optimizer step `step` (0-based)."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * (decay_rate ** (epoch // adjust_freq))

    return schedule


def make_optimizer(name: str, params, lr: float, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    name = name.lower()
    kw = dict(lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, **kw)
    if name == "adamw":
        return torch.optim.AdamW(params, **kw)
    if name == "radam":
        return torch.optim.RAdam(params, **kw)
    raise NotImplementedError(f"optimizer {name}")


def make_scheduler(optimizer, base_lr: float, adjust_freq: int,
                   decay_rate: float, steps_per_epoch: int):
    """A LambdaLR giving `steplr`'s lr; call .step() after every
    optimizer step."""
    sched = steplr(base_lr, adjust_freq, decay_rate, steps_per_epoch)
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: sched(step) / base_lr)
