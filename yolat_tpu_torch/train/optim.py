"""Optimizers and the LR schedule.

Counterpart of `yolat_tpu/train/optim.py:19-58`: the reference's own
optimizer, torch.optim.Adam with coupled L2 weight decay
(cad_recognition/train.py:212-214; optax add_decayed_weights before
scale_by_adam), AdamW (decoupled decay) and RAdam (coupled decay), and
the epoch-granular StepLR lr * decay^(epoch // adjust_freq), stepped once
per iteration as optax's schedule counts steps.

On CUDA parameters the optimizers are built with `capturable=True` and the
learning rate is a device tensor, so that a train step captured as a CUDA
graph reads the step count and the rate from the device: `StepSchedule`
writes each step's rate into that tensor between replays (a LambdaLR would
write a Python float, which a capture bakes in).
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
    params = list(params)
    kw = dict(lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay)
    if params and params[0].device.type == "cuda":
        kw.update(lr=torch.tensor(lr, device=params[0].device),
                  capturable=True)
    name = name.lower()
    if name == "adam":
        return torch.optim.Adam(params, **kw)
    if name == "adamw":
        return torch.optim.AdamW(params, **kw)
    if name == "radam":
        return torch.optim.RAdam(params, **kw)
    raise NotImplementedError(f"optimizer {name}")


class StepSchedule:
    """`steplr`'s lr in every param group of `optimizer`; call .step()
    after every optimizer step. The value is LambdaLR's, base_lr *
    (steplr(step) / base_lr); a tensor lr is filled in place (a kernel
    queued behind the step, nothing read back), a float one replaced. The
    state dict is LambdaLR's `last_epoch`, so checkpoints of either load."""

    def __init__(self, optimizer, base_lr: float, adjust_freq: int,
                 decay_rate: float, steps_per_epoch: int):
        self.optimizer, self.base_lr = optimizer, base_lr
        self.sched = steplr(base_lr, adjust_freq, decay_rate, steps_per_epoch)
        self.last_epoch = 0
        self._apply()

    def _apply(self) -> None:
        lr = self.base_lr * (self.sched(self.last_epoch) / self.base_lr)
        for group in self.optimizer.param_groups:
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(lr)
            elif group.get("capturable"):  # a float restored from a file
                group["lr"] = torch.tensor(lr,
                                           device=group["params"][0].device)
            else:
                group["lr"] = lr

    def step(self) -> None:
        self.last_epoch += 1
        self._apply()

    def state_dict(self) -> dict:
        return {"last_epoch": self.last_epoch}

    def load_state_dict(self, state: dict) -> None:
        self.last_epoch = int(state["last_epoch"])
        self._apply()


def make_scheduler(optimizer, base_lr: float, adjust_freq: int,
                   decay_rate: float, steps_per_epoch: int) -> StepSchedule:
    """`steplr` over `optimizer`; call .step() after every optimizer step."""
    return StepSchedule(optimizer, base_lr, adjust_freq, decay_rate,
                        steps_per_epoch)
