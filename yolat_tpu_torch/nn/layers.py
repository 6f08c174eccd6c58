"""Masked BatchNorm and the reference-shaped MLP block (eval forward).

Counterpart of `yolat_tpu/nn/layers.py:43-157` (`MaskedBatchNorm`, `MLP`).
The MLP is laid out as the reference's flat Sequential
(gcn_lib/sparse/torch_nn.py:50-71): per stage Linear, then BatchNorm and
the activation unless the stage is bare, so a stage-k Linear sits at index
3k and its BatchNorm at 3k+1 — the state-dict keys
`yolat_tpu/train/import_reference._export_mlp` (:138-165) writes.

Eval uses the running statistics (eps 1e-5), as the JAX module does with
train=False: y = (x - mean) * rsqrt(var + eps) * weight + bias. The
masked batch statistics (padding rows excluded) are training-only and
arrive with the training slice, together with the mask argument.
Weight init matches the reference model_init: Kaiming-normal (fan_in,
ReLU gain) for Linear weights, zero biases (`init_weights`).
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over a padded element axis; eval form only."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int64))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm training statistics arrive with the "
                "training slice; call model.eval()")
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean) * inv + self.bias).to(x.dtype)


class MLP(nn.Sequential):
    """Linear -> BatchNorm -> ReLU per channel transition; bare=True keeps
    only the Linear layers (the reference's classifier stage)."""

    def __init__(self, channels, bare: bool = False):
        layers = []
        for i in range(len(channels) - 1):
            layers.append(nn.Linear(channels[i], channels[i + 1]))
            if not bare:
                layers += [MaskedBatchNorm(channels[i + 1]), nn.ReLU()]
        super().__init__(*layers)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Kaiming-normal Linear weights (fan_in, ReLU gain), zero biases
    (architecture3cc_rpn_gp_iter2.py:97-104); BatchNorm at identity."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                    nonlinearity="relu", generator=generator)
            nn.init.zeros_(m.bias)
