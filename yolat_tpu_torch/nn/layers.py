"""Masked BatchNorm, the reference-shaped MLP block and the fused pool head.

Counterpart of `yolat_tpu/nn/layers.py:30-237` (`act_fn`,
`MaskedBatchNorm`, `SumEmbedding`, `MLP`, `FusedPoolFusion`). The MLP is laid out as the
reference's flat Sequential (gcn_lib/sparse/torch_nn.py:50-71): per stage
Linear, then the norm (`norm`: 'batch', 'layer' or None) and the
activation (`act`: 'relu', 'leakyrelu' with slope 0.2 and flax's gradient
1 at 0, 'gelu' in flax's tanh form, or None), each taking an index where
it is there. With the
defaults (ReLU, BatchNorm) a stage-k Linear sits at index 3k and its
BatchNorm at 3k+1 — the state-dict keys
`yolat_tpu/train/import_reference._export_mlp` (:138-165) writes; a bare
stage (no norm, no activation) is its Linear alone. LayerNorm's epsilon is
flax's 1e-6. Dropout holds no tensor and takes no index, so reference
`.pth` files load strictly whatever the dropout rate.

Train mode computes masked batch statistics (padding rows excluded) in
f32 as E[z^2] - E[z]^2 clamped at 0, over max(count, 1) rows, and moves
the f32 running statistics with momentum 0.1 and the unbiased variance
var * n / max(n - 1, 1) (torch.nn.BatchNorm1d's convention). Eval uses
the running statistics. Either way y = (x - mean) * rsqrt(var + eps) *
weight + bias in f32, returned in x's type.
Data parallel (`yolat_tpu/nn/layers.py:81-84`, the model's `axis_name`):
with `sync_group` set (`parallel.set_sync_group`), MaskedBatchNorm sums
(count, total, total_sq) over the group's ranks, packed in one [2C + 1]
f32 tensor (one collective per layer), before the mean and variance,
through the differentiable sum (`parallel.distributed.all_reduce_sum`,
psum's transpose in the backward); the running statistics move from those
global moments, so every rank holds the same ones. FusedPoolFusion hands
its group to the fused head (kernels 3 and 11). With no group set, both
are what they are on one device.
Weight init matches the reference model_init: Kaiming-normal (fan_in,
ReLU gain) for Linear weights, zero biases (`init_weights`).
"""

from __future__ import annotations

import torch
from torch import nn

from yolat_tpu_torch.ops.fused_pool_train import fused_pool_train
from yolat_tpu_torch.parallel.distributed import all_reduce_sum


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over a padded element axis."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int64))
        self.sync_group = None  # a process group: moments over its ranks

    @torch.no_grad()
    def update_running(self, mean, var, count) -> None:
        """Move the running statistics toward one batch's f32 moments."""
        unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * unbiased)

    def forward(self, x, mask=None):
        if self.training:
            xf = x.float()
            if mask is not None:
                m = mask.float()[:, None]
                count = m.sum()
                total = (xf * m).sum(dim=0)
                total_sq = (xf * xf * m).sum(dim=0)
            else:
                # a fill, not a host-to-device copy: capturable
                count = xf.new_full((), float(x.shape[0]))
                total = xf.sum(dim=0)
                total_sq = (xf * xf).sum(dim=0)
            if self.sync_group is not None:
                c = total.shape[0]
                packed = all_reduce_sum(
                    torch.cat([count.reshape(1), total, total_sq]),
                    self.sync_group)
                count, total, total_sq = (packed[0], packed[1:c + 1],
                                          packed[c + 1:])
            count = torch.clamp(count, min=1.0)
            mean = total / count
            var = torch.clamp(total_sq / count - mean * mean, min=0.0)
            self.update_running(mean.detach(), var.detach(), count)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * inv + self.bias).to(x.dtype)


def dropout(x, p: float, generator: torch.Generator | None):
    """Inverted dropout with an explicit generator (keep 1 - p, scale
    1 / (1 - p)), as flax's nn.Dropout."""
    if generator is None:
        raise ValueError("dropout > 0 in training needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _is_none(name) -> bool:
    return name is None or str(name).lower() == "none"


def leaky_relu(x, negative_slope: float = 0.2):
    """flax's leaky_relu: x where x >= 0, else negative_slope * x. Its
    gradient at x = 0 is 1, where torch's F.leaky_relu gives the slope: a
    GAT node with no incoming edge sits at its bias exactly, 0 at init, so
    the kink decides that bias's gradient."""
    return torch.where(x >= 0, x, x * negative_slope)


class LeakyReLU(nn.Module):
    """`leaky_relu` as a module (no tensors, so it takes a Sequential index
    as torch.nn.LeakyReLU does)."""

    def __init__(self, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return leaky_relu(x, self.negative_slope)


def act_layer(name):
    """The activation module of `act` (`yolat_tpu/nn/layers.py:30-40`;
    flax's nn.gelu is the tanh approximation), or None for 'none' / None."""
    if _is_none(name):
        return None
    name = name.lower()
    if name == "relu":
        return nn.ReLU()
    if name == "leakyrelu":
        return LeakyReLU(0.2)
    if name == "gelu":
        return nn.GELU(approximate="tanh")
    raise NotImplementedError(f"--act {name!r}: relu, leakyrelu, gelu or none")


def act_fn(name):
    """`act_layer` as a function; the identity for 'none' / None."""
    layer = act_layer(name)
    return (lambda x: x) if layer is None else layer


def norm_layer(name, features: int):
    """MaskedBatchNorm for 'batch', flax's LayerNorm (epsilon 1e-6) for
    'layer', None for 'none' / None."""
    if _is_none(name):
        return None
    name = name.lower()
    if name == "batch":
        return MaskedBatchNorm(features)
    if name == "layer":
        return nn.LayerNorm(features, eps=1e-6)
    raise NotImplementedError(f"--norm {name!r}: batch, layer or none")


class SumEmbedding(nn.Module):
    """The sum of one embedding per integer feature column, `emb_{i}`
    (the Atom/BondEncoder pattern, gcn_lib/sparse/torch_nn.py:74-113):
    x [N, F] int -> [N, emb_dim]. Weights start xavier-uniform, as flax's
    nn.Embed under `xavier_uniform()`, drawn from `generator`."""

    def __init__(self, feature_dims, emb_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_features = len(feature_dims)
        for i, dim in enumerate(feature_dims):
            emb = nn.Embedding(dim, emb_dim)
            nn.init.xavier_uniform_(emb.weight, generator=generator)
            setattr(self, f"emb_{i}", emb)

    def forward(self, x):
        out = 0
        for i in range(self.n_features):
            out = out + getattr(self, f"emb_{i}")(x[:, i].long())
        return out


class MLP(nn.Sequential):
    """Linear -> [norm] -> [act] [-> dropout] per channel transition
    (`yolat_tpu/nn/layers.py:119-155`); the defaults are BatchNorm and
    ReLU, and bare=True keeps only the Linear layers (the reference's
    classifier stage). `mask` selects the rows of the BatchNorm
    statistics."""

    def __init__(self, channels, bare: bool = False, drop: float = 0.0,
                 act="relu", norm="batch", bias: bool = True):
        if bare:
            act, norm = None, None
        layers, ends = [], []
        for i in range(len(channels) - 1):
            layers.append(nn.Linear(channels[i], channels[i + 1], bias=bias))
            for extra in (norm_layer(norm, channels[i + 1]), act_layer(act)):
                if extra is not None:
                    layers.append(extra)
            ends.append(len(layers) - 1)
        super().__init__(*layers)
        self.drop = drop
        # the last layer of each stage: dropout follows it in training
        self.stage_ends = frozenset(ends) if drop > 0 else frozenset()

    def forward(self, x, mask=None, generator=None):
        for i, layer in enumerate(self):
            if isinstance(layer, MaskedBatchNorm):
                x = layer(x, mask)
            else:
                x = layer(x)
            if i in self.stage_ends and self.training:
                x = dropout(x, self.drop, generator)
        return x


class FusedPoolFusion(MLP):
    """The fusion MLP [cin -> h] of the pool head. Its parameters and
    buffers are MLP([cin, h])'s (Linear at 0, BatchNorm at 1), so fused
    and unfused checkpoints are interchangeable. `pool` is the train-mode
    fused route: Dense -> masked BN (batch statistics in closed form) ->
    ReLU -> per-proposal max, through kernels 3 and 11
    (`ops/fused_pool_train.py`); it moves the running statistics with
    MaskedBatchNorm's convention."""

    def __init__(self, cin: int, h: int, act="relu", norm="batch"):
        super().__init__([cin, h], act=act, norm=norm)

    def pool(self, cat, node_mask, blk_first, n_prop: int):
        lin, bn = self[0], self[1]
        if not (isinstance(bn, MaskedBatchNorm) and isinstance(self[2],
                                                               nn.ReLU)):
            raise ValueError("the fused pool head (--fused_head_train true) "
                             "is BatchNorm and ReLU: --norm batch --act relu")
        maskf = node_mask.float()[:, None]
        pooled, mean, var, count = fused_pool_train(
            cat, maskf, lin.weight.t(), lin.bias, bn.weight, bn.bias,
            blk_first, n_prop, group=bn.sync_group)
        bn.update_running(mean, var, count)
        return pooled


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Kaiming-normal Linear weights (fan_in, ReLU gain), zero biases
    (architecture3cc_rpn_gp_iter2.py:97-104); BatchNorm at identity; a
    module's own parameters through its `init_parameters(generator)`."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                    nonlinearity="relu", generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif hasattr(m, "init_parameters"):
            m.init_parameters(generator)
