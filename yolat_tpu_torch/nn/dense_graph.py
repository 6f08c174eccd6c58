"""The batched fixed-shape GNN library (the reference's gcn_lib/dense).

Counterpart of `yolat_tpu/nn/dense_graph.py`, in its [B, N, C] layout
with neighbour indices [B, N, K]:

  BasicConv             Linear -> BatchNorm -> act per stage (:27-47)
  batched_index_select  x [B, N, C], idx [B, M, K] -> [B, M, K, C] (:50)
  pairwise_neg_sqdist   [B, N, N] (:55)
  dense_knn             top-k indices [B, N, K] (:62)
  EdgeConv2d, MRConv2d  (:73-105)
  GraphConv2d           `gconv`: edge or mr, NotImplementedError else
  DynConv2d             kNN rebuilt from x each call, every dilation-th
  ResDynBlock2d, DenseDynBlock2d

BasicConv's norm is flax's `nn.BatchNorm` (`FlaxBatchNorm`), not the
masked one: statistics over every (B, N[, K]) position, E[x^2] - E[x]^2
clamped at 0 (flax's fast variance), running statistics moved 0.01
toward the batch (flax momentum 0.99) with the biased variance, eps 1e-5.

`dense_knn` scores as `ops.knn` does; its self penalty is 1e30, the
mask's value, so a self column ties with masked columns and the lower
index wins, as `lax.top_k` ranks it in JAX. The max over K (EdgeConv2d's
after the activation, MRConv2d's of x_k - x_i) is `amax`, whose gradient
splits evenly among tied entries as `jnp.max`'s does (the sparse
`segment_max` gives every tie the whole cotangent).
"""

from __future__ import annotations

import torch
from torch import nn

from yolat_tpu_torch.nn.layers import act_layer
from yolat_tpu_torch.ops.knn import knn_indices


class FlaxBatchNorm(nn.Module):
    """flax's nn.BatchNorm over the last axis of x [..., C] (every other
    axis is a batch axis, no mask)."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int64))

    def forward(self, x):
        if self.training:
            xf = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(
                -1, x.shape[-1])
            mean = xf.mean(dim=0)
            var = torch.clamp((xf * xf).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * inv + self.bias).to(x.dtype)


class BasicConv(nn.Sequential):
    """Linear [-> FlaxBatchNorm] [-> act] per channel transition, laid out
    as the reference's Sequential (Linear at 0, then the norm and the
    activation where there is one)."""

    def __init__(self, channels, act="relu", norm="batch", bias=True):
        layers = []
        for cin, cout in zip(channels[:-1], channels[1:]):
            layers.append(nn.Linear(cin, cout, bias=bias))
            if norm == "batch":
                layers.append(FlaxBatchNorm(cout))
            a = act_layer(act)
            if a is not None:
                layers.append(a)
        super().__init__(*layers)
        self.has_act = act_layer(act) is not None


def batched_index_select(x, idx):
    """x [B, N, C], idx [B, M, K] -> [B, M, K, C]."""
    b, n, c = x.shape
    base = torch.arange(b, device=idx.device).reshape(b, 1, 1) * n
    rows = (idx.long() + base).reshape(-1)
    return x.reshape(b * n, c).index_select(0, rows).reshape(
        *idx.shape, c)


def pairwise_neg_sqdist(x):
    """[B, N, C] -> negative squared distances [B, N, N]."""
    x2 = (x * x).sum(dim=-1)
    return 2 * torch.bmm(x, x.transpose(1, 2)) - x2[:, :, None] \
        - x2[:, None, :]


def dense_knn(x, k: int, mask=None, chunk_rows: int | None = None):
    """Batched kNN indices [B, N, K] (dense_knn_matrix, torch_edge.py:45),
    in `lax.top_k`'s order, row chunks at a time (`ops.knn`)."""
    return torch.stack([
        knn_indices(x[b], k, None if mask is None else mask[b],
                    self_penalty=1e30, chunk_rows=chunk_rows)
        for b in range(x.shape[0])])


class EdgeConv2d(nn.Module):
    """max_k BasicConv([x_i || x_k - x_i]) (torch_vertex.py:23-35)."""

    def __init__(self, in_channels, out_channels, act="relu", norm="batch"):
        super().__init__()
        self.nn = BasicConv([in_channels * 2, out_channels], act, norm)

    def forward(self, x, idx):
        x_k = batched_index_select(x, idx)
        x_i = x[:, :, None, :].expand_as(x_k)
        return self.nn(torch.cat([x_i, x_k - x_i], dim=-1)).amax(dim=2)


class MRConv2d(nn.Module):
    """BasicConv([x || max_k (x_k - x_i)]) (torch_vertex.py:8-20)."""

    def __init__(self, in_channels, out_channels, act="relu", norm="batch"):
        super().__init__()
        self.nn = BasicConv([in_channels * 2, out_channels], act, norm)

    def forward(self, x, idx):
        rel = (batched_index_select(x, idx) - x[:, :, None, :]).amax(dim=2)
        return self.nn(torch.cat([x, rel], dim=-1))


class GraphConv2d(nn.Module):
    """`gconv`: EdgeConv2d for 'edge', MRConv2d for 'mr'
    (torch_vertex.py:38-52)."""

    def __init__(self, in_channels, out_channels, conv="edge", act="relu",
                 norm="batch"):
        super().__init__()
        if conv == "edge":
            self.gconv = EdgeConv2d(in_channels, out_channels, act, norm)
        elif conv == "mr":
            self.gconv = MRConv2d(in_channels, out_channels, act, norm)
        else:
            raise NotImplementedError(f"dense conv {conv}")

    def forward(self, x, idx):
        return self.gconv(x, idx)


class DynConv2d(nn.Module):
    """The kNN graph rebuilt from x each call (kernel_size * dilation
    neighbours, every dilation-th kept), then `body`
    (torch_vertex.py:55-72)."""

    def __init__(self, in_channels, out_channels, kernel_size=9, dilation=1,
                 conv="edge", act="relu", norm="batch"):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        self.body = GraphConv2d(in_channels, out_channels, conv, act, norm)

    def forward(self, x, mask=None):
        idx = dense_knn(x, self.kernel_size * self.dilation, mask=mask)
        return self.body(x, idx[:, :, ::self.dilation])


class ResDynBlock2d(nn.Module):
    def __init__(self, channels, kernel_size=9, dilation=1, conv="edge",
                 res_scale=1.0):
        super().__init__()
        self.res_scale = res_scale
        self.body = DynConv2d(channels, channels, kernel_size, dilation, conv)

    def forward(self, x, mask=None):
        return self.body(x, mask) + x * self.res_scale


class DenseDynBlock2d(nn.Module):
    def __init__(self, in_channels, out_channels=64, kernel_size=9,
                 dilation=1, conv="edge"):
        super().__init__()
        self.body = DynConv2d(in_channels, out_channels, kernel_size,
                              dilation, conv)

    def forward(self, x, mask=None):
        return torch.cat([x, self.body(x, mask)], dim=-1)
