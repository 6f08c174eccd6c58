"""The generalized aggregation conv (DeeperGCN), the registry's `gen`.

Counterpart of `yolat_tpu/nn/gen_conv.py:21-128` (the reference's
gcn_lib/sparse/torch_message.py GenMessagePassing :8-85 and MsgNorm
:88-99, and the GENConv wrapper torch_vertex.py:16-94): softmax,
softmax_sg, softmax_sum, power and power_sum aggregations with a
temperature t, power p and degree scale y that are parameters when
learned, over the padded edge list (`ops.segment.segment_softmax`). As in
the JAX package, softmax_sg is softmax (no stop-gradient). The clamps are
`torch.maximum` / `torch.minimum`, which split the gradient of a tie
evenly as `jnp.clip` does (a message of relu(x_j) + 1e-7 sits on the
lower bound wherever x_j <= 0).
"""

from __future__ import annotations

import torch
from torch import nn

from yolat_tpu_torch.nn.layers import MLP
from yolat_tpu_torch.ops.segment import (segment_mean, segment_softmax,
                                         segment_sum)

AGGRS = ("softmax", "softmax_sg", "softmax_sum", "power", "power_sum")


def _scalar(value: float, learn: bool):
    return nn.Parameter(torch.tensor(float(value))) if learn else float(value)


class GenAggregation(nn.Module):
    """Per-target aggregation of [E, C] messages; t, p, y are parameters
    (0-d, from their initial values) where learned, else constants."""

    def __init__(self, aggr: str = "softmax", t: float = 1.0, p: float = 1.0,
                 y: float = 0.0, learn_t: bool = False, learn_p: bool = False,
                 learn_y: bool = False):
        super().__init__()
        if aggr not in AGGRS:
            raise NotImplementedError(f"aggregation {aggr!r}: one of {AGGRS}")
        self.aggr = aggr
        if aggr.startswith("softmax"):
            self.t = _scalar(t, learn_t)
        else:
            self.p = _scalar(p, learn_p)
        if aggr.endswith("_sum"):
            self.y = _scalar(y, learn_y)

    def _degree_scale(self, out, seg, n: int, mask):
        ones = torch.ones(seg.shape[0], dtype=out.dtype, device=out.device)
        deg = torch.clamp(segment_sum(ones, seg, n, mask=mask), min=1.0)
        return out * torch.pow(deg, self.y)[:, None]

    def forward(self, msg, seg, n: int, mask=None):
        if self.aggr.startswith("softmax"):
            w = segment_softmax(msg * self.t, seg, n, mask=mask)
            out = segment_sum(msg * w, seg, n, mask=mask)
        else:
            lo = torch.full((), 1e-7, dtype=msg.dtype, device=msg.device)
            hi = torch.full((), 10.0, dtype=msg.dtype, device=msg.device)
            clamped = torch.minimum(torch.maximum(msg, lo), hi)
            out = segment_mean(torch.pow(clamped, self.p), seg, n, mask=mask)
            out = torch.pow(torch.minimum(torch.maximum(out, lo), hi),
                            1.0 / self.p)
        if self.aggr.endswith("_sum"):
            out = self._degree_scale(out, seg, n, mask)
        return out


class MsgNorm(nn.Module):
    """Rescale the aggregated message to the feature's L2 norm, times a
    scale (a [1] parameter from 1 where learned)."""

    def __init__(self, learn_scale: bool = False):
        super().__init__()
        self.scale = (nn.Parameter(torch.ones(1)) if learn_scale else 1.0)

    def forward(self, x, msg):
        msg = msg / torch.clamp(torch.linalg.vector_norm(
            msg, dim=-1, keepdim=True), min=1e-12)
        return msg * torch.linalg.vector_norm(x, dim=-1,
                                              keepdim=True) * self.scale


class GENConv(nn.Module):
    """message = relu(x_j [+ e_attr where its width is x's]) + eps, the
    generalized aggregation `aggr` over each node's incoming edges, an
    optional MsgNorm, then the update MLP (ReLU, no norm) on x + agg."""

    def __init__(self, in_channels: int, out_channels: int,
                 aggr: str = "softmax", learn_t: bool = True,
                 learn_p: bool = False, msg_norm: bool = False,
                 mlp_layers: int = 1, eps: float = 1e-7):
        super().__init__()
        self.eps = eps
        self.aggr = GenAggregation(aggr, learn_t=learn_t, learn_p=learn_p)
        self.msg_norm = MsgNorm(learn_scale=True) if msg_norm else None
        self.mlp = MLP([in_channels] + [out_channels] * max(mlp_layers, 1),
                       act="relu", norm=None)

    def forward(self, x, edge, e_attr, edge_mask, node_mask=None):
        x_j = x.index_select(0, edge[:, 0].long())
        if e_attr is not None and e_attr.shape[-1] == x.shape[-1]:
            x_j = x_j + e_attr
        msg = torch.relu(x_j) + self.eps
        agg = self.aggr(msg, edge[:, 1], x.shape[0], mask=edge_mask)
        if self.msg_norm is not None:
            agg = self.msg_norm(x, agg)
        return self.mlp(x + agg, node_mask)
