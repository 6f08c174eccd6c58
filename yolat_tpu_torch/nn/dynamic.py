"""Graph attention, the registry's `gat`.

Counterpart of `GATConv` in `yolat_tpu/nn/dynamic.py:32-71` (the
reference's torch_vertex.py:608-624): multi-head attention over the
incoming edges, then bias, the activation and an optional BatchNorm. The
rest of that module (the kNN-rebuilt `DynConv` and its blocks) is not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yolat_tpu_torch.nn.layers import MaskedBatchNorm, act_fn
from yolat_tpu_torch.ops.segment import segment_softmax, segment_sum


class GATConv(nn.Module):
    """`heads` heads of `out_channels` each: h = lin(x) (no bias), per
    head logits leaky_relu(a_src . h_j + a_dst . h_i, 0.2), a softmax over
    each node's incoming edges, the attention-weighted sum of h_j, bias,
    act and, for norm 'batch', `bn` over the real nodes."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 8,
                 act="relu", norm=None):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        width = heads * out_channels
        self.lin = nn.Linear(in_channels, width, bias=False)
        self.a_src = nn.Parameter(torch.empty(1, heads, out_channels))
        self.a_dst = nn.Parameter(torch.empty(1, heads, out_channels))
        self.bias = nn.Parameter(torch.zeros(width))
        self.act = act_fn(act)
        self.bn = (MaskedBatchNorm(width)
                   if norm is not None and norm.lower() == "batch" else None)
        self.init_parameters(None)

    @torch.no_grad()
    def init_parameters(self, generator) -> None:
        # flax's Kaiming init of a [1, H, C] kernel: fan_in = H
        for a in (self.a_src, self.a_dst):
            a.normal_(0.0, (2.0 / self.heads) ** 0.5, generator=generator)
        self.bias.zero_()

    def forward(self, x, edge, e_attr, edge_mask, node_mask=None):
        n = x.shape[0]
        h = self.lin(x).reshape(n, self.heads, self.out_channels)
        alpha_src = (h * self.a_src).sum(-1)  # [N, H]
        alpha_dst = (h * self.a_dst).sum(-1)
        src, dst = edge[:, 0].long(), edge[:, 1].long()
        logits = F.leaky_relu(alpha_src.index_select(0, src)
                              + alpha_dst.index_select(0, dst), 0.2)
        attn = segment_softmax(logits, dst, n, mask=edge_mask)  # [E, H]
        msg = h.index_select(0, src) * attn[:, :, None]
        msg = torch.where(edge_mask.bool()[:, None, None], msg,
                          torch.zeros_like(msg))
        out = segment_sum(msg.reshape(src.shape[0], -1), dst, n) + self.bias
        out = self.act(out)
        if self.bn is not None:
            out = self.bn(out, node_mask)
        return out
