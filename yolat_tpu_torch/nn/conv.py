"""The canonical conv, `attr_edge_gp2`, sparse branch (eval forward).

Counterpart of `yolat_tpu/nn/conv.py:78-150` (`AttrEdgeGP2`), which is the
reference's AttrRelativeEdgeConvGlobalPool2
(gcn_lib/sparse/torch_vertex.py:288-341): a message MLP
[x_i || x_j - x_i || e_attr] -> C -> C (Linear+BN+ReLU stages) mean-
aggregated over each node's incoming edges (empty nodes get 0), plus
`lin_r(x)`, and a propagation-free node stream `mlp_node`. An edge row
(a, b) sends a message from source j=a to target i=b. The dense and window
branches are TPU layouts and are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from yolat_tpu_torch.nn.layers import MLP
from yolat_tpu_torch.ops.segment import segment_mean


class AttrEdgeGP2(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.nn = MLP([in_channels * 2 + 4, out_channels, out_channels])
        self.lin_r = nn.Linear(in_channels, out_channels)
        self.mlp_node = MLP([in_channels, out_channels])

    def forward(self, x, x_node, edge, e_attr, edge_mask, dst_count=None):
        dst = edge[:, 1].long()
        x_i, x_j = x[dst], x[edge[:, 0].long()]
        msg = self.nn(torch.cat([x_i, x_j - x_i, e_attr], dim=1))
        agg = segment_mean(msg, dst, x.shape[0], mask=edge_mask,
                           counts=dst_count)
        return agg + self.lin_r(x), self.mlp_node(x_node)
