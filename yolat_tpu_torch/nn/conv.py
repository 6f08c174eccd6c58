"""The canonical conv, `attr_edge_gp2`, sparse branch (train and eval).

Counterpart of `yolat_tpu/nn/conv.py:78-150` (`AttrEdgeGP2`), which is the
reference's AttrRelativeEdgeConvGlobalPool2
(gcn_lib/sparse/torch_vertex.py:288-341): a message MLP
[x_i || x_j - x_i || e_attr] -> C -> C (Linear+BN+ReLU stages) mean-
aggregated over each node's incoming edges (empty nodes get 0), plus
`lin_r(x)`, and a propagation-free node stream `mlp_node`. An edge row
(a, b) sends a message from source j=a to target i=b. In train mode the
message MLP's BatchNorm takes its statistics over the real edges
(`edge_mask`) and `mlp_node`'s over the real nodes (`node_mask`). The
dense branch is a TPU layout; the window branch (`--train_layout window`)
is queued with its kernels (ROADMAP queue 2, kernels 9-10).
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

    def forward(self, x, x_node, edge, e_attr, edge_mask, node_mask=None,
                dst_count=None):
        # index_select, not x[idx]: the advanced-index backward sorts the
        # indices and serialises the run of padding edges (all at node 0),
        # 11.9 of 23.7 ms of device time in a bf16 train step on an H100
        dst = edge[:, 1].long()
        x_i, x_j = x.index_select(0, dst), x.index_select(0, edge[:, 0].long())
        msg = self.nn(torch.cat([x_i, x_j - x_i, e_attr], dim=1), edge_mask)
        agg = segment_mean(msg, dst, x.shape[0], mask=edge_mask,
                           counts=dst_count)
        return agg + self.lin_r(x), self.mlp_node(x_node, node_mask)
