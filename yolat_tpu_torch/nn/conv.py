"""The canonical conv, `attr_edge_gp2`, in its three layouts (train and eval).

Counterpart of `yolat_tpu/nn/conv.py:63-150` (`_dense_mean`, `AttrEdgeGP2`),
which is the reference's AttrRelativeEdgeConvGlobalPool2
(gcn_lib/sparse/torch_vertex.py:288-341): a message MLP
[x_i || x_j - x_i || e_attr] -> C -> C (Linear+BN+ReLU stages) mean-
aggregated over each node's incoming edges (empty nodes get 0), plus
`lin_r(x)`, and a propagation-free node stream `mlp_node`. An edge row
(a, b) sends a message from source j=a to target i=b. In train mode the
message MLP's BatchNorm takes its statistics over the real edges and
`mlp_node`'s over the real nodes (`node_mask`).

Three layouts, the same parameters and state-dict keys, the same edge
population through the MLP and its BatchNorm, so a checkpoint trained in
one evaluates in another:
  * window (`ew` given: `ops.plans.ew_train_of`): the gathers and the
    per-node sum, and their backward passes, run through the trainable
    edge-window ops (`ops/edge_window_train.py`, kernels 9 and 10) over the
    plan's real edges, BatchNorm masking the capacity padding's rows;
  * dense (`nbr` given: the neighbour table (nbr_idx [N, D], nbr_attr
    [N, D, 4], nbr_mask [N, D])): the MLP over the flattened [N * D] slots,
    BatchNorm over the masked slots, a masked mean over D;
  * sparse (neither): the padded flat edge list with `edge_mask` and a
    segment mean.
"""

from __future__ import annotations

import torch
from torch import nn

from yolat_tpu_torch.nn.layers import MLP
from yolat_tpu_torch.ops.edge_window_train import (ew_pair_features,
                                                   ew_window_segment_sum_n)
from yolat_tpu_torch.ops.plans import real_rows
from yolat_tpu_torch.ops.segment import segment_mean


class AttrEdgeGP2(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.nn = MLP([in_channels * 2 + 4, out_channels, out_channels])
        self.lin_r = nn.Linear(in_channels, out_channels)
        self.mlp_node = MLP([in_channels, out_channels])

    def _window_mean(self, x, ew, ew_attr, dst_count):
        n = x.shape[0]
        g = ew_pair_features(x, ew)
        # the plan's real rows: a batch at capacity has pad rows past dptr[N]
        msg = self.nn(torch.cat([g, ew_attr.to(x.dtype)], dim=1),
                      real_rows(ew[2], g.shape[0]))
        s = ew_window_segment_sum_n(msg, ew, n)
        if dst_count is None:
            ones = torch.ones(g.shape[0], 1, dtype=torch.float32,
                              device=x.device)
            dst_count = ew_window_segment_sum_n(ones, ew, n)[:, 0]
        cnt = torch.clamp(dst_count.float(), min=1.0)
        return (s / cnt[:, None]).to(x.dtype)

    def _dense_mean(self, x, nbr):
        nbr_idx, nbr_attr, nbr_mask = nbr
        n, d = nbr_idx.shape
        # index_select for its index_add backward, as in the sparse branch
        x_nbr = x.index_select(0, nbr_idx.reshape(-1).long()).reshape(n, d, -1)
        x_i = x[:, None, :].expand_as(x_nbr)
        f = torch.cat([x_i, x_nbr - x_i, nbr_attr.to(x.dtype)], dim=-1)
        msg = self.nn(f.reshape(n * d, -1), nbr_mask.reshape(n * d))
        m = nbr_mask[..., None].to(msg.dtype)
        return ((msg.reshape(n, d, -1) * m).sum(dim=1)
                / torch.clamp(m.sum(dim=1), min=1.0))

    def forward(self, x, x_node, edge, e_attr, edge_mask, node_mask=None,
                dst_count=None, ew=None, ew_attr=None, nbr=None):
        if ew is not None:
            agg = self._window_mean(x, ew, ew_attr, dst_count)
        elif nbr is not None:
            agg = self._dense_mean(x, nbr)
        else:
            # index_select, not x[idx]: the advanced-index backward sorts
            # the indices and serialises the run of padding edges (all at
            # node 0), 11.9 of 23.7 ms of device time in a bf16 train step
            # on an H100
            dst = edge[:, 1].long()
            x_i = x.index_select(0, dst)
            x_j = x.index_select(0, edge[:, 0].long())
            msg = self.nn(torch.cat([x_i, x_j - x_i, e_attr], dim=1),
                          edge_mask)
            agg = segment_mean(msg, dst, x.shape[0], mask=edge_mask,
                               counts=dst_count)
        return agg + self.lin_r(x), self.mlp_node(x_node, node_mask)
