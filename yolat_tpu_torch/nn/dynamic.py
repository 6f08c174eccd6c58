"""Graph attention and the dynamic-graph blocks.

Counterpart of `yolat_tpu/nn/dynamic.py` (the reference's
torch_vertex.py):
  GATConv          :32-71 (torch_vertex.py:608-624), the registry's `gat`:
                   multi-head attention over the incoming edges, then
                   bias, the activation and an optional BatchNorm;
  DynConv          :74-104 (:778-791): the kNN graph of the features
                   rebuilt each call (`ops.knn.knn_graph` with the node
                   mask, kernel_size * dilation neighbours, `dilated`),
                   then a conv of the registry, `gconv`;
  PlainDynBlock, ResDynBlock, DenseDynBlock  :107-162 (:794-885), `body`;
  ResGraphBlock, DenseGraphBlock  :165-201 (:888-911), on given edges;
  ResBlockMultiEdge  :204-234 (:831-857): one residual conv per edge
                   family (`gconvs`), the elementwise max across them.

As in JAX, DynConv passes no segment ids to the kNN (:91-93): on a
flat-packed batch of several images it picks neighbours across images
(the reference's DynConv passes `batch`). Only DynConv takes `stochastic`
and `epsilon`; the blocks build theirs without (:118-120, :137-139). A
conv takes no edge attributes here, so DynConv refuses the convs that
need them or another signature (`NO_DYN_CONVS`) where JAX fails at trace,
and the given-edge blocks refuse the two with another signature
(attr_edge_gp2, attr_edge_cf). `norm` defaults to None, JAX's default
(the registry's is 'batch'). JAX's `sorted_edges` has no counterpart: no
conv of the port reads it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yolat_tpu_torch.nn.layers import MaskedBatchNorm, act_fn
from yolat_tpu_torch.ops.knn import dilated, knn_graph
from yolat_tpu_torch.ops.segment import segment_softmax, segment_sum

# DynConv calls its conv with x, the kNN edges and masks alone
NO_DYN_CONVS = ("attr_edge_gp2", "attr_edge", "multilayer_edge",
                "attr_edge_gp", "attr_edge_cf")
# convs of another signature (x_node; pos) than (x, edge, e_attr, ...)
OTHER_SIGNATURE = ("attr_edge_gp2", "attr_edge_cf")


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


def _registry_conv(conv, in_channels, out_channels, act, norm, refused,
                   block):
    from yolat_tpu_torch.nn.conv import make_conv

    if conv.lower() in refused:
        raise ValueError(
            f"{block} with conv {conv!r}: {block} calls its conv with x, "
            f"the edges{'' if block == 'DynConv' else ', their attributes'} "
            f"and the masks alone, and the JAX block fails at trace; it "
            f"takes any conv but {', '.join(refused)}")
    return make_conv(conv, in_channels, out_channels, act=act, norm=norm)


def _ones_mask(edge_mask, edge):
    if edge_mask is None:
        return torch.ones(edge.shape[0], dtype=torch.bool, device=edge.device)
    return edge_mask


class DynConv(nn.Module):
    """kernel_size * dilation nearest neighbours of each node in feature
    space, every dilation-th (or, stochastic in training, a random
    k-subset with probability epsilon), then `gconv`."""

    def __init__(self, in_channels, out_channels, kernel_size=9, dilation=1,
                 conv="edge", act="relu", norm=None, stochastic=False,
                 epsilon=0.2):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        self.stochastic, self.epsilon = stochastic, epsilon
        self.conv, self.act = conv.lower(), act
        self.gconv = _registry_conv(conv, in_channels, out_channels, act,
                                    norm, NO_DYN_CONVS, "DynConv")

    def forward(self, x, node_mask=None, generator=None):
        edge_index, edge_mask = knn_graph(
            x, self.kernel_size * self.dilation, mask=node_mask)
        edge_index, edge_mask = dilated(
            edge_index, edge_mask, self.kernel_size, self.dilation,
            stochastic=self.stochastic and self.training,
            epsilon=self.epsilon, generator=generator)
        return self.gconv(x, edge_index.t().contiguous(), None, edge_mask,
                          node_mask)


class PlainDynBlock(nn.Module):
    def __init__(self, channels, kernel_size=9, dilation=1, conv="edge",
                 act="relu", norm=None):
        super().__init__()
        self.body = DynConv(channels, channels, kernel_size, dilation, conv,
                            act, norm)

    def forward(self, x, node_mask=None, generator=None):
        return self.body(x, node_mask, generator)


class ResDynBlock(nn.Module):
    def __init__(self, channels, kernel_size=9, dilation=1, conv="edge",
                 act="relu", norm=None, res_scale=1.0):
        super().__init__()
        self.res_scale = res_scale
        self.body = DynConv(channels, channels, kernel_size, dilation, conv,
                            act, norm)

    def forward(self, x, node_mask=None, generator=None):
        return self.body(x, node_mask, generator) + x * self.res_scale


class DenseDynBlock(nn.Module):
    def __init__(self, in_channels, out_channels=64, kernel_size=9,
                 dilation=1, conv="edge", act="relu", norm=None):
        super().__init__()
        self.body = DynConv(in_channels, out_channels, kernel_size, dilation,
                            conv, act, norm)

    def forward(self, x, node_mask=None, generator=None):
        return torch.cat([x, self.body(x, node_mask, generator)], dim=1)


class ResGraphBlock(nn.Module):
    def __init__(self, channels, conv="edge", act="relu", norm=None,
                 res_scale=1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv, self.act = conv.lower(), act
        self.gconv = _registry_conv(conv, channels, channels, act, norm,
                                    OTHER_SIGNATURE, "ResGraphBlock")

    def forward(self, x, edge, e_attr=None, edge_mask=None, node_mask=None):
        out = self.gconv(x, edge, e_attr, _ones_mask(edge_mask, edge),
                         node_mask)
        return out + x * self.res_scale


class DenseGraphBlock(nn.Module):
    def __init__(self, in_channels, out_channels, conv="edge", act="relu",
                 norm=None):
        super().__init__()
        self.conv, self.act = conv.lower(), act
        self.gconv = _registry_conv(conv, in_channels, out_channels, act,
                                    norm, OTHER_SIGNATURE, "DenseGraphBlock")

    def forward(self, x, edge, e_attr=None, edge_mask=None, node_mask=None):
        out = self.gconv(x, edge, e_attr, _ones_mask(edge_mask, edge),
                         node_mask)
        return torch.cat([x, out], dim=1)


class ResBlockMultiEdge(nn.Module):
    """One residual conv per edge family (`gconvs.i`, e.g. shape / super /
    control edges), the elementwise max across the families (`amax`: its
    gradient splits among ties, as jnp.max's does)."""

    def __init__(self, channels, conv="edge", n_edges=3, act="relu",
                 norm=None, res_scale=1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv, self.act = conv.lower(), act
        self.gconvs = nn.ModuleList(
            _registry_conv(conv, channels, channels, act, norm,
                           OTHER_SIGNATURE, "ResBlockMultiEdge")
            for _ in range(n_edges))

    def forward(self, x, edges, e_attrs=None, edge_masks=None,
                node_mask=None):
        """edges: a sequence of [E_i, 2]; e_attrs / edge_masks: matching
        sequences (or None)."""
        feats = []
        for i, conv in enumerate(self.gconvs):
            out = conv(x, edges[i], None if e_attrs is None else e_attrs[i],
                       _ones_mask(None if edge_masks is None
                                  else edge_masks[i], edges[i]), node_mask)
            feats.append(out + x * self.res_scale)
        return torch.stack(feats, dim=-1).amax(dim=-1)
