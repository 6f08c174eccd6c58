"""The conv registry: the canonical `attr_edge_gp2` in its three layouts,
and the twelve other convs of `make_conv`.

Counterpart of `yolat_tpu/nn/conv.py` (`_dense_mean` :63, `AttrEdgeGP2`
:77-150, the other convs :153-428, `CONV_REGISTRY` / `make_conv`
:431-495), the reference's gcn_lib/sparse/torch_vertex.py zoo. An edge row
(a, b) sends a message from source j=a to target i=b; aggregation is a
masked mean (or max, or sum) over each node's incoming edges, empty nodes
getting 0. In train mode a message MLP's BatchNorm takes its statistics
over the real edges (`edge_mask`, or the dense table's `nbr_mask`) and a
node MLP's over the real nodes (`node_mask`). Gathers are
`index_select`s: the backward of advanced indexing sorts its indices and
serialises the run of padding edges (all at node 0), 11.9 of 23.7 ms of
device time in a bf16 train step on an H100.

The canonical conv, `AttrEdgeGP2` (AttrRelativeEdgeConvGlobalPool2,
torch_vertex.py:288-341): a message MLP [x_i || x_j - x_i || e_attr] -> C
-> C (Linear+BN+ReLU stages) mean-aggregated, plus `lin_r(x)`, and a
propagation-free node stream `mlp_node`. Three layouts, the same
parameters and state-dict keys, the same edge population through the MLP
and its BatchNorm, so a checkpoint trained in one evaluates in another:
  * window (`ew` given: `ops.plans.ew_train_of`): the gathers and the
    per-node sum, and their backward passes, run through the trainable
    edge-window ops (`ops/edge_window_train.py`, kernels 9 and 10) over the
    plan's real edges, BatchNorm masking the capacity padding's rows;
  * dense (`nbr` given: the neighbour table (nbr_idx [N, D], nbr_attr
    [N, D, 4], nbr_mask [N, D])): the MLP over the flattened [N * D] slots,
    BatchNorm over the masked slots, a masked mean over D;
  * sparse (neither): the padded flat edge list with `edge_mask` and a
    segment mean.

The other convs take `act` and `norm` for their MLPs (`nn.layers.MLP`)
and run the sparse layout; the six of `DENSE_CONVS` also the dense one:
  attr_edge        MLP([C+4 -> C]) on [x_j - x_i || e_attr], mean + lin_r;
  multilayer_edge  the same with a 2-stage MLP;
  attr_edge_gp     x is [features || root features]: the message on the
                   feature half, plus lin_r(features) + mlp(root);
  attr_edge_cf     8 MLPs([C+4 -> C -> C]), one per octant of pos_j - pos_i;
                   each runs on every real edge (its BatchNorm's statistics
                   are over all of them) and the edge's octant selects;
  edge             MLP([2C -> C]) on [x_j - x_i || x_i], mean + lin_r;
  mr               MLP([2C -> C]) on [x || max_j (x_j - x_i)];
  gcn              symmetric-normalised propagation both ways with self
                   loops (degree = in + out + 1), then act, then an
                   optional BatchNorm;
  gin              MLP((1 + eps) x + sum_j x_j), eps a parameter from 0;
  sage / rsage     mean of x_j W (rsage: (x_j - x_i) W), MLP([x || agg]) +
                   bias, L2-normalised (clamp 1e-12);
  gat              `nn.dynamic.GATConv`, 8 heads splitting the width;
  gen              `nn.gen_conv.GENConv`, which takes neither act nor norm.
"""

from __future__ import annotations

import torch
from torch import nn

from yolat_tpu_torch.nn.dynamic import GATConv
from yolat_tpu_torch.nn.gen_conv import GENConv
from yolat_tpu_torch.nn.layers import MLP, MaskedBatchNorm, act_fn
from yolat_tpu_torch.ops.edge_window_train import (ew_pair_features,
                                                   ew_window_segment_sum_n)
from yolat_tpu_torch.ops.plans import real_rows
from yolat_tpu_torch.ops.segment import (segment_max, segment_mean,
                                         segment_sum)

# the convs with a dense neighbour-table branch (`yolat_tpu/nn/model.py:
# 71-77`); the others propagate both ways or read no table
DENSE_CONVS = ("attr_edge", "multilayer_edge", "attr_edge_gp",
               "attr_edge_cf", "edge", "mr")


def _gather_ij(x, edge):
    """(x_i, x_j): target and source rows of each edge."""
    return (x.index_select(0, edge[:, 1].long()),
            x.index_select(0, edge[:, 0].long()))


def _gather_nbr(x, nbr_idx):
    """x at the neighbour table's slots: [N, D, C]."""
    n, d = nbr_idx.shape
    return x.index_select(0, nbr_idx.reshape(-1).long()).reshape(n, d, -1)


def _dense_mean(mlp, f, nbr_mask):
    """A message MLP over the dense table's [N, D, F] inputs, flattened to
    [N * D] rows (BatchNorm over the masked slots), masked-meaned over D."""
    n, d = nbr_mask.shape
    msg = mlp(f.reshape(n * d, -1), nbr_mask.reshape(n * d))
    return _slot_mean(msg.reshape(n, d, -1), nbr_mask)


def _slot_mean(msg, nbr_mask):
    m = nbr_mask[..., None].to(msg.dtype)
    return (msg * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


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
        x_nbr = _gather_nbr(x, nbr_idx)
        x_i = x[:, None, :].expand_as(x_nbr)
        f = torch.cat([x_i, x_nbr - x_i, nbr_attr.to(x.dtype)], dim=-1)
        return _dense_mean(self.nn, f, nbr_mask)

    def forward(self, x, x_node, edge, e_attr, edge_mask, node_mask=None,
                dst_count=None, ew=None, ew_attr=None, nbr=None):
        if ew is not None:
            agg = self._window_mean(x, ew, ew_attr, dst_count)
        elif nbr is not None:
            agg = self._dense_mean(x, nbr)
        else:
            x_i, x_j = _gather_ij(x, edge)
            msg = self.nn(torch.cat([x_i, x_j - x_i, e_attr], dim=1),
                          edge_mask)
            agg = segment_mean(msg, edge[:, 1], x.shape[0], mask=edge_mask,
                               counts=dst_count)
        return agg + self.lin_r(x), self.mlp_node(x_node, node_mask)


class AttrEdgeConv(nn.Module):
    """attr_edge / multilayer_edge (`layers=2`): the message on
    [x_j - x_i || e_attr]."""

    def __init__(self, in_channels, out_channels, layers: int = 1,
                 act="relu", norm=None):
        super().__init__()
        self.nn = MLP([in_channels + 4] + [out_channels] * layers, act=act,
                      norm=norm)
        self.lin_r = nn.Linear(in_channels, out_channels)

    def forward(self, x, edge, e_attr, edge_mask, node_mask=None, nbr=None):
        if nbr is not None:
            nbr_idx, nbr_attr, nbr_mask = nbr
            f = torch.cat([_gather_nbr(x, nbr_idx) - x[:, None, :],
                           nbr_attr.to(x.dtype)], dim=-1)
            agg = _dense_mean(self.nn, f, nbr_mask)
        else:
            x_i, x_j = _gather_ij(x, edge)
            msg = self.nn(torch.cat([x_j - x_i, e_attr], dim=1), edge_mask)
            agg = segment_mean(msg, edge[:, 1], x.shape[0], mask=edge_mask)
        return agg + self.lin_r(x)


class AttrEdgeGP(nn.Module):
    """attr_edge_gp: x is [features || root features]; the message reads
    the feature half, `mlp` the root half."""

    def __init__(self, in_channels, out_channels, act="relu", norm=None):
        super().__init__()
        self.c = in_channels
        self.nn = MLP([2 * in_channels + 4, out_channels], act=act, norm=norm)
        self.lin_r = nn.Linear(in_channels, out_channels)
        self.mlp = MLP([in_channels, out_channels], act=act, norm=norm)

    def forward(self, x, edge, e_attr, edge_mask, node_mask=None, nbr=None):
        x_feat, x_root = x[:, :self.c], x[:, self.c:]
        if nbr is not None:
            nbr_idx, nbr_attr, nbr_mask = nbr
            x_nbr = _gather_nbr(x_feat, nbr_idx)
            x_i = x_feat[:, None, :].expand_as(x_nbr)
            f = torch.cat([x_i, x_nbr - x_i, nbr_attr.to(x.dtype)], dim=-1)
            agg = _dense_mean(self.nn, f, nbr_mask)
        else:
            x_i, x_j = _gather_ij(x_feat, edge)
            msg = self.nn(torch.cat([x_i, x_j - x_i, e_attr], dim=1),
                          edge_mask)
            agg = segment_mean(msg, edge[:, 1], x.shape[0], mask=edge_mask)
        return agg + self.lin_r(x_feat) + self.mlp(x_root, node_mask)


class AttrEdgeConvCF(nn.Module):
    """attr_edge_cf: 8 direction-conditioned message MLPs `mlp_0`..`mlp_7`,
    selected per edge by octant(sign dx, sign dy, sign(|dx| - |dy|)) of
    pos_j - pos_i. Every MLP runs on every row, so each BatchNorm takes its
    statistics over all real edges, as in the JAX package's batched
    evaluation (`yolat_tpu/nn/conv.py:260-268`)."""

    def __init__(self, in_channels, out_channels, act="relu", norm=None):
        super().__init__()
        for b in range(8):
            setattr(self, f"mlp_{b}", MLP(
                [in_channels + 4, out_channels, out_channels], act=act,
                norm=norm))
        self.lin_r = nn.Linear(in_channels, out_channels)

    def forward(self, x, edge, e_attr, edge_mask, node_mask=None, nbr=None,
                pos=None):
        if nbr is not None:
            nbr_idx, nbr_attr, nbr_mask = nbr
            n, d = nbr_idx.shape
            diff = (_gather_nbr(pos, nbr_idx) - pos[:, None, :]).reshape(
                n * d, 2)
            f = torch.cat([_gather_nbr(x, nbr_idx) - x[:, None, :],
                           nbr_attr.to(x.dtype)], dim=-1).reshape(n * d, -1)
            emask = nbr_mask.reshape(n * d)
        else:
            x_i, x_j = _gather_ij(x, edge)
            p_i, p_j = _gather_ij(pos, edge)
            diff = p_j - p_i
            f = torch.cat([x_j - x_i, e_attr], dim=1)
            emask = edge_mask
        octant = ((diff[:, 0] > 0).long() + 2 * (diff[:, 1] > 0).long()
                  + 4 * (diff[:, 0].abs() - diff[:, 1].abs() > 0).long())
        msg = None
        for b in range(8):
            out = getattr(self, f"mlp_{b}")(f, emask)
            msg = out if msg is None else torch.where(
                (octant == b)[:, None], out, msg)
        if nbr is not None:
            agg = _slot_mean(msg.reshape(n, d, -1), nbr_mask)
        else:
            agg = segment_mean(msg, edge[:, 1], x.shape[0], mask=edge_mask)
        return agg + self.lin_r(x)


class EdgeConv(nn.Module):
    """edge: the message on [x_j - x_i || x_i]."""

    def __init__(self, in_channels, out_channels, act="relu", norm=None):
        super().__init__()
        self.nn = MLP([2 * in_channels, out_channels], act=act, norm=norm)
        self.lin_r = nn.Linear(in_channels, out_channels)

    def forward(self, x, edge, e_attr, edge_mask, node_mask=None, nbr=None):
        if nbr is not None:
            nbr_idx, _, nbr_mask = nbr
            x_nbr = _gather_nbr(x, nbr_idx)
            x_i = x[:, None, :].expand_as(x_nbr)
            agg = _dense_mean(self.nn, torch.cat([x_nbr - x_i, x_i], dim=-1),
                              nbr_mask)
        else:
            x_i, x_j = _gather_ij(x, edge)
            msg = self.nn(torch.cat([x_j - x_i, x_i], dim=1), edge_mask)
            agg = segment_mean(msg, edge[:, 1], x.shape[0], mask=edge_mask)
        return agg + self.lin_r(x)


class MRConv(nn.Module):
    """mr: MLP([x || max_j (x_j - x_i)]) (empty nodes: 0)."""

    def __init__(self, in_channels, out_channels, act="relu", norm=None):
        super().__init__()
        self.nn = MLP([2 * in_channels, out_channels], act=act, norm=norm)

    def forward(self, x, edge, e_attr, edge_mask, node_mask=None, nbr=None):
        if nbr is not None:
            nbr_idx, _, nbr_mask = nbr
            diff = _gather_nbr(x, nbr_idx) - x[:, None, :]
            rel = torch.where(nbr_mask[..., None].bool(), diff,
                              torch.full_like(diff, -1e30)).amax(dim=1)
            rel = torch.where(rel <= -1e29, torch.zeros_like(rel), rel)
        else:
            x_i, x_j = _gather_ij(x, edge)
            rel = segment_max(x_j - x_i, edge[:, 1], x.shape[0],
                              mask=edge_mask)
        return self.nn(torch.cat([x, rel], dim=1), node_mask)


class GCNConv(nn.Module):
    """gcn: Kipf-Welling propagation with self loops, messages both ways,
    then act and an optional BatchNorm `bn` (norm 'batch' only)."""

    def __init__(self, in_channels, out_channels, act="relu", norm=None):
        super().__init__()
        self.lin = nn.Linear(in_channels, out_channels)
        self.act = act_fn(act)
        self.bn = (MaskedBatchNorm(out_channels)
                   if norm is not None and norm.lower() == "batch" else None)

    def forward(self, x, edge, e_attr, edge_mask, node_mask=None):
        n = x.shape[0]
        h = self.lin(x)
        src, dst = edge[:, 0], edge[:, 1]
        ones = edge_mask.to(x.dtype)
        deg = segment_sum(ones, dst, n) + segment_sum(ones, src, n) + 1.0
        inv_sqrt = 1.0 / torch.sqrt(deg)
        w = (inv_sqrt.index_select(0, src.long())
             * inv_sqrt.index_select(0, dst.long()) * ones)[:, None]
        h_i, h_j = _gather_ij(h, edge)
        out = (segment_sum(h_j * w, dst, n) + segment_sum(h_i * w, src, n)
               + h * (inv_sqrt * inv_sqrt)[:, None])
        out = self.act(out)
        if self.bn is not None:
            out = self.bn(out, node_mask)
        return out


class GINConv(nn.Module):
    """gin: MLP((1 + eps) x + sum_j x_j)."""

    def __init__(self, in_channels, out_channels, act="relu", norm=None):
        super().__init__()
        self.eps = nn.Parameter(torch.zeros(()))
        self.nn = MLP([in_channels, out_channels], act=act, norm=norm)

    def forward(self, x, edge, e_attr, edge_mask, node_mask=None):
        agg = segment_sum(x.index_select(0, edge[:, 0].long()), edge[:, 1],
                          x.shape[0], mask=edge_mask)
        return self.nn((1.0 + self.eps) * x + agg, node_mask)


class SAGEConv(nn.Module):
    """sage / rsage (`relative`): the mean of x_j W (or (x_j - x_i) W),
    MLP([x || agg]) + bias, L2-normalised. `weight` is [C_in, C_out], as
    the flax kernel and the reference's parameter."""

    def __init__(self, in_channels, out_channels, relative: bool = False,
                 act="relu", norm=None):
        super().__init__()
        self.relative = relative
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels))
        self.nn = MLP([in_channels + out_channels, out_channels], act=act,
                      norm=norm)
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.init_parameters(None)

    def forward(self, x, edge, e_attr, edge_mask, node_mask=None):
        x_i, x_j = _gather_ij(x, edge)
        h = (x_j - x_i if self.relative else x_j) @ self.weight
        agg = segment_mean(h, edge[:, 1], x.shape[0], mask=edge_mask)
        out = self.nn(torch.cat([x, agg], dim=1), node_mask) + self.bias
        norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        return out / torch.clamp(norm, min=1e-12)

    @torch.no_grad()
    def init_parameters(self, generator) -> None:
        # Kaiming-normal over fan_in = C_in, as flax's kernel init
        nn.init.kaiming_normal_(self.weight.t(), mode="fan_in",
                                nonlinearity="relu", generator=generator)
        self.bias.zero_()


def make_conv(name: str, in_channels: int, out_channels: int, act="relu",
              norm="batch", heads: int = 8):
    """The conv `name` (`yolat_tpu/nn/conv.py:465-495`): attr_edge_gp2 is
    ReLU and BatchNorm whatever act and norm say, gat splits out_channels
    over `heads` heads, gen takes neither act nor norm."""
    name = name.lower()
    if name not in CONV_REGISTRY:
        raise NotImplementedError(
            f"--conv {name!r}: one of {', '.join(CONV_NAMES)}")
    cls = CONV_REGISTRY[name]
    if name in ("attr_edge_gp2", "gen"):
        return cls(in_channels, out_channels)
    kw = dict(act=act, norm=norm)
    if name == "multilayer_edge":
        kw["layers"] = 2
    if name == "rsage":
        kw["relative"] = True
    if name == "gat":
        return cls(in_channels, out_channels // heads, heads=heads, **kw)
    return cls(in_channels, out_channels, **kw)


CONV_REGISTRY = {"attr_edge_gp2": AttrEdgeGP2, "attr_edge": AttrEdgeConv,
                 "multilayer_edge": AttrEdgeConv, "attr_edge_gp": AttrEdgeGP,
                 "attr_edge_cf": AttrEdgeConvCF, "edge": EdgeConv,
                 "mr": MRConv, "gcn": GCNConv, "gin": GINConv,
                 "sage": SAGEConv, "rsage": SAGEConv, "gat": GATConv,
                 "gen": GENConv}
CONV_NAMES = tuple(CONV_REGISTRY)
