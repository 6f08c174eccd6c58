"""YOLaT++: the canonical detector with gated hierarchy residuals.

Counterpart of `yolat_tpu/nn/yolat_pp.py:65-359` (`fourier_features`,
`YOLaTPlusPlus`), train and eval mode. The canonical dual-stream conv
stack, fusion and head (`nn/model.py`, same dimensions) plus three
strictly additive residual levels, each behind a 0-d gate that starts at
zero, so a fresh model is the canonical detector bit for bit:

  point      Fourier features of the proposal-normalised positions through
             `point_pe_mlp`, added to the first conv's local stream
             (gate_point);
  curve      one token per shape edge from [e_attr || x_src || x_dst]
             through `curve_mlp`, mean-scattered to both endpoints
             (gate_curve);
  primitive  (a) the super-edge clique family: per edge
             [s_i || s_j - s_i || attr] through `super_edge_mlp`, mean per
             dst node (:230-257) - or, with `factored_prim`
             (cfg.pp_factored_prim, :190-213), the mean of the preceding
             member features of the proposal by an exclusive prefix sum,
             through `super_fact_mlp` per node (gate_prim);
             (b) per-proposal super tokens from the centroid's Fourier
             features, the member mean and the root's member mean through
             `super_node_mlp`, added to the 512-wide head feature
             (gate_super).

Every MLP of the hierarchy, the fusion and the head (`point_pe_mlp`,
`curve_mlp`, `super_edge_mlp` / `super_fact_mlp`, `super_node_mlp`,
`fusion_block`, `fusion_block_super`, `prediction_cls.0` and `.1`) takes
`act` and `norm` (cfg.act, cfg.norm; `nn.layers.MLP`), as the JAX module
does (:121-353); the two gp2 convs stay ReLU and BatchNorm, and
`prediction_cls.2` stays bare. A LayerNorm normalises every row, pad rows
too; those rows reach no sum (segment_mean masks, kernel 8 sums the
plan's rows up to nptr[N]).

A model holds `super_edge_mlp` or `super_fact_mlp`, never both, as a JAX
checkpoint does. The parameter tree is flat, as the JAX module's
(`AttrEdgeGP2_{i}` at the top, not under `cls_net`): `convs.{i}`,
`fusion_block`, `fusion_block_super`, `prediction_cls.{k}`, the four
hierarchy MLPs and the gates; `nn.state_dict.export_state_dict_pp` maps JAX
variables onto these names.

Train mode (`model.train()`) uses masked batch statistics in every MLP:
`point_pe_mlp` over the real nodes, `curve_mlp` over the real edges,
`super_edge_mlp` over the real super edges, `super_fact_mlp` over the
nodes that receive, `super_node_mlp` and the head over the real proposals.
Three routes through the primitive level (a), as in the JAX module:

  per-edge sparse  over the padded super-edge buffer (:230-257), plain
                   PyTorch ops; the dst gather reads one row per
                   SUPER_BLOCK through the aligned `sup_` plan;
  per-edge banded  `banded_super` (cfg.pp_banded_super, :214-229): kernel 7
                   gathers both endpoint rows over the `sew_` plan's rows
                   (the real super edges, nothing masked), `super_edge_mlp`
                   runs over them, kernel 8 sums the tokens per node; same
                   parameters as the sparse route. A batch without the plan
                   raises: the JAX module falls to the sparse branch there,
                   which would hide the kernels;
  factored         `factored_prim` (:190-213); the exclusive prefix sum
                   carries a gradient (`_PrefixSum`).

With `fused_pool` (cfg.fused_head_train, :278-293) the train-mode pool head
is the fused op of `ops/fused_pool_train.py` (kernels 3 and 11), as in the
canonical model (`nn/model.py`); `fusion_block` keeps its parameter names.
The JAX module never hands its convs an edge-window plan (:131-134), so
there is no window layout under YOLaT++ (`nn.model.build_model` refuses
`train_layout='window'`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from yolat_tpu_torch.config import PP_GATES
from yolat_tpu_torch.nn.conv import AttrEdgeGP2
from yolat_tpu_torch.nn.layers import MLP, FusedPoolFusion
from yolat_tpu_torch.nn.model import FUSION, takes_fused_head
from yolat_tpu_torch.ops.banded_train import banded_gather, banded_scatter_own
from yolat_tpu_torch.ops.plans import bm_of, plan_of, real_rows, sup_plan_of
from yolat_tpu_torch.ops.segment import (segment_broadcast, segment_max,
                                         segment_max_concat, segment_mean)


def fourier_features(pos, n_freqs: int = 4):
    """[N, 2] -> [N, 4 * n_freqs] sin/cos features, in pos's type."""
    freqs = torch.pow(2.0, torch.arange(n_freqs, dtype=pos.dtype,
                                        device=pos.device)) * math.pi
    ang = pos[:, :, None] * freqs[None, None, :]  # [N, 2, F]
    return torch.cat([torch.sin(ang), torch.cos(ang)],
                     dim=-1).reshape(pos.shape[0], -1)


class _PrefixSum(torch.autograd.Function):
    """Exclusive prefix sum over the rows of [N, C]. Both passes scan the
    contiguous axis of the transpose: torch.cumsum over dim 0 of
    [72704, 64] f32 took 16.0 ms of a 19.0 ms predict (NVIDIA H100 80GB
    HBM3, 700.00 W; cli/profile --stages serve_pp), and autograd's own
    backward of a transposed scan would scan that axis again."""

    @staticmethod
    def forward(ctx, rows):
        t = rows.t().contiguous()
        return (torch.cumsum(t, dim=1) - t).t()

    @staticmethod
    def backward(ctx, g):
        # d rows[i] = the sum of g over the rows after i
        t = g.t().contiguous()
        return (torch.cumsum(t.flip(1), dim=1).flip(1) - t).t()


def prefix_member_mean(s_f, batch: dict, pool):
    """The factored primitive level's aggregate -> (m [N, C] in s_f's type,
    valid [N] bool): m_i is the mean of the member rows of node i's
    proposal that precede it, by one exclusive prefix sum over the member
    rows and a per-proposal rebase; valid = member & (rank > 0), the first
    member receives nothing. The prefix sum runs in f32 (its values grow
    with the batch; the rebase cancels them), or in float64 for a float64
    s_f (the reference a smoke check holds the card to)."""
    acc = torch.float64 if s_f.dtype == torch.float64 else torch.float32
    member, rank = batch["sup_member"], batch["sup_rank"]
    rows = torch.where(member[:, None], s_f, torch.zeros_like(s_f)).to(acc)
    pref = _PrefixSum.apply(rows)
    base = segment_broadcast(
        pref.index_select(0, batch["prop_first_row"].long()),
        batch["bbox_idx"], s_f.shape[0], plan=pool)
    m = (pref - base) / torch.clamp(rank.to(acc), min=1.0)[:, None]
    return m.to(s_f.dtype), member & (rank > 0)


class YOLaTPlusPlus(nn.Module):
    def __init__(self, n_classes: int, in_channels: int = 5,
                 channels: int = 64, n_blocks: int = 2, n_blocks_out: int = 2,
                 n_freqs: int = 4, classifier: str = "softmax",
                 dropout: float = 0.0, factored_prim: bool = False,
                 banded_super: bool = False, fused_pool: bool = False,
                 act="relu", norm="batch"):
        super().__init__()
        c = channels
        self.n_blocks, self.n_blocks_out = n_blocks, n_blocks_out
        self.n_freqs = n_freqs
        self.classifier = classifier
        self.act, self.norm = act, norm
        self.factored_prim = factored_prim
        self.banded_super = banded_super
        self.fused_pool = fused_pool
        # train-mode CPU batches that could not take the fused head
        self.fused_fallbacks = 0
        self.convs = nn.ModuleList(
            AttrEdgeGP2(in_channels if i == 0 else c, c)
            for i in range(n_blocks))
        fusion_dims = c * n_blocks_out
        kw = dict(act=act, norm=norm)
        self.fusion_block = FusedPoolFusion(fusion_dims, FUSION, **kw)
        self.fusion_block_super = MLP([fusion_dims, FUSION], **kw)
        self.prediction_cls = nn.ModuleList([
            MLP([(fusion_dims + FUSION) * 2, 512], **kw),
            MLP([512, 256], drop=dropout, **kw),
            MLP([256, n_classes], bare=True),
        ])
        self.point_pe_mlp = MLP([4 * n_freqs, c], **kw)
        self.curve_mlp = MLP([4 + 2 * c, c], **kw)
        if factored_prim:
            self.super_fact_mlp = MLP([2 * c + 4, c], **kw)
        else:
            self.super_edge_mlp = MLP([2 * c + 4, c], **kw)
        self.super_node_mlp = MLP([4 * n_freqs + 2 * c, 512], **kw)
        for g in PP_GATES:
            setattr(self, g, nn.Parameter(torch.zeros(())))

    def _prim_at_node(self, s_f, batch: dict, pool):
        """Primitive level (a) -> [N, C]."""
        if self.factored_prim:
            if "sup_rank" not in batch:
                raise ValueError(
                    "pp_factored_prim=True but the batch has no factored "
                    "pack fields ('sup_rank'): pack with PackedLoader("
                    "super_family=True), or set pp_factored_prim=False")
            m, valid = prefix_member_mean(s_f, batch, pool)
            prim_in = torch.cat([s_f, m - s_f, batch["sup_abar"].to(s_f.dtype)],
                                dim=1)
            tok = self.super_fact_mlp(prim_in, valid)
            return torch.where(valid[:, None], tok, torch.zeros_like(tok))
        if self.banded_super:
            bm = bm_of(batch, "sew_")
            if bm is None or batch.get("super_dst_count") is None:
                raise ValueError(
                    "pp_banded_super=True but the batch has no super-edge "
                    "plan sew_ or no super_dst_count: pack with PackedLoader("
                    "super_family=True, sew_plan='transpose'); edge dropout "
                    "strips both")
            x_own, x_oth = banded_gather(s_f, bm)
            prim_in = torch.cat([x_own, x_oth - x_own, bm.attr.to(s_f.dtype)],
                                dim=1)
            # the plan's real rows: a batch at capacity has pad rows past
            # nptr[N]
            tok = self.super_edge_mlp(prim_in,
                                      real_rows(bm.nptr, prim_in.shape[0]))
            total = banded_scatter_own(tok, bm, s_f.shape[0])
            count = torch.clamp(batch["super_dst_count"].float(), min=1.0)
            return (total / count[:, None]).to(s_f.dtype)
        es, es_mask = batch["edge_super"], batch["super_mask"]
        sup = sup_plan_of(batch)
        dst = es[:, 1].long()
        # dst runs are SUPER_BLOCK-aligned: with the plan the gather reads
        # one row per block
        s_i = segment_broadcast(s_f, dst, es.shape[0], plan=sup)
        s_j = s_f.index_select(0, es[:, 0].long())
        # e_attr_super comes in the compute type: the train step casts it
        # with the other float fields (train/loop._COMPUTE_KEYS)
        prim_in = torch.cat([s_i, s_j - s_i, batch["e_attr_super"]], dim=1)
        tok = self.super_edge_mlp(prim_in, es_mask)
        return segment_mean(tok, dst, s_f.shape[0], mask=es_mask, plan=sup,
                            counts=batch.get("super_dst_count"))

    def forward(self, batch: dict, generator=None, probes: dict | None = None):
        """Finalized tensor batch (packed with the super-edge family) ->
        (logits [P, n_classes], boxes [P, 4]). `generator` draws the dropout
        masks in train mode; a `probes` dict is filled with 'prim_at_node'
        [N, C], the primitive level's output before its gate (what the JAX
        module sows at :264)."""
        n_prop = batch["labels"].shape[0]
        node_mask, pm = batch["node_mask"], batch["proposal_mask"]
        edge, edge_mask = batch["edge"], batch["edge_mask"]
        bbox_idx = batch["bbox_idx"]
        pool = plan_of(batch)
        n = batch["x"].shape[0]

        x = torch.where(node_mask[:, None], batch["x"],
                        torch.zeros_like(batch["x"]))
        pe_tok = self.point_pe_mlp(
            fourier_features(batch["pos"].to(x.dtype), self.n_freqs),
            node_mask)

        kw = {"dst_count": batch.get("dst_count")}
        if "nbr_idx" in batch:
            kw["nbr"] = (batch["nbr_idx"], batch["nbr_attr"],
                         batch["nbr_mask"])
        f, s = x, x
        feats, feats_super = [], []
        for i, conv in enumerate(self.convs):
            f, s = conv(f, s, edge, batch["e_attr"], edge_mask, node_mask,
                        **kw)
            if i == 0:
                f = f + self.gate_point * pe_tok
            feats.append(f)
            feats_super.append(s)

        # curve level: per-edge tokens mean-scattered to both endpoints
        src, dst = edge[:, 0].long(), edge[:, 1].long()
        curve_in = torch.cat([batch["e_attr"].to(x.dtype),
                              feats[-1].index_select(0, src),
                              feats[-1].index_select(0, dst)], dim=1)
        curve_tok = self.curve_mlp(curve_in, edge_mask)
        curve_at_node = segment_mean(
            curve_tok, dst, n, mask=edge_mask, counts=batch.get("dst_count")
        ) + segment_mean(curve_tok, src, n, mask=edge_mask,
                         counts=batch.get("src_count"))
        prim_at_node = self._prim_at_node(feats[-1], batch, pool)
        if probes is not None:
            probes["prim_at_node"] = prim_at_node
        feats[-1] = (feats[-1] + self.gate_curve * curve_at_node
                     + self.gate_prim * prim_at_node)

        # canonical fusion and pooling (nn/model.Backbone's dimensions)
        lo = self.n_blocks - self.n_blocks_out
        cat = torch.cat(feats[lo:], dim=1)
        if takes_fused_head(self, cat, pool):
            pooled = torch.cat([
                self.fusion_block.pool(cat, node_mask, pool[0], n_prop),
                segment_max(cat, bbox_idx, n_prop, mask=node_mask,
                            plan=pool).to(cat.dtype)], dim=1)
        else:
            pooled = None
            fusion = self.fusion_block(cat, node_mask)
        pooled_super = segment_mean(torch.cat(feats_super[lo:], dim=1),
                                    bbox_idx, n_prop, mask=node_mask,
                                    plan=pool, counts=batch.get("prop_count"))
        out_super = torch.cat([self.fusion_block_super(pooled_super, pm),
                               pooled_super], dim=1)

        # primitive level (b): per-proposal super tokens
        centroid = segment_mean(batch["pos"].to(x.dtype), bbox_idx, n_prop,
                                mask=node_mask, plan=pool,
                                counts=batch.get("prop_count"))
        member_mean = segment_mean(feats[-1], bbox_idx, n_prop, mask=node_mask,
                                   plan=pool, counts=batch.get("prop_count"))
        sup_in = torch.cat([fourier_features(centroid, self.n_freqs),
                            member_mean,
                            member_mean.index_select(
                                0, batch["root_slot"].long())], dim=1)
        super_tok = self.super_node_mlp(sup_in, pm)

        if pooled is None:
            pooled = segment_max_concat((fusion, cat), bbox_idx, n_prop,
                                        mask=node_mask, plan=pool)
        h = torch.cat([pooled, out_super], dim=1)
        h = self.prediction_cls[0](h, pm)
        h = h + self.gate_super * super_tok
        h = self.prediction_cls[1](h, pm, generator)
        h = self.prediction_cls[2](h)
        if self.classifier != "softmax":
            h = torch.sigmoid(h)
        return h, batch["bbox"]
