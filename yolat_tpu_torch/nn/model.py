"""The canonical YOLaT detector, eval forward: Backbone + SparseCADGCN.

Counterpart of `yolat_tpu/nn/model.py:39-234` (the reference's
cad_recognition/architecture3cc_rpn_gp_iter2.py): a head conv
(in_channels -> C), n_blocks-1 further convs (no residual for gp2), the
fusion MLP C*n_blocks_out -> 1024 max-pooled per proposal beside the raw
features, the super stream mean-pooled per proposal through its own
fusion MLP, then the prediction MLP (2*(C*n_blocks_out+1024) -> 512 ->
256 -> n_classes).

Submodules carry the reference's names — `cls_net.head.gconv`,
`cls_net.backbone.{i}.body.gconv`, `cls_net.fusion_block[_super]`,
`prediction_cls.{k}` — so a reference `.pth`, or JAX variables through
`nn.state_dict.export_state_dict`, load with
`load_state_dict(strict=True)` (`load_jax_variables`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from yolat_tpu_torch.nn.conv import AttrEdgeGP2
from yolat_tpu_torch.nn.layers import MLP, MaskedBatchNorm, init_weights
from yolat_tpu_torch.nn.state_dict import (export_state_dict,
                                           load_reference_state_dict)
from yolat_tpu_torch.ops.plans import plan_of
from yolat_tpu_torch.ops.segment import segment_max_concat, segment_mean

FUSION = 1024  # fusion MLP width, fixed by the reference


class _GConv(nn.Module):
    """The reference's GraphConv wrapper (`.gconv` holds the conv)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.gconv = AttrEdgeGP2(cin, cout)


class _ResBlock(nn.Module):
    """The reference's ResBlock (`.body`); its residual is off for gp2."""

    def __init__(self, c: int):
        super().__init__()
        self.body = _GConv(c, c)


class Backbone(nn.Module):
    def __init__(self, in_channels: int = 5, channels: int = 64,
                 n_blocks: int = 2, n_blocks_out: int = 2):
        super().__init__()
        self.n_blocks, self.n_blocks_out = n_blocks, n_blocks_out
        self.fusion_dims = channels * n_blocks_out
        self.head = _GConv(in_channels, channels)
        self.backbone = nn.ModuleList(_ResBlock(channels)
                                      for _ in range(n_blocks - 1))
        self.fusion_block = MLP([self.fusion_dims, FUSION])
        self.fusion_block_super = MLP([self.fusion_dims, FUSION])

    def forward(self, batch: dict):
        """-> ((fusion, cat) node-level parts, pooled super-stream [P, .])"""
        n_prop = batch["labels"].shape[0]
        plan = plan_of(batch)
        args = (batch["edge"], batch["e_attr"], batch["edge_mask"])
        f, s = self.head.gconv(batch["x"], batch["x"], *args,
                               dst_count=batch.get("dst_count"))
        feats, feats_super = [f], [s]
        for blk in self.backbone:
            f, s = blk.body.gconv(f, s, *args, dst_count=batch.get("dst_count"))
            feats.append(f)
            feats_super.append(s)
        lo = self.n_blocks - self.n_blocks_out
        cat = torch.cat(feats[lo:], dim=1)
        fusion = self.fusion_block(cat)
        pooled = segment_mean(torch.cat(feats_super[lo:], dim=1),
                              batch["bbox_idx"], n_prop,
                              mask=batch["node_mask"], plan=plan,
                              counts=batch.get("prop_count"))
        fusion_super = self.fusion_block_super(pooled)
        return (fusion, cat), torch.cat([fusion_super, pooled], dim=1)


class SparseCADGCN(nn.Module):
    def __init__(self, n_classes: int, in_channels: int = 5,
                 channels: int = 64, n_blocks: int = 2, n_blocks_out: int = 2,
                 classifier: str = "softmax"):
        super().__init__()
        self.n_blocks = n_blocks
        self.classifier = classifier
        self.cls_net = Backbone(in_channels, channels, n_blocks, n_blocks_out)
        fusion_out = self.cls_net.fusion_dims + FUSION
        self.prediction_cls = nn.ModuleList([
            MLP([fusion_out * 2, 512]),
            MLP([512, 256]),
            MLP([256, n_classes], bare=True),
        ])

    def forward(self, batch: dict):
        """Finalized tensor batch -> (logits [P, n_classes], boxes [P, 4])."""
        parts, out_super = self.cls_net(batch)
        pooled = segment_max_concat(parts, batch["bbox_idx"],
                                    batch["labels"].shape[0],
                                    mask=batch["node_mask"],
                                    plan=plan_of(batch))
        h = torch.cat([pooled, out_super], dim=1)
        for mlp in self.prediction_cls:
            h = mlp(h)
        if self.classifier != "softmax":
            h = torch.sigmoid(h)
        return h, batch["bbox"]


def build_model(cfg) -> SparseCADGCN:
    """The canonical detector from a `yolat_tpu_torch.config.Config`
    (yolat_tpu/train/loop.py:47)."""
    if cfg.arch != "centernet3cc_rpn_gp_iter2" or cfg.conv != "attr_edge_gp2":
        raise NotImplementedError(
            f"arch {cfg.arch!r} / conv {cfg.conv!r}: this port serves the "
            "canonical centernet3cc_rpn_gp_iter2 + attr_edge_gp2 detector")
    return SparseCADGCN(cfg.n_classes, cfg.in_channels, cfg.n_filters,
                        cfg.n_blocks, cfg.n_blocks_out, cfg.classifier)


@torch.no_grad()
def seeded_model(cfg, seed: int = 0) -> SparseCADGCN:
    """A random eval-mode detector made from `seed`: Kaiming weights and
    randomised BatchNorm affine terms and running statistics, so folding
    them is not the identity (smoke checks, profiling, tests)."""
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            f = m.weight.shape[0]
            m.weight.copy_(1.0 + 0.2 * torch.randn(f, generator=gen))
            m.bias.copy_(0.1 * torch.randn(f, generator=gen))
            m.running_mean.copy_(0.2 * torch.randn(f, generator=gen))
            m.running_var.copy_(0.5 + torch.rand(f, generator=gen))
    return model.eval()


def _load_numpy_state(model: SparseCADGCN, sd: dict) -> SparseCADGCN:
    model.load_state_dict({k: torch.from_numpy(np.array(v, copy=True))
                           for k, v in sd.items()}, strict=True)
    return model


def load_jax_variables(model: SparseCADGCN, variables) -> SparseCADGCN:
    """JAX flax variables (numpy leaves) -> the port's weights, through the
    reference state dict (`export_state_dict`)."""
    return _load_numpy_state(model, export_state_dict(
        variables, n_blocks=model.n_blocks))


def load_reference_checkpoint(model: SparseCADGCN, path: str) -> SparseCADGCN:
    """Load a reference-format `.pth` ({'state_dict': ...}) strictly."""
    return _load_numpy_state(model, load_reference_state_dict(path))
