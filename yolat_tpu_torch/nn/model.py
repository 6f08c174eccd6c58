"""The canonical YOLaT detector: Backbone + SparseCADGCN + the loss.

Counterpart of `yolat_tpu/nn/model.py:39-288` (the reference's
cad_recognition/architecture3cc_rpn_gp_iter2.py): a head conv
(in_channels -> C), n_blocks-1 further convs, the fusion MLP
C*n_blocks_out -> 1024 max-pooled per proposal beside the raw features,
the super stream mean-pooled per proposal through its own fusion MLP, then
the prediction MLP (2*(C*n_blocks_out+1024) -> 512 -> 256 -> n_classes,
dropout on the 256 stage), and `detection_loss`.

The conv is any of `nn.conv.CONV_NAMES` (`conv`; the MLPs take `act` and
`norm`, `yolat_tpu/nn/model.py:61-159`). The canonical attr_edge_gp2 is
dual-stream (a node stream and a super stream, no residual). Every other
conv is single-stream: from the second conv on a residual adds its input
(the reference's ResBlock, torch_vertex.py:829), and the super stream is
the same features. attr_edge_gp is given [f || its proposal's mean of f],
attr_edge_cf the node positions, and the dense table goes only to the
convs of `nn.conv.DENSE_CONVS`.

`remat` (cfg.remat, --remat) checkpoints the MLPs the JAX package wraps
(`yolat_tpu/nn/model.py:122, 141-156`): attr_edge_gp2's message MLP `nn`
on every layout, the unfused `fusion_block` forward (not its fused
`.pool`) and `fusion_block_super`, on the dual and the single-stream
path; the other convs' MLPs, `mlp_node`, `lin_r` and `prediction_cls`
stay plain. Their activations are recomputed in the backward
(`nn.layers.MLP`); losses, gradients, running statistics and state-dict
keys are those of remat off.

Train mode (`model.train()`) uses masked batch statistics everywhere. With
`fused_pool` set (cfg.fused_head_train) the train-mode pool head is the
fused op of `ops/fused_pool_train.py` (kernels 3 and 11):
[pooled fusion | segment_max(cat)] replaces segment_max_concat of
[fusion | cat] (`nn/model.py:122-139`). It needs the aligned pool plan
and N % 512 == 0, which `pack_files` batches always have; without them
a CUDA batch raises, and a CPU batch takes the unfused route as the JAX
package does, counted in `Backbone.fused_fallbacks`.

The conv layout follows the batch and `window_edges`
(`yolat_tpu/nn/model.py:176-193`, cfg.train_layout == 'window'): with
`window_edges` (attr_edge_gp2 only) the convs run the window branch over
the batch's edge-window plan (kernels 9 and 10) and a batch without the
plan raises — the JAX model falls to the sparse branch there, which would
hide the kernels; otherwise a batch that carries the dense neighbour table
(`nbr_idx`) takes the dense branch (a conv without one raises), and any
other batch the sparse one.

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

from yolat_tpu_torch.config import CANONICAL_ARCH, PP_ARCHS, PP_GATES
from yolat_tpu_torch.nn.conv import CONV_NAMES, DENSE_CONVS, make_conv
from yolat_tpu_torch.nn.layers import (MLP, FusedPoolFusion, MaskedBatchNorm,
                                       init_weights)
from yolat_tpu_torch.nn.state_dict import (export_state_dict,
                                           export_state_dict_pp,
                                           load_reference_state_dict)
from yolat_tpu_torch.ops.fused_pool_train import fused_pool_available
from yolat_tpu_torch.ops.plans import ew_train_of, plan_of
from yolat_tpu_torch.ops.segment import (segment_broadcast, segment_max,
                                         segment_max_concat, segment_mean)

FUSION = 1024  # fusion MLP width, fixed by the reference


CANONICAL_CONV = "attr_edge_gp2"


class _GConv(nn.Module):
    """The reference's GraphConv wrapper (`.gconv` holds the conv)."""

    def __init__(self, cin: int, cout: int, conv: str = CANONICAL_CONV,
                 act="relu", norm="batch", remat: bool = False):
        super().__init__()
        self.gconv = make_conv(conv, cin, cout, act, norm, remat=remat)


class _ResBlock(nn.Module):
    """The reference's ResBlock (`.body`); its residual is off for gp2."""

    def __init__(self, c: int, conv: str = CANONICAL_CONV, act="relu",
                 norm="batch", remat: bool = False):
        super().__init__()
        self.body = _GConv(c, c, conv, act, norm, remat)


def takes_fused_head(module, cat, plan) -> bool:
    """Whether `module` (its `fused_pool`, `training`, `fused_fallbacks`)
    pools this batch through the fused head: in train mode with the
    aligned pool plan and N % 512 == 0. Without them a CUDA batch raises
    and a CPU batch takes the unfused route, counted in
    `module.fused_fallbacks`."""
    if not (module.fused_pool and module.training):
        return False
    if fused_pool_available(cat.shape[0], plan):
        return True
    if cat.device.type == "cuda":
        raise ValueError(
            "fused_head_train needs the aligned pool plan and N % 512 "
            "== 0 (batches from yolat_tpu_torch.data.packing.pack_files "
            "have both)")
    module.fused_fallbacks += 1
    return False


def _check_window(conv: str) -> None:
    if conv != CANONICAL_CONV:
        raise ValueError(
            f"--train_layout window with --conv {conv}: the window layout is "
            f"the {CANONICAL_CONV} conv's (the JAX model builds its plan for "
            "that conv alone and trains any other sparse)")


class Backbone(nn.Module):
    def __init__(self, in_channels: int = 5, channels: int = 64,
                 n_blocks: int = 2, n_blocks_out: int = 2,
                 fused_pool: bool = False, window_edges: bool = False,
                 conv: str = CANONICAL_CONV, act="relu", norm="batch",
                 remat: bool = False):
        super().__init__()
        if window_edges:
            _check_window(conv)
        self.conv = conv
        self.n_blocks, self.n_blocks_out = n_blocks, n_blocks_out
        self.fusion_dims = channels * n_blocks_out
        self.fused_pool = fused_pool
        self.window_edges = window_edges
        # train-mode CPU batches that could not take the fused head
        self.fused_fallbacks = 0
        self.head = _GConv(in_channels, channels, conv, act, norm, remat)
        self.backbone = nn.ModuleList(
            _ResBlock(channels, conv, act, norm, remat)
            for _ in range(n_blocks - 1))
        self.fusion_block = FusedPoolFusion(self.fusion_dims, FUSION, act,
                                            norm, remat)
        self.fusion_block_super = MLP([self.fusion_dims, FUSION], act=act,
                                      norm=norm, remat=remat)

    def features(self, batch: dict):
        """-> (cat [N, C * n_blocks_out], cat_super [N, C * n_blocks_out]):
        the last n_blocks_out conv outputs of both streams."""
        if self.conv != CANONICAL_CONV:
            cat = self._single_stream(batch)
            return cat, cat
        args = (batch["edge"], batch["e_attr"], batch["edge_mask"],
                batch["node_mask"])
        kw = {"dst_count": batch.get("dst_count")}
        if self.window_edges:
            kw["ew"] = ew_train_of(batch)
            if kw["ew"] is None:
                raise ValueError(
                    "the window layout needs the edge-window plan with its "
                    "transpose (yolat_tpu_torch.data.packing.pack_files("
                    "ew_transpose=True)); edge dropout strips it")
            kw["ew_attr"] = batch["ew_attr"]
        elif "nbr_idx" in batch:
            kw["nbr"] = (batch["nbr_idx"], batch["nbr_attr"],
                         batch["nbr_mask"])
        f, s = self.head.gconv(batch["x"], batch["x"], *args, **kw)
        feats, feats_super = [f], [s]
        for blk in self.backbone:
            f, s = blk.body.gconv(f, s, *args, **kw)
            feats.append(f)
            feats_super.append(s)
        lo = self.n_blocks - self.n_blocks_out
        return torch.cat(feats[lo:], dim=1), torch.cat(feats_super[lo:], dim=1)

    def _single_stream(self, batch: dict):
        """The features of a single-stream conv (`yolat_tpu/nn/model.py:
        79-116`): cat [N, C * n_blocks_out]."""
        kw = {}
        if "nbr_idx" in batch:
            if self.conv not in DENSE_CONVS:
                raise ValueError(
                    f"--conv {self.conv} has no dense neighbour-table branch "
                    "(--train_layout dense, --dense_layout true): it takes "
                    f"one of {', '.join(DENSE_CONVS)}")
            kw["nbr"] = (batch["nbr_idx"], batch["nbr_attr"],
                         batch["nbr_mask"])
        if self.conv == "attr_edge_cf":
            kw["pos"] = batch["pos"]
        node_mask = batch["node_mask"]
        args = (batch["edge"], batch["e_attr"], batch["edge_mask"], node_mask)

        def apply(layer, f):
            if self.conv == "attr_edge_gp":
                # the proposal-pooled features gathered back to their nodes
                # ride beside f (EdgConvGlobalPool, torch_vertex.py:343-425)
                idx, plan = batch["bbox_idx"], plan_of(batch)
                root = segment_mean(f, idx, batch["labels"].shape[0],
                                    mask=node_mask, plan=plan,
                                    counts=batch.get("prop_count"))
                f = torch.cat([f, segment_broadcast(root, idx, f.shape[0],
                                                    plan)], dim=1)
            return layer.gconv(f, *args, **kw)

        feats = [apply(self.head, batch["x"])]
        for blk in self.backbone:
            feats.append(apply(blk.body, feats[-1]) + feats[-1])
        return torch.cat(feats[self.n_blocks - self.n_blocks_out:], dim=1)

    def forward(self, batch: dict):
        """-> (pooled [P, .] or the (fusion, cat) node-level parts to pool,
        pooled super-stream [P, .])"""
        n_prop = batch["labels"].shape[0]
        plan = plan_of(batch)
        node_mask = batch["node_mask"]
        cat, cat_super = self.features(batch)
        if takes_fused_head(self, cat, plan):
            pooled_fusion = self.fusion_block.pool(cat, node_mask, plan[0],
                                                   n_prop)
            pooled_cat = segment_max(cat, batch["bbox_idx"], n_prop,
                                     mask=node_mask, plan=plan)
            parts = torch.cat([pooled_fusion,
                               pooled_cat.to(pooled_fusion.dtype)], dim=1)
        else:
            parts = (self.fusion_block(cat, node_mask), cat)
        pooled = segment_mean(cat_super, batch["bbox_idx"], n_prop,
                              mask=node_mask, plan=plan,
                              counts=batch.get("prop_count"))
        fusion_super = self.fusion_block_super(pooled, batch["proposal_mask"])
        return parts, torch.cat([fusion_super, pooled], dim=1)


class SparseCADGCN(nn.Module):
    def __init__(self, n_classes: int, in_channels: int = 5,
                 channels: int = 64, n_blocks: int = 2, n_blocks_out: int = 2,
                 classifier: str = "softmax", dropout: float = 0.0,
                 fused_pool: bool = False, window_edges: bool = False,
                 conv: str = CANONICAL_CONV, act="relu", norm="batch",
                 remat: bool = False):
        super().__init__()
        self.n_blocks = n_blocks
        self.classifier = classifier
        self.conv, self.act, self.norm = conv, act, norm
        self.cls_net = Backbone(in_channels, channels, n_blocks, n_blocks_out,
                                fused_pool, window_edges, conv, act, norm,
                                remat)
        fusion_out = self.cls_net.fusion_dims + FUSION
        self.prediction_cls = nn.ModuleList([
            MLP([fusion_out * 2, 512], act=act, norm=norm),
            MLP([512, 256], drop=dropout, act=act, norm=norm),
            MLP([256, n_classes], bare=True),
        ])

    def forward(self, batch: dict, generator=None):
        """Finalized tensor batch -> (logits [P, n_classes], boxes [P, 4]).
        `generator` draws the dropout masks in train mode."""
        parts, out_super = self.cls_net(batch)
        if isinstance(parts, tuple):
            pooled = segment_max_concat(parts, batch["bbox_idx"],
                                        batch["labels"].shape[0],
                                        mask=batch["node_mask"],
                                        plan=plan_of(batch))
        else:  # the fused head pooled already
            pooled = parts
        h = torch.cat([pooled, out_super], dim=1)
        pm = batch["proposal_mask"]
        h = self.prediction_cls[0](h, pm)
        h = self.prediction_cls[1](h, pm, generator)
        h = self.prediction_cls[2](h)
        if self.classifier != "softmax":
            h = torch.sigmoid(h)
        return h, batch["bbox"]


def detection_loss(pred_cls, labels, proposal_mask, classifier: str = "softmax",
                   label_iou=None, pos_weight: float = 1.0) -> dict:
    """Masked classification loss over proposals (`yolat_tpu/nn/model.py:
    237-288`, the reference's DetectionLoss): {'loss', 'loss_cls'}, logits
    upcast to f32. label_iou gives positives the soft target {class: q,
    background: 1 - q}; pos_weight multiplies positive rows' loss in a
    weighted mean."""
    pred_cls = pred_cls.float()
    k = pred_cls.shape[-1]
    background = k - 1
    labels = labels.long()
    m = proposal_mask.float()
    if pos_weight != 1.0:
        m = m * torch.where(labels != background,
                            torch.full_like(m, pos_weight), torch.ones_like(m))
    denom = torch.clamp(m.sum(), min=1.0)
    onehot = torch.nn.functional.one_hot(labels, k).float()
    if label_iou is not None:
        q = torch.where(labels == background, torch.ones_like(m),
                        label_iou.float())[:, None]
        bg = torch.zeros_like(onehot)
        bg[:, background] = 1.0
        target = onehot * q + bg * (1.0 - q)
    else:
        target = onehot
    if classifier == "softmax":
        logp = torch.log_softmax(pred_cls, dim=-1)
        loss = (-(target * logp).sum(dim=-1) * m).sum() / denom
    else:
        p = torch.clamp(pred_cls, 1e-7, 1 - 1e-7)
        bce = -(target * torch.log(p)
                + (1 - target) * torch.log(1 - p)).mean(dim=-1)
        loss = (bce * m).sum() / denom
    return {"loss": loss, "loss_cls": loss}


def _canonical_mlps(cfg) -> bool:
    return (str(cfg.act).lower(), str(cfg.norm).lower()) == ("relu", "batch")


def check_model_config(cfg) -> None:
    """Refuse what the JAX package runs silently or fails on without
    saying why: an unknown conv; the dense table (--train_layout dense,
    --dense_layout true) with a conv that has no dense branch; the fused
    pool head with other MLPs than ReLU and BatchNorm (JAX's fused head
    is ReLU + BN whatever --act says, so it would train one function and
    evaluate another); YOLaT++ with another conv (its convs are
    attr_edge_gp2 whatever --conv says); the window layout with another
    conv (the JAX model trains it sparse). YOLaT++ takes every --act and
    --norm: its hierarchy, fusion and head MLPs take them, its two gp2
    convs stay ReLU and BatchNorm, as in JAX. --remat passes here under
    every arch: YOLaT++ reads it nowhere, as its JAX module declares the
    field and reads it nowhere (`yolat_tpu/nn/yolat_pp.py:84`), so it
    builds and trains the same module with it on or off."""
    if cfg.conv not in CONV_NAMES:
        raise NotImplementedError(
            f"--conv {cfg.conv!r}: one of {', '.join(CONV_NAMES)}")
    if cfg.train_layout not in ("sparse", "window", "dense"):
        raise ValueError(f"train_layout {cfg.train_layout!r}: sparse, window "
                         "or dense")
    if cfg.train_layout == "window":
        _check_window(cfg.conv)
    dense = cfg.train_layout == "dense" or cfg.dense_layout
    if dense and cfg.conv != CANONICAL_CONV and cfg.conv not in DENSE_CONVS:
        raise ValueError(
            f"--train_layout dense / --dense_layout true with --conv "
            f"{cfg.conv}: that conv has no dense neighbour-table branch (the "
            "JAX package ignores the table there); the dense convs are "
            f"{CANONICAL_CONV}, {', '.join(DENSE_CONVS)}")
    if cfg.fused_head_train and not _canonical_mlps(cfg):
        raise ValueError(
            f"--fused_head_train true with --act {cfg.act} --norm "
            f"{cfg.norm}: the fused pool head is ReLU and BatchNorm (--act "
            "relu --norm batch)")
    if cfg.arch in PP_ARCHS and cfg.conv != CANONICAL_CONV:
        raise NotImplementedError(
            f"--arch {cfg.arch} with --conv {cfg.conv}: YOLaT++'s convs are "
            f"{CANONICAL_CONV}")


def build_model(cfg):
    """The detector of a `yolat_tpu_torch.config.Config`
    (yolat_tpu/train/loop.py:47-81): SparseCADGCN with cfg's conv, act and
    norm, or YOLaT++ (`nn.yolat_pp.YOLaTPlusPlus`) for an arch of
    `PP_ARCHS` (which reads no `cfg.remat`); `check_model_config`
    first."""
    check_model_config(cfg)
    if cfg.arch in PP_ARCHS:
        from yolat_tpu_torch.nn.yolat_pp import YOLaTPlusPlus

        if cfg.train_layout == "window":
            raise NotImplementedError(
                "train_layout 'window' under YOLaT++: the reference module "
                "hands its convs no edge-window plan, so it trains the sparse "
                "layout whatever this flag says; train with train_layout "
                "'sparse' or 'dense'")
        return YOLaTPlusPlus(cfg.n_classes, cfg.in_channels, cfg.n_filters,
                             cfg.n_blocks, cfg.n_blocks_out,
                             classifier=cfg.classifier, dropout=cfg.dropout,
                             factored_prim=cfg.pp_factored_prim,
                             banded_super=cfg.pp_banded_super,
                             fused_pool=cfg.fused_head_train,
                             act=cfg.act, norm=cfg.norm)
    if cfg.arch != CANONICAL_ARCH:
        raise NotImplementedError(
            f"arch {cfg.arch!r}: this port runs {CANONICAL_ARCH} and "
            f"YOLaT++ ({', '.join(PP_ARCHS)})")
    return SparseCADGCN(cfg.n_classes, cfg.in_channels, cfg.n_filters,
                        cfg.n_blocks, cfg.n_blocks_out, cfg.classifier,
                        cfg.dropout, cfg.fused_head_train,
                        window_edges=cfg.train_layout == "window",
                        conv=cfg.conv, act=cfg.act, norm=cfg.norm,
                        remat=cfg.remat)


@torch.no_grad()
def seeded_model(cfg, seed: int = 0):
    """A random eval-mode detector made from `seed`: Kaiming weights and
    randomised BatchNorm affine terms and running statistics, so folding
    them is not the identity, and randomised LayerNorm affine terms, so a
    misplaced one shows (smoke checks, profiling, tests). A YOLaT++
    model gets its gates opened (0.3, 0.4, 0.5, 0.6): at their initial zero
    no hierarchy level reaches the logits."""
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    for m in model.modules():
        if isinstance(m, (MaskedBatchNorm, nn.LayerNorm)):
            f = m.weight.shape[0]
            m.weight.copy_(1.0 + 0.2 * torch.randn(f, generator=gen))
            m.bias.copy_(0.1 * torch.randn(f, generator=gen))
        if isinstance(m, MaskedBatchNorm):
            m.running_mean.copy_(0.2 * torch.randn(f, generator=gen))
            m.running_var.copy_(0.5 + torch.rand(f, generator=gen))
    if cfg.arch in PP_ARCHS:
        for i, g in enumerate(PP_GATES):
            getattr(model, g).fill_(0.3 + 0.1 * i)
    return model.eval()


def _load_numpy_state(model, sd: dict):
    model.load_state_dict({k: torch.from_numpy(np.array(v, copy=True))
                           for k, v in sd.items()}, strict=True)
    return model


def load_jax_variables(model, variables):
    """JAX flax variables (numpy leaves) -> the port's weights, through the
    reference state dict (`export_state_dict`, for the model's conv and
    act) or, for a YOLaT++ model, `export_state_dict_pp`."""
    if isinstance(model, SparseCADGCN):
        sd = export_state_dict(variables, n_blocks=model.n_blocks,
                               conv=model.conv, act=model.act)
    else:
        sd = export_state_dict_pp(variables, n_blocks=model.n_blocks,
                                  act=model.act)
    return _load_numpy_state(model, sd)


def load_reference_checkpoint(model, path: str):
    """Load a reference-format `.pth` ({'state_dict': ...}) strictly; for a
    YOLaT++ model the keys are its own state dict's."""
    return _load_numpy_state(model, load_reference_state_dict(path))
