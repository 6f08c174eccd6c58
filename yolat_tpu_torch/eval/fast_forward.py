"""Folded-BatchNorm serving engine for the canonical detector.

Counterpart of `yolat_tpu/eval/fast_forward.py:28-238`: `fold_params`
(:76, same `(W, [scale; shift])` layout as `_fold_stage` :63-73) and
`fast_forward` (:132). BatchNorm running statistics and Linear biases are
folded into per-channel scale/shift pairs; the result equals
`SparseCADGCN(batch)` in eval mode to float tolerance.

Routes:
  * conv layers: the edge-window message sum (`ops/edge_window.py`) over
    the batch's edge-window plan, which `pack_files` attaches to every
    batch (the JAX engine's plain sparse route for plan-less batches,
    :114-126, is not carried: a batch without a plan raises);
  * pool head: the fused fusion-MLP block max (`ops/block_max.py`); it
    needs the aligned pool plan and N % 512 == 0, which `pack_files`
    batches always have, and raises without them.
Kernels are chosen by the tensors' device inside each wrapper, never by
a backend probe. bf16=True runs bfloat16 activations and weights with
f32 accumulation; logits come back f32.
"""

from __future__ import annotations

import torch

from yolat_tpu_torch.ops.block_max import folded_mlp_block_max2
from yolat_tpu_torch.ops.edge_window import edge_window_message_sum
from yolat_tpu_torch.ops.plans import POOL_BLOCK, ew_of, plan_aligned, plan_of
from yolat_tpu_torch.ops.segment import segment_max, segment_mean


def _fold_stage(lin, bn):
    """(W [in, out], [scale; shift] [2, out]) for relu(BN(lin(x)))."""
    w = lin.weight.detach().float().t().contiguous()
    b = lin.bias.detach().float()
    s = bn.weight.detach().float() / torch.sqrt(bn.running_var.float() + bn.eps)
    shift = b * s + bn.bias.detach().float() - bn.running_mean.float() * s
    return w, torch.stack([s, shift], dim=0)


def fold_params(model, device=None) -> dict:
    """Fold an eval-mode SparseCADGCN into the inference layout."""
    cls = model.cls_net
    gconvs = [cls.head.gconv] + [blk.body.gconv for blk in cls.backbone]
    out = {"convs": []}
    for g in gconvs:
        w1, sc1 = _fold_stage(g.nn[0], g.nn[1])
        w2, sc2 = _fold_stage(g.nn[3], g.nn[4])
        wn, scn = _fold_stage(g.mlp_node[0], g.mlp_node[1])
        out["convs"].append(dict(
            w1=w1, sc1=sc1, w2=w2, sc2=sc2,
            wr=g.lin_r.weight.detach().float().t().contiguous(),
            br=g.lin_r.bias.detach().float(), wn=wn, scn=scn))
    for name in ("fusion_block", "fusion_block_super"):
        mlp = getattr(cls, name)
        out[name] = _fold_stage(mlp[0], mlp[1])
    pred = model.prediction_cls
    out["pred_0"] = _fold_stage(pred[0][0], pred[0][1])
    out["pred_1"] = _fold_stage(pred[1][0], pred[1][1])
    out["pred_2"] = (pred[2][0].weight.detach().float().t().contiguous(),
                     pred[2][0].bias.detach().float())
    out["n_blocks_out"] = cls.n_blocks_out
    return _map(out, lambda t: t.to(device) if device is not None else t)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _folded(x, w_sc):
    w, sc = w_sc
    return torch.relu((x @ w) * sc[0] + sc[1])


def _pool_head(cat, fusion_wsc, batch, plan, n_prop: int, block_max):
    """Fusion MLP + per-proposal max of [fusion(cat) | cat] through the
    fused block max: [P, H + Cin]."""
    if plan is None or not plan_aligned(plan) or cat.shape[0] % 512:
        raise ValueError(
            "the fused pool head needs the aligned pool plan and N % 512 == 0 "
            "(batches from yolat_tpu_torch.data.packing.pack_files have both)")
    w, sc = fusion_wsc
    maskf = batch["node_mask"].float()[:, None]
    bh, bx = block_max(cat, maskf, w, sc, block=POOL_BLOCK)
    return segment_max(torch.cat([bh, bx], dim=1), plan[0], n_prop)


def fast_forward(folded: dict, batch: dict, bf16: bool = False, plain: bool = False):
    """Eval forward on a finalized tensor batch -> (logits f32, boxes).

    plain=True runs the kernels' plain versions whatever the device — only
    for comparing the kernel route with them; serving never sets it.
    """
    x = batch["x"]
    n_prop = batch["labels"].shape[0]
    if bf16:
        folded = _map(folded, lambda t: t.to(torch.bfloat16)
                      if t.dtype == torch.float32 else t)
        x = x.to(torch.bfloat16)
    if plain:
        from yolat_tpu_torch.ops.block_max import folded_mlp_block_max2_plain
        from yolat_tpu_torch.ops.edge_window import edge_window_message_sum_plain

        msg_sum, block_max = edge_window_message_sum_plain, folded_mlp_block_max2_plain
    else:
        msg_sum, block_max = edge_window_message_sum, folded_mlp_block_max2

    ew = ew_of(batch)
    if ew is None or "dst_count" not in batch:
        raise ValueError(
            "fast_forward needs the edge-window plan and in-degree counts "
            "(batches from yolat_tpu_torch.data.packing.pack_files have both)")
    cnt = torch.clamp(batch["dst_count"].float(), min=1.0)[:, None]
    f, s = x, x
    feats, feats_super = [], []
    for c in folded["convs"]:
        agg = msg_sum(f, ew, c["w1"], c["sc1"], c["w2"], c["sc2"])
        f = (agg / cnt).to(f.dtype) + f @ c["wr"] + c["br"].reshape(1, -1)
        s = _folded(s, (c["wn"], c["scn"]))
        feats.append(f)
        feats_super.append(s)

    lo = len(feats) - folded["n_blocks_out"]
    cat = torch.cat(feats[lo:], dim=1)
    plan = plan_of(batch)
    pooled = segment_mean(torch.cat(feats_super[lo:], dim=1), batch["bbox_idx"],
                          n_prop, mask=batch["node_mask"], plan=plan,
                          counts=batch.get("prop_count"))
    out_super = torch.cat([_folded(pooled, folded["fusion_block_super"]),
                           pooled], dim=1)
    pmax = _pool_head(cat, folded["fusion_block"], batch, plan, n_prop,
                      block_max)
    h = torch.cat([pmax, out_super], dim=1)
    h = _folded(h, folded["pred_0"])
    h = _folded(h, folded["pred_1"])
    w2, b2 = folded["pred_2"]
    return (h @ w2 + b2).float(), batch["bbox"]
