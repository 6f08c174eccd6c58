"""Folded-BatchNorm serving engines of both detectors.

Counterpart of `yolat_tpu/eval/fast_forward.py`: `fold_params` (:76, same
`(W, [scale; shift])` layout as `_fold_stage` :63-73) and `fast_forward`
(:132) for the canonical detector; `fold_params_pp` (:249),
`fold_params_for` (:296) and `fast_forward_pp` (:323) for YOLaT++.
BatchNorm running statistics and Linear biases are folded into per-channel
scale/shift pairs; the result equals the eval-mode module to float
tolerance.

Routes:
  * conv layers, by what the batch carries (the JAX engine's rule,
    :180-209): the edge-window message sum (`ops/edge_window.py`, kernel
    1) when it has the edge-window plan and `dst_count`; else the fused
    dense message (`ops/dense_message.py`, kernel 4) when it has the dense
    neighbour table `nbr_idx`; else it raises (the JAX engine's plain
    sparse route, :114-126, is not carried). On the dense route the JAX
    engine prefers XLA to its kernel at bf16; here kernel 4 runs at both
    types;
  * pool head: the fused fusion-MLP block max (`ops/block_max.py`); it
    needs the aligned pool plan and N % 512 == 0, which `pack_files`
    batches always have, and raises without them.
  * YOLaT++ (`fast_forward_pp`): the convs run kernel 1 and the pool
    head kernel 2 as above; the curve level runs the both-endpoint banded
    message sum (`ops/banded_message.py`, kernel 6) over the edge-window
    plan with its transpose, or with curve_fused=False two launches of
    kernel 5 over that plan sorted by dst and by src; the primitive level
    runs kernel 5 over the super-edge plan `sew_`, or for a factored
    checkpoint (`super_fact_mlp`) a prefix sum per proposal and no kernel
    of its own. The banded plans exist for every edge list, so the JAX
    engine's gather/segment second route (:425-435, :475-487) is not
    carried: a batch without the plans raises.
Kernels are chosen by the tensors' device inside each wrapper, never by
a backend probe. bf16=True runs bfloat16 activations and weights with
f32 accumulation; logits come back f32.
"""

from __future__ import annotations

import torch

from yolat_tpu_torch.config import PP_ARCHS, PP_GATES, check_serve_mode
from yolat_tpu_torch.nn.yolat_pp import fourier_features, prefix_member_mean
from yolat_tpu_torch.ops.banded_message import (
    banded_message_sum, banded_message_sum_both,
    banded_message_sum_both_plain, banded_message_sum_plain)
from yolat_tpu_torch.ops.block_max import (folded_mlp_block_max2,
                                           folded_mlp_block_max2_plain)
from yolat_tpu_torch.ops.dense_message import (fused_dense_message,
                                               fused_dense_message_plain)
from yolat_tpu_torch.ops.edge_window import (edge_window_message_sum,
                                             edge_window_message_sum_plain)
from yolat_tpu_torch.ops.plans import (POOL_BLOCK, bm_of, ew_of, plan_aligned,
                                       plan_of)
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
    out = {"convs": [_fold_conv(g) for g in gconvs]}
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


def _fold_conv(g) -> dict:
    w1, sc1 = _fold_stage(g.nn[0], g.nn[1])
    w2, sc2 = _fold_stage(g.nn[3], g.nn[4])
    wn, scn = _fold_stage(g.mlp_node[0], g.mlp_node[1])
    return dict(w1=w1, sc1=sc1, w2=w2, sc2=sc2,
                wr=g.lin_r.weight.detach().float().t().contiguous(),
                br=g.lin_r.bias.detach().float(), wn=wn, scn=scn)


def fold_params_pp(model, device=None) -> dict:
    """Fold an eval-mode YOLaTPlusPlus into the inference layout: the
    canonical stages, the hierarchy MLPs (each one Linear -> BN -> ReLU
    stage; `super_edge_mlp` or `super_fact_mlp`, whichever the model has)
    and the four gates as 0-d tensors under 'gates'."""
    out = {"convs": [_fold_conv(g) for g in model.convs]}
    names = ["fusion_block", "fusion_block_super", "point_pe_mlp",
             "curve_mlp", "super_node_mlp"]
    names += [n for n in ("super_edge_mlp", "super_fact_mlp")
              if hasattr(model, n)]
    for name in names:
        mlp = getattr(model, name)
        out[name] = _fold_stage(mlp[0], mlp[1])
    pred = model.prediction_cls
    out["pred_0"] = _fold_stage(pred[0][0], pred[0][1])
    out["pred_1"] = _fold_stage(pred[1][0], pred[1][1])
    out["pred_2"] = (pred[2][0].weight.detach().float().t().contiguous(),
                     pred[2][0].bias.detach().float())
    out["gates"] = {g: getattr(model, g).detach().float().clone()
                    for g in PP_GATES}
    out["n_blocks_out"] = model.n_blocks_out
    out["n_freqs"] = model.n_freqs
    return _map(out, lambda t: t.to(device) if device is not None else t)


def fold_params_for(cfg, model, device=None) -> dict:
    """The fold of cfg's arch: YOLaT++ or the canonical detector; any other
    conv or MLP is refused (`config.check_serve_mode`)."""
    check_serve_mode(cfg, "fast")
    if getattr(cfg, "arch", "") in PP_ARCHS:
        return fold_params_pp(model, device)
    return fold_params(model, device)


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
    convs_f32 = folded["convs"]
    if bf16:
        folded = _map(folded, lambda t: t.to(torch.bfloat16)
                      if t.dtype == torch.float32 else t)
        x = x.to(torch.bfloat16)
    if plain:
        msg_sum, dense_msg, block_max = (
            edge_window_message_sum_plain, fused_dense_message_plain,
            folded_mlp_block_max2_plain)
    else:
        msg_sum, dense_msg, block_max = (
            edge_window_message_sum, fused_dense_message,
            folded_mlp_block_max2)

    ew = ew_of(batch)
    if ew is not None and "dst_count" in batch:
        cnt = torch.clamp(batch["dst_count"].float(), min=1.0)[:, None]
    elif "nbr_idx" in batch:
        ew = None
        nbr = (batch["nbr_idx"], batch["nbr_attr"], batch["nbr_mask"])
    else:
        raise ValueError(
            "fast_forward needs the edge-window plan and in-degree counts "
            "(batches from yolat_tpu_torch.data.packing.pack_files have "
            "both) or the dense neighbour table (add_dense_neighbors)")
    f, s = x, x
    feats, feats_super = [], []
    for c, c32 in zip(folded["convs"], convs_f32):
        if ew is not None:
            agg = msg_sum(f, ew, c["w1"], c["sc1"], c["w2"], c["sc2"])
            f = (agg / cnt).to(f.dtype) + f @ c["wr"] + c["br"].reshape(1, -1)
        else:
            # mean, skip and bias are inside; the f32 parameters go in and
            # are rounded there, as the JAX engine hands them to its kernel
            # (fast_forward.py:200)
            f = dense_msg(f, *nbr, c32["w1"], c32["sc1"], c32["w2"],
                          c32["sc2"], c32["wr"], c32["br"]).to(f.dtype)
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


def fast_forward_pp(folded: dict, batch: dict, bf16: bool = False,
                    curve_fused: bool = True, plain: bool = False):
    """Eval forward of YOLaT++ on a finalized tensor batch packed with
    `data.loader.extra_plans_for`'s options -> (logits f32, boxes).

    `folded` is `fold_params_pp`'s: with 'super_edge_mlp' the primitive
    level runs per super edge (kernel 5 over `sew_`), with 'super_fact_mlp'
    as a prefix sum per proposal. curve_fused picks kernel 6 (one pass,
    both endpoint sums) or two launches of kernel 5 for the curve level.
    The sums come back f32; each is divided by max(count, 1) in f32 and
    cast to x's type before its gate, as the JAX engine does (:413-415,
    :473-474, :489-491). plain=True runs the kernels' plain versions
    whatever the device - only for comparing the kernel route with them.
    """
    n_prop = batch["labels"].shape[0]
    node_mask, bbox_idx = batch["node_mask"], batch["bbox_idx"]
    pool = plan_of(batch)
    prop_count = batch.get("prop_count")
    x = torch.where(node_mask[:, None], batch["x"],
                    torch.zeros_like(batch["x"]))
    if bf16:
        folded = _map(folded, lambda t: t.to(torch.bfloat16)
                      if t.dtype == torch.float32 else t)
        x = x.to(torch.bfloat16)
    if plain:
        msg_sum, block_max, bsum, bsum_both = (
            edge_window_message_sum_plain, folded_mlp_block_max2_plain,
            banded_message_sum_plain, banded_message_sum_both_plain)
    else:
        msg_sum, block_max, bsum, bsum_both = (
            edge_window_message_sum, folded_mlp_block_max2,
            banded_message_sum, banded_message_sum_both)

    ew = ew_of(batch)
    cwd = bm_of(batch, "cwd_")
    if cwd is None or "dst_count" not in batch or "src_count" not in batch:
        raise ValueError(
            "fast_forward_pp needs the edge-window plan with its transpose "
            "and the dst/src edge counts (pack with the options of "
            "yolat_tpu_torch.data.loader.extra_plans_for)")
    factored = "super_fact_mlp" in folded
    if factored and "sup_rank" not in batch:
        raise ValueError(
            "factored checkpoint (folded 'super_fact_mlp') requires the "
            "factored pack fields ('sup_rank'/'sup_member'/'sup_abar') in "
            "the batch: pack with PackedLoader(super_family=True), or serve "
            "a non-factored checkpoint")
    if not factored:
        sew = bm_of(batch, "sew_")
        if sew is None or "super_dst_count" not in batch:
            raise ValueError(
                "fast_forward_pp needs the super-edge plan sew_ and "
                "super_dst_count for a per-edge checkpoint (pack with the "
                "options of yolat_tpu_torch.data.loader.extra_plans_for)")

    def per_node(total, count_key):
        return total / torch.clamp(batch[count_key].float(), min=1.0)[:, None]

    g = folded["gates"]
    n_freqs = folded["n_freqs"]
    pe_tok = _folded(fourier_features(batch["pos"].to(x.dtype), n_freqs),
                     folded["point_pe_mlp"])
    f, s = x, x
    feats, feats_super = [], []
    for i, c in enumerate(folded["convs"]):
        agg = msg_sum(f, ew, c["w1"], c["sc1"], c["w2"], c["sc2"])
        f = (per_node(agg, "dst_count").to(f.dtype) + f @ c["wr"]
             + c["br"].reshape(1, -1))
        if i == 0:
            f = f + g["gate_point"] * pe_tok
        s = _folded(s, (c["wn"], c["scn"]))
        feats.append(f)
        feats_super.append(s)

    # curve level: [attr || x_src || x_dst] @ W splits by W's input rows
    # into the per-endpoint products the banded kernels form
    s_f = feats[-1]
    cf = s_f.shape[1]
    cw, csc = folded["curve_mlp"]
    na = cwd.attr.shape[1]
    w_attr, w_src, w_dst = cw[:na], cw[na:na + cf], cw[na + cf:]
    if curve_fused:
        dst_sum, src_sum = bsum_both(s_f, cwd, w_dst, w_src, w_attr, csc)
    else:
        dst_sum = bsum(s_f, cwd, w_dst, w_src, w_attr, csc)
        src_sum = bsum(s_f, bm_of(batch, "cws_"), w_src, w_dst, w_attr, csc)
    curve_at_node = (per_node(dst_sum, "dst_count")
                     + per_node(src_sum, "src_count"))

    # primitive level (a)
    if factored:
        m, valid = prefix_member_mean(s_f, batch, pool)
        prim_in = torch.cat([s_f, m - s_f, batch["sup_abar"].to(x.dtype)],
                            dim=1)
        tok = _folded(prim_in, folded["super_fact_mlp"])
        prim_at_node = torch.where(valid[:, None], tok, torch.zeros_like(tok))
    else:
        # [s_i || s_j - s_i || attr] @ W = s_i @ (Wa - Wb) + s_j @ Wb + ...;
        # Wa - Wb is formed in the folded type
        sw, ssc = folded["super_edge_mlp"]
        wa, wb, wc = sw[:cf], sw[cf:2 * cf], sw[2 * cf:]
        prim_at_node = per_node(bsum(s_f, sew, wa - wb, wb, wc, ssc),
                                "super_dst_count")
    feats[-1] = (s_f + g["gate_curve"] * curve_at_node.to(x.dtype)
                 + g["gate_prim"] * prim_at_node.to(x.dtype))

    lo = len(feats) - folded["n_blocks_out"]
    cat = torch.cat(feats[lo:], dim=1)
    pooled_super = segment_mean(torch.cat(feats_super[lo:], dim=1), bbox_idx,
                                n_prop, mask=node_mask, plan=pool,
                                counts=prop_count)
    out_super = torch.cat([_folded(pooled_super, folded["fusion_block_super"]),
                           pooled_super], dim=1)

    # primitive level (b): per-proposal super tokens
    centroid = segment_mean(batch["pos"].to(x.dtype), bbox_idx, n_prop,
                            mask=node_mask, plan=pool, counts=prop_count)
    member_mean = segment_mean(feats[-1], bbox_idx, n_prop, mask=node_mask,
                               plan=pool, counts=prop_count)
    sup_in = torch.cat([fourier_features(centroid, n_freqs), member_mean,
                        member_mean[batch["root_slot"].long()]], dim=1)
    super_tok = _folded(sup_in, folded["super_node_mlp"])

    pmax = _pool_head(cat, folded["fusion_block"], batch, pool, n_prop,
                      block_max)
    h = torch.cat([pmax, out_super], dim=1)
    h = _folded(h, folded["pred_0"])
    h = h + g["gate_super"] * super_tok
    h = _folded(h, folded["pred_1"])
    w2, b2 = folded["pred_2"]
    return (h @ w2 + b2).float(), batch["bbox"]
