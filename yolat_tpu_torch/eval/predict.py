"""One-pass prediction + NMS over a packed batch.

Counterpart of `yolat_tpu/eval/predict.py:78-186` (`make_predict_core`,
with its dispatch on the arch, :91-113: a YOLaT++ config runs
`fast_forward_pp`) and `yolat_tpu/eval/runner.py:40` (`img_slot_cap`). In eval mode the
reference's two passes (roots, then children of background roots) reduce
to one forward over all proposals plus a selection mask
  keep(p) = is_root(p) or argmax(logits[root_of(p)]) == background,
then the x1.05 box inflation, the score rewrite [1 - p_bg, p_0..p_K-1],
pixel scaling, a per-image slot layout and class-offset NMS.

`make_serving_fn` is the counterpart of `yolat_tpu/eval/predict.py:212-405`
(`kept_batch_keys`, `make_serving_fn`): the batch's kept leaves in one
buffer, one transfer, and on the card one CUDA graph per signature,
optionally over a chunk of K batches. `make_dp_predict_fn` (:189-209) is
its data-parallel form: each rank serves its own row of a [D, ...]
batch, with no collective.
"""

from __future__ import annotations

import numpy as np
import torch

from yolat_tpu_torch.config import PP_ARCHS
from yolat_tpu_torch.data.packing import finalize_batch
from yolat_tpu_torch.data.staging import PackSpec, StagedBuffers, fetch
from yolat_tpu_torch.eval.fast_forward import fast_forward, fast_forward_pp
from yolat_tpu_torch.ops.iou import inflate_boxes
from yolat_tpu_torch.ops.nms import batched_nms
from yolat_tpu_torch.ops.plans import (EW_BATCH_KEYS, EW_KEYS, SEW_KEYS,
                                       ew_of)
from yolat_tpu_torch.parallel.mesh import shard_leading_axis
from yolat_tpu_torch.utils.cuda_graph import CapturedStep


def img_slot_cap(batch: dict, quantum: int = 256) -> int:
    """Per-image NMS slot cap of one numpy batch: the max real-proposal
    count of any image, rounded up to `quantum`. Exact by construction,
    so the capped layout gives the same detections as the uncapped one."""
    real = np.asarray(batch["image_id"])[np.asarray(batch["proposal_mask"])]
    mx = int(np.bincount(real).max()) if real.size else 1
    return -(-mx // quantum) * quantum


def make_predict_core(cfg, folded=None, model=None, bf16: bool = False,
                      max_det: int = 300, img_slots: int | None = None,
                      detections_only: bool = False):
    """Returns predict(batch) -> detections dict, for a tensor batch.

    With `folded` (eval/fast_forward.fold_params_for) the forward runs
    the arch's folded-BN engine (bf16 selects its precision); otherwise the
    eval-mode `model`.
    Output (leading axis = image slot): boxes [B, max_det, 4] pixel xyxy,
    scores [B, max_det], classes [B, max_det] i32, valid [B, max_det];
    unless detections_only, also pred_label/kept [P] and the per-proposal
    prop_boxes/prop_obj/prop_cls.
    """
    if folded is None and model is None:
        raise ValueError("make_predict_core needs folded params or the model")
    background = cfg.n_classes - 1
    engine = (fast_forward_pp if getattr(cfg, "arch", "") in PP_ARCHS
              else fast_forward)

    @torch.no_grad()
    def predict(batch):
        batch = finalize_batch(batch)
        if folded is not None:
            logits, prop_boxes = engine(folded, batch, bf16=bf16)
        else:
            logits, prop_boxes = model(batch)

        pred_label = torch.argmax(logits, dim=1)
        root_is_bg = pred_label[batch["root_slot"].long()] == background
        kept = batch["proposal_mask"] & (batch["is_root"] | root_is_bg)
        boxes = inflate_boxes(prop_boxes, 1.05)
        probs = torch.softmax(logits, dim=1) if cfg.classifier == "softmax" \
            else logits
        obj = 1.0 - probs[:, background]
        cls_scores = probs[:, :background]

        image_id = batch["image_id"].long()
        wh = batch["wh"][image_id]
        boxes = boxes * torch.cat([wh, wh], dim=1)

        # proposals are packed contiguously per image: position within the
        # image = index - first index of the image
        P = logits.shape[0]
        B = batch["gt_bbox"].shape[0]
        arange = torch.arange(P, device=logits.device)
        first = torch.full((B,), P, dtype=arange.dtype, device=arange.device)
        first = first.scatter_reduce(
            0, image_id, torch.where(batch["proposal_mask"], arange,
                                     torch.full_like(arange, P)), "amin")
        idx_in_img = arange - first[image_id]
        S = P if img_slots is None else min(int(img_slots), P)
        ok = kept & (idx_in_img < S)
        # rows not kept (or past the cap) go to a trash slot B*S
        flat_slot = torch.where(ok, image_id * S + torch.clamp(idx_in_img, 0, S - 1),
                                torch.full_like(arange, B * S))

        def scatter(v, fill=0.0):
            out = torch.full((B * S + 1,) + v.shape[1:], fill, dtype=v.dtype,
                             device=v.device)
            m = ok.reshape(ok.shape + (1,) * (v.dim() - 1))
            out[flat_slot] = torch.where(m, v, torch.full_like(v, fill))
            return out[:B * S]

        nms = batched_nms(
            scatter(boxes).reshape(B, S, 4),
            scatter(cls_scores).reshape(B, S, background),
            scatter(obj).reshape(B, S),
            scatter(kept, False).reshape(B, S),
            iou_thres=cfg.nms_iou, conf_thres=cfg.nms_conf, max_det=max_det,
            algorithm=cfg.nms_algorithm, topk=cfg.nms_topk)
        if detections_only:
            return nms
        nms.update(pred_label=pred_label, kept=kept, prop_boxes=boxes,
                   prop_obj=obj, prop_cls=cls_scores)
        return nms

    return predict


# what every serving route reads of a batch (the predict core and the pool
# head): the engine reads `labels` and `gt_bbox` only for their shapes
_POOL_KEYS = tuple("pool_" + k for k in (
    "blk_first", "blk_full", "bnd_rows", "bnd_seg", "bnd_mask"))
_COMMON_KEYS = ("pos", "node_mask", "bbox_idx", "labels", "bbox",
                "prop_count", "proposal_mask", "is_root", "root_slot",
                "image_id", "wh", "gt_bbox") + _POOL_KEYS
_ROUTE_KEYS = {
    "plan": EW_KEYS + ("ew_wn_tag", "dst_count"),
    "dense": ("nbr_idx", "nbr_attr", "nbr_mask"),
    "pp_per_edge": EW_BATCH_KEYS + ("dst_count", "src_count",
                                    "super_dst_count") + SEW_KEYS,
    "pp_factored": EW_BATCH_KEYS + ("dst_count", "src_count", "sup_member",
                                    "sup_rank", "sup_abar", "prop_first_row"),
}


def serving_route(cfg, example: dict, folded=None) -> str:
    """The serving route a batch takes: 'module' (no fold: the eval-mode
    module), 'plan' (the edge-window plan, kernel 1), 'dense' (the dense
    table, kernel 4), 'pp_per_edge' or 'pp_factored' (YOLaT++ by its
    checkpoint), by the engines' own rules."""
    if folded is None:
        return "module"
    if getattr(cfg, "arch", "") in PP_ARCHS:
        return "pp_factored" if "super_fact_mlp" in folded else "pp_per_edge"
    if ew_of(example) is not None and "dst_count" in example:
        return "plan"
    if "nbr_idx" in example:
        return "dense"
    raise ValueError("the serving engine needs the edge-window plan or the "
                     "dense neighbour table")


def kept_batch_keys(route: str, example: dict) -> tuple:
    """The batch keys a route's predict reads, sorted: the JAX function
    finds them by dead-code elimination of the traced program
    (`yolat_tpu/eval/predict.py:212-238`); PyTorch has no trace, so each
    route states its list (tests/test_torch_serving_fn.py runs each route
    with every other key deleted). The module route keeps every array."""
    if route == "module":
        return tuple(sorted(k for k, v in example.items() if np.ndim(v)))
    return tuple(sorted(_COMMON_KEYS + _ROUTE_KEYS[route]))


def make_serving_fn(cfg, example_batch: dict, chunk: int | None = None,
                    device="cuda", **kw):
    """Transfer-fused serving over `make_predict_core(cfg, **kw)` for
    numpy batches of `example_batch`'s shape signature (pad the plans to
    capacity first: `ops.plans.pad_plans`).

    The route's kept arrays (`kept_batch_keys`) of each batch are packed
    into one buffer (`PackSpec`; bf16 wire under kw bf16 with folded
    params) and cross in one transfer; the step reads views of it. On the
    card the step is a CUDA graph (`utils.cuda_graph.CapturedStep`),
    captured at the first call after an eager warm-up: one graph per
    serving fn, that is per (route, img_slots, signature) as its callers
    memoize it. `nms_algorithm='loop'` reads back per pick and is refused
    there. On the CPU the same pack, unpack and chunk code runs the eager
    core.

    fn(batch) -> `Fetched` detections. With chunk=K, fn(batches) takes 1
    to K batches, packs them into the rows of a [K, total] buffer (a short
    chunk repeats its last row, as the JAX function does) and runs K
    predict bodies in one graph, the counterpart of `lax.map`; it returns
    (Fetched with a leading [K] axis, n_real): rows n_real: are replays the
    caller drops. Outputs are static memory that the next replay
    overwrites; their copy to the host is queued before it.
    """
    device = torch.device(device)
    core = make_predict_core(cfg, **kw)
    route = serving_route(cfg, example_batch, kw.get("folded"))
    if device.type == "cuda" and cfg.nms_algorithm == "loop":
        raise ValueError(
            "--nms_algorithm loop is the sequential oracle: it reads back "
            "per pick and cannot run inside a CUDA graph; serve with "
            "fixpoint or classfix (the same detections), or evaluate "
            "through the eager route (--serve_mode flax)")
    keys = kept_batch_keys(route, example_batch)
    spec = PackSpec(example_batch, keys,
                    bf16_wire=bool(kw.get("bf16")) and route != "module")
    rows = 1 if chunk is None else int(chunk)
    staged = StagedBuffers(spec, rows, device)

    def body(buf):
        outs = [core(spec.unpack(buf[r])) for r in range(rows)]
        if chunk is None:
            return outs[0]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    graph = []

    def run(batches):
        buf = staged.stage(batches)
        if device.type != "cuda":
            return fetch(body(buf))
        if not graph:
            graph.append(CapturedStep(lambda: body(buf)))
        return fetch(graph[0].replay())

    if chunk is None:
        def fn(batch):
            return run([batch])
    else:
        def fn(batches):
            return run(list(batches)), len(batches)
    fn.kept_batch_keys = keys
    fn.route = route
    fn.captured = graph  # [the CapturedStep] after the first call on the card
    return fn


def make_dp_predict_fn(cfg, example_stacked: dict, rank: int,
                       device="cuda", **kw):
    """Data-parallel serving, the counterpart of `make_dp_predict_fn`
    (`yolat_tpu/eval/predict.py:189-209`): fn(stacked [D, ...] numpy
    batch, `data/loader.stack_shards`) -> this rank's detections
    (`Fetched`), the rank's row served through `make_serving_fn` (on the
    card a CUDA graph replay). Prediction has no collective inside it; a
    rank whose loader yields its own windows calls make_serving_fn
    directly."""
    fn = make_serving_fn(cfg, shard_leading_axis(example_stacked, rank),
                         device=device, **kw)

    def dp_fn(stacked):
        return fn(shard_leading_axis(stacked, rank))

    return dp_fn
