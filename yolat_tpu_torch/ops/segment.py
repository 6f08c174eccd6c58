"""Masked segment reductions over padded, flat-packed graphs.

Counterpart of `yolat_tpu/ops/segment.py`: `segment_broadcast` (:148),
`segment_sum` (:218), `segment_mean` (:265), `segment_max` (:307),
`segment_max_concat` (:396), `segment_softmax` (:410), with the two-level
plan path (`_two_level`,
:161-207) and the plain scatter path. Conventions kept (:8-12): an empty
segment gives 0 (mean and max), masked rows contribute nothing,
low-precision sums accumulate in f32.

Gradients follow the JAX package's custom VJPs, as autograd Functions:
  * `segment_max` (`_segment_max_core` :357-393): the compare form — every
    masked-in row equal to its segment's maximum gets the full cotangent
    (torch's own scatter_reduce('amax') backward splits it among ties);
  * the plan sum (`_plan_sum_vjp` :236-262): a row gather of the
    cotangent, independent of the block/boundary decomposition.
With an aligned plan both gather per block (`_block_rows` :134-145).
"""

from __future__ import annotations

import torch

from yolat_tpu_torch.ops.plans import plan_aligned

NEG = -1e30


def _expand(v, data):
    """Broadcast a per-row [E] vector against [E, ...] data."""
    return v.reshape(v.shape + (1,) * (data.dim() - v.dim()))


def _acc_dtype(data):
    return torch.float32 if data.dtype in (torch.bfloat16, torch.float16) \
        else data.dtype


def _scatter(data, seg, num_segments: int, op: str, neutral: float):
    """Per-segment sum or max of rows; segments with no row get `neutral`."""
    out = torch.full((num_segments,) + data.shape[1:], neutral,
                     dtype=data.dtype, device=data.device)
    idx = _expand(seg.long(), data).expand_as(data)
    if op == "sum":
        return out.scatter_add_(0, idx, data)
    return out.scatter_reduce_(0, idx, data, "amax", include_self=True)


def _two_level(data, mask, plan, num_segments: int, op: str, neutral: float):
    """Block reduce over the plan's POOL_BLOCK-row blocks, then a scatter of
    the full blocks' results by block owner, plus the boundary rows of
    non-full blocks (none for an aligned plan)."""
    blk_first, blk_full, bnd_rows, bnd_seg, bnd_mask = plan
    nb = blk_first.shape[0]
    b = data.shape[0] // nb
    blocks = data.reshape((nb, b) + data.shape[1:])
    bmask = _expand(mask.bool(), data).reshape((nb, b) + (1,) * (data.dim() - 1))
    filled = torch.where(bmask, blocks, torch.full_like(blocks, neutral))
    bred = filled.amax(dim=1) if op == "max" else filled.sum(dim=1)
    bred = torch.where(_expand(blk_full.bool(), bred), bred,
                       torch.full_like(bred, neutral))
    out = _scatter(bred, blk_first, num_segments, op, neutral)
    if bnd_rows.shape[0]:
        rows = bnd_rows.long()
        bnd = data[rows]
        bndm = _expand(bnd_mask.bool() & mask.bool()[rows], bnd)
        bnd = torch.where(bndm, bnd, torch.full_like(bnd, neutral))
        out2 = _scatter(bnd, bnd_seg, num_segments, op, neutral)
        out = torch.maximum(out, out2) if op == "max" else out + out2
    return out


def _block_rows(a, plan, n: int):
    """Per-segment [S, ...] -> per-row [n, ...] through the block owners of
    an aligned plan (uniform segment within each block)."""
    blk_first = plan[0].long()
    nb = blk_first.shape[0]
    # index_select, not a[...]: the backward of advanced indexing sorts its
    # indices (15.9 ms of a 38 ms YOLaT++ train step for this gather over
    # the super-edge blocks; NVIDIA H100 80GB HBM3, 700.00 W, cli/profile
    # --stages train_pp)
    blk = a.index_select(0, blk_first)
    return blk[:, None].expand((nb, n // nb) + a.shape[1:]).reshape(
        (n,) + a.shape[1:])


def _rows_of(a, segment_ids, plan, n: int):
    if plan is not None and plan_aligned(plan):
        return _block_rows(a, plan, n)
    return a.index_select(0, segment_ids.long())


def segment_broadcast(values, segment_ids, n: int, plan=None):
    """values[segment_ids]: per-segment [S, ...] -> per-row [n, ...]."""
    return _rows_of(values, segment_ids, plan, n)


class _PlanSum(torch.autograd.Function):
    """Two-level masked segment sum; backward = masked row gather."""

    @staticmethod
    def forward(ctx, data, mask, segment_ids, plan, num_segments: int):
        ctx.save_for_backward(mask, segment_ids)
        ctx.plan = plan
        return _two_level(data, mask, plan, num_segments, "sum", 0.0)

    @staticmethod
    def backward(ctx, g):
        mask, segment_ids = ctx.saved_tensors
        rows = _rows_of(g, segment_ids, ctx.plan, segment_ids.shape[0])
        dx = torch.where(_expand(mask.bool(), rows), rows,
                         torch.zeros_like(rows))
        return dx, None, None, None, None


class _SegmentMax(torch.autograd.Function):
    """Masked segment max, empty segments 0; compare-form backward."""

    @staticmethod
    def forward(ctx, data, mask, segment_ids, plan, num_segments: int):
        if plan is not None:
            raw = _two_level(data, mask, plan, num_segments, "max", NEG)
        else:
            masked = torch.where(_expand(mask.bool(), data), data,
                                 torch.full_like(data, NEG))
            raw = _scatter(masked, segment_ids, num_segments, "max", NEG)
        ctx.save_for_backward(data, mask, raw, segment_ids)
        ctx.plan = plan
        return torch.where(raw <= NEG / 2, torch.zeros_like(raw), raw)

    @staticmethod
    def backward(ctx, g):
        data, mask, raw, segment_ids = ctx.saved_tensors
        n = data.shape[0]
        raw_rows = _rows_of(raw, segment_ids, ctx.plan, n)
        g_rows = _rows_of(g, segment_ids, ctx.plan, n)
        # an empty segment's raw is NEG, which no masked-in row equals
        hit = (data == raw_rows) & _expand(mask.bool(), data)
        dx = torch.where(hit, g_rows, torch.zeros_like(g_rows)).to(data.dtype)
        return dx, None, None, None, None


def segment_sum(data, segment_ids, num_segments: int, mask=None, plan=None):
    acc = data.to(_acc_dtype(data))
    if mask is None:
        mask = torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
    if plan is not None:
        out = _PlanSum.apply(acc, mask, segment_ids, plan, num_segments)
    else:
        acc = torch.where(_expand(mask.bool(), acc), acc, torch.zeros_like(acc))
        out = _scatter(acc, segment_ids, num_segments, "sum", 0.0)
    return out.to(data.dtype)


def segment_mean(data, segment_ids, num_segments: int, mask=None, plan=None,
                 counts=None):
    """counts: optional per-segment count of mask-True rows (pack time);
    ignored when its length no longer matches num_segments (stale)."""
    acc_dt = _acc_dtype(data)
    if mask is None:
        mask = torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
    total = segment_sum(data.to(acc_dt), segment_ids, num_segments, mask=mask,
                        plan=plan)
    if counts is None or counts.shape[0] != num_segments:
        with torch.no_grad():
            counts = segment_sum(mask.to(acc_dt), segment_ids, num_segments,
                                 plan=plan, mask=mask)
    count = torch.clamp(counts.to(acc_dt), min=1.0)
    return (total / _expand(count, total)).to(data.dtype)


def segment_max(data, segment_ids, num_segments: int, mask=None, plan=None):
    """Max-reduce; empty segments produce 0 (torch_scatter convention).
    Every row attaining the max gets the full cotangent."""
    if mask is None:
        mask = torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
    return _SegmentMax.apply(data, mask, segment_ids, plan, num_segments)


def segment_max_concat(parts, segment_ids, num_segments: int, mask=None,
                       plan=None):
    """segment_max(concat(parts, 1)) without the node-level concat."""
    return torch.cat([segment_max(p, segment_ids, num_segments, mask=mask,
                                  plan=plan) for p in parts], dim=1)


def segment_softmax(data, segment_ids, num_segments: int, mask=None):
    """Per-segment softmax along axis 0 (torch_scatter's scatter_softmax;
    `yolat_tpu/ops/segment.py:410-426`): masked rows are filled with NEG
    before the segment max, an empty segment's max becomes 0, masked rows
    get weight 0 and the denominator is clamped at 1e-16. The max is
    detached: softmax does not move with its shift, so its gradient
    through the max is zero. Host-sync free (capturable)."""
    if mask is not None:
        keep = _expand(mask.bool(), data)
        data = torch.where(keep, data, torch.full_like(data, NEG))
    with torch.no_grad():
        seg_max = _scatter(data, segment_ids, num_segments, "max", NEG)
        seg_max = torch.where(seg_max <= NEG / 2, torch.zeros_like(seg_max),
                              seg_max)
    seg = segment_ids.long()
    e = torch.exp(data - seg_max.index_select(0, seg))
    if mask is not None:
        e = torch.where(keep, e, torch.zeros_like(e))
    denom = _scatter(e, segment_ids, num_segments, "sum", 0.0)
    return e / torch.clamp(denom, min=1e-16).index_select(0, seg)
