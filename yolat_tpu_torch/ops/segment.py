"""Masked segment reductions over padded, flat-packed graphs (forward).

Counterpart of `yolat_tpu/ops/segment.py` forward: `segment_sum` (:218),
`segment_mean` (:265), `segment_max` (:307), `segment_max_concat` (:396),
with the two-level plan path (`_two_level`, :161-207) and the plain
scatter path. Conventions kept (:8-12): an empty segment gives 0 (mean
and max), masked rows contribute nothing, low-precision sums accumulate in
f32. The compare-form max backward (:324) arrives with the training slice.
"""

from __future__ import annotations

import torch

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


def segment_sum(data, segment_ids, num_segments: int, mask=None, plan=None):
    acc = data.to(_acc_dtype(data))
    if mask is None:
        mask = torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
    if plan is not None:
        out = _two_level(acc, mask, plan, num_segments, "sum", 0.0)
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
        counts = segment_sum(mask.to(acc_dt), segment_ids, num_segments,
                             plan=plan, mask=mask)
    count = torch.clamp(counts.to(acc_dt), min=1.0)
    return (total / _expand(count, total)).to(data.dtype)


def segment_max(data, segment_ids, num_segments: int, mask=None, plan=None):
    """Max-reduce; empty segments produce 0 (torch_scatter convention)."""
    if mask is None:
        mask = torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
    if plan is not None:
        raw = _two_level(data, mask, plan, num_segments, "max", NEG)
    else:
        masked = torch.where(_expand(mask.bool(), data), data,
                             torch.full_like(data, NEG))
        raw = _scatter(masked, segment_ids, num_segments, "max", NEG)
    return torch.where(raw <= NEG / 2, torch.zeros_like(raw), raw)


def segment_max_concat(parts, segment_ids, num_segments: int, mask=None,
                       plan=None):
    """segment_max(concat(parts, 1)) without the node-level concat."""
    return torch.cat([segment_max(p, segment_ids, num_segments, mask=mask,
                                  plan=plan) for p in parts], dim=1)
