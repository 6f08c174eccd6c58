"""Pack-time plans (numpy only): the two-level pool plan and the
edge-window plan.

Counterparts of `yolat_tpu/ops/segment.py:26-131` (`POOL_BLOCK`,
`pool_plan`, `plan_of`, `_plan_aligned`), with identical
outputs (tests/test_torch_packing.py holds them bitwise equal), and of
`yolat_tpu/ops/edge_window.py:43-122` (`edge_window_plan`, `ew_of`,
`WN_DEFAULT`). The edge-window plan takes the CUDA kernel's shape rather
than the TPU kernel's: a flat dst-sorted list of the real edges with
absolute node rows and per-window offsets. The TPU layout pads every
window to a fixed edge capacity EB and addresses sources inside a
3-window band, because its kernel stages whole windows in VMEM; the CUDA
kernel gathers rows from global memory and streams a window's edges in
tiles, so neither limit exists and every edge list has a plan.
"""

from __future__ import annotations

import numpy as np

POOL_BLOCK = 8

EW_KEYS = ("ew_src", "ew_dst", "ew_attr", "ew_wptr")
# ew_wn_tag is a zeros[(wn,)] marker whose shape records the window size
EW_BATCH_KEYS = EW_KEYS + ("ew_wn_tag",)
WN_DEFAULT = 256


def pool_plan(segment_ids: np.ndarray, num_segments: int,
              block: int = POOL_BLOCK, cap: int | None = None) -> dict:
    """Two-level segment-reduction plan over sorted, contiguous ids
    (prefix `pool_`): blk_first [NB] i32, blk_full [NB] bool, and the
    boundary rows of non-full blocks bnd_rows/bnd_seg/bnd_mask [CAP].
    cap=0 asserts full block alignment (0-length boundary arrays)."""
    seg = np.asarray(segment_ids, np.int32)
    n = seg.shape[0]
    if n % block != 0:
        raise ValueError(f"n={n} not divisible by block={block}")
    nb = n // block
    s2 = seg.reshape(nb, block)
    blk_first = s2[:, 0].copy()
    blk_full = s2[:, 0] == s2[:, -1]
    if cap is None:
        cap = min(nb, num_segments) * block
    rows = np.nonzero(np.repeat(~blk_full, block))[0].astype(np.int32)
    if len(rows) > cap:
        raise ValueError(f"{len(rows)} boundary rows exceed cap {cap}")
    bnd_rows = np.zeros(cap, np.int32)
    bnd_seg = np.full(cap, num_segments - 1, np.int32)
    bnd_mask = np.zeros(cap, bool)
    bnd_rows[: len(rows)] = rows
    bnd_seg[: len(rows)] = seg[rows]
    bnd_mask[: len(rows)] = True
    return {
        "pool_blk_first": blk_first,
        "pool_blk_full": blk_full,
        "pool_bnd_rows": bnd_rows,
        "pool_bnd_seg": bnd_seg,
        "pool_bnd_mask": bnd_mask,
    }


def plan_of(batch: dict):
    """The pool plan tuple of a batch, or None when absent or stale (node
    count no longer NB * POOL_BLOCK)."""
    if "pool_blk_first" not in batch:
        return None
    if batch["pool_blk_first"].shape[0] * POOL_BLOCK != batch["pos"].shape[0]:
        return None
    return (batch["pool_blk_first"], batch["pool_blk_full"],
            batch["pool_bnd_rows"], batch["pool_bnd_seg"],
            batch["pool_bnd_mask"])


def plan_aligned(plan) -> bool:
    """True for plans built with cap=0 (every block lies in one segment)."""
    return plan[2].shape[0] == 0


def edge_window_plan(edge, edge_mask, e_attr, n_nodes: int,
                     wn: int = WN_DEFAULT) -> dict:
    """The real edges of an edge list, stably sorted by dst, bucketed per
    window of `wn` destination nodes:

      ew_src  [E] i32      source node row
      ew_dst  [E] i32      destination node row (ascending)
      ew_attr [E, 4] f32   edge attributes
      ew_wptr [NW + 1] i32 window k's edges are ew_*[wptr[k]:wptr[k+1]],
                           NW = ceil(n_nodes / wn)

    Each node's in-edges form one run in their list order, so a kernel
    that sums runs in order sums in a fixed order. Raises ValueError on an
    endpoint outside [0, n_nodes).
    """
    edge = np.asarray(edge)
    idx = np.nonzero(np.asarray(edge_mask, bool))[0]
    dst = edge[idx, 1].astype(np.int64)
    order = idx[np.argsort(dst, kind="stable")]
    src, dst = edge[order, 0].astype(np.int64), edge[order, 1].astype(np.int64)
    if len(order) and (min(src.min(), dst.min()) < 0
                       or max(src.max(), dst.max()) >= n_nodes):
        raise ValueError(f"edge endpoints outside [0, {n_nodes})")
    nw = -(-n_nodes // wn)
    wptr = np.searchsorted(dst, np.arange(nw + 1, dtype=np.int64) * wn)
    return {"ew_src": src.astype(np.int32), "ew_dst": dst.astype(np.int32),
            "ew_attr": np.ascontiguousarray(np.asarray(e_attr, np.float32)[order]),
            "ew_wptr": wptr.astype(np.int32),
            "ew_wn_tag": np.zeros((wn,), np.int8)}


def ew_of(batch: dict):
    """The edge-window plan tuple (src, dst, attr, wptr, wn) of a batch,
    or None when absent or stale (window count no longer ceil(N / wn))."""
    if "ew_wptr" not in batch or "ew_wn_tag" not in batch:
        return None
    n = batch["pos"].shape[0] if "pos" in batch else batch["x"].shape[0]
    wn = batch["ew_wn_tag"].shape[0]
    if batch["ew_wptr"].shape[0] != -(-n // wn) + 1:
        return None
    return tuple(batch[k] for k in EW_KEYS) + (wn,)
