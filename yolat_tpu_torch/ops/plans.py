"""Pack-time plans (numpy): the two-level pool plan, the edge-window plan
and the banded-message plans, and their capacity padding (`pad_plans`).

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

With `transpose` the plan also carries what the trainable window ops
(`ops/edge_window_train.py`, kernels 9 and 10) read: per-node offsets of
the dst-sorted list, and the list's transpose by source (a stable argsort
of the sources with per-node offsets), so that the backward of the pair
gather sums each node's out-edges in a fixed order, without float atomics.

The banded-message plans (`yolat_tpu/ops/banded_message.py:75-178`,
`banded_plan` and `bm_of`) feed kernels 5 and 6 (`ops/banded_message.py`).
They too take the CUDA kernels' shape: the family's real edges, stably
sorted by the endpoint that is summed at, with absolute node rows,
per-node offsets and node ranges for the thread blocks. The TPU plan
exists only inside a band (other endpoint within 128 rows of the own
512-row window, node count a multiple of the window, a block cap) and
`banded_plan` returns None outside it; a row gather has no band, so every
edge list has a plan. YOLaT++'s curve family is the conv's edge family:
its dst-sorted plan (`cwd_`) is the edge-window plan and its src-sorted
plan (`cws_`) that plan's transpose, so `bm_of` reads both from the `ew_`
keys and only the super-edge clique family (`sew_`) is packed anew.
"""

from __future__ import annotations

import numpy as np
import torch

POOL_BLOCK = 8

EW_KEYS = ("ew_src", "ew_dst", "ew_attr", "ew_wptr")
# the transposed part, packed for the trainable window ops only
EW_TRAIN_KEYS = ("ew_dptr", "ew_sperm", "ew_sptr")
# ew_wn_tag is a zeros[(wn,)] marker whose shape records the window size
EW_BATCH_KEYS = EW_KEYS + EW_TRAIN_KEYS + ("ew_wn_tag",)
WN_DEFAULT = 256

SUPER_BLOCK = 4   # super-edge dst runs are padded to this many rows
SEW_KEYS = ("sew_own", "sew_oth", "sew_attr", "sew_nptr", "sew_cnode")
# the clique family's transpose by the other endpoint, packed for the banded
# training route only (kernel 7's backward sums through it)
SEW_TRAIN_KEYS = ("sew_tperm", "sew_tptr")
# edges + nodes one thread block of kernel 5 takes from the clique family
SEW_BLOCK_WORK = 512


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


def sup_plan_of(batch: dict):
    """The pool plan over the SUPER_BLOCK-aligned super-edge runs
    (`sup_pool_*`), or None when absent or stale (super-edge buffer no
    longer NB * SUPER_BLOCK rows)."""
    if "sup_pool_blk_first" not in batch:
        return None
    if (batch["sup_pool_blk_first"].shape[0] * SUPER_BLOCK
            != batch["edge_super"].shape[0]):
        return None
    return tuple(batch[f"sup_pool_{k}"] for k in (
        "blk_first", "blk_full", "bnd_rows", "bnd_seg", "bnd_mask"))


def plan_aligned(plan) -> bool:
    """True for plans built with cap=0 (every block lies in one segment)."""
    return plan[2].shape[0] == 0


def edge_window_plan(edge, edge_mask, e_attr, n_nodes: int,
                     wn: int = WN_DEFAULT, transpose: bool = False) -> dict:
    """The real edges of an edge list, stably sorted by dst, bucketed per
    window of `wn` destination nodes:

      ew_src  [E] i32      source node row
      ew_dst  [E] i32      destination node row (ascending)
      ew_attr [E, 4] f32   edge attributes
      ew_wptr [NW + 1] i32 window k's edges are ew_*[wptr[k]:wptr[k+1]],
                           NW = ceil(n_nodes / wn)

    Each node's in-edges form one run in their list order, so a kernel
    that sums runs in order sums in a fixed order. With `transpose`, also

      ew_dptr  [N + 1] i32 node v's in-edges are ew_*[dptr[v]:dptr[v+1]]
      ew_sperm [E] i32     the edge rows stably sorted by source
      ew_sptr  [N + 1] i32 node v's out-edges are the rows
                           ew_sperm[sptr[v]:sptr[v+1]], ascending

    Raises ValueError on an endpoint outside [0, n_nodes).
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
    plan = {"ew_src": src.astype(np.int32), "ew_dst": dst.astype(np.int32),
            "ew_attr": np.ascontiguousarray(np.asarray(e_attr, np.float32)[order]),
            "ew_wptr": wptr.astype(np.int32),
            "ew_wn_tag": np.zeros((wn,), np.int8)}
    if transpose:
        def offsets(ids):  # [N + 1] run starts of the sorted ids
            counts = np.bincount(ids, minlength=n_nodes)
            return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

        plan.update(ew_dptr=offsets(dst),
                    ew_sperm=np.argsort(src, kind="stable").astype(np.int32),
                    ew_sptr=offsets(src))
    return plan


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


def ew_train_of(batch: dict):
    """The trainable window ops' plan tuple (src, dst, dptr, sperm, sptr)
    of a batch, or None when absent or stale (node count no longer the
    offsets' length - 1)."""
    if ew_of(batch) is None or any(k not in batch for k in EW_TRAIN_KEYS):
        return None
    n = batch["pos"].shape[0] if "pos" in batch else batch["x"].shape[0]
    if batch["ew_dptr"].shape[0] != n + 1 or batch["ew_sptr"].shape[0] != n + 1:
        return None
    return (batch["ew_src"], batch["ew_dst"]) + tuple(
        batch[k] for k in EW_TRAIN_KEYS)


def banded_plan(edge, mask, attr, n_nodes: int, sortby: int = 1,
                block_work: int = SEW_BLOCK_WORK,
                transpose: bool = False) -> dict:
    """The real edges of one family, stably sorted by the endpoint
    `sortby` (1 = dst) at which kernel 5 sums:

      own   [E] i32       the sorted endpoint's node row (ascending)
      oth   [E] i32       the other endpoint's node row
      attr  [E, A] f32    edge attributes
      nptr  [N + 1] i32   node v's edges are rows nptr[v]:nptr[v + 1]
      cnode [NC + 1] i32  thread block k takes nodes cnode[k]:cnode[k + 1]

    The node ranges hold about `block_work` edges plus nodes each and never
    split a node, so a node's sum is formed by one block in list order: dense
    cliques and long edge-free stretches cost a block the same. A node with
    more edges than that ends its range, which holds less than one more
    share beside it. Rows where `mask` is False
    (buffer padding, run-alignment pad rows) are left out. With `transpose`,
    also the sorted list's transpose by the other endpoint, as
    `edge_window_plan` carries it for the conv's family:

      tperm [E] i32       the rows stably sorted by `oth`
      tptr  [N + 1] i32   node v is the other endpoint of the rows
                          tperm[tptr[v]:tptr[v + 1]], ascending

    Raises ValueError on an endpoint outside [0, n_nodes).
    """
    edge = np.asarray(edge)
    idx = np.nonzero(np.asarray(mask, bool))[0]
    key = edge[idx, sortby].astype(np.int64)
    order = idx[np.argsort(key, kind="stable")]
    own = edge[order, sortby].astype(np.int64)
    oth = edge[order, 1 - sortby].astype(np.int64)
    if len(order) and (min(own.min(), oth.min()) < 0
                       or max(own.max(), oth.max()) >= n_nodes):
        raise ValueError(f"edge endpoints outside [0, {n_nodes})")
    nptr = np.concatenate(
        [[0], np.cumsum(np.bincount(own, minlength=n_nodes))])
    # work up to node v: its edges' offset plus v; strictly increasing, so
    # the cuts are distinct nodes
    work = nptr + np.arange(n_nodes + 1)
    cuts = np.searchsorted(work, np.arange(0, work[-1], block_work))
    cnode = np.unique(np.append(cuts, n_nodes))
    plan = {"own": own.astype(np.int32), "oth": oth.astype(np.int32),
            "attr": np.ascontiguousarray(np.asarray(attr, np.float32)[order]),
            "nptr": nptr.astype(np.int32), "cnode": cnode.astype(np.int32)}
    if transpose:
        plan["tperm"] = np.argsort(oth, kind="stable").astype(np.int32)
        plan["tptr"] = np.concatenate(
            [[0], np.cumsum(np.bincount(oth, minlength=n_nodes))]
        ).astype(np.int32)
    return plan


def sew_cnode_cap(n_super: int, n_nodes: int,
                  block_work: int = SEW_BLOCK_WORK) -> int:
    """Entries of `sew_cnode` at capacity: a plan of E <= n_super edges over
    n_nodes nodes cuts its E + N units of work every `block_work`, so it
    has at most ceil((n_super + n_nodes) / block_work) cuts and the end."""
    return -(-(n_super + n_nodes) // block_work) + 1


def pad_plans(batch: dict) -> dict:
    """The numpy batch with its content-shaped plan arrays at capacity, so
    that every batch of one loader (one `PadSizes`) has one shape
    signature and a CUDA graph captured on one replays on all of them:

      ew_src, ew_dst, ew_attr, ew_sperm  the edge buffer's rows (`edge`)
      sew_own, sew_oth, sew_attr, sew_tperm  the super buffer's rows
                                         (`edge_super`)
      sew_cnode                          `sew_cnode_cap` entries

    A pad row lies past every pointer range (ew_wptr, ew_dptr, ew_sptr,
    sew_nptr, sew_tptr end at the real count, which is where the pad rows
    start; the permutations map them to themselves), names the last node
    row (a valid row; the dst- and own-sorted lists stay sorted) and
    carries zero attributes; a pad cnode range is empty (cut at N). The
    kernels walk the pointer ranges, and the ops that map every row (the
    gathers 7 and 9, the sums' backward 8b and 10b, BatchNorm over the
    rows) mask by row < pointer end (`real_rows`), so no pad row reaches
    a sum or a gradient. Other keys, and a plan already at capacity, are
    left as they are."""
    out = dict(batch)
    n = batch["pos"].shape[0]

    def rows(prefix, keys, perm, cap):
        e = batch[prefix + keys[0]].shape[0]
        if e == cap:
            return
        if e > cap:
            raise ValueError(f"{prefix} plan of {e} rows over a {cap}-row "
                             "buffer")
        for k in keys:
            a = batch[prefix + k]
            fill = n - 1 if a.ndim == 1 else 0
            out[prefix + k] = np.concatenate(
                [a, np.full((cap - e,) + a.shape[1:], fill, a.dtype)])
        if prefix + perm in batch:
            out[prefix + perm] = np.concatenate(
                [batch[prefix + perm], np.arange(e, cap, dtype=np.int32)])

    if "ew_src" in batch:
        rows("ew_", ("src", "dst", "attr"), "sperm", batch["edge"].shape[0])
    if "sew_own" in batch:
        s = batch["edge_super"].shape[0]
        rows("sew_", ("own", "oth", "attr"), "tperm", s)
        cn = batch["sew_cnode"]
        cap = sew_cnode_cap(s, n)
        if len(cn) > cap:
            raise ValueError(f"sew_cnode of {len(cn)} entries over its "
                             f"capacity {cap}")
        out["sew_cnode"] = np.concatenate(
            [cn, np.full(cap - len(cn), n, cn.dtype)])
    return out


def real_rows(ptr, n_rows: int):
    """[n_rows] bool: the rows of a plan list below its real count, the
    last entry of the plan's pointer array `ptr` (False on the rows that
    `pad_plans` adds). Device ops only: nothing is read back."""
    return torch.arange(n_rows, device=ptr.device) < ptr[-1]


class BandedPlan(tuple):
    """What kernels 5 and 6 read of one edge family, as a tuple
    (own, oth, attr, perm, nptr, cnode, wn, tperm, tptr):

      own, oth, attr  the edge rows' summed-at endpoint, other endpoint and
                      attributes;
      perm            None when the rows are already sorted by `own`, else
                      the [E] i32 row order that sorts them (position i of
                      the sorted list is row perm[i]);
      nptr [N + 1]    per-node offsets into the sorted list;
      cnode, wn       the thread blocks' node ranges: explicit [NC + 1]
                      cuts, or (cnode None) windows of wn nodes;
      tperm, tptr     the sorted list's transpose by the other endpoint
                      (kernel 6's second sum, kernel 7's backward), or None.
    """

    __slots__ = ()
    own, oth, attr, perm, nptr, cnode, wn, tperm, tptr = (
        property(lambda self, i=i: self[i]) for i in range(9))

    @property
    def n_edges(self) -> int:
        """The plan's rows, capacity padding included."""
        return self.own.shape[0]

    def rows(self):
        """(own, oth, attr) of the real rows in the sorted order, as long
        indices (the count is read back: for the plain versions)."""
        e = int(self.nptr[-1])
        if self.perm is None:
            return self.own[:e].long(), self.oth[:e].long(), self.attr[:e]
        p = self.perm[:e].long()
        return self.own.long()[p], self.oth.long()[p], self.attr[p]


def bm_of(batch: dict, prefix: str):
    """The banded plan of an edge family of a tensor batch, or None when
    absent or stale (node count no longer the offsets' length - 1):
      'sew_'  the super-edge clique family, sorted by dst (packed keys),
              with its transpose when the batch carries `SEW_TRAIN_KEYS`;
      'cwd_'  the conv's edge family sorted by dst: the edge-window plan
              with its transpose (kernel 6 sums at the sources through it);
      'cws_'  the same rows sorted by src: that plan read through
              `ew_sperm` / `ew_sptr`, own and other endpoint swapped.
    """
    n = batch["pos"].shape[0] if "pos" in batch else batch["x"].shape[0]
    if prefix == "sew_":
        if any(k not in batch for k in SEW_KEYS) \
                or batch["sew_nptr"].shape[0] != n + 1:
            return None
        tperm, tptr = (batch.get(k) for k in SEW_TRAIN_KEYS)
        if tperm is None or tptr is None or tptr.shape[0] != n + 1:
            tperm = tptr = None
        return BandedPlan((batch["sew_own"], batch["sew_oth"],
                           batch["sew_attr"], None, batch["sew_nptr"],
                           batch["sew_cnode"], 0, tperm, tptr))
    if prefix not in ("cwd_", "cws_"):
        raise ValueError(f"banded plan family {prefix!r}: sew_, cwd_ or cws_")
    ew = ew_of(batch)
    if ew is None or ew_train_of(batch) is None:
        return None
    src, dst, attr, _, wn = ew
    if prefix == "cwd_":
        return BandedPlan((dst, src, attr, None, batch["ew_dptr"], None, wn,
                           batch["ew_sperm"], batch["ew_sptr"]))
    return BandedPlan((src, dst, attr, batch["ew_sperm"], batch["ew_sptr"],
                       None, wn, None, None))
