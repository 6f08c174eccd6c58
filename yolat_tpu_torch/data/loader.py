"""Packed loader over `yolat_tpu_torch.data.dataset.SESYDDataset`.

Counterpart of `yolat_tpu/data/dataset.py:209-600` (`PackedLoader`) for
one device: no buckets, no mixup. With shuffle, epoch e visits the files
in the order `np.random.default_rng(seed + e).shuffle` gives, exactly as
`_iter_sync` (:517-529) orders them, so both packages train on the same
batch sequence. Pad sizes follow
`PackedLoader.compute_pad` (:402-454): the sum of the `batch_size` largest
per-file counts per dimension, rounded up as `PadSizes` does
(`yolat_tpu/data/packing.py:53-79`), computed from this port's own
CompactFiles. `extra_plans_for` is
`yolat_tpu/eval/fast_forward.py:303-309`: what a YOLaT++ arch asks of the
loader.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from yolat_tpu_torch.config import PP_ARCHS
from yolat_tpu_torch.data.packing import (CompactFile, PadSizes,
                                          add_dense_neighbors, dense_width,
                                          pack_files, round_up)


def extra_plans_for(cfg) -> dict:
    """The loader options an arch's serving path needs: YOLaT++ reads the
    super-edge family, which comes with its banded plan (kernel 5), and
    the edge-window plan's transpose (its curve level, kernels 5 and 6);
    the canonical detector nothing."""
    if getattr(cfg, "arch", "") in PP_ARCHS:
        return {"super_family": True, "ew_transpose": True}
    return {}


def train_plans_for(cfg) -> dict:
    """The loader options an arch's train step needs
    (`yolat_tpu/train/trainer.py:102-111`, `train_plans`): YOLaT++ reads
    the super-edge family and the factored fields; the clique family's
    banded plan is packed, with its transpose, only for the banded
    training route (cfg.pp_banded_super, kernels 7 and 8)."""
    if getattr(cfg, "arch", "") in PP_ARCHS:
        return {"super_family": True,
                "sew_plan": "transpose" if cfg.pp_banded_super else "none"}
    return {}


class PackedLoader:
    """Yields numpy batch dicts of `batch_size` images, in manifest order
    or, with shuffle, in each epoch's shuffled order.

    prefetch=1 packs the next batch on one background thread while the
    consumer runs the current one; prefetch=0 packs inline.
    cache_files keeps the CompactFiles of the pad pass in memory, so the
    iteration does not load them again (off for large manifests).
    ew_transpose adds the transposed part of the edge-window plan (the
    window training layout reads it); dense adds the dense neighbour table,
    D slots wide for the manifest's largest in-degree
    (`packing.dense_width`) unless d_max is given. super_family packs the
    super-edge clique family and the factored fields (YOLaT++), sized by
    `PadSizes.n_super`, with that family's banded plan `sew_*` as
    `sew_plan` says ('own', 'transpose' or 'none': `packing.pack_files`).
    """

    def __init__(self, dataset, batch_size: int = 4, prefetch: int = 1,
                 edge_window: bool = True, cache_files: bool = True,
                 shuffle: bool = False, seed: int = 0,
                 ew_transpose: bool = False, dense: bool = False,
                 d_max: int | None = None, super_family: bool = False,
                 sew_plan: str = "own"):
        if prefetch not in (0, 1):
            raise ValueError("prefetch is 0 or 1")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.prefetch = prefetch
        self.edge_window = edge_window
        self.ew_transpose = ew_transpose
        self.dense = dense
        self.super_family = super_family
        self.sew_plan = sew_plan
        self.cache_files = cache_files
        self._compact: dict = {}
        self._max_indegree = 0
        self.pad = self.compute_pad()
        self.d_max = d_max if d_max is not None else dense_width(
            self._max_indegree)

    def _load(self, i: int):
        hit = self._compact.get(i)
        if hit is not None:
            return hit
        f, gt, wh = self.ds.load(i)
        item = (CompactFile(f, n_classes=getattr(self.ds, "n_classes", None),
                            super_family=self.super_family), gt, wh)
        if self.cache_files:
            self._compact[i] = item
        return item

    def compute_pad(self) -> PadSizes:
        nodes, edges, supers, props, gts = [], [], [], [], []
        for i in range(len(self.ds)):
            f, (gt, _), _ = self._load(i)
            nodes.append(len(f.pos))
            edges.append(len(f.edge))
            supers.append(len(f.edge_super) if self.super_family else 0)
            props.append(f.n_proposals)
            gts.append(len(gt))
            if len(f.edge):
                self._max_indegree = max(self._max_indegree,
                                         int(f.dst_count.max()))

        def topsum(vals, mult):
            return round_up(sum(sorted(vals)[-self.batch_size:]), mult)

        return PadSizes(topsum(nodes, 512), topsum(edges, 512),
                        topsum(props, 64), round_up(max([1] + gts), 16),
                        self.batch_size,
                        n_super=(topsum(supers, 2048) if self.super_family
                                 else 0))

    def __len__(self):
        return -(-len(self.ds) // self.batch_size)

    def epoch_order(self):
        """The next epoch's file order (advances the epoch counter)."""
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(order)
        return order

    def _iter_sync(self):
        order = self.epoch_order()
        for start in range(0, len(order), self.batch_size):
            loads = [self._load(int(i))
                     for i in order[start:start + self.batch_size]]
            files = [l[0] for l in loads]
            batch = pack_files(files, [l[1] for l in loads],
                               [l[2] for l in loads], self.pad,
                               edge_window=self.edge_window,
                               ew_transpose=self.ew_transpose,
                               super_family=self.super_family,
                               sew_plan=self.sew_plan)
            if self.dense:
                batch = add_dense_neighbors(batch, d_max=self.d_max,
                                            files=files)
            yield batch

    def __iter__(self):
        if self.prefetch == 0:
            yield from self._iter_sync()
            return
        q: queue.Queue = queue.Queue(maxsize=1)
        done = object()
        err: list = []

        def producer():
            try:
                for item in self._iter_sync():
                    q.put(item)
            except BaseException as e:  # re-raised on the consumer side
                err.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                break
            yield item
        t.join()
        if err:
            raise err[0]
