"""Packed loader over `yolat_tpu_torch.data.dataset.SESYDDataset`.

Counterpart of `yolat_tpu/data/dataset.py:209-600` (`PackedLoader`) for
one device: no buckets, no mixup. With shuffle, epoch e visits the files
in the order `np.random.default_rng(seed + e).shuffle` gives, exactly as
`_iter_sync` (:517-529) orders them, so both packages train on the same
batch sequence. Pad sizes follow
`PackedLoader.compute_pad` (:402-454): the sum of the `batch_size` largest
per-file counts per dimension, rounded up as `PadSizes` does
(`yolat_tpu/data/packing.py:53-79`), computed from this port's own
CompactFiles.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from yolat_tpu_torch.data.packing import (CompactFile, PadSizes, pack_files,
                                          round_up)


class PackedLoader:
    """Yields numpy batch dicts of `batch_size` images, in manifest order
    or, with shuffle, in each epoch's shuffled order.

    prefetch=1 packs the next batch on one background thread while the
    consumer runs the current one; prefetch=0 packs inline.
    cache_files keeps the CompactFiles of the pad pass in memory, so the
    iteration does not load them again (off for large manifests).
    """

    def __init__(self, dataset, batch_size: int = 4, prefetch: int = 1,
                 edge_window: bool = True, cache_files: bool = True,
                 shuffle: bool = False, seed: int = 0):
        if prefetch not in (0, 1):
            raise ValueError("prefetch is 0 or 1")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.prefetch = prefetch
        self.edge_window = edge_window
        self.cache_files = cache_files
        self._compact: dict = {}
        self.pad = self.compute_pad()

    def _load(self, i: int):
        hit = self._compact.get(i)
        if hit is not None:
            return hit
        f, gt, wh = self.ds.load(i)
        item = (CompactFile(f, n_classes=getattr(self.ds, "n_classes", None)),
                gt, wh)
        if self.cache_files:
            self._compact[i] = item
        return item

    def compute_pad(self) -> PadSizes:
        nodes, edges, props, gts = [], [], [], []
        for i in range(len(self.ds)):
            f, (gt, _), _ = self._load(i)
            nodes.append(len(f.pos))
            edges.append(len(f.edge))
            props.append(f.n_proposals)
            gts.append(len(gt))

        def topsum(vals, mult):
            return round_up(sum(sorted(vals)[-self.batch_size:]), mult)

        return PadSizes(topsum(nodes, 512), topsum(edges, 512),
                        topsum(props, 64), round_up(max([1] + gts), 16),
                        self.batch_size)

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
            yield pack_files([l[0] for l in loads], [l[1] for l in loads],
                             [l[2] for l in loads], self.pad,
                             edge_window=self.edge_window)

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
