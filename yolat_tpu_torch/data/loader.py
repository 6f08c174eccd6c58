"""Packed loader over `yolat_tpu_torch.data.dataset.SESYDDataset`.

Counterpart of `yolat_tpu/data/dataset.py:209-608` (`PackedLoader`,
`stack_shards`), with its training options:

- **The schedule** (:517-545). Epoch e draws from
  `np.random.default_rng(seed + e)`: with shuffle, each bucket's files are
  shuffled in turn and cut into windows of `batch_size * n_devices` (a
  short last window is dropped under `drop_last`); with more than one
  bucket the steps are then shuffled. A batch never mixes buckets. The rng
  calls come in the JAX loader's order, so both packages train on the
  same batch sequence.
- **Buckets** (`compute_pad`, :402-454). The manifest is sorted by node
  count (a stable argsort) and split into `buckets` groups
  (`np.array_split`), each with its own `PadSizes`; `pad` is the largest.
  A bucket's pads are the sum of its `batch_size` largest per-file counts
  per dimension, rounded up as `PadSizes` does
  (`yolat_tpu/data/packing.py:53-79`), from this port's own CompactFiles.
- **A given `pad`** (:278-293) skips the manifest pass and forces one
  bucket; the dense table is then 8 slots wide unless `d_max` is given,
  as in JAX (no pass, no in-degree).
- **Mixup** (a dataset with `do_mixup`, :258-276, :376-400, :582-593).
  Every load draws a fresh mixed proposal set, so nothing is kept in
  memory and no worker pool runs (the draws would diverge across
  processes). Each step loads its files, then raises its bucket's pads to
  cover them (a grow-only watermark with `compute_pad`'s multiples,
  counted in `pad_growths`), then packs. Refused over several nodes.
- **Data parallel** (:517-574). Every rank builds the same global step
  schedule, node `host_id` of `n_hosts` keeps
  `steps[:even][host_id::n_hosts]` (equal step counts per node), and local
  rank `rank` packs window `rank` of each step, so one rank's loader
  yields what the JAX loader's [D, ...] batch holds in row `rank`. Under
  mixup every rank loads what the one JAX host loads: the whole manifest
  in the pad pass, then every window of each step in order; it grows the
  shared pads from all of them and packs its own window. So every rank
  draws the same stream and packs to one shape. A rank whose window is
  empty (the last short step) still yields an all-masked batch: every
  rank steps, or the others wait in the collective.

With `preproc_workers`, the cold loads run in a spawn process pool
(:238-265, :309-358), in submission order. `extra_plans_for` is
`yolat_tpu/eval/fast_forward.py:303-309`: what a YOLaT++ arch asks of the
loader.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

from yolat_tpu_torch.config import PP_ARCHS
from yolat_tpu_torch.data.dataset import (_loader_worker_init,
                                          _loader_worker_load)
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
    """Yields numpy batch dicts of `batch_size` images in the epoch's
    schedule (module docstring); `iter_buckets()` yields them as (bucket,
    batch) pairs.

    prefetch=1 packs the next batch on one background thread while the
    consumer runs the current one; prefetch=0 packs inline.
    cache_files keeps the CompactFiles of the pad pass in memory, so the
    iteration does not load them again (off for large manifests, and
    under mixup).
    ew_transpose adds the transposed part of the edge-window plan (the
    window training layout reads it); dense adds the dense neighbour table,
    D slots wide for the manifest's largest in-degree
    (`packing.dense_width`) unless d_max is given. super_family packs the
    super-edge clique family and the factored fields (YOLaT++), sized by
    `PadSizes.n_super`, with that family's banded plan `sew_*` as
    `sew_plan` says ('own', 'transpose' or 'none': `packing.pack_files`).
    preproc_workers > 0 loads the files that are not in memory (SVG parse,
    graph, proposals, CompactFile) in that many spawn processes, at most
    one per core, the pad pass's cold scan included; the batches are byte
    for byte those of preproc_workers=0. `close()` stops the pool.
    buckets, drop_last and pad shape the schedule and the pads (module
    docstring). n_devices, host_id, n_hosts and rank select one rank's
    windows of the global step schedule; the pads come from the whole
    split, so every rank packs to one shape. The defaults are one device.
    """

    def __init__(self, dataset, batch_size: int = 4, prefetch: int = 1,
                 edge_window: bool = True, cache_files: bool = True,
                 shuffle: bool = False, seed: int = 0,
                 ew_transpose: bool = False, dense: bool = False,
                 d_max: int | None = None, super_family: bool = False,
                 sew_plan: str = "own", preproc_workers: int = 0,
                 n_devices: int = 1, host_id: int = 0, n_hosts: int = 1,
                 rank: int = 0, buckets: int = 1, drop_last: bool = False,
                 pad: PadSizes | None = None):
        if prefetch not in (0, 1):
            raise ValueError("prefetch is 0 or 1")
        if not (0 <= rank < n_devices and 0 <= host_id < n_hosts):
            raise ValueError(f"rank {rank} of {n_devices} local devices, "
                             f"node {host_id} of {n_hosts}")
        self.mixup = bool(getattr(dataset, "do_mixup", False))
        if self.mixup and n_hosts > 1:
            # the pad watermark grows from each node's own draws: the
            # nodes' shapes would diverge and the collectives deadlock
            raise NotImplementedError(
                "mixup is not supported in multi-node training "
                "(per-node stochastic pad growth diverges)")
        self.n_devices, self.rank = n_devices, rank
        self.host_id, self.n_hosts = host_id, n_hosts
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self.buckets = max(1, buckets)
        self.prefetch = prefetch
        self.edge_window = edge_window
        self.ew_transpose = ew_transpose
        self.dense = dense
        self.super_family = super_family
        self.sew_plan = sew_plan
        # mixup draws anew on every load: nothing recurs to keep, and
        # worker processes would draw other streams
        self.cache_files = cache_files and not self.mixup
        self.preproc_workers = 0 if self.mixup else max(0, preproc_workers)
        self.pad_growths = 0
        self._pool = None
        self._compact: dict = {}
        if pad is not None:
            self.pad, self.buckets = pad, 1
            self._bucket_pads = [pad]
            self._bucket_of = np.zeros(len(dataset), np.int32)
            width = 8
        else:
            self._max_indegree = 0
            self.pad = self.compute_pad()
            width = dense_width(self._max_indegree)
        self.d_max = d_max if d_max is not None else width

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

    def _ensure_pool(self):
        if self.preproc_workers <= 0:
            return None
        if self._pool is None:
            import multiprocessing as mp

            # spawn: a fork would copy a parent that may hold a CUDA
            # context. The work is CPU-bound: no more processes than cores
            n = max(1, min(self.preproc_workers, os.cpu_count() or 1))
            self._pool = mp.get_context("spawn").Pool(
                n, initializer=_loader_worker_init,
                initargs=(self.ds.ctor_kwargs(), self.super_family))
        return self._pool

    def close(self) -> None:
        """Stop the preprocessing pool, if one was started."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def _load_many(self, idxs):
        """Yield (CompactFile, gt, wh) per manifest index, in order. With
        preproc_workers the files not in memory stream through the pool
        (imap keeps submission order, which is the consumption order)."""
        idxs = [int(i) for i in idxs]
        pool = self._ensure_pool()
        if pool is None:
            for i in idxs:
                yield self._load(i)
            return
        miss = [i for i in idxs if i not in self._compact]
        it = pool.imap(_loader_worker_load, miss, chunksize=1)
        for i in idxs:
            item = self._compact.get(i)
            if item is None:
                j, item = next(it)
                assert j == i, (j, i)
                if self.cache_files:
                    self._compact[i] = item
            yield item

    def compute_pad(self) -> PadSizes:
        """The largest bucket's pads, after one pass over the whole
        manifest that gives every file its bucket and every bucket its
        `PadSizes` (module docstring)."""
        nodes, edges, supers, props, gts = [], [], [], [], []
        for f, (gt, _), _ in self._load_many(range(len(self.ds))):
            nodes.append(len(f.pos))
            edges.append(len(f.edge))
            supers.append(len(f.edge_super) if self.super_family else 0)
            props.append(f.n_proposals)
            gts.append(len(gt))
            if len(f.edge):
                self._max_indegree = max(self._max_indegree,
                                         int(f.dst_count.max()))

        def pad_for(idx):
            def topsum(vals, mult):
                return round_up(sum(sorted(vals[i] for i in idx)
                                    [-self.batch_size:]), mult)

            return PadSizes(topsum(nodes, 512), topsum(edges, 512),
                            topsum(props, 64),
                            round_up(max([1] + [gts[i] for i in idx]), 16),
                            self.batch_size,
                            n_super=(topsum(supers, 2048)
                                     if self.super_family else 0))

        self._bucket_of = np.zeros(len(self.ds), np.int32)
        if self.buckets > 1 and len(self.ds) >= self.buckets:
            groups = np.array_split(
                np.argsort(np.asarray(nodes), kind="stable"), self.buckets)
            for b, g in enumerate(groups):
                self._bucket_of[g] = b
            self._bucket_pads = [pad_for(g) for g in groups]
        else:
            self._bucket_pads = [pad_for(range(len(self.ds)))]
        return self._bucket_pads[int(np.argmax(
            [p.n_nodes for p in self._bucket_pads]))]

    def __len__(self):
        per_step = self.batch_size * self.n_devices
        total = 0
        for b in range(len(self._bucket_pads)):
            n = int((self._bucket_of == b).sum())
            total += n // per_step if self.drop_last else -(-n // per_step)
        return total // self.n_hosts if self.n_hosts > 1 else total

    def epoch_steps(self) -> list:
        """The next epoch's steps on this node, as (bucket, window of up to
        `batch_size * n_devices` manifest indices); advances the epoch
        counter (module docstring)."""
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        per_step = self.batch_size * self.n_devices
        steps = []
        for b in range(len(self._bucket_pads)):
            order = np.arange(len(self.ds))[self._bucket_of == b]
            if self.shuffle:
                rng.shuffle(order)
            for s in range(0, len(order), per_step):
                window = order[s:s + per_step]
                if len(window) < per_step and self.drop_last:
                    break
                steps.append((b, window))
        if self.shuffle and len(self._bucket_pads) > 1:
            rng.shuffle(steps)
        if self.n_hosts > 1:
            even = (len(steps) // self.n_hosts) * self.n_hosts
            steps = steps[:even][self.host_id::self.n_hosts]
        return steps

    def epoch_order(self) -> np.ndarray:
        """The next epoch's files on this node, in schedule order; advances
        the epoch counter."""
        steps = self.epoch_steps()
        return (np.concatenate([w for _, w in steps]) if steps
                else np.zeros(0, np.int64))

    def _grown_pad(self, b: int, loads: list) -> PadSizes:
        """Bucket b's pads raised to cover each window of a step's loads
        (the JAX loader's `_grown_pad`, :376-400): the grow-only watermark
        of mixup's stochastic batch contents."""
        pad = self._bucket_pads[b]
        bs = self.batch_size
        wins = [loads[d * bs:(d + 1) * bs] for d in range(self.n_devices)]

        def need(count):
            return max(sum(count(f) for f, _, _ in w) for w in wins)

        n = need(lambda f: len(f.pos))
        e = need(lambda f: len(f.edge))
        s = need(lambda f: len(f.edge_super)) if self.super_family else 0
        p = need(lambda f: f.n_proposals)
        g = max([0] + [len(gt[0]) for _, gt, _ in loads])
        if (n <= pad.n_nodes and e <= pad.n_edges and s <= pad.n_super
                and p <= pad.n_proposals and g <= pad.n_gt):
            return pad
        self.pad_growths += 1
        pad = self._bucket_pads[b] = PadSizes(
            max(pad.n_nodes, round_up(n, 512)),
            max(pad.n_edges, round_up(e, 512)),
            max(pad.n_proposals, round_up(p, 64)),
            max(pad.n_gt, round_up(g, 16)), pad.n_images,
            n_super=(max(pad.n_super, round_up(s, 2048))
                     if self.super_family else 0))
        return pad

    def _pack(self, loads: list, pad: PadSizes) -> dict:
        files = [f for f, _, _ in loads]
        batch = pack_files(files, [gt for _, gt, _ in loads],
                           [wh for _, _, wh in loads], pad,
                           edge_window=self.edge_window,
                           ew_transpose=self.ew_transpose,
                           super_family=self.super_family,
                           sew_plan=self.sew_plan)
        if self.dense:
            batch = add_dense_neighbors(batch, d_max=self.d_max, files=files)
        return batch

    def _iter_sync(self):
        """(bucket, this rank's batch) per step of the next epoch."""
        steps = self.epoch_steps()
        lo, hi = self.rank * self.batch_size, (self.rank + 1) * self.batch_size
        if self.mixup:
            # every window of the step in the JAX host's order, then the
            # shared pads, then this rank's window
            for b, window in steps:
                loads = [self._load(int(i)) for i in window]
                yield b, self._pack(loads[lo:hi], self._grown_pad(b, loads))
            return
        stream = self._load_many([i for _, w in steps for i in w[lo:hi]])
        for b, window in steps:
            loads = [next(stream) for _ in window[lo:hi]]
            yield b, self._pack(loads, self._bucket_pads[b])

    def iter_buckets(self):
        """The next epoch as (bucket, batch) pairs, packed `prefetch`
        steps ahead."""
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

    def __iter__(self):
        for _, batch in self.iter_buckets():
            yield batch


def stack_shards(shards: list) -> dict:
    """[D] list of batch dicts -> dict of [D, ...] arrays (the JAX loader's
    stacked batch; 0-d leaves such as n_images become [D]). The pack-time
    plans' lengths follow each batch: stack batches with their plans at
    capacity (`ops.plans.pad_plans`)."""
    return {k: np.stack([s[k] for s in shards], axis=0) for k in shards[0]}
