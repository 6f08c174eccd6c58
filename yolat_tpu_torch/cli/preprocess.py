"""Offline preprocessing CLI: caches every file's graph and proposals.

Counterpart of `yolat_tpu/cli/preprocess.py:1-119`:

  python -m yolat_tpu_torch.cli.preprocess --data_dir DIR \
      [--bbox_sampling_step 10] [--partitions train,test] [--workers N] \
      [--hierarchical] [--mode floorplan|diagram|chart]

builds and caches, for each split's files, the graph dict and the proposal
set beside the SVG (`SESYDDataset`, the JAX package's file names and cache
version, so either package reads the other's caches), and writes the
dataset-wide super-edge attribute statistics to DIR/stats.pkl (angles and
distances, mean and std; the reference's build_graph_bbox.py:377-381).
`--hierarchical` also writes the YOLaT++ super-node graph of each file
(`geom/hierarchical.build_hierarchical_graph`) as
<file>.hier.v{CACHE_VERSION}.pkl. `--workers N` runs the per-file work in N
spawn processes, results in file order, so stats.pkl is the same bytes as
with `--workers 0`; the caches are per file, so workers never race.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np

from yolat_tpu_torch.data.dataset import CACHE_VERSION, SESYDDataset

_WORKER_DS = None
_WORKER_HIER = False


def _init_worker(root, part, step, mode, hierarchical):
    global _WORKER_DS, _WORKER_HIER
    _WORKER_DS = SESYDDataset(root, part, step, mode=mode)
    _WORKER_HIER = hierarchical


def _process_file(i: int):
    ds = _WORKER_DS
    ds.load(i)
    g = ds._graph(ds.files[i])
    if _WORKER_HIER:
        _emit_hierarchical(ds.files[i], g)
    ea = np.asarray(g["edge_attr"]["super"])
    if len(ea):
        return ea[:, 4], ea[:, 5]
    return np.zeros(0), np.zeros(0)


def _emit_hierarchical(path: str, g: dict):
    from yolat_tpu_torch.geom.hierarchical import build_hierarchical_graph

    out = path.replace(".svg", f".hier.v{CACHE_VERSION}.pkl")
    if not os.path.exists(out):
        with open(out, "wb") as f:
            pickle.dump(build_hierarchical_graph(g), f)


def main(argv=None):
    p = argparse.ArgumentParser(description="yolat_tpu_torch preprocessing")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--bbox_sampling_step", default=10, type=int)
    p.add_argument("--mode", default=None,
                   choices=[None, "floorplan", "diagram", "chart"])
    p.add_argument("--partitions", default="train,test", type=str)
    p.add_argument("--workers", default=0, type=int,
                   help="parallel preprocessing processes (0 = in-process)")
    p.add_argument("--hierarchical", action="store_true",
                   help="also write the YOLaT++ hierarchical graph per file")
    args = p.parse_args(argv)

    angles, dists = [], []
    stats = None
    for part in args.partitions.split(","):
        list_path = os.path.join(args.data_dir, f"{part}_list.txt")
        if not os.path.exists(list_path):
            print(f"skip partition {part}: no {list_path}")
            continue
        ds = SESYDDataset(args.data_dir, part, args.bbox_sampling_step,
                          mode=args.mode)
        init = (args.data_dir, part, args.bbox_sampling_step, args.mode,
                args.hierarchical)
        t0 = time.time()
        if args.workers > 0:
            import multiprocessing as mp

            with mp.get_context("spawn").Pool(
                    args.workers, initializer=_init_worker,
                    initargs=init) as pool:
                results = pool.imap(_process_file, range(len(ds)))
                for i, (a, d) in enumerate(results):
                    if len(a):
                        angles.append(a)
                        dists.append(d)
                    print(f"[{part} {i + 1}/{len(ds)}] {ds.files[i]}")
        else:
            _init_worker(*init)
            for i in range(len(ds)):
                a, d = _process_file(i)
                if len(a):
                    angles.append(a)
                    dists.append(d)
                print(f"[{part} {i + 1}/{len(ds)}] {ds.files[i]}")
        print(f"{part}: {len(ds)} files in {time.time() - t0:.1f}s")

    if angles:
        a = np.concatenate(angles)
        d = np.concatenate(dists)
        stats = {
            "angles": {"mean": float(a.mean()), "std": float(a.std())},
            "distances": {"mean": float(d.mean()), "std": float(d.std())},
        }
        with open(os.path.join(args.data_dir, "stats.pkl"), "wb") as f:
            pickle.dump(stats, f)
        print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
