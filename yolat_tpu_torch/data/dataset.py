"""SESYD-style dataset for serving: SVG -> graph -> proposals, cached.

Counterpart of `yolat_tpu/data/dataset.py:28-206` (the loader workers'
entry points, `CACHE_VERSION`, `_atomic_pickle`, `SESYDDataset` with
`ctor_kwargs`) without training-time mixup and the anchor-statistics tool.
Each SVG goes through the graph build and the proposal generator of
`yolat_tpu_torch.geom`, on the host library (`geom/_native.py`); both
stages are cached on disk beside the SVG under the JAX package's file
names and format, so either package reads the other's caches.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from yolat_tpu_torch.data.synthetic import (CHART_CLASSES, DIAGRAM_CLASSES,
                                            FLOORPLAN_CLASSES)
from yolat_tpu_torch.geom.graph_build import build_svg_graph
from yolat_tpu_torch.geom.proposals import ProposalFile, generate_proposals
from yolat_tpu_torch.geom.svg_io import SVGDocument, read_ground_truth_boxes

# --- the worker processes of PackedLoader(preproc_workers=N) -------------
# Module-level, so a spawn pool pickles them by reference. Each worker holds
# one SESYDDataset and returns finished CompactFile loads. The host stage is
# numpy and the host library: a worker never touches CUDA (no torch.cuda
# call, no tensor on a device).
_LOADER_WORKER_DS = None
_LOADER_WORKER_SUPER = False


def _loader_worker_init(ctor_kwargs: dict, super_family: bool = False):
    global _LOADER_WORKER_DS, _LOADER_WORKER_SUPER
    _LOADER_WORKER_DS = SESYDDataset(**ctor_kwargs)
    _LOADER_WORKER_SUPER = super_family


def _loader_worker_load(idx: int):
    from yolat_tpu_torch.data.packing import CompactFile

    ds = _LOADER_WORKER_DS
    f, gt, wh = ds.load(idx)
    return idx, (CompactFile(f, n_classes=ds.n_classes,
                             super_family=_LOADER_WORKER_SUPER), gt, wh)


CACHE_VERSION = 4  # the JAX package's cache format version


def _atomic_pickle(path: str, obj) -> None:
    """Write-then-rename, so a concurrent reader never sees half a file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


class SESYDDataset:
    """Files from `<root>/<partition>_list.txt` (or an explicit `files`
    list, for bare SVGs); `load(i)` -> (ProposalFile, (gt_bbox, gt_labels),
    (width, height)). `mode` picks the class vocabulary and defaults from
    the path, as the reference does (graph_dict3.py:57)."""

    def __init__(self, root: str, partition: str = "train",
                 bbox_sampling_step: int = 10, mode: str | None = None,
                 class_dict: dict | None = None, cache: bool = True,
                 files: list | None = None, require_gt: bool = True):
        self.root = root
        self.partition = partition
        self.step = bbox_sampling_step
        self.require_gt = require_gt
        if files is not None:
            self.files = list(files)
        else:
            list_path = os.path.join(root, f"{partition}_list.txt")
            if not os.path.exists(list_path):
                # the reference's val_list2.txt breaks the pattern
                alt = os.path.join(root, f"{partition}.txt")
                if os.path.exists(alt):
                    list_path = alt
            with open(list_path) as f:
                self.files = [os.path.join(root, line.strip())
                              for line in f if line.strip()]
        if mode is None:
            d = os.path.dirname(self.files[0])
            mode = ("diagram" if "diagram" in d
                    else "chart" if "chart" in d else "floorplan")
        self.mode = mode
        if class_dict is None:
            class_dict = {"diagram": DIAGRAM_CLASSES,
                          "chart": CHART_CLASSES}.get(mode, FLOORPLAN_CLASSES)
        self.class_dict = class_dict
        self.n_classes = len(set(class_dict.values()))
        self.cache = cache

    def __len__(self):
        return len(self.files)

    def ctor_kwargs(self) -> dict:
        """Constructor arguments that rebuild this dataset in a worker
        process, everything resolved (mode, class vocabulary, file list)."""
        return dict(root=self.root, partition=self.partition,
                    bbox_sampling_step=self.step, mode=self.mode,
                    class_dict=self.class_dict, cache=self.cache,
                    files=self.files, require_gt=self.require_gt)

    def _graph(self, path: str) -> dict:
        cache_path = path.replace(".svg", f".graph.v{CACHE_VERSION}.pkl")
        if self.cache and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                return pickle.load(f)
        # the reference's own offline graphs (<file>.pkl, same schema,
        # build_graph_bbox.py:302-381) load directly
        ref_path = path.replace(".svg", ".pkl")
        if self.cache and os.path.exists(ref_path):
            with open(ref_path, "rb") as f:
                g = pickle.load(f)
            if isinstance(g, dict) and {"pos", "attr", "edge", "edge_attr",
                                        "cc"} <= set(g):
                if isinstance(g["pos"], dict):  # build_graph_bbox.py:353
                    g = {**g, "pos": g["pos"]["spatial"]}
                g.setdefault("img_width", 1.0)
                g.setdefault("img_height", 1.0)
                return g
        g = build_svg_graph(SVGDocument.from_file(path), mode=self.mode)
        if self.cache:
            _atomic_pickle(cache_path, g)
        return g

    def load(self, idx: int):
        """-> (ProposalFile, (gt_bbox, gt_labels), (width, height))."""
        path = self.files[idx]
        graph = self._graph(path)
        w, h = graph["img_width"], graph["img_height"]
        xml_path = path.replace(".svg", ".xml")
        if os.path.exists(xml_path) or self.require_gt:
            gt_bbox, gt_labels = read_ground_truth_boxes(
                xml_path, w, h, self.class_dict)
        else:
            # unannotated SVGs: every proposal labels background
            gt_bbox = np.zeros((0, 4))
            gt_labels = np.zeros(0, np.int64)
        # GT-less proposals must not share a cache file with labelled ones
        gt_key = "" if len(gt_bbox) else ".nogt"
        cache_path = path.replace(
            ".svg", f".props{self.step}{gt_key}.v{CACHE_VERSION}.pkl")
        if self.cache and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                pf = ProposalFile.from_dict(pickle.load(f))
        else:
            pf = generate_proposals(graph, gt_bbox, gt_labels, self.n_classes,
                                    bbox_sampling_step=self.step)
            if self.cache:
                _atomic_pickle(cache_path, pf.to_dict())
        return pf, (gt_bbox, gt_labels), (w, h)
