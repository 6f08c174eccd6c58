"""In-memory toy fixtures.

Counterpart of `yolat_tpu/data/toy.py:1-141`, on the port's own geometry
and packing, with the same numpy draws in the same order:

  * toy_shape_sample / ToyDataset: the reference's only synthetic fixture
    (Datasets/toy_dataset.py), procedural circle / triangle / rectangle
    single-shape graphs with a per-shape class label.
  * random_packed_batch: a structurally valid packed batch (random
    rectangle scenes through the graph build and the proposal generator)
    for checks and timings that must not depend on files on disk.
  * toy_batch: the same, its node rows padded for the fused pool head.

The toy batch is degenerate for train-mode logits: every proposal of a
scene covers the same square (the rectangle and its diagonal), so the
proposals of a CC differ only in which nodes they pool. It serves the
pipeline's shapes and code paths, not its quality.
"""

from __future__ import annotations

import numpy as np

from yolat_tpu_torch.data.packing import (CompactFile, PadSizes, pack_files,
                                          round_up)
from yolat_tpu_torch.geom.bezier import circle_to_cubics, line_to_cubic
from yolat_tpu_torch.geom.graph_build import (cubics_to_graph,
                                              merge_connected_components,
                                              merge_nodes)
from yolat_tpu_torch.geom.proposals import generate_proposals

TOY_CLASSES = {"circle": 0, "triangle": 1, "rectangle": 2}


def _toy_cubics(kind: str, rng: np.random.Generator) -> np.ndarray:
    if kind == "circle":
        r = rng.uniform(0.1, 0.45)
        return circle_to_cubics(0.5, 0.5, r)
    if kind == "rectangle":
        w, h = rng.uniform(0.2, 0.9, 2)
        return np.concatenate([line_to_cubic(0, 0, w, 0),
                               line_to_cubic(w, 0, w, h),
                               line_to_cubic(w, h, 0, h),
                               line_to_cubic(0, h, 0, 0)])
    if kind == "triangle":
        p = rng.uniform(0.05, 0.95, (3, 2))
        return np.concatenate([line_to_cubic(*p[0], *p[1]),
                               line_to_cubic(*p[1], *p[2]),
                               line_to_cubic(*p[2], *p[0])])
    raise ValueError(kind)


def toy_shape_sample(rng: np.random.Generator):
    """One toy graph and its label, the shape in the unit square."""
    kind = list(TOY_CLASSES)[int(rng.integers(len(TOY_CLASSES)))]
    cubics = _toy_cubics(kind, rng)
    graph = merge_nodes(cubics_to_graph(cubics, 1.0, 1.0, stroke_width=3.0))
    return graph, TOY_CLASSES[kind]


class ToyDataset:
    """Per-node shape classification (the reference's
    Datasets/toy_dataset.py: 2000 procedural samples, control nodes
    stripped, every node labelled with the shape class); item `idx` draws
    from `default_rng(seed * 100003 + idx)`."""

    def __init__(self, n_samples: int = 2000, seed: int = 0):
        self.n = n_samples
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        graph, label = toy_shape_sample(rng)
        is_control = graph["attr"]["is_control"].reshape(-1) > 0.5
        o2n = np.cumsum(~is_control) - 1
        edges = [[o2n[a], o2n[b]] for a, b in graph["edge"]["shape"]
                 if not is_control[a] and not is_control[b]]
        pos = graph["pos"][~is_control]
        return {"x": pos.astype(np.float32),
                "pos": pos.astype(np.float32),
                "edge": np.asarray(edges, dtype=np.int64).reshape(-1, 2),
                "labels": np.full(len(pos), label, dtype=np.int64),
                "label": label}


def _toy_scene(rng: np.random.Generator, ccs: int, n_classes: int):
    """One 100 x 100 scene of `ccs` squares, each with its diagonal, and
    their GT boxes (normalised) and labels; the draws of each square come
    as the JAX package draws them (corner, side, label)."""
    cubics, boxes, labels = [], [], []
    for _ in range(ccs):
        x0, y0 = rng.uniform(5, 60, 2)
        s = rng.uniform(15, 35)
        cubics.append(np.concatenate([
            line_to_cubic(x0, y0, x0 + s, y0),
            line_to_cubic(x0 + s, y0, x0 + s, y0 + s),
            line_to_cubic(x0 + s, y0 + s, x0, y0 + s),
            line_to_cubic(x0, y0 + s, x0, y0),
            line_to_cubic(x0, y0, x0 + s, y0 + s)]))
        boxes.append([x0 / 100, y0 / 100, (x0 + s) / 100, (y0 + s) / 100])
        labels.append(int(rng.integers(n_classes - 1)))
    g = merge_nodes(cubics_to_graph(np.concatenate(cubics), 100.0, 100.0))
    info = merge_connected_components(g)
    g["edge"]["super"] = np.concatenate(
        [info["shape_shape_edges"], info["cross_shape_edges"]], axis=0)
    g["edge_attr"]["super"] = np.concatenate(
        [info["shape_shape_attr"], info["cross_attr"]], axis=0)
    g["attr"]["is_super"] = np.zeros((len(g["pos"]), 1), bool)
    g["cc"] = info["cc"]
    return g, np.asarray(boxes), np.asarray(labels)


def random_packed_batch(seed: int = 0, n_images: int = 2,
                        ccs_per_image: int = 3, n_classes: int = 17,
                        step: int = 4, pad: PadSizes | None = None):
    """(batch, pad): `n_images` random scenes packed for both detectors:
    the super-edge family with its banded plan, and the edge-window plan
    with its transpose (what YOLaT++'s curve level reads). Every key the
    JAX package's batch also has is byte-equal to it; the plans are the
    port's layout. Without `pad`, the pads are the JAX package's
    (`PadSizes.for_files` at node and edge multiples 256, super 512,
    proposal 32, GT 16, over the block-aligned counts). The files are
    compacted without `n_classes`, as JAX's `pack_files` compacts raw
    files: a proposal is positive where its target box is nonzero."""
    rng = np.random.default_rng(seed)
    files, gts, whs = [], [], []
    for _ in range(n_images):
        g, gt_bbox, gt_labels = _toy_scene(rng, ccs_per_image, n_classes)
        pf = generate_proposals(g, gt_bbox, gt_labels, n_classes,
                                bbox_sampling_step=step)
        files.append(CompactFile(pf, super_family=True))
        gts.append((gt_bbox, gt_labels))
        whs.append((100.0, 100.0))
    if pad is None:
        pad = PadSizes(round_up(sum(len(f.pos) for f in files), 256),
                       round_up(sum(len(f.edge) for f in files), 256),
                       round_up(sum(f.n_proposals for f in files), 32),
                       round_up(max(len(b) for b, _ in gts), 16),
                       n_images,
                       n_super=round_up(sum(len(f.edge_super)
                                            for f in files), 512))
    return pack_files(files, gts, whs, pad, ew_transpose=True,
                      super_family=True), pad


def toy_batch(seed: int = 0, n_images: int = 4):
    """(batch, pad): `random_packed_batch`'s batch of `n_images` scenes with
    its node rows rounded up to a multiple of 512 (the fused pool head's
    tile); the other pads as `random_packed_batch` chooses them."""
    _, pad = random_packed_batch(seed=seed, n_images=n_images)
    pad = PadSizes(round_up(pad.n_nodes, 512), pad.n_edges, pad.n_proposals,
                   pad.n_gt, pad.n_images, n_super=pad.n_super)
    return random_packed_batch(seed=seed, n_images=n_images, pad=pad)
