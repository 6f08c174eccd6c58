"""Point-cloud / graph visualisation helpers.

A copy of `yolat_tpu/utils/viz.py`, the functional replacement for the
reference's VTK viewer (utils/pc_viz.py, a DeepGCN leftover): matplotlib
scatter/segment rendering of point sets and graphs with per-point
colouring, saved to file (headless). matplotlib is imported inside the
drawing functions only, so the module imports where it is absent;
tests/test_torch_drivers.py holds each function's pixels to the original's.
"""

from __future__ import annotations

import os

import numpy as np


def plot_points(points: np.ndarray, colors=None, out_path: str = "points.png",
                size: float = 4.0):
    """points [N, 2] or [N, 3] (3-D drawn as a projection)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    points = np.asarray(points)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(points[:, 0], points[:, 1], c=colors, s=size, cmap="tab20")
    ax.set_aspect("equal")
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path


def plot_graph(pos: np.ndarray, edges: np.ndarray, node_colors=None,
               out_path: str = "graph.png"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    pos = np.asarray(pos)
    edges = np.asarray(edges).reshape(-1, 2)
    fig, ax = plt.subplots(figsize=(8, 8))
    segs = np.stack([pos[edges[:, 0]], pos[edges[:, 1]]], axis=1)
    ax.add_collection(LineCollection(segs, colors="0.6", linewidths=0.8))
    ax.scatter(pos[:, 0], pos[:, 1], c=node_colors, s=8, cmap="tab20", zorder=2)
    ax.autoscale()
    ax.set_aspect("equal")
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path


def show_pointclouds(points, colors, text=(), title="Default", png_path="",
                     orientation="horizontal"):
    """Multi-panel point-cloud comparison (reference utils/pc_viz.py:98
    show_pointclouds): one panel per cloud, shared title, optional per-panel
    text, saved to png_path (always headless: the reference's VTK
    interactive window has no counterpart here).

    points: list of [N_i, 2|3] arrays; colors: list of per-point colour
    arrays (ints or RGB); 3-D clouds are drawn as an XY projection."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(points)
    rows, cols = (1, n) if orientation == "horizontal" else (n, 1)
    fig, axes = plt.subplots(rows, cols, figsize=(6 * cols, 6 * rows))
    axes = np.atleast_1d(axes).ravel()
    for i, (pts, col) in enumerate(zip(points, colors)):
        pts = np.asarray(pts)
        axes[i].scatter(pts[:, 0], pts[:, 1], c=col, s=6, cmap="tab20")
        axes[i].set_aspect("equal")
        if i < len(text):
            axes[i].set_title(text[i], fontsize=10)
    fig.suptitle(title)
    out = png_path or "pointclouds.png"
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out


def get_points_colors_from_obj(filename: str, limit: int = 1):
    """Parse `v x y z r g b` lines of a coloured .obj (reference
    utils/pc_viz.py:242): returns (points [N, 3], colors [N, 3])."""
    pts, cols = [], []
    with open(filename) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 7 and parts[0] == "v":
                pts.append([float(v) for v in parts[1:4]])
                cols.append([float(v) for v in parts[4:7]])
    pts = np.asarray(pts, np.float64)
    cols = np.asarray(cols, np.float64)
    if limit and limit < 1:
        keep = max(1, int(len(pts) * limit))
        pts, cols = pts[:keep], cols[:keep]
    return pts, cols


def visualize_part_seg(file_name_pred: str, file_name_gt: str,
                       comparison_folders, limit: int = 1, text=(),
                       png_path: str = ""):
    """Part-segmentation comparison panels (reference utils/pc_viz.py:256):
    renders the same .obj point cloud coloured by each folder's prediction
    (and the GT) side by side. Out of domain for the CAD pipeline (a
    DeepGCN PartNet leftover), kept for the surface."""
    points, colors = [], []
    for folder in list(comparison_folders):
        p, c = get_points_colors_from_obj(
            os.path.join(folder, file_name_pred), limit)
        points.append(p)
        colors.append(c)
    gt_path = (file_name_gt if os.path.isabs(file_name_gt)
               else os.path.join(comparison_folders[0], file_name_gt))
    p, c = get_points_colors_from_obj(gt_path, limit)
    points.append(p)
    colors.append(c)
    return show_pointclouds(points, colors, text=list(text),
                            title=file_name_pred, png_path=png_path)
