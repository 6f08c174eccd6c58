# Frozen copy of yolat_tpu_torch/geom/split_cross.py at commit 8dc2b5b (the
# benchmark's yardstick: later changes to the program do not reach it).
# Only the imports differ: they point into benchmark.ref.geom, and the host
# library's entry points are stubs that return None, so every call takes
# the numpy path (the program's `_native.disabled()` oracle).
"""Cross-point splitting of primitives.

Counterpart of utils/svg_utils/split_cross.py in the reference: SESYD ground
truth is defined over primitives split at their crossings, so circles are
split into arcs at incident line endpoints and lines are split at endpoints
of other lines lying on them. The epsilon thresholds (1e-4 merge radius,
15px circle-incidence band, 3px point-to-line distance, 1px endpoint
exclusion box) are part of the data contract and preserved exactly
(split_cross.py:59,79-81,238-245).

Implementation is numpy-vectorised per primitive (the reference loops in
Python over all pairs); semantics are identical.

Port of `yolat_tpu/geom/split_cross.py:1-213`. `split_line` runs in the
host library (`geom/_native.py` split_lines); its numpy body is the oracle
(`_native.disabled()`).
"""

from __future__ import annotations

import numpy as np

from benchmark.ref.geom import _numpy_only as _native
from benchmark.ref.geom.bezier import shapes_to_primitives

MERGE_TH = 1e-4
CIRCLE_TH = 15.0
LINE_TH = 3.0


def merge_close_points(points: np.ndarray) -> np.ndarray:
    """Greedy row-order merge of points closer than MERGE_TH.

    Mirrors merge_close_points (split_cross.py:57-69): scanning rows in
    order, each unmerged group of near-coincident points collapses to its
    mean.
    """
    points = np.asarray(points, dtype=np.float64)
    if len(points) == 0:
        return points.reshape(0, 2)
    d = np.linalg.norm(points[:, None, :] - points[None, :, :], axis=-1)
    close = d < MERGE_TH
    merged = np.zeros(len(points), dtype=bool)
    out = []
    for i in range(len(points)):
        cand = points[(~merged) & close[i]]
        if len(cand) == 0:
            continue
        out.append(cand.mean(axis=0))
        merged[close[i]] = True
    return np.asarray(out).reshape(-1, 2)


def _sort_by_angle(rel: np.ndarray) -> np.ndarray:
    """Ascending arctan(y/x) order (reference sort_points_by_angle)."""
    return np.argsort(np.arctan(rel[:, 1] / rel[:, 0]), kind="stable")


def _arc_large_flag(start, end, center):
    """Recover the SVG large-arc flag for a sweep-positive arc from start to
    end on the circle centred at `center` (split_cross.py:152-180)."""
    sv = start - center
    ev = end - center
    a = sv[1] / (sv[0] + 1e-7)
    if sv[0] > 0:  # start in 1st/4th quadrant
        return 0 if ev[1] > a * ev[0] else 1
    return 1 if ev[1] > a * ev[0] else 0


def split_circle(points: np.ndarray, circles: np.ndarray):
    """Split circles at incident points into arc runs.

    Returns (arcs [A, 9] rows x0 y0 x1 y1 rx ry rot large sweep,
             remaining_circles [C', 3]).
    """
    circles = np.asarray(circles, dtype=np.float64).reshape(-1, 3)
    points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    if len(circles) == 0:
        return np.zeros((0, 9)), circles

    arcs = []
    keep = []
    for ci, (cx, cy, r) in enumerate(circles):
        if len(points):
            r2 = (points[:, 0] - cx) ** 2 + (points[:, 1] - cy) ** 2
            on = np.abs(r2 - r * r) < CIRCLE_TH * CIRCLE_TH
            split_points = points[on]
        else:
            split_points = np.zeros((0, 2))
        if len(split_points) == 0:
            keep.append(ci)
            continue
        split_points = merge_close_points(split_points)

        center = np.array([cx, cy])
        if len(split_points) == 1:
            # a single incident point splits the circle at it and its
            # antipode (split_cross.py:106-109)
            rel = split_points - center
            split_points = np.concatenate([split_points, center - rel], axis=0)

        rel = split_points - center + 1e-7

        m14 = (rel[:, 0] > 0) & (rel[:, 1] != 0)  # 1st/4th quadrant (x>0)
        m14 = ((rel[:, 0] > 0) & (rel[:, 1] > 0)) | ((rel[:, 0] > 0) & (rel[:, 1] < 0))
        m2 = (rel[:, 0] < 0) & (rel[:, 1] > 0)
        m3 = (rel[:, 0] < 0) & (rel[:, 1] < 0)

        groups = []
        for mask in (m14, m2, m3):
            if mask.any():
                order = _sort_by_angle(rel[mask])
                groups.append(split_points[mask][order])
        sorted_pos = (
            np.concatenate(groups, axis=0) if groups else np.zeros((0, 2))
        )

        n = len(sorted_pos)
        for i in range(n):
            start = sorted_pos[i]
            end = sorted_pos[(i + 1) % n]
            large = _arc_large_flag(start, end, center)
            arcs.append([start[0], start[1], end[0], end[1], r, r, 0.0, float(large), 1.0])

    return np.asarray(arcs, dtype=np.float64).reshape(-1, 9), circles[keep]


def _points_on_line_batch(points, lines):
    """Vectorised _points_on_line over all lines at once -> bool [L, P].

    Same epsilon semantics (1px endpoint boxes keyed on the min/max corners
    — the reference's quirk — 3px distance, bbox projection containment);
    one [L, P] broadcast instead of a Python loop per line."""
    x = points[:, 0][None, :]
    y = points[:, 1][None, :]
    x0, y0 = lines[:, 0:1], lines[:, 1:2]
    x1, y1 = lines[:, 2:3], lines[:, 3:4]
    min_x, max_x = np.minimum(x0, x1), np.maximum(x0, x1)
    min_y, max_y = np.minimum(y0, y1), np.maximum(y0, y1)

    is_start_end = (
        (np.abs(x - min_x) <= 1) & (np.abs(y - min_y) <= 1)
    ) | ((np.abs(x - max_x) <= 1) & (np.abs(y - max_y) <= 1))

    vert = (x1 - x0) == 0
    dx = np.where(vert, 1.0, x1 - x0)
    a = (y1 - y0) / dx
    b = y0 - a * x0
    denom = a * a + 1
    d2 = np.where(vert, (x - x0) ** 2, (a * x - y + b) ** 2 / denom)
    x_proj = np.where(vert, x0, (a * (y - b) + x) / denom)
    y_proj = np.where(vert, y, a * x_proj + b)

    close = d2 < LINE_TH * LINE_TH
    within = (x_proj >= min_x) & (x_proj <= max_x) & \
        (y_proj >= min_y) & (y_proj <= max_y)
    return ~is_start_end & close & within


def split_line(points: np.ndarray, lines: np.ndarray) -> np.ndarray:
    """Split each line at candidate points lying on it. Returns [L', 4]."""
    lines = np.asarray(lines, dtype=np.float64).reshape(-1, 4)
    points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    if len(lines) and len(points):
        native = _native.split_lines_native(lines, points, LINE_TH, MERGE_TH)
        if native is not None:
            return native
    on_all = (
        _points_on_line_batch(points, lines)
        if len(points) and len(lines)
        else np.zeros((len(lines), len(points)), bool)
    )
    any_split = on_all.any(axis=1)
    out = []
    for li, (x0, y0, x1, y1) in enumerate(lines):
        if not any_split[li]:
            out.append([x0, y0, x1, y1])
            continue
        sp = points[on_all[li]]
        if len(sp) == 0:
            out.append([x0, y0, x1, y1])
            continue
        sp = merge_close_points(sp)
        sp = np.concatenate([[[x0, y0]], sp, [[x1, y1]]], axis=0)
        # order along the dominant axis (split_cross.py:296-306)
        if x1 == x0:
            sp = sp[np.argsort(sp[:, 1], kind="stable")]
        else:
            a = (y1 - y0) / (x1 - x0)
            axis = 1 if abs(a) > 0.5 else 0
            sp = sp[np.argsort(sp[:, axis], kind="stable")]
        for i in range(len(sp) - 1):
            out.append([sp[i, 0], sp[i, 1], sp[i + 1, 0], sp[i + 1, 1]])
    return np.asarray(out, dtype=np.float64).reshape(-1, 4)


def split_cross(shapes: list) -> dict:
    """Full split pass over a parsed shape list.

    Returns {'lines': [L,4], 'circles': [C,3], 'arcs': [A,9]} with circles
    split at incident line endpoints (appended to arcs) and lines split at
    each other's endpoints. Counterpart of split_cross
    (split_cross.py:323-389) — candidate split points are the *original*
    line endpoints in both passes, as in the reference.
    """
    prims = shapes_to_primitives(shapes)
    endpoints = prims["lines"].reshape(-1, 2)

    new_arcs, remaining_circles = split_circle(endpoints, prims["circles"])
    new_lines = split_line(endpoints, prims["lines"])

    arcs = prims["arcs"]
    if len(new_arcs):
        arcs = np.concatenate([arcs, new_arcs], axis=0) if len(arcs) else new_arcs

    return {"lines": new_lines, "circles": remaining_circles, "arcs": arcs}
