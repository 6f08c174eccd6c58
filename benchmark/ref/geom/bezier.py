# Frozen copy of yolat_tpu_torch/geom/bezier.py at commit 8dc2b5b (the
# benchmark's yardstick: later changes to the program do not reach it).
# Only the imports differ: they point into benchmark.ref.geom, and the host
# library's entry points are stubs that return None, so every call takes
# the numpy path (the program's `_native.disabled()` oracle).
"""Primitive -> cubic-Bezier normalisation.

Equivalent of the reference BezierParser (Datasets/bezier_parser.py): every
supported primitive becomes a run of cubic segments stored as a single
float64 array [S, 4, 2] with rows (start, control1, control2, end).

Conventions preserved from the reference:
  * line -> one degenerate cubic with control1=start, control2=end
    (bezier_parser.py:62-71);
  * circle -> four quadrant cubics starting at the top point (cx, cy-r),
    clockwise in image coords, with kappa = 0.552284749831
    (bezier_parser.py:98-135);
  * arc -> a2c conversion (<=90 degree splits).

Port of `yolat_tpu/geom/bezier.py:1-149`, carried unchanged: the JAX
package's module is jax-free, but its package `__init__`s are not, so the
port owns its own copy of the host stage.
"""

from __future__ import annotations

import numpy as np

from benchmark.ref.geom.arc2bezier import arc_to_cubics
from benchmark.ref.geom.svg_io import ARC, CUBIC, LINE, QUAD, UnsupportedSVGError, parse_path_d

KAPPA = 0.552284749831


def line_to_cubic(x1, y1, x2, y2) -> np.ndarray:
    seg = np.array([[[x1, y1], [x1, y1], [x2, y2], [x2, y2]]], dtype=np.float64)
    return seg


def circle_to_cubics(cx, cy, r) -> np.ndarray:
    m = r * KAPPA
    return np.array(
        [
            # top -> right
            [[cx, cy - r], [cx + m, cy - r], [cx + r, cy - m], [cx + r, cy]],
            # right -> bottom
            [[cx + r, cy], [cx + r, cy + m], [cx + m, cy + r], [cx, cy + r]],
            # bottom -> left
            [[cx, cy + r], [cx - m, cy + r], [cx - r, cy + m], [cx - r, cy]],
            # left -> top
            [[cx - r, cy], [cx - r, cy - m], [cx - m, cy - r], [cx, cy - r]],
        ],
        dtype=np.float64,
    )


def quad_to_cubic(x0, y0, cx, cy, x1, y1) -> np.ndarray:
    """Exact degree elevation of a quadratic Bezier to a cubic."""
    c1 = (x0 + 2.0 * cx) / 3.0, (y0 + 2.0 * cy) / 3.0
    c2 = (x1 + 2.0 * cx) / 3.0, (y1 + 2.0 * cy) / 3.0
    return np.array([[[x0, y0], [c1[0], c1[1]], [c2[0], c2[1]], [x1, y1]]], dtype=np.float64)


def path_to_cubics(d: str) -> np.ndarray:
    """SVG path "d" string -> cubic segment array [S, 4, 2].

    Counterpart of BezierParser.path2BezierPath (bezier_parser.py:79-96),
    which accepts Line and Arc path elements; we additionally pass through
    genuine cubic/quadratic path segments.
    """
    out = []
    for kind, p in parse_path_d(d):
        if kind == LINE:
            out.append(line_to_cubic(*p))
        elif kind == ARC:
            x0, y0, x1, y1, rx, ry, rot, fa, fs = p
            out.append(arc_to_cubics(x0, y0, x1, y1, rx, ry, rot, fa, fs))
        elif kind == CUBIC:
            out.append(np.asarray(p, dtype=np.float64).reshape(1, 4, 2))
        elif kind == QUAD:
            out.append(quad_to_cubic(*p))
        else:  # pragma: no cover - parse_path_d only emits the kinds above
            raise UnsupportedSVGError(f"unhandled path segment kind {kind}")
    if not out:
        return np.zeros((0, 4, 2))
    return np.concatenate(out, axis=0)


def shape_to_cubics(shape: dict) -> np.ndarray:
    """One parsed shape dict (from SVGDocument) -> cubics [S, 4, 2]."""
    name = shape["shape_name"]
    if name == "line":
        return line_to_cubic(
            float(shape["x1"]), float(shape["y1"]), float(shape["x2"]), float(shape["y2"])
        )
    if name == "circle":
        return circle_to_cubics(float(shape["cx"]), float(shape["cy"]), float(shape["r"]))
    if name == "path":
        return path_to_cubics(shape["d"])
    raise UnsupportedSVGError(f"shape not implemented: {name}")


def shapes_to_primitives(shapes: list) -> dict:
    """Bucket parsed shapes into typed primitive arrays for split_cross.

    Counterpart of the bucketing prologue of split_cross
    (utils/svg_utils/split_cross.py:323-373). Output dict:
      lines   [L, 4]  x0 y0 x1 y1
      circles [C, 3]  cx cy r
      arcs    [A, 9]  x0 y0 x1 y1 rx ry rot large_arc sweep
    Path elements must decompose into lines/arcs only (the SESYD contract);
    anything else raises.
    """
    lines, circles, arcs = [], [], []
    for shape in shapes:
        name = shape["shape_name"]
        if name == "line":
            lines.append(
                [float(shape["x1"]), float(shape["y1"]), float(shape["x2"]), float(shape["y2"])]
            )
        elif name == "circle":
            circles.append([float(shape["cx"]), float(shape["cy"]), float(shape["r"])])
        elif name == "path":
            for kind, p in parse_path_d(shape["d"]):
                if kind == LINE:
                    lines.append(list(p))
                elif kind == ARC:
                    arcs.append(list(p))
                else:
                    raise UnsupportedSVGError(
                        f"path segment kind {kind} not supported in primitive bucketing"
                    )
        else:
            raise UnsupportedSVGError(f"shape not implemented: {name}")
    return {
        "lines": np.asarray(lines, dtype=np.float64).reshape(-1, 4),
        "circles": np.asarray(circles, dtype=np.float64).reshape(-1, 3),
        "arcs": np.asarray(arcs, dtype=np.float64).reshape(-1, 9),
    }


def primitives_to_cubics(prims: dict) -> np.ndarray:
    """Typed primitive arrays -> one concatenated cubic path [S, 4, 2].

    Counterpart of shape2Path (utils/svg_utils/build_graph_bbox.py:21-51):
    lines first, then arcs, then circles — order preserved because node ids
    downstream depend on it.
    """
    out = []
    for x0, y0, x1, y1 in prims["lines"]:
        out.append(line_to_cubic(x0, y0, x1, y1))
    for x0, y0, x1, y1, rx, ry, rot, fa, fs in prims["arcs"]:
        out.append(arc_to_cubics(x0, y0, x1, y1, rx, ry, rot, fa, fs))
    for cx, cy, r in prims["circles"]:
        out.append(circle_to_cubics(cx, cy, r))
    if not out:
        return np.zeros((0, 4, 2))
    return np.concatenate(out, axis=0)
