# Frozen copy of yolat_tpu_torch/geom/arc2bezier.py at commit 8dc2b5b (the
# benchmark's yardstick: later changes to the program do not reach it).
# Only the imports differ: they point into benchmark.ref.geom, and the host
# library's entry points are stubs that return None, so every call takes
# the numpy path (the program's `_native.disabled()` oracle).
"""Elliptical arc -> cubic Bezier conversion (SVG endpoint parameterisation).

Standard math from the SVG 1.1 implementation notes (W3C, F.6) plus the
classic 4/3*tan(theta/4) unit-arc approximation; behaviourally equivalent to
the converter used by the reference (Datasets/a2c.py, itself a port of
fontello/svgpath). Arcs are split into <=90 degree segments so each cubic is
an accurate approximation.

Output convention here: a float64 array of cubic segments [K, 4, 2] with rows
(start, control1, control2, end), endpoints pinned exactly to the input
endpoints the way the reference does when assembling the path
(Datasets/bezier_parser.py:36-58).

Port of `yolat_tpu/geom/arc2bezier.py:1-122`, carried unchanged: the JAX
package's module is jax-free, but its package `__init__`s are not, so the
port owns its own copy of the host stage.
"""

from __future__ import annotations

import math

import numpy as np

TAU = 2.0 * math.pi


def _angle_between(ux, uy, vx, vy):
    """Signed angle between two (not-necessarily-unit) radius vectors."""
    sign = -1.0 if (ux * vy - uy * vx) < 0 else 1.0
    dot = ux * vx + uy * vy
    dot = min(1.0, max(-1.0, dot))
    return sign * math.acos(dot)


def _arc_center(x1, y1, x2, y2, fa, fs, rx, ry, sin_phi, cos_phi):
    """Endpoint -> center parameterisation (W3C F.6.5). Returns cx, cy,
    theta1, delta_theta with radius vectors already normalised by rx/ry."""
    x1p = cos_phi * (x1 - x2) / 2 + sin_phi * (y1 - y2) / 2
    y1p = -sin_phi * (x1 - x2) / 2 + cos_phi * (y1 - y2) / 2

    rx_sq, ry_sq = rx * rx, ry * ry
    x1p_sq, y1p_sq = x1p * x1p, y1p * y1p

    radicant = rx_sq * ry_sq - rx_sq * y1p_sq - ry_sq * x1p_sq
    radicant = max(radicant, 0.0)  # clamp rounding error
    radicant /= rx_sq * y1p_sq + ry_sq * x1p_sq
    factor = -1.0 if fa == fs else 1.0
    radicant = math.sqrt(radicant) * factor

    cxp = radicant * rx / ry * y1p
    cyp = radicant * -ry / rx * x1p

    cx = cos_phi * cxp - sin_phi * cyp + (x1 + x2) / 2
    cy = sin_phi * cxp + cos_phi * cyp + (y1 + y2) / 2

    v1x, v1y = (x1p - cxp) / rx, (y1p - cyp) / ry
    v2x, v2y = (-x1p - cxp) / rx, (-y1p - cyp) / ry

    theta1 = _angle_between(1.0, 0.0, v1x, v1y)
    delta = _angle_between(v1x, v1y, v2x, v2y)

    if fs == 0 and delta > 0:
        delta -= TAU
    if fs == 1 and delta < 0:
        delta += TAU
    return cx, cy, theta1, delta


def _unit_arc_cubic(theta1, delta):
    """One cubic approximating the unit-circle arc [theta1, theta1+delta]."""
    alpha = 4.0 / 3.0 * math.tan(delta / 4.0)
    x1, y1 = math.cos(theta1), math.sin(theta1)
    x2, y2 = math.cos(theta1 + delta), math.sin(theta1 + delta)
    return np.array(
        [
            [x1, y1],
            [x1 - y1 * alpha, y1 + x1 * alpha],
            [x2 + y2 * alpha, y2 - x2 * alpha],
            [x2, y2],
        ]
    )


def arc_to_cubics(x1, y1, x2, y2, rx, ry, phi_deg, large_arc, sweep) -> np.ndarray:
    """Convert one SVG arc to cubic segments [K, 4, 2].

    Degenerate arcs (coincident endpoints or zero radius) yield K=0, matching
    the reference converter's early-outs (a2c.py:129-135).
    """
    fa = 1 if large_arc else 0
    fs = 1 if sweep else 0
    sin_phi = math.sin(phi_deg * TAU / 360.0)
    cos_phi = math.cos(phi_deg * TAU / 360.0)

    x1p = cos_phi * (x1 - x2) / 2 + sin_phi * (y1 - y2) / 2
    y1p = -sin_phi * (x1 - x2) / 2 + cos_phi * (y1 - y2) / 2
    if (x1p == 0 and y1p == 0) or rx == 0 or ry == 0:
        return np.zeros((0, 4, 2))

    rx, ry = abs(rx), abs(ry)
    lam = (x1p * x1p) / (rx * rx) + (y1p * y1p) / (ry * ry)
    if lam > 1:
        s = math.sqrt(lam)
        rx *= s
        ry *= s

    cx, cy, theta1, delta = _arc_center(x1, y1, x2, y2, fa, fs, rx, ry, sin_phi, cos_phi)

    n_seg = max(int(math.ceil(abs(delta) / (TAU / 4))), 1)
    delta /= n_seg

    out = np.empty((n_seg, 4, 2))
    for k in range(n_seg):
        unit = _unit_arc_cubic(theta1 + k * delta, delta)
        # scale -> rotate -> translate back to the original ellipse
        sx = unit[:, 0] * rx
        sy = unit[:, 1] * ry
        out[k, :, 0] = cos_phi * sx - sin_phi * sy + cx
        out[k, :, 1] = sin_phi * sx + cos_phi * sy + cy

    # Pin exact endpoints (bezier_parser.py:36-55 does the same when
    # rebuilding the path: first start / last end come from the arc itself).
    out[0, 0] = (x1, y1)
    out[-1, 3] = (x2, y2)
    return out
