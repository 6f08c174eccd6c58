"""Synthetic SESYD-style SVG + annotation generator.

The SESYD Floorplans/Diagrams datasets are not redistributable with this
repo, so tests and benchmarks run on procedurally generated documents that
exercise the same primitive vocabulary (<line>, <circle>, arc <path>), the
same annotation schema (<a>/<o> tags with x0/y0/x1/y1/label children), and a
comparable structure: a large connected "wall" skeleton plus disconnected
symbols placed inside rooms.

This generalises the reference's only synthetic fixture
(Datasets/toy_dataset.py: circle/triangle/rectangle generator) into full
documents compatible with the end-to-end pipeline.

Port of `yolat_tpu/data/synthetic.py`: the floorplan, diagram and chart
writers and their class vocabularies, each drawing the same rng stream and
writing byte for byte the same files. The JAX package's module is
jax-free, but its package `__init__`s are not, so the port owns its own
copy of the host stage.
"""

from __future__ import annotations

import os

import numpy as np

# Symbol vocabulary: small parametric glyphs drawn from lines/circles/arcs.
# Class names reuse the floorplans dictionary of the reference
# (Datasets/graph_dict3.py:84-102) so class ids line up.
FLOORPLAN_CLASSES = {
    "armchair": 0,
    "bed": 1,
    "door1": 2,
    "door2": 3,
    "sink1": 4,
    "sink2": 5,
    "sink3": 6,
    "sink4": 7,
    "sofa1": 8,
    "sofa2": 9,
    "table1": 10,
    "table2": 11,
    "table3": 12,
    "tub": 13,
    "window1": 14,
    "window2": 15,
    "None": 16,
}

DIAGRAM_CLASSES = {
    "diode2": 0, "capacitor2": 1, "diode3": 2, "earth": 3, "battery1": 4,
    "battery2": 5, "core-iron": 6, "outlet": 7, "transistor-npn": 8,
    "capacitor1": 9, "resistor": 10, "relay": 11, "core-air": 12,
    "transistor-mosfetn": 13, "transistor-mosfetp": 14, "core-hiron": 15,
    "transistor-pnp": 16, "diode1": 17, "diodephoto": 18, "gate-ampli": 19,
    "unspecified": 20, "None": 21,
}


def _line(x1, y1, x2, y2):
    return f'<line x1="{x1:.6f}" y1="{y1:.6f}" x2="{x2:.6f}" y2="{y2:.6f}"/>'


def _circle(cx, cy, r):
    return f'<circle cx="{cx:.6f}" cy="{cy:.6f}" r="{r:.6f}"/>'


def _arc(x0, y0, x1, y1, r, large=0, sweep=1):
    return (
        f'<path d="M {x0:.6f} {y0:.6f} A {r:.6f} {r:.6f} 0 {large} {sweep} '
        f'{x1:.6f} {y1:.6f}"/>'
    )


# --- symbol glyphs -----------------------------------------------------------
# Each returns (list of svg element strings, (x0, y0, x1, y1) tight bbox).


def _glyph_rect_cross(x, y, w, h):
    el = [
        _line(x, y, x + w, y),
        _line(x + w, y, x + w, y + h),
        _line(x + w, y + h, x, y + h),
        _line(x, y + h, x, y),
        _line(x, y, x + w, y + h),
    ]
    return el, (x, y, x + w, y + h)


def _glyph_rect_circle(x, y, w, h):
    r = min(w, h) * 0.3
    el = [
        _line(x, y, x + w, y),
        _line(x + w, y, x + w, y + h),
        _line(x + w, y + h, x, y + h),
        _line(x, y + h, x, y),
        _circle(x + w / 2, y + h / 2, r),
    ]
    return el, (x, y, x + w, y + h)


def _glyph_door(x, y, w, h):
    # quarter-arc door swing: wall stub + arc
    r = min(w, h)
    el = [
        _line(x, y, x, y + r),
        _arc(x, y + r, x + r, y, r, large=0, sweep=1),
        _line(x, y, x + r, y),
    ]
    return el, (x, y, x + r, y + r)


def _glyph_table(x, y, w, h):
    el = [
        _line(x, y, x + w, y),
        _line(x + w, y, x + w, y + h),
        _line(x + w, y + h, x, y + h),
        _line(x, y + h, x, y),
        _line(x + w * 0.2, y, x + w * 0.2, y + h),
        _line(x + w * 0.8, y, x + w * 0.8, y + h),
    ]
    return el, (x, y, x + w, y + h)


def _glyph_sink(x, y, w, h):
    r = min(w, h) * 0.35
    cx, cy = x + w / 2, y + h / 2
    el = [
        _line(x, y, x + w, y),
        _line(x + w, y, x + w, y + h),
        _line(x + w, y + h, x, y + h),
        _line(x, y + h, x, y),
        _circle(cx, cy, r),
        _line(cx - r, cy, cx + r, cy),
    ]
    return el, (x, y, x + w, y + h)


def _glyph_sofa(x, y, w, h):
    el = [
        _line(x, y, x + w, y),
        _line(x + w, y, x + w, y + h),
        _line(x + w, y + h, x, y + h),
        _line(x, y + h, x, y),
        _line(x, y + h * 0.3, x + w, y + h * 0.3),
        _line(x + w * 0.5, y + h * 0.3, x + w * 0.5, y + h),
    ]
    return el, (x, y, x + w, y + h)


def _glyph_tub(x, y, w, h):
    r = min(w, h) * 0.25
    el = [
        _line(x, y, x + w, y),
        _line(x + w, y, x + w, y + h),
        _line(x + w, y + h, x, y + h),
        _line(x, y + h, x, y),
        _circle(x + w * 0.25, y + h / 2, r),
        _line(x + w * 0.55, y + h * 0.25, x + w * 0.85, y + h * 0.25),
        _line(x + w * 0.55, y + h * 0.75, x + w * 0.85, y + h * 0.75),
    ]
    return el, (x, y, x + w, y + h)


GLYPHS = {
    "armchair": _glyph_rect_cross,
    "bed": _glyph_rect_circle,
    "door1": _glyph_door,
    "table1": _glyph_table,
    "sink1": _glyph_sink,
    "sofa1": _glyph_sofa,
    "tub": _glyph_tub,
}


def generate_floorplan(rng: np.random.Generator, width: float = 2000.0,
                       height: float = 1500.0, n_rooms: int = 4,
                       symbols_per_room=(1, 3)):
    """Generate one synthetic floorplan.

    Returns (svg_text, xml_text, gt_boxes_px [G,4], gt_labels [G]).
    """
    elements = []
    boxes, labels = [], []

    margin = 60.0
    x0, y0 = margin, margin
    x1, y1 = width - margin, height - margin

    # outer walls
    elements += [
        _line(x0, y0, x1, y0),
        _line(x1, y0, x1, y1),
        _line(x1, y1, x0, y1),
        _line(x0, y1, x0, y0),
    ]

    # room partitions: vertical splits crossing the full plan (these cross
    # the outer walls' interiors, exercising split_line)
    n_cols = max(2, int(np.ceil(np.sqrt(n_rooms))))
    col_w = (x1 - x0) / n_cols
    for c in range(1, n_cols):
        xc = x0 + c * col_w
        elements.append(_line(xc, y0, xc, y1))
    yc = (y0 + y1) / 2
    elements.append(_line(x0, yc, x1, yc))

    cells = []
    for c in range(n_cols):
        for rrow in range(2):
            cells.append(
                (
                    x0 + c * col_w,
                    y0 + rrow * (y1 - y0) / 2,
                    x0 + (c + 1) * col_w,
                    y0 + (rrow + 1) * (y1 - y0) / 2,
                )
            )

    # Sweep-aware symbol placement. The canonical bbox_sampling_step=10
    # grid has pitch extent/10; a sweep window can isolate a symbol from
    # the wall skeleton (and from its neighbours) only when a grid line
    # falls in the surrounding clearance, i.e. clearance > pitch. Real
    # SESYD floorplans have symbols at this relative scale, which is why
    # step 10 suffices there — mirror that: wall clearance ~extent/9 and
    # symbol sizes proportional to the remaining cell interior.
    pad_x = (x1 - x0) / 9.0
    pad_y = (y1 - y0) / 9.0
    glyph_names = list(GLYPHS.keys())
    for cell in cells:
        cx0, cy0, cx1, cy1 = cell
        avail_w = (cx1 - cx0) - 2 * pad_x
        avail_h = (cy1 - cy0) - 2 * pad_y
        if avail_w < 50 or avail_h < 50:
            continue
        n_sym = int(rng.integers(symbols_per_room[0], symbols_per_room[1] + 1))
        placed: list = []
        for _ in range(n_sym):
            name = glyph_names[int(rng.integers(len(glyph_names)))]
            w = float(rng.uniform(0.35, 0.8) * avail_w)
            h = float(rng.uniform(0.35, 0.8) * avail_h)
            for _attempt in range(8):
                gx = float(rng.uniform(cx0 + pad_x, cx1 - pad_x - w))
                gy = float(rng.uniform(cy0 + pad_y, cy1 - pad_y - h))
                # a window around one symbol excludes another iff they are
                # separated by more than a grid pitch on some axis
                ok = all(
                    (gx > bx1 + pad_x or bx0 > gx + w + pad_x)
                    or (gy > by1 + pad_y or by0 > gy + h + pad_y)
                    for (bx0, by0, bx1, by1) in placed
                )
                if ok:
                    break
            else:
                continue
            el, bb = GLYPHS[name](gx, gy, w, h)
            elements += el
            boxes.append(bb)
            labels.append(name)
            placed.append(bb)

    if not boxes:
        # tiny scenes where no cell clears the clearance: place one
        # best-effort symbol so every image has ground truth
        cx0, cy0, cx1, cy1 = max(
            cells, key=lambda c: (c[2] - c[0]) * (c[3] - c[1])
        )
        w = (cx1 - cx0) * 0.5
        h = (cy1 - cy0) * 0.5
        gx, gy = cx0 + (cx1 - cx0 - w) / 2, cy0 + (cy1 - cy0 - h) / 2
        name = glyph_names[int(rng.integers(len(glyph_names)))]
        el, bb = GLYPHS[name](gx, gy, w, h)
        elements += el
        boxes.append(bb)
        labels.append(name)

    svg = (
        '<?xml version="1.0"?>\n'
        f'<svg xmlns="http://www.w3.org/2000/svg" stroke="black" stroke-width="3">\n'
        f'<image width="{width:.1f}" height="{height:.1f}"/>\n'
        + "\n".join(elements)
        + "\n</svg>\n"
    )

    ann = ['<?xml version="1.0"?>', "<data>", "<o>"]
    for (bx0, by0, bx1, by1), name in zip(boxes, labels):
        ann.append(
            f'<object x0="{bx0:.6f}" y0="{by0:.6f}" x1="{bx1:.6f}" y1="{by1:.6f}" '
            f'label="{name}"/>'
        )
    ann += ["</o>", "</data>", ""]

    gt = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    gt_labels = np.asarray([FLOORPLAN_CLASSES[n] for n in labels], dtype=np.int64)
    return svg, "\n".join(ann), gt, gt_labels


DIAGRAM_GLYPHS = {
    "resistor": lambda x, y, w, h: (
        [
            _line(x, y + h / 2, x + 0.2 * w, y + h / 2),
            _line(x + 0.2 * w, y, x + 0.8 * w, y),
            _line(x + 0.8 * w, y, x + 0.8 * w, y + h),
            _line(x + 0.8 * w, y + h, x + 0.2 * w, y + h),
            _line(x + 0.2 * w, y + h, x + 0.2 * w, y),
            _line(x + 0.8 * w, y + h / 2, x + w, y + h / 2),
        ],
        (x, y, x + w, y + h),
    ),
    "capacitor1": lambda x, y, w, h: (
        [
            _line(x, y + h / 2, x + 0.45 * w, y + h / 2),
            _line(x + 0.45 * w, y, x + 0.45 * w, y + h),
            _line(x + 0.55 * w, y, x + 0.55 * w, y + h),
            _line(x + 0.55 * w, y + h / 2, x + w, y + h / 2),
        ],
        (x, y, x + w, y + h),
    ),
    "diode1": lambda x, y, w, h: (
        [
            _line(x, y + h / 2, x + 0.3 * w, y + h / 2),
            _line(x + 0.3 * w, y, x + 0.3 * w, y + h),
            _line(x + 0.3 * w, y, x + 0.7 * w, y + h / 2),
            _line(x + 0.3 * w, y + h, x + 0.7 * w, y + h / 2),
            _line(x + 0.7 * w, y, x + 0.7 * w, y + h),
            _line(x + 0.7 * w, y + h / 2, x + w, y + h / 2),
        ],
        (x, y, x + w, y + h),
    ),
    "earth": lambda x, y, w, h: (
        [
            _line(x + w / 2, y, x + w / 2, y + 0.4 * h),
            _line(x, y + 0.4 * h, x + w, y + 0.4 * h),
            _line(x + 0.2 * w, y + 0.7 * h, x + 0.8 * w, y + 0.7 * h),
            _line(x + 0.4 * w, y + h, x + 0.6 * w, y + h),
        ],
        (x, y, x + w, y + h),
    ),
    "core-air": lambda x, y, w, h: (
        [_circle(x + w / 2, y + h / 2, min(w, h) * 0.45)],
        (x, y, x + w, y + h),
    ),
}


def generate_diagram(rng: np.random.Generator, width: float = 1500.0,
                     height: float = 1000.0, n_symbols: int = 8):
    """Synthetic diagram: disconnected electrical glyphs (the mergeCluster
    preprocessing path of build_graph_bbox_diagram.py)."""
    elements, boxes, labels = [], [], []
    names = list(DIAGRAM_GLYPHS)
    cols = int(np.ceil(np.sqrt(n_symbols)))
    cw, ch = (width - 100) / cols, (height - 100) / cols
    k = 0
    for r in range(cols):
        for c in range(cols):
            if k >= n_symbols:
                break
            name = names[int(rng.integers(len(names)))]
            w = float(rng.uniform(100, min(200, cw - 60)))
            h = float(rng.uniform(60, min(120, ch - 60)))
            gx = 50 + c * cw + float(rng.uniform(0, max(cw - w - 50, 1)))
            gy = 50 + r * ch + float(rng.uniform(0, max(ch - h - 50, 1)))
            el, bb = DIAGRAM_GLYPHS[name](gx, gy, w, h)
            elements += el
            boxes.append(bb)
            labels.append(name)
            k += 1

    svg = (
        '<?xml version="1.0"?>\n'
        '<svg xmlns="http://www.w3.org/2000/svg" stroke="black" stroke-width="3">\n'
        f'<image width="{width:.1f}" height="{height:.1f}"/>\n'
        + "\n".join(elements)
        + "\n</svg>\n"
    )
    ann = ['<?xml version="1.0"?>', "<data>", "<o>"]
    for (bx0, by0, bx1, by1), name in zip(boxes, labels):
        ann.append(
            f'<object x0="{bx0:.6f}" y0="{by0:.6f}" x1="{bx1:.6f}" y1="{by1:.6f}" '
            f'label="{name}"/>'
        )
    ann += ["</o>", "</data>", ""]
    gt = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    gt_labels = np.asarray([DIAGRAM_CLASSES[n] for n in labels], dtype=np.int64)
    return svg, "\n".join(ann), gt, gt_labels


def write_diagram_dataset(root: str, n_train: int = 4, n_test: int = 2,
                          seed: int = 0, **kwargs) -> None:
    """SESYD diagrams layout: <root>/diagrams-syn/... ('diagram' in the dir
    name drives the class dictionary, graph_dict3.py:57)."""
    rng = np.random.default_rng(seed)
    sub = "diagrams-syn"
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = {"train": [], "test": []}
    for split, n in (("train", n_train), ("test", n_test)):
        for i in range(n):
            name = f"{sub}/file_{split}_{i}"
            svg, xml, _, _ = generate_diagram(rng, **kwargs)
            with open(os.path.join(root, name + ".svg"), "w") as f:
                f.write(svg)
            with open(os.path.join(root, name + ".xml"), "w") as f:
                f.write(xml)
            names[split].append(name + ".svg")
    for split in ("train", "test"):
        with open(os.path.join(root, f"{split}_list.txt"), "w") as f:
            f.write("\n".join(names[split]) + "\n")


# --- chart vector graphics (BASELINE.json configs[5]: "Large-batch chart
# VG detection (VGDCU-style) with ICI data-parallel training") -------------
# Line/bar charts as pure vector line art: axis frame + ticks (one connected
# skeleton, like floorplan walls), polyline series whose segments stop short
# of the data markers (markers are separate CCs, like diagram glyphs), bars
# standing on the x-axis (connected to the skeleton — isolated by the
# proposal sweep), and a legend box containing a marker (exercises
# mergeCC's 90%-containment cross-CC merge, build_graph_bbox.py:130-160).
# Detection targets: the markers, bars, and legend box.

CHART_CLASSES = {
    "marker-circle": 0,
    "marker-square": 1,
    "marker-triangle": 2,
    "marker-diamond": 3,
    "bar": 4,
    "legend-box": 5,
    "None": 6,
}


def _marker(name: str, cx: float, cy: float, r: float):
    if name == "marker-circle":
        return [_circle(cx, cy, r)], (cx - r, cy - r, cx + r, cy + r)
    if name == "marker-square":
        el = [
            _line(cx - r, cy - r, cx + r, cy - r),
            _line(cx + r, cy - r, cx + r, cy + r),
            _line(cx + r, cy + r, cx - r, cy + r),
            _line(cx - r, cy + r, cx - r, cy - r),
        ]
        return el, (cx - r, cy - r, cx + r, cy + r)
    if name == "marker-triangle":
        el = [
            _line(cx - r, cy + r, cx + r, cy + r),
            _line(cx + r, cy + r, cx, cy - r),
            _line(cx, cy - r, cx - r, cy + r),
        ]
        return el, (cx - r, cy - r, cx + r, cy + r)
    # diamond
    el = [
        _line(cx - r, cy, cx, cy - r),
        _line(cx, cy - r, cx + r, cy),
        _line(cx + r, cy, cx, cy + r),
        _line(cx, cy + r, cx - r, cy),
    ]
    return el, (cx - r, cy - r, cx + r, cy + r)


def generate_chart(rng: np.random.Generator, width: float = 1600.0,
                   height: float = 1200.0, n_series: int = 2,
                   points_per_series: int = 5, n_bars: int = 0):
    """Generate one synthetic chart. n_bars > 0 adds a bar group standing
    on the x-axis. Returns (svg_text, xml_text, gt_boxes_px, gt_labels)."""
    elements, boxes, labels = [], [], []
    m = 120.0  # outer margin
    x0, y0, x1, y1 = m, m, width - m, height - m

    # axis frame: y-axis + x-axis + ticks (one connected skeleton)
    elements += [_line(x0, y0, x0, y1), _line(x0, y1, x1, y1)]
    n_ticks = 6
    for t in range(1, n_ticks):
        xt = x0 + t * (x1 - x0) / n_ticks
        elements.append(_line(xt, y1, xt, y1 + 18))
        yt = y1 - t * (y1 - y0) / n_ticks
        elements.append(_line(x0 - 18, yt, x0, yt))

    marker_names = ["marker-circle", "marker-square", "marker-triangle",
                    "marker-diamond"]
    # marker radius: large enough that a step-10 sweep window can isolate a
    # marker from the polyline (clearance > grid pitch, the sweep-aware
    # placement rule of generate_floorplan)
    r = min(x1 - x0, y1 - y0) / 16.0

    used = []
    for s in range(n_series):
        name = marker_names[int(rng.integers(len(marker_names)))]
        xs = np.linspace(x0 + 2.5 * r, x1 - 2.5 * r, points_per_series)
        ys = rng.uniform(y0 + 2.5 * r, y1 - 2.5 * r, points_per_series)
        # keep vertical separation from other series so windows isolate
        for _ in range(12):
            clear = all(
                np.abs(ys - oys).min() > 2.8 * r for oys in used
            ) if used else True
            if clear:
                break
            ys = rng.uniform(y0 + 2.5 * r, y1 - 2.5 * r, points_per_series)
        used.append(ys)
        for k in range(points_per_series):
            el, bb = _marker(name, float(xs[k]), float(ys[k]), r)
            elements += el
            boxes.append(bb)
            labels.append(name)
            if k + 1 < points_per_series:
                # segment from marker edge to next marker edge (markers stay
                # their own CCs; gap > merge_nodes epsilon by construction)
                dx, dy = xs[k + 1] - xs[k], ys[k + 1] - ys[k]
                d = float(np.hypot(dx, dy))
                ux, uy = dx / d, dy / d
                gap = 1.35 * r
                elements.append(_line(xs[k] + ux * gap, ys[k] + uy * gap,
                                      xs[k + 1] - ux * gap,
                                      ys[k + 1] - uy * gap))

    if n_bars > 0:
        # bar group standing on the x-axis (merges into the axis skeleton;
        # the grid sweep must isolate each bar: width/gaps > pitch)
        slot = (x1 - x0) / (2 * n_bars + 1)
        for bkk in range(n_bars):
            bx = x0 + (2 * bkk + 1) * slot
            bw = slot
            bh = float(rng.uniform(0.25, 0.85) * (y1 - y0 - 3 * r))
            el = [
                _line(bx, y1, bx, y1 - bh),
                _line(bx, y1 - bh, bx + bw, y1 - bh),
                _line(bx + bw, y1 - bh, bx + bw, y1),
            ]
            elements += el
            boxes.append((bx, y1 - bh, bx + bw, y1))
            labels.append("bar")

    # legend: a box in the top-right with a marker inside (mergeCC
    # containment: the marker CC is 100%-contained by the box CC)
    lw, lh = 4.5 * r, 3 * r
    lx, ly = x1 - lw - r, y0 + r
    elements += [
        _line(lx, ly, lx + lw, ly),
        _line(lx + lw, ly, lx + lw, ly + lh),
        _line(lx + lw, ly + lh, lx, ly + lh),
        _line(lx, ly + lh, lx, ly),
    ]
    boxes.append((lx, ly, lx + lw, ly + lh))
    labels.append("legend-box")
    name = marker_names[int(rng.integers(len(marker_names)))]
    el, bb = _marker(name, lx + lh / 2, ly + lh / 2, r * 0.6)
    elements += el
    boxes.append(bb)
    labels.append(name)

    svg = (
        '<?xml version="1.0"?>\n'
        '<svg xmlns="http://www.w3.org/2000/svg" stroke="black" stroke-width="3">\n'
        f'<image width="{width:.1f}" height="{height:.1f}"/>\n'
        + "\n".join(elements)
        + "\n</svg>\n"
    )
    ann = ['<?xml version="1.0"?>', "<data>", "<o>"]
    for (bx0, by0, bx1, by1), nm in zip(boxes, labels):
        ann.append(
            f'<object x0="{bx0:.6f}" y0="{by0:.6f}" x1="{bx1:.6f}" y1="{by1:.6f}" '
            f'label="{nm}"/>'
        )
    ann += ["</o>", "</data>", ""]
    gt = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    gt_labels = np.asarray([CHART_CLASSES[n] for n in labels], dtype=np.int64)
    return svg, "\n".join(ann), gt, gt_labels


def write_chart_dataset(root: str, n_train: int = 8, n_test: int = 4,
                        seed: int = 0, bar_fraction: float = 0.5,
                        **kwargs) -> None:
    """Chart layout: <root>/charts-syn/... ('chart' in the dir name drives
    the class dictionary, same convention as diagrams)."""
    rng = np.random.default_rng(seed)
    sub = "charts-syn"
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = {"train": [], "test": []}
    for split, n in (("train", n_train), ("test", n_test)):
        for i in range(n):
            name = f"{sub}/file_{split}_{i}"
            n_bars = 4 if rng.uniform() < bar_fraction else 0
            svg, xml, _, _ = generate_chart(rng, n_bars=n_bars, **kwargs)
            with open(os.path.join(root, name + ".svg"), "w") as f:
                f.write(svg)
            with open(os.path.join(root, name + ".xml"), "w") as f:
                f.write(xml)
            names[split].append(name + ".svg")
    for split in ("train", "test"):
        with open(os.path.join(root, f"{split}_list.txt"), "w") as f:
            f.write("\n".join(names[split]) + "\n")


def write_dataset(root: str, n_train: int = 8, n_test: int = 4, seed: int = 0,
                  **kwargs) -> None:
    """Materialise a synthetic dataset with the SESYD directory layout:
    <root>/<subdir>/file_N.svg + file_N.xml and <root>/{train,test}_list.txt.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "floorplans-syn"), exist_ok=True)
    names = {"train": [], "test": []}
    for split, n in (("train", n_train), ("test", n_test)):
        for i in range(n):
            name = f"floorplans-syn/file_{split}_{i}"
            svg, xml, _, _ = generate_floorplan(rng, **kwargs)
            with open(os.path.join(root, name + ".svg"), "w") as f:
                f.write(svg)
            with open(os.path.join(root, name + ".xml"), "w") as f:
                f.write(xml)
            names[split].append(name + ".svg")
    for split in ("train", "test"):
        with open(os.path.join(root, f"{split}_list.txt"), "w") as f:
            f.write("\n".join(names[split]) + "\n")
