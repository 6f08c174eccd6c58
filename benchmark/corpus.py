"""The benchmark's corpus: synthetic SESYD-style floorplans, SVG and
annotation XML, written from a seed.

Frozen copy of the floorplan writer of yolat_tpu_torch/data/synthetic.py at
commit 8dc2b5b (`FLOORPLAN_CLASSES`, the glyphs, `generate_floorplan`), so
that later changes to the program do not change the traffic. `write_corpus`
lays the files out as the program's `SESYDDataset` reads them.
"""

from __future__ import annotations

import os

import numpy as np

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


def write_corpus(root: str, n_files: int, seed: int, width: float,
                 height: float, n_rooms: int, symbols_per_room) -> list:
    """Write `n_files` floorplans drawn from one rng seeded by `seed` under
    `root` (floorplans/file_<i>.svg and .xml, and train_list.txt); returns
    the SVG paths in list order."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "floorplans"), exist_ok=True)
    names = []
    for i in range(n_files):
        name = f"floorplans/file_{i}"
        svg, xml, _, _ = generate_floorplan(rng, width=width, height=height,
                                            n_rooms=n_rooms,
                                            symbols_per_room=symbols_per_room)
        with open(os.path.join(root, name + ".svg"), "w") as f:
            f.write(svg)
        with open(os.path.join(root, name + ".xml"), "w") as f:
            f.write(xml)
        names.append(name + ".svg")
    with open(os.path.join(root, "train_list.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return [os.path.join(root, n) for n in names]
