# Frozen copy of yolat_tpu_torch/geom/svg_io.py at commit 8dc2b5b (the
# benchmark's yardstick: later changes to the program do not reach it).
# Only the imports differ: they point into benchmark.ref.geom, and the host
# library's entry points are stubs that return None, so every call takes
# the numpy path (the program's `_native.disabled()` oracle).
"""SVG and ground-truth XML ingestion.

Re-derivation of the reference's L0 ingestion (SVGParser at
Datasets/svg_parser.py:765-805 and the GT reader at
Datasets/graph_dict3.py:129-151), with a self-contained SVG path-data
tokenizer replacing the svgpathtools dependency (not available here and not
needed: SESYD uses only line/circle/arc-path primitives; the tokenizer is
nonetheless general over M/L/H/V/C/S/Q/T/A/Z).

All geometry is returned as plain numpy arrays / dicts; no torch, no device.

Port of `yolat_tpu/geom/svg_io.py:1-294`, carried unchanged: the JAX
package's module is jax-free, but its package `__init__`s are not, so the
port owns its own copy of the host stage.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass, field

import numpy as np

SUPPORTED_SHAPES = ("line", "path", "circle")
# Container / non-geometry nodes silently skipped during traversal
# (reference: filtered_nodename, svg_parser.py:770).
FILTERED_NODES = ("image", "g", "defs", "svg", "title", "desc")


class UnsupportedSVGError(ValueError):
    """Raised on SVG content outside the supported primitive set."""


@dataclass
class SVGDocument:
    """A parsed SVG: flat shape list with inherited attributes + image size."""

    shapes: list = field(default_factory=list)
    width: float = 0.0
    height: float = 0.0

    @classmethod
    def from_file(cls, filepath: str) -> "SVGDocument":
        import xml.etree.ElementTree as ET

        return cls._from_root(ET.parse(str(filepath)).getroot())

    @classmethod
    def from_string(cls, text: str) -> "SVGDocument":
        import xml.etree.ElementTree as ET

        return cls._from_root(ET.fromstring(text))

    @classmethod
    def _from_root(cls, root) -> "SVGDocument":
        shapes: list = []
        root_attrs = {k: v for k, v in root.attrib.items()}
        for child in root:
            _walk(child, shapes, root_attrs)
        width, height = _image_size(root)
        return cls(shapes=shapes, width=width, height=height)


def _walk(elem, out, inherited):
    """Depth-first ElementTree walk collecting shape elements with inherited
    attrs (C-expat parse; minidom's Python node objects cost ~4 ms/image).

    Mirrors the traversal contract of the reference `_traverse_tree`
    (svg_parser.py:772-793): attributes of ancestors are inherited by
    children, shape-local attributes override, and unknown element nodes are
    an error.
    """
    name = _local_tag(elem.tag)
    if name in SUPPORTED_SHAPES:
        attrs = copy.copy(inherited)
        attrs.update(elem.attrib)
        attrs["shape_name"] = name
        out.append(attrs)
    elif name not in FILTERED_NODES:
        raise UnsupportedSVGError(f"unsupported SVG element <{name}>")
    merged = inherited
    if elem.attrib:
        merged = copy.copy(inherited)
        merged.update(elem.attrib)
    for child in elem:
        _walk(child, out, merged)


def _image_size(root):
    """Image size from the first <image> tag (svg_parser.py:801-805), falling
    back to the svg root's width/height attributes."""
    for e in root.iter():
        if _local_tag(e.tag) == "image":
            return float(e.get("width")), float(e.get("height"))
    w = root.get("width")
    h = root.get("height")
    if w and h:
        return float(re.sub(r"[a-z%]+$", "", w)), float(re.sub(r"[a-z%]+$", "", h))
    raise UnsupportedSVGError("SVG has no <image> tag and no root width/height")


# ---------------------------------------------------------------------------
# SVG path-data ("d" attribute) tokenizer
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(
    r"[-+]?(?:\d*\.\d+|\d+\.?)(?:[eE][-+]?\d+)?"
)
_CMD_RE = re.compile(r"[MmLlHhVvCcSsQqTtAaZz]")

# Segment kinds produced by parse_path_d
LINE = "line"
CUBIC = "cubic"
QUAD = "quad"
ARC = "arc"


def _tokenize(d: str):
    pos = 0
    tokens = []
    while pos < len(d):
        ch = d[pos]
        if ch.isspace() or ch == ",":
            pos += 1
            continue
        m = _CMD_RE.match(d, pos)
        if m:
            tokens.append(m.group(0))
            pos = m.end()
            continue
        m = _NUM_RE.match(d, pos)
        if m:
            tokens.append(float(m.group(0)))
            pos = m.end()
            continue
        raise UnsupportedSVGError(f"cannot tokenize path data at: {d[pos:pos+16]!r}")
    return tokens


_ARITY = {"M": 2, "L": 2, "H": 1, "V": 1, "C": 6, "S": 4, "Q": 4, "T": 2, "A": 7, "Z": 0}


def parse_path_d(d: str):
    """Parse an SVG path "d" string into absolute segments.

    Returns a list of (kind, params) tuples:
      ("line",  [x0, y0, x1, y1])
      ("cubic", [x0, y0, c1x, c1y, c2x, c2y, x1, y1])
      ("quad",  [x0, y0, cx, cy, x1, y1])
      ("arc",   [x0, y0, x1, y1, rx, ry, rot_deg, large_arc, sweep])
    """
    tokens = _tokenize(d)
    segs = []
    i = 0
    cur = np.zeros(2)
    start = np.zeros(2)
    prev_cmd = None
    prev_ctrl = None  # reflection point for S/T

    def take(n):
        nonlocal i
        vals = tokens[i : i + n]
        if len(vals) != n or any(isinstance(v, str) for v in vals):
            raise UnsupportedSVGError("malformed path data (argument underflow)")
        i += n
        return [float(v) for v in vals]

    cmd = None
    while i < len(tokens):
        tok = tokens[i]
        if isinstance(tok, str):
            cmd = tok
            i += 1
        elif cmd is None:
            raise UnsupportedSVGError("path data does not start with a command")
        else:
            # implicit command repetition; M repeats as L
            if cmd == "M":
                cmd = "L"
            elif cmd == "m":
                cmd = "l"

        rel = cmd.islower()
        C = cmd.upper()
        if C == "Z":
            if not np.allclose(cur, start):
                segs.append((LINE, [cur[0], cur[1], start[0], start[1]]))
            cur = start.copy()
            prev_ctrl = None
            prev_cmd = C
            continue

        args = take(_ARITY[C])
        o = cur.copy() if rel else np.zeros(2)

        if C == "M":
            cur = o + np.array(args)
            start = cur.copy()
            prev_ctrl = None
        elif C == "L":
            p1 = o + np.array(args)
            segs.append((LINE, [cur[0], cur[1], p1[0], p1[1]]))
            cur = p1
            prev_ctrl = None
        elif C == "H":
            x1 = (cur[0] if rel else 0.0) + args[0]
            segs.append((LINE, [cur[0], cur[1], x1, cur[1]]))
            cur = np.array([x1, cur[1]])
            prev_ctrl = None
        elif C == "V":
            y1 = (cur[1] if rel else 0.0) + args[0]
            segs.append((LINE, [cur[0], cur[1], cur[0], y1]))
            cur = np.array([cur[0], y1])
            prev_ctrl = None
        elif C == "C":
            c1 = o + np.array(args[0:2])
            c2 = o + np.array(args[2:4])
            p1 = o + np.array(args[4:6])
            segs.append((CUBIC, [cur[0], cur[1], c1[0], c1[1], c2[0], c2[1], p1[0], p1[1]]))
            prev_ctrl = c2
            cur = p1
        elif C == "S":
            c1 = 2 * cur - prev_ctrl if (prev_cmd in ("C", "S") and prev_ctrl is not None) else cur.copy()
            c2 = o + np.array(args[0:2])
            p1 = o + np.array(args[2:4])
            segs.append((CUBIC, [cur[0], cur[1], c1[0], c1[1], c2[0], c2[1], p1[0], p1[1]]))
            prev_ctrl = c2
            cur = p1
        elif C == "Q":
            c = o + np.array(args[0:2])
            p1 = o + np.array(args[2:4])
            segs.append((QUAD, [cur[0], cur[1], c[0], c[1], p1[0], p1[1]]))
            prev_ctrl = c
            cur = p1
        elif C == "T":
            c = 2 * cur - prev_ctrl if (prev_cmd in ("Q", "T") and prev_ctrl is not None) else cur.copy()
            p1 = o + np.array(args)
            segs.append((QUAD, [cur[0], cur[1], c[0], c[1], p1[0], p1[1]]))
            prev_ctrl = c
            cur = p1
        elif C == "A":
            rx, ry, rot, fa, fs, x1, y1 = args
            p1 = o + np.array([x1, y1])
            segs.append(
                (ARC, [cur[0], cur[1], p1[0], p1[1], rx, ry, rot, float(fa != 0), float(fs != 0)])
            )
            cur = p1
            prev_ctrl = None
        prev_cmd = C

    return segs


# ---------------------------------------------------------------------------
# Ground-truth boxes (SESYD .xml sidecar)
# ---------------------------------------------------------------------------


def read_ground_truth_boxes(xml_path: str, width: float, height: float, class_dict: dict):
    """Read GT boxes/labels from a SESYD annotation XML.

    Mirrors Datasets/graph_dict3.py:_get_bbox:129-151: collects element
    children of every <a> and <o> tag; box coords are normalised by image
    width/height; labels map through `class_dict`.

    Returns (bbox [G,4] float64 normalised x0,y0,x1,y1, labels [G] int64).
    """
    # ElementTree (C expat) instead of minidom: ~3x faster per sidecar and
    # the GT reader sits on the per-image preprocessing path
    import xml.etree.ElementTree as ET

    root = ET.parse(str(xml_path)).getroot()

    nodes = []
    for tagname in ("a", "o"):
        nodes += [e for e in root.iter() if _local_tag(e.tag) == tagname]

    boxes, labels = [], []
    for node in nodes:
        for n in node:
            boxes.append(
                (
                    float(n.get("x0")) / width,
                    float(n.get("y0")) / height,
                    float(n.get("x1")) / width,
                    float(n.get("y1")) / height,
                )
            )
            labels.append(class_dict[n.get("label")])
    return np.asarray(boxes, dtype=np.float64).reshape(-1, 4), np.asarray(labels, dtype=np.int64)


def _local_tag(tag) -> str:
    """Namespace-stripped element tag ('{ns}line' -> 'line')."""
    if isinstance(tag, str) and tag.startswith("{"):
        return tag.rsplit("}", 1)[1]
    return tag if isinstance(tag, str) else ""
