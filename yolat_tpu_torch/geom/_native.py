"""ctypes binding of the host geometry library (csrc/geomcore.cpp).

Counterpart of `yolat_tpu/geom/_native.py:1-595`: the same entry points
with the same signatures and return values, over a copy of the same C++
source (`yolat_tpu_torch/csrc/geomcore.cpp`, byte for byte
`csrc/geomcore.cpp`). It is host code, not a GPU kernel: g++ compiles it
at first use,

  g++ -O3 -march=native -ffp-contract=off -shared -fPIC -o <so> <source>

(again without -march=native where the compiler refuses it) into
build/yolat_tpu_torch/geomcore/<hash>/libgeomcore.so, keyed on a hash of
the source, the flags, `g++ --version` and what -march=native means on
this host (`build/` is git-ignored). The library is written under a
temporary name and renamed into place, so processes that race to the first
build each load a whole file. -ffp-contract=off keeps every float
threshold decision (split distances, IoU labels) equal to numpy's
uncontracted arithmetic.

Unlike the JAX package, nothing falls back silently: a failed build
raises, with the compiler's output. The numpy paths of `geom/` run only

- under `disabled()`, which the tests and `chip_smoke.py` use for the
  numpy oracle, or
- in the per-call cases that are part of an entry's definition (empty
  `rects`, a degenerate grid, an exhausted capacity retry), where a wrapper
  returns None as the JAX one does. Each such case adds one to
  `numpy_cases[entry]`; each call answered by the library adds one to
  `native_calls[entry]`, so a run can show its path went through it.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "geomcore.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "yolat_tpu_torch",
                         "geomcore")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC")

ENTRIES = ("merge_cc", "sweep_rects", "enumerate_rect_sets",
           "build_rect_proposals", "window_pipeline", "split_lines",
           "angle_stats", "compact_sort_align", "compact_sort_align_stats")
native_calls = dict.fromkeys(ENTRIES, 0)
numpy_cases = dict.fromkeys(ENTRIES, 0)

_lock = threading.Lock()
_count_lock = threading.Lock()  # the loader's prefetch thread counts too
_lib = None
_off = False


def reset_counts() -> None:
    with _count_lock:
        for d in (native_calls, numpy_cases):
            for k in d:
                d[k] = 0


@contextlib.contextmanager
def disabled():
    """Run the numpy paths of `geom/` and `data/packing` inside the block
    (the oracle), in every thread of the process."""
    global _off
    prev, _off = _off, True
    try:
        yield
    finally:
        _off = prev


def _run(cmd) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e


def compiler_version() -> str:
    r = _run([CXX, "--version"])
    if r.returncode != 0:
        raise RuntimeError(f"{CXX} --version failed ({r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    return r.stdout.splitlines()[0] if r.stdout else ""


def library_path() -> str:
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(_run([CXX, "--version"]).stdout.encode())
    # what -march=native selects on this host: the library is host-specific
    h.update(_run([CXX, "-march=native", "-Q", "--help=target"])
             .stdout.encode())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], "libgeomcore.so")


def _compile(so: str) -> None:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, SOURCE]
    r = _run(cmd)
    if r.returncode != 0 and "-march=native" in cmd:
        # compilers that refuse -march=native: the portable build
        first = r
        cmd.remove("-march=native")
        r = _run(cmd)
        if r.returncode != 0:
            r.stderr = f"{first.stderr}\n(without -march=native)\n{r.stderr}"
    if r.returncode != 0:
        raise RuntimeError(f"{CXX} failed ({r.returncode}) building the host "
                           f"geometry library:\n{' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)


def load_library() -> ctypes.CDLL:
    """The loaded geometry library, compiling it first if needed; raises if
    it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _compile(so)
        lib = ctypes.CDLL(so)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        L, D = ctypes.c_long, ctypes.c_double
        lib.angle_stats.restype = L
        lib.angle_stats.argtypes = [i64p, L, f64p, L, D, f64p]
        lib.rect_membership.restype = None
        lib.rect_membership.argtypes = [i32p, i32p, L, i32p, L, u8p]
        lib.enumerate_rect_sets.restype = L
        lib.enumerate_rect_sets.argtypes = [i32p, i32p, L, i32p, L,
                                            i64p, L, i64p, L]
        lib.build_rect_proposals.restype = L
        lib.build_rect_proposals.argtypes = [
            i32p, i32p, L, i32p, L,
            i64p, i64p, L,
            i64p, i64p, L,
            i64p, L, i64p,
            i64p, L, i64p,
            i64p, L, i64p, L,
        ]
        lib.window_pipeline.restype = L
        lib.window_pipeline.argtypes = [
            i32p, i32p, L, f64p,
            i32p, L,
            i64p, i64p, L, f64p,
            i64p, i64p, L, f64p, u8p,
            f64p, i64p, L,
            L, D, D, D, D,
            i64p, L, i64p,
            i64p, L, i64p, i64p,
            i64p, L, i64p, i64p,
            f64p, L, i64p,
            ctypes.c_int, f64p,
            f64p, f64p, u8p, i64p, f64p, i64p,
            i64p,
        ]
        lib.merge_cc.restype = L
        lib.merge_cc.argtypes = [
            f64p, L, i64p, L, u8p, D,
            i64p, L, i64p, L,
            f64p, f64p,
            i64p, L, i64p, L,
            i64p,
        ]
        lib.sweep_rects.restype = L
        lib.sweep_rects.argtypes = [f64p, L, f64p, L, f64p, L, f64p, L,
                                    i32p, L]
        lib.split_lines.restype = L
        lib.split_lines.argtypes = [f64p, L, f64p, L, D, D, f64p, L]
        lib.compact_sort_align.restype = L
        lib.compact_sort_align.argtypes = [i64p, f32p, L, L, i64p, L, L,
                                           i32p, f32p, u8p, L]
        lib.compact_sort_align_stats.restype = L
        lib.compact_sort_align_stats.argtypes = [
            i64p, f32p, L, L, i64p, L, L, i32p, f32p, u8p, L,
            L, f32p, f32p, f32p, u8p,
        ]
        _lib = lib
        return lib


def _library():
    """The library for one call, or None under `disabled()`."""
    return None if _off else load_library()


def _native(entry: str, value):
    with _count_lock:
        native_calls[entry] += 1
    return value


def _numpy_case(entry: str):
    with _count_lock:
        numpy_cases[entry] += 1
    return None


def _p(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def merge_cc_native(pos: np.ndarray, edges: np.ndarray,
                    is_control: np.ndarray, contain_th: float):
    """mergeCC in C++: the merge_connected_components dict, or None (capacity
    retry exhausted, or `disabled()`)."""
    lib = _library()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    edges = np.ascontiguousarray(edges, dtype=np.int64).reshape(-1, 2)
    ctrl = np.ascontiguousarray(is_control, dtype=np.uint8)
    n = len(pos)
    i64, f64 = ctypes.c_int64, ctypes.c_double

    cap_clique = max(n * 64, 1 << 14)
    cap_cross = max(n * 16, 1 << 14)
    for _ in range(3):
        out_clique = np.empty((cap_clique, 2), np.int64)
        out_cross = np.empty((cap_cross, 2), np.int64)
        clique_attr = np.empty((cap_clique, 6), np.float64)
        cross_attr = np.empty((cap_cross, 6), np.float64)
        cc_ids = np.empty(max(n, 1), np.int64)
        cc_off = np.empty(n + 2, np.int64)
        counts = np.zeros(3, np.int64)
        rc = lib.merge_cc(
            _p(pos, f64), n, _p(edges, i64), len(edges),
            _p(ctrl, ctypes.c_uint8), float(contain_th),
            _p(out_clique, i64), cap_clique, _p(out_cross, i64), cap_cross,
            _p(clique_attr, f64), _p(cross_attr, f64),
            _p(cc_ids, i64), len(cc_ids), _p(cc_off, i64), n + 1,
            _p(counts, i64),
        )
        if rc == 0:
            nq, nx, nc = (int(c) for c in counts)
            return _native("merge_cc", {
                "shape_shape_edges": out_clique[:nq].copy(),
                "cross_shape_edges": out_cross[:nx].copy(),
                "shape_shape_attr": clique_attr[:nq].copy(),
                "cross_attr": cross_attr[:nx].copy(),
                "cc": [cc_ids[cc_off[i]:cc_off[i + 1]].tolist()
                       for i in range(nc)],
            })
        cap_clique *= 4
        cap_cross *= 4
    return _numpy_case("merge_cc")


def sweep_rects_native(x_values, y_values, x_grids, y_grids):
    """Walk-order rectangle enumeration in C++: [n, 4] int32 rects (possibly
    empty), or None (`disabled()`; the capacity is an exact bound)."""
    lib = _library()
    if lib is None:
        return None
    xv = np.ascontiguousarray(x_values, dtype=np.float64)
    yv = np.ascontiguousarray(y_values, dtype=np.float64)
    xg = np.ascontiguousarray(x_grids, dtype=np.float64)
    yg = np.ascontiguousarray(y_grids, dtype=np.float64)
    f64 = ctypes.c_double
    # exact bound: <= ngx^2 * ngy^2 rects (starts/ends are grid-bounded)
    cap = max((len(xg) * len(yg)) ** 2, 64)
    out = np.empty((cap, 4), np.int32)
    n = lib.sweep_rects(_p(xv, f64), len(xv), _p(yv, f64), len(yv),
                        _p(xg, f64), len(xg), _p(yg, f64), len(yg),
                        _p(out, ctypes.c_int32), cap)
    if n < 0:
        return _numpy_case("sweep_rects")
    return _native("sweep_rects", out[:n].copy())


def enumerate_rect_sets_native(xi: np.ndarray, yi: np.ndarray,
                               rects: np.ndarray):
    """Distinct rectangle point-sets as a list of int64 arrays, or None
    (no rects, capacity exceeded, or `disabled()`)."""
    lib = _library()
    if lib is None:
        return None
    if len(rects) == 0:
        return _numpy_case("enumerate_rect_sets")
    xi = np.ascontiguousarray(xi, dtype=np.int32)
    yi = np.ascontiguousarray(yi, dtype=np.int32)
    rects = np.ascontiguousarray(rects, dtype=np.int32)
    max_sets = len(rects)
    # average set size is bounded by the point count; cap generously
    max_total = max(len(xi) * 64, len(rects) * 8)
    out_ids = np.empty(max_total, dtype=np.int64)
    out_offsets = np.empty(max_sets + 1, dtype=np.int64)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    n = lib.enumerate_rect_sets(_p(xi, i32), _p(yi, i32), len(xi),
                                _p(rects, i32), len(rects),
                                _p(out_ids, i64), max_total,
                                _p(out_offsets, i64), max_sets)
    if n < 0:
        return _numpy_case("enumerate_rect_sets")
    return _native("enumerate_rect_sets",
                   [out_ids[out_offsets[i]:out_offsets[i + 1]].copy()
                    for i in range(n)])


def build_rect_proposals_native(xi, yi, rects, edges_cl, supers_cl):
    """One-pass proposal cores: a list of (point_ids, edge_rows, super_rows)
    per distinct window, or None (no rects, capacity retry exhausted, or
    `disabled()`)."""
    lib = _library()
    if lib is None:
        return None
    if len(rects) == 0:
        return _numpy_case("build_rect_proposals")
    xi = np.ascontiguousarray(xi, dtype=np.int32)
    yi = np.ascontiguousarray(yi, dtype=np.int32)
    rects = np.ascontiguousarray(rects, dtype=np.int32)
    edges_cl = np.ascontiguousarray(edges_cl, dtype=np.int64).reshape(-1, 2)
    supers_cl = np.ascontiguousarray(supers_cl, dtype=np.int64).reshape(-1, 2)
    eu = np.ascontiguousarray(edges_cl[:, 0])
    ev = np.ascontiguousarray(edges_cl[:, 1])
    su = np.ascontiguousarray(supers_cl[:, 0])
    sv = np.ascontiguousarray(supers_cl[:, 1])
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    max_sets = len(rects)

    cap_ids = max(len(xi) * 64, 1 << 16)
    cap_eids = max(len(eu) * 64, 1 << 16)
    cap_sids = max(len(su) * 64, 1 << 16)
    for _ in range(3):  # grow capacity on exhaustion
        out_ids = np.empty(cap_ids, np.int64)
        out_id_off = np.empty(max_sets + 1, np.int64)
        out_eids = np.empty(cap_eids, np.int64)
        out_eid_off = np.empty(max_sets + 1, np.int64)
        out_sids = np.empty(cap_sids, np.int64)
        out_sid_off = np.empty(max_sets + 1, np.int64)
        n = lib.build_rect_proposals(
            _p(xi, i32), _p(yi, i32), len(xi), _p(rects, i32), len(rects),
            _p(eu, i64), _p(ev, i64), len(eu),
            _p(su, i64), _p(sv, i64), len(su),
            _p(out_ids, i64), cap_ids, _p(out_id_off, i64),
            _p(out_eids, i64), cap_eids, _p(out_eid_off, i64),
            _p(out_sids, i64), cap_sids, _p(out_sid_off, i64),
            max_sets,
        )
        if n >= 0:
            return _native("build_rect_proposals", [
                (out_ids[out_id_off[i]:out_id_off[i + 1]].copy(),
                 out_eids[out_eid_off[i]:out_eid_off[i + 1]].copy(),
                 out_sids[out_sid_off[i]:out_sid_off[i + 1]].copy())
                for i in range(n)])
        cap_ids *= 4
        cap_eids *= 4
        cap_sids *= 4
    return _numpy_case("build_rect_proposals")


def window_pipeline_native(xi, yi, pos_cluster, rects, edges_cl, supers_cl,
                           attr_e, attr_s, issuper_cluster,
                           gt_boxes, gt_label_vals, bg_label,
                           iou_th, ios_th, angle_th, min_extent,
                           normalize_pos: bool = False,
                           initial_caps=None):
    """The whole per-CC window pipeline (enumeration, dedup, filters,
    features, GT labelling, attribute-row gathers) in C++. Returns a dict
    of flat CSR arrays, or None (no rects, a degenerate grid, capacity
    retry exhausted, or `disabled()`):
      n_w, n_distinct, ids [T], id_off [n_w+1], eids [Te], eid_off, eloc
      [Te,2] (CC-local member-row endpoints), sids [Ts], sid_off, sloc
      [Ts,2], feats [n_w, 17] = box(4) + stat_feat(13), pos [T, 2]
      per-member positions (normalised to each window box when
      normalize_pos), issuper [T] bool, eattr [Te,6], sattr [Ts,6],
      labels [n_w], targets [n_w,4], hasobj [n_w].
    `initial_caps` (ids, eids, sids) sizes the first attempt (a test hook
    for the counting retry).
    """
    lib = _library()
    if lib is None:
        return None
    if len(rects) == 0:
        return _numpy_case("window_pipeline")
    xi = np.ascontiguousarray(xi, dtype=np.int32)
    yi = np.ascontiguousarray(yi, dtype=np.int32)
    pos = np.ascontiguousarray(pos_cluster, dtype=np.float64)
    rects = np.ascontiguousarray(rects, dtype=np.int32)
    edges_cl = np.ascontiguousarray(edges_cl, dtype=np.int64).reshape(-1, 2)
    supers_cl = np.ascontiguousarray(supers_cl, dtype=np.int64).reshape(-1, 2)
    eu = np.ascontiguousarray(edges_cl[:, 0])
    ev = np.ascontiguousarray(edges_cl[:, 1])
    su = np.ascontiguousarray(supers_cl[:, 0])
    sv = np.ascontiguousarray(supers_cl[:, 1])
    attr_e = np.ascontiguousarray(attr_e, dtype=np.float64).reshape(-1, 6)
    attr_s = np.ascontiguousarray(attr_s, dtype=np.float64).reshape(-1, 6)
    issuper = np.ascontiguousarray(issuper_cluster, dtype=np.uint8)
    gtb = np.ascontiguousarray(gt_boxes, dtype=np.float64).reshape(-1, 4)
    gt_lab = np.ascontiguousarray(gt_label_vals, dtype=np.int64)
    i32, i64, f64, u8 = (ctypes.c_int32, ctypes.c_int64, ctypes.c_double,
                         ctypes.c_uint8)
    max_sets = len(rects)

    # totals scale with windows x members per window (the rect count bounds
    # the windows), not with the input sizes. np.empty pages fault on
    # write, so the over-allocation is virtual memory only; an overflow
    # costs one counting pass (-2 reports the exact totals for the retry)
    if initial_caps is not None:
        cap_ids, cap_eids, cap_sids = initial_caps
    else:
        cap_ids = max(len(rects) * 64, len(xi) * 64, 1 << 16)
        cap_eids = max(len(rects) * 64, len(eu) * 64, 1 << 16)
        cap_sids = max(len(rects) * 128, len(su) * 64, 1 << 16)
    for _ in range(2):
        out_ids = np.empty(cap_ids, np.int64)
        out_id_off = np.empty(max_sets + 1, np.int64)
        out_eids = np.empty(cap_eids, np.int64)
        out_eid_off = np.empty(max_sets + 1, np.int64)
        out_eloc = np.empty((cap_eids, 2), np.int64)
        out_sids = np.empty(cap_sids, np.int64)
        out_sid_off = np.empty(max_sets + 1, np.int64)
        out_sloc = np.empty((cap_sids, 2), np.int64)
        out_feats = np.empty((max_sets, 17), np.float64)
        out_pos = np.empty((cap_ids, 2), np.float64)
        out_eattr = np.empty((cap_eids, 6), np.float64)
        out_sattr = np.empty((cap_sids, 6), np.float64)
        out_issuper = np.empty(cap_ids, np.uint8)
        out_labels = np.empty(max_sets, np.int64)
        out_targets = np.empty((max_sets, 4), np.float64)
        out_hasobj = np.empty(max_sets, np.int64)
        n_distinct = np.zeros(1, np.int64)
        req = np.zeros(3, np.int64)
        n = lib.window_pipeline(
            _p(xi, i32), _p(yi, i32), len(xi), _p(pos, f64),
            _p(rects, i32), len(rects),
            _p(eu, i64), _p(ev, i64), len(eu), _p(attr_e, f64),
            _p(su, i64), _p(sv, i64), len(su), _p(attr_s, f64),
            _p(issuper, u8),
            _p(gtb, f64), _p(gt_lab, i64), len(gtb),
            int(bg_label), float(iou_th), float(ios_th),
            float(angle_th), float(min_extent),
            _p(out_ids, i64), cap_ids, _p(out_id_off, i64),
            _p(out_eids, i64), cap_eids, _p(out_eid_off, i64),
            _p(out_eloc, i64),
            _p(out_sids, i64), cap_sids, _p(out_sid_off, i64),
            _p(out_sloc, i64),
            _p(out_feats, f64), max_sets, _p(n_distinct, i64),
            ctypes.c_int(1 if normalize_pos else 0), _p(out_pos, f64),
            _p(out_eattr, f64), _p(out_sattr, f64), _p(out_issuper, u8),
            _p(out_labels, i64), _p(out_targets, f64), _p(out_hasobj, i64),
            _p(req, i64),
        )
        if n >= 0:
            t = int(out_id_off[n])
            te, ts = int(out_eid_off[n]), int(out_sid_off[n])
            # views, not copies: every consumer re-offsets the rows or
            # copies them into the accumulator's concatenation
            return _native("window_pipeline", {
                "n_w": int(n),
                "n_distinct": int(n_distinct[0]),
                "ids": out_ids[:t],
                "id_off": out_id_off[: n + 1],
                "eids": out_eids[:te],
                "eid_off": out_eid_off[: n + 1],
                "eloc": out_eloc[:te],
                "sids": out_sids[:ts],
                "sid_off": out_sid_off[: n + 1],
                "sloc": out_sloc[:ts],
                "feats": out_feats[:n],
                "pos": out_pos[:t],
                "issuper": out_issuper[:t].astype(bool),
                "eattr": out_eattr[:te],
                "sattr": out_sattr[:ts],
                "labels": out_labels[:n],
                "targets": out_targets[:n],
                "hasobj": out_hasobj[:n],
            })
        if n != -2:  # -1: a degenerate grid, which the numpy path takes
            return _numpy_case("window_pipeline")
        # capacity overflow: the counting pass reported the exact totals
        cap_ids = max(int(req[0]), 1)
        cap_eids = max(int(req[1]), 1)
        cap_sids = max(int(req[2]), 1)
    return _numpy_case("window_pipeline")


def split_lines_native(lines: np.ndarray, points: np.ndarray,
                       line_th: float, merge_th: float):
    """split_line in C++ (lines split at incident points): the [L', 4] line
    array, or None (capacity retry exhausted, or `disabled()`)."""
    lib = _library()
    if lib is None:
        return None
    lines = np.ascontiguousarray(lines, dtype=np.float64).reshape(-1, 4)
    points = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 2)
    f64 = ctypes.c_double
    cap = max(len(lines) * 8 + len(points) * 2, 1 << 10)
    for _ in range(3):
        out = np.empty((cap, 4), np.float64)
        n = lib.split_lines(_p(lines, f64), len(lines), _p(points, f64),
                            len(points), float(line_th), float(merge_th),
                            _p(out, f64), cap)
        if n >= 0:
            return _native("split_lines", out[:n].copy())
        cap *= 4
    return _numpy_case("split_lines")


def angle_stats_native(edges_local: np.ndarray, pos_local: np.ndarray,
                       th: float):
    """The stats dict of proposals._angle_stats ({"empty": True} when no
    angle pair exists), or None under `disabled()`."""
    lib = _library()
    if lib is None:
        return None
    edges = np.ascontiguousarray(edges_local, dtype=np.int64)
    pos = np.ascontiguousarray(pos_local, dtype=np.float64)
    out = np.zeros(7, dtype=np.float64)
    n = lib.angle_stats(_p(edges, ctypes.c_int64), len(edges),
                        _p(pos, ctypes.c_double), len(pos), float(th),
                        _p(out, ctypes.c_double))
    if n == 0:
        return _native("angle_stats", {"empty": True})
    return _native("angle_stats", dict(
        n_90=int(out[0]), n_less90=int(out[1]), n_more90=int(out[2]),
        mean=out[3], max=out[4], min=out[5], std=out[6]))


def _csa_inputs(edge, attr, old2new):
    edge = np.ascontiguousarray(edge, dtype=np.int64).reshape(-1, 2)
    # f32 by API: one f64 -> f32 rounding here is the C side's float cast
    attr = np.ascontiguousarray(attr, dtype=np.float32)
    if attr.ndim == 1:
        attr = attr.reshape(len(edge), -1)
    old2new = np.ascontiguousarray(old2new, dtype=np.int64)
    adim = attr.shape[1] if len(edge) else 4
    return edge, attr, old2new, adim


def compact_sort_align_native(edge: np.ndarray, attr: np.ndarray,
                              old2new: np.ndarray, block: int):
    """CompactFile's edge transform in C++: stable dst counting sort,
    endpoint remap and run alignment to `block`. (edge2 [S2,2] int32,
    attr2 [S2,4] float32, valid [S2] bool), or None (`disabled()`, or a
    row count the second pass did not reproduce). block=1: valid is all
    True."""
    lib = _library()
    if lib is None:
        return None
    edge, attr, old2new, adim = _csa_inputs(edge, attr, old2new)
    S = len(edge)
    i32, i64, f32, u8 = (ctypes.c_int32, ctypes.c_int64, ctypes.c_float,
                         ctypes.c_uint8)
    args = (_p(edge, i64), _p(attr, f32), S, adim, _p(old2new, i64),
            len(old2new), block)
    s2 = lib.compact_sort_align(*args, ctypes.POINTER(i32)(),
                                ctypes.POINTER(f32)(), ctypes.POINTER(u8)(), 0)
    edge2 = np.empty((s2, 2), np.int32)
    attr2 = np.empty((s2, 4), np.float32)
    valid = np.empty(s2, np.uint8)
    got = lib.compact_sort_align(*args, _p(edge2, i32), _p(attr2, f32),
                                 _p(valid, u8), s2)
    if got != s2:
        return _numpy_case("compact_sort_align")
    return _native("compact_sort_align", (edge2, attr2, valid.astype(bool)))


def compact_sort_align_stats_native(edge: np.ndarray, attr: np.ndarray,
                                    old2new: np.ndarray, block: int,
                                    n_new: int):
    """compact_sort_align and, in the same pass, the per-node populations
    over the real rows: in-degree, out-degree, the mean incoming attribute
    (the factored clique level's sup_abar) and edge-endpoint membership
    (sup_member). (edge2 [S2,2] int32, attr2 [S2,4] f32, valid [S2] bool,
    dst_count [n_new] f32, src_count [n_new] f32, abar [n_new,4] f32,
    member [n_new] bool), or None (as compact_sort_align_native)."""
    lib = _library()
    if lib is None:
        return None
    edge, attr, old2new, adim = _csa_inputs(edge, attr, old2new)
    S = len(edge)
    i32, i64, f32, u8 = (ctypes.c_int32, ctypes.c_int64, ctypes.c_float,
                         ctypes.c_uint8)
    args = (_p(edge, i64), _p(attr, f32), S, adim, _p(old2new, i64),
            len(old2new), block)
    s2 = lib.compact_sort_align(*args, ctypes.POINTER(i32)(),
                                ctypes.POINTER(f32)(), ctypes.POINTER(u8)(), 0)
    edge2 = np.empty((s2, 2), np.int32)
    attr2 = np.empty((s2, 4), np.float32)
    valid = np.empty(s2, np.uint8)
    dst_count = np.empty(n_new, np.float32)
    src_count = np.empty(n_new, np.float32)
    abar = np.empty((n_new, 4), np.float32)
    member = np.empty(n_new, np.uint8)
    got = lib.compact_sort_align_stats(
        *args, _p(edge2, i32), _p(attr2, f32), _p(valid, u8), s2,
        n_new, _p(dst_count, f32), _p(src_count, f32), _p(abar, f32),
        _p(member, u8))
    if got != s2:
        return _numpy_case("compact_sort_align_stats")
    return _native("compact_sort_align_stats",
                   (edge2, attr2, valid.astype(bool), dst_count, src_count,
                    abar, member.astype(bool)))
