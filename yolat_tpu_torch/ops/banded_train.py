"""Trainable banded ops over one edge family: the gather of both endpoint
rows and the per-node sum at the sorted endpoint, each with its backward
(kernels 7, 7b, 8, 8b).

Counterpart of `yolat_tpu/ops/banded_train.py`: `banded_gather` (:281,
`_gather_fwd` / `_gather_bwd`) and `banded_scatter_own` (:307,
`_scatter_own_fwd` / `_scatter_own_bwd`), each a `torch.autograd.Function`
where JAX has a `custom_vjp`. YOLaT++'s banded training route
(`nn/yolat_pp.py`, cfg.pp_banded_super) runs the super-edge clique level
through them. Both read the plan of `ops.plans.banded_plan(transpose=True)`
as `ops.plans.bm_of(batch, 'sew_')` gives it: the family's E real edges
sorted by `own` (own, oth [E], nptr [N + 1]) and, for the gather's backward,
the list's transpose by the other endpoint (tperm [E], tptr [N + 1]).

The TPU plan lays the edges out in blocks of 256 rows per 512-node window,
padded with masked rows, and every tensor between the two primitives lives
in that layout; here the rows are the real edges, followed, in a batch at
capacity (`ops.plans.pad_plans`), by pad rows past nptr[N]: the gather
maps them (to the last node row), the sum and the gather's backward never
read them, and the sum's backward gives them 0. BatchNorm over these rows
masks them (`nn/yolat_pp.py`), so it sees the population the sparse
route's masked rows give it.

  gather forward    x_own[r] = x[own r], x_oth[r] = x[oth r]   in x's type
  gather backward   dx[v] = sum_{own r = v} g_own[r]
                          + sum_{oth r = v} g_oth[r]           in x's type
  sum forward       out[v] = sum_{own r = v} rows[r]           f32
  sum backward      d_rows[r] = g[own r]                       in rows' type

Rounding follows the TPU kernels: a gathered row is a copy (they return it
in f32 and the caller rounds it back to x's type, `yolat_pp.py:217-218`,
which is exact, so the port writes x's type); the gather's backward takes
its cotangents in x's type, forms the two sums in f32, adds them and
rounds once (:298-300); the sum accumulates and returns f32; its backward
rounds g to the rows' type (:324).

Each of the four wrappers launches its CUDA kernel for CUDA tensors and runs
its plain version for CPU tensors; any other device raises. Kernels 7 and 7b
are in `csrc/banded_train.cu`; the sum and its backward (8, 8b) are kernel
10's two functions over this plan and run its kernels
(`csrc/edge_window_train.cu`). A comparison of a kernel with its plain
version calls `gather_plain`, `gather_bwd_plain`, `scatter_own_plain` or
`scatter_own_bwd_plain` directly. The kernels take any width and pick their
route themselves: 16-byte pieces of a row where the row and the value
arrays allow it, else narrower loads; either route returns the same bits.
"""

from __future__ import annotations

import torch

from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.edge_window_train import _check_int31
from yolat_tpu_torch.ops.plans import real_rows

_FLOATS = (torch.float32, torch.bfloat16)


def gather_plain(x, own, oth):
    return x.index_select(0, own.long()), x.index_select(0, oth.long())


def gather_bwd_plain(g_own, g_oth, own, oth, n: int):
    """g_own, g_oth [E, C] -> dx [n, C] in their type."""
    zeros = torch.zeros(n, g_own.shape[1], dtype=torch.float32,
                        device=g_own.device)
    dx = (zeros.clone().index_add_(0, own.long(), g_own.float())
          + zeros.index_add_(0, oth.long(), g_oth.float()))
    return dx.to(g_own.dtype)


def scatter_own_plain(rows, own, n: int):
    out = torch.zeros(n, rows.shape[1], dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, own.long(), rows.float())


def scatter_own_bwd_plain(g, own, dtype):
    return g.to(dtype).index_select(0, own.long())


def _route(t, name: str) -> bool:
    """True for the kernel route (a CUDA tensor), False for the plain one
    (a CPU tensor); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no route for {t.device}")
    if t.dtype not in _FLOATS:
        raise TypeError(f"{name}: dtype {t.dtype}, want float32 or bfloat16")
    return True


def _index(name: str, t, length: int, ref):
    if t.dtype != torch.int32 or t.device != ref.device \
            or tuple(t.shape) != (length,):
        raise TypeError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                        f"want int32 ({length},) on {ref.device}")
    return t.contiguous()


def _rows(name: str, t, shape, ref):
    """A contiguous [E, C] operand of ref's type (a view off a 16-byte
    boundary stays so: the kernel then takes its narrow route)."""
    if t.dtype != ref.dtype or t.device != ref.device \
            or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                        f"want {ref.dtype} {tuple(shape)} on {ref.device}")
    return t.contiguous()


def gather_fwd(x, own, oth):
    """Kernel 7: x [N, C] -> (x_own, x_oth), each [E, C] in x's type."""
    if not _route(x, "banded_gather"):
        return gather_plain(x, own, oth)
    n, c = x.shape
    e = own.shape[0]
    own, oth = _index("own", own, e, x), _index("oth", oth, e, x)
    x_own = torch.empty(e, c, dtype=x.dtype, device=x.device)
    x_oth = torch.empty_like(x_own)
    if e == 0 or c == 0:
        return x_own, x_oth
    if n == 0:
        raise ValueError("banded_gather: edges over an empty node set")
    x = _rows("x", x, (n, c), x)
    lib = _build.library()
    rc = lib.yk_banded_gather(
        _build.ptr(x), _build.ptr(own), _build.ptr(oth), _build.ptr(x_own),
        _build.ptr(x_oth), n, e, c, int(x.dtype == torch.bfloat16),
        _build.stream_of(x))
    _build.check(lib, rc, "banded_gather")
    _build.launch_counts["banded_gather"] += 1
    return x_own, x_oth


def gather_bwd(g_own, g_oth, own, oth, nptr, tperm, tptr, n: int):
    """Kernel 7b: g_own, g_oth [E, C] -> dx [n, C] in their type."""
    if not _route(g_own, "banded_gather_bwd"):
        e = int(nptr[-1])  # the real rows (capacity padding left out)
        return gather_bwd_plain(g_own[:e], g_oth[:e], own[:e], oth[:e], n)
    e, c = g_own.shape
    if e == 0 or n == 0 or c == 0:
        return torch.zeros(n, c, dtype=g_own.dtype, device=g_own.device)
    _check_int31("banded_gather_bwd", e * c, n * c)
    nptr = _index("nptr", nptr, n + 1, g_own)
    tperm = _index("tperm", tperm, e, g_own)
    tptr = _index("tptr", tptr, n + 1, g_own)
    g_own = _rows("g_own", g_own, (e, c), g_own)
    g_oth = _rows("g_oth", g_oth, (e, c), g_own)
    dx = torch.empty(n, c, dtype=g_own.dtype, device=g_own.device)
    lib = _build.library()
    rc = lib.yk_banded_gather_bwd(
        _build.ptr(g_own), _build.ptr(g_oth), _build.ptr(nptr),
        _build.ptr(tperm), _build.ptr(tptr), _build.ptr(dx), n, e, c,
        int(g_own.dtype == torch.bfloat16), _build.stream_of(g_own))
    _build.check(lib, rc, "banded_gather_bwd")
    _build.launch_counts["banded_gather_bwd"] += 1
    return dx


def scatter_own_fwd(rows, own, nptr, n: int):
    """Kernel 8: rows [E, C] -> [n, C] f32."""
    if not _route(rows, "banded_scatter_own"):
        e = int(nptr[-1])
        return scatter_own_plain(rows[:e], own[:e], n)
    e, c = rows.shape
    if e == 0 or n == 0 or c == 0:
        return torch.zeros(n, c, dtype=torch.float32, device=rows.device)
    _check_int31("banded_scatter_own", e * c, n * c)
    nptr = _index("nptr", nptr, n + 1, rows)
    rows = _rows("rows", rows, (e, c), rows)
    out = torch.empty(n, c, dtype=torch.float32, device=rows.device)
    lib = _build.library()
    rc = lib.yk_banded_scatter_own(
        _build.ptr(rows), _build.ptr(nptr), _build.ptr(out), n, e, c,
        int(rows.dtype == torch.bfloat16), _build.stream_of(rows))
    _build.check(lib, rc, "banded_scatter_own")
    _build.launch_counts["banded_scatter_own"] += 1
    return out


def scatter_own_bwd(g, own, dtype):
    """Kernel 8b: g [N, C] f32 -> d_rows [E, C] in `dtype`."""
    if not _route(g, "banded_scatter_own_bwd"):
        return scatter_own_bwd_plain(g, own, dtype)
    if g.dtype != torch.float32 or dtype not in _FLOATS:
        raise TypeError(f"banded_scatter_own_bwd: g {g.dtype} (want float32) "
                        f"-> {dtype} (want float32 or bfloat16)")
    n, c = g.shape
    e = own.shape[0]
    own = _index("own", own, e, g)
    _check_int31("banded_scatter_own_bwd", e * c, n * c)
    out = torch.empty(e, c, dtype=dtype, device=g.device)
    if e == 0 or c == 0:
        return out
    if n == 0:
        raise ValueError("banded_scatter_own_bwd: edges over an empty node set")
    lib = _build.library()
    rc = lib.yk_banded_scatter_own_bwd(
        _build.ptr(g.contiguous()), _build.ptr(own), _build.ptr(out), n, e, c,
        int(dtype == torch.bfloat16), _build.stream_of(g))
    _build.check(lib, rc, "banded_scatter_own_bwd")
    _build.launch_counts["banded_scatter_own_bwd"] += 1
    return out


class _BandedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, own, oth, nptr, tperm, tptr):
        ctx.save_for_backward(own, oth, nptr, tperm, tptr)
        ctx.n = x.shape[0]
        return gather_fwd(x, own, oth)

    @staticmethod
    def backward(ctx, g_own, g_oth):
        own, oth, nptr, tperm, tptr = ctx.saved_tensors
        dx = gather_bwd(g_own, g_oth, own, oth, nptr, tperm, tptr, ctx.n)
        return dx, None, None, None, None, None


class _BandedScatterOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, own, nptr, n: int):
        ctx.save_for_backward(own, nptr)
        ctx.dtype = rows.dtype
        return scatter_own_fwd(rows, own, nptr, n)

    @staticmethod
    def backward(ctx, g):
        own, nptr = ctx.saved_tensors
        d_rows = scatter_own_bwd(g.float(), own, ctx.dtype)
        # a pad row is in no sum: its gradient is 0, not g at its own row
        keep = real_rows(nptr, d_rows.shape[0])[:, None]
        return (torch.where(keep, d_rows, d_rows.new_zeros(())), None, None,
                None)


def _sorted_plan(bm, name: str) -> None:
    if bm.perm is not None:
        raise ValueError(f"{name} needs a plan whose rows are sorted in place "
                         "(ops.plans.bm_of(batch, 'sew_'))")


def banded_gather(x, bm):
    """(x[own], x[oth]) per row of the plan `bm` (`ops.plans.BandedPlan`):
    x [N, C] f32/bf16 -> two [E, C] in x's type. A gradient needs the plan's
    transpose (`banded_plan(transpose=True)`)."""
    _sorted_plan(bm, "banded_gather")
    if bm.tperm is None:
        if x.requires_grad and torch.is_grad_enabled():
            raise ValueError(
                "banded_gather: the gradient sums by the other endpoint and "
                "needs the plan's transpose (ops.plans.banded_plan("
                "transpose=True); pack_files(sew_plan='transpose'))")
        return gather_fwd(x, bm.own, bm.oth)
    return _BandedGather.apply(x, bm.own, bm.oth, bm.nptr, bm.tperm, bm.tptr)


def banded_scatter_own(rows, bm, n_nodes: int):
    """Per-node sum of the plan's rows at its sorted endpoint: rows [E, C]
    f32/bf16 -> [n_nodes, C] f32."""
    _sorted_plan(bm, "banded_scatter_own")
    return _BandedScatterOwn.apply(rows, bm.own, bm.nptr, n_nodes)
