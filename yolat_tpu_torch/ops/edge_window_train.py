"""Trainable edge-window ops: the pair-feature gather and the per-destination
sum of the conv's window layout, each with its backward (kernels 9 and 10).

Counterpart of `yolat_tpu/ops/edge_window_train.py`: `ew_pair_features`
(:167, `_pair_fwd` / `_pair_bwd`) and `ew_window_segment_sum_n` (:277,
`_wsum_fwd` / `_wsum_bwd`), each a `torch.autograd.Function` where JAX has a
`custom_vjp`. Both run over the plan of
`ops.plans.edge_window_plan(transpose=True)`, read with `ops.plans.ew_train_of`:
(src [E], dst [E] ascending, dptr [N + 1], sperm [E], sptr [N + 1]).

The TPU layout pads every window of 256 nodes to a fixed edge capacity and
marks the real rows with a mask; here the edge rows are the real edges in
dst order, followed, in a batch at capacity (`ops.plans.pad_plans`), by pad
rows past dptr[N]: the pair gather maps them (to the last node row), the
sums and the pair backward never read them, and the sum's backward gives
them 0. BatchNorm over these rows masks them (`nn/conv.py`), so it sees
the population the sparse branch's masked rows give it.

  pair forward   g[e] = [x[dst e] || x[src e] - x[dst e]]      in x's type
  pair backward  dx[v] = sum_{dst e = v} (dg0[e] - dg1[e])
                       + sum_{src e = v} dg1[e]                in x's type
  sum forward    out[v] = sum_{dst e = v} h[e]                 f32
  sum backward   dh[e] = g[dst e]                              in h's type

Rounding follows the TPU kernels: the difference x_j - x_i is taken in x's
type (:72-76); dg0 - dg1 in dg's type before the f32 sum (:91); dx is
rounded to x's type at the end (:192); the sum accumulates and returns f32
(:211-212); its backward rounds g to h's type (:300).

Each of the four wrappers launches its CUDA kernel
(`csrc/edge_window_train.cu`) for CUDA tensors and runs its plain version
for CPU tensors; any other device raises. A comparison of a kernel with its
plain version calls `pair_fwd_plain`, `pair_bwd_plain`, `wsum_fwd_plain` or
`wsum_bwd_plain` directly. The kernel picks its route: 16-byte pieces of
a row where the row and the value arrays allow it, else one thread per row.
Either route returns the same bits: per channel, a node's in-edges in dptr
order, then its out-edges in sperm order, added left to right in f32.
"""

from __future__ import annotations

import torch

from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.plans import real_rows

_FLOATS = (torch.float32, torch.bfloat16)


def pair_fwd_plain(x, src, dst):
    x_i = x.index_select(0, dst.long())
    return torch.cat([x_i, x.index_select(0, src.long()) - x_i], dim=1)


def pair_bwd_plain(dg, src, dst, n: int):
    """dg [E, 2C] -> dx [n, C] in dg's type."""
    c = dg.shape[1] // 2
    d_xi = (dg[:, :c] - dg[:, c:]).float()
    dx = torch.zeros(n, c, dtype=torch.float32, device=dg.device)
    dx.index_add_(0, dst.long(), d_xi)
    dx.index_add_(0, src.long(), dg[:, c:].float())
    return dx.to(dg.dtype)


def wsum_fwd_plain(h, dst, n: int):
    out = torch.zeros(n, h.shape[1], dtype=torch.float32, device=h.device)
    return out.index_add_(0, dst.long(), h.float())


def wsum_bwd_plain(g, dst, dtype):
    return g.to(dtype).index_select(0, dst.long())


def _check_int31(name: str, *sizes: int) -> None:
    """The kernels index in 32-bit int: every size must be below 2^31."""
    if max(sizes) >= 2 ** 31:
        raise ValueError(f"{name}: {max(sizes)} elements do not fit the "
                         f"kernel's 32-bit indices")


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


def _check_index(name: str, t, length: int, ref) -> None:
    if t.dtype != torch.int32 or t.device != ref.device \
            or tuple(t.shape) != (length,):
        raise TypeError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                        f"want int32 ({length},) on {ref.device}")


def pair_fwd(x, src, dst):
    """Kernel 9's forward: x [N, C] -> g [E, 2C] in x's type."""
    if not _route(x, "ew_pair_features"):
        return pair_fwd_plain(x, src, dst)
    n, c = x.shape
    e = src.shape[0]
    _check_index("src", src, e, x)
    _check_index("dst", dst, e, x)
    g = torch.empty(e, 2 * c, dtype=x.dtype, device=x.device)
    if e == 0 or c == 0:
        return g
    if n == 0:
        raise ValueError("ew_pair_features: edges over an empty node set")
    _check_int31("ew_pair_features", e * 2 * c, n * c)
    lib = _build.library()
    rc = lib.yk_ew_pair_fwd(
        _build.ptr(x.contiguous()), _build.ptr(src.contiguous()),
        _build.ptr(dst.contiguous()), _build.ptr(g), n, e, c,
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(lib, rc, "ew_pair_features")
    _build.launch_counts["ew_pair_features"] += 1
    return g


def pair_bwd(dg, src, dst, dptr, sperm, sptr, n: int):
    """Kernel 9's backward: dg [E, 2C] -> dx [n, C] in dg's type."""
    if not _route(dg, "ew_pair_features_bwd"):
        e = int(dptr[-1])  # the real rows (capacity padding left out)
        return pair_bwd_plain(dg[:e], src[:e], dst[:e], n)
    e, c = dg.shape[0], dg.shape[1] // 2
    _check_index("dptr", dptr, n + 1, dg)
    _check_index("sperm", sperm, e, dg)
    _check_index("sptr", sptr, n + 1, dg)
    dx = torch.empty(n, c, dtype=dg.dtype, device=dg.device)
    if n == 0 or c == 0:
        return dx
    _check_int31("ew_pair_features_bwd", e * 2 * c, n * c)
    lib = _build.library()
    rc = lib.yk_ew_pair_bwd(
        _build.ptr(dg.contiguous()), _build.ptr(dptr.contiguous()),
        _build.ptr(sperm.contiguous()), _build.ptr(sptr.contiguous()),
        _build.ptr(dx), n, e, c, int(dg.dtype == torch.bfloat16),
        _build.stream_of(dg))
    _build.check(lib, rc, "ew_pair_features_bwd")
    _build.launch_counts["ew_pair_features_bwd"] += 1
    return dx


def wsum_fwd(h, dst, dptr, n: int):
    """Kernel 10's forward: h [E, C] -> [n, C] f32."""
    if not _route(h, "ew_window_segment_sum"):
        e = int(dptr[-1])
        return wsum_fwd_plain(h[:e], dst[:e], n)
    e, c = h.shape
    _check_index("dptr", dptr, n + 1, h)
    out = torch.empty(n, c, dtype=torch.float32, device=h.device)
    if n == 0 or c == 0:
        return out
    _check_int31("ew_window_segment_sum", e * c, n * c)
    lib = _build.library()
    rc = lib.yk_ew_wsum_fwd(
        _build.ptr(h.contiguous()), _build.ptr(dptr.contiguous()),
        _build.ptr(out), n, e, c, int(h.dtype == torch.bfloat16),
        _build.stream_of(h))
    _build.check(lib, rc, "ew_window_segment_sum")
    _build.launch_counts["ew_window_segment_sum"] += 1
    return out


def wsum_bwd(g, dst, dtype):
    """Kernel 10's backward: g [N, C] f32 -> dh [E, C] in `dtype`."""
    if not _route(g, "ew_window_segment_sum_bwd"):
        return wsum_bwd_plain(g, dst, dtype)
    if g.dtype != torch.float32 or dtype not in _FLOATS:
        raise TypeError(f"ew_window_segment_sum_bwd: g {g.dtype} (want "
                        f"float32) -> {dtype} (want float32 or bfloat16)")
    n, c = g.shape
    e = dst.shape[0]
    _check_index("dst", dst, e, g)
    dh = torch.empty(e, c, dtype=dtype, device=g.device)
    if e == 0 or c == 0:
        return dh
    _check_int31("ew_window_segment_sum_bwd", e * c, n * c)
    lib = _build.library()
    rc = lib.yk_ew_wsum_bwd(
        _build.ptr(g.contiguous()), _build.ptr(dst.contiguous()),
        _build.ptr(dh), n, e, c, int(dtype == torch.bfloat16),
        _build.stream_of(g))
    _build.check(lib, rc, "ew_window_segment_sum_bwd")
    _build.launch_counts["ew_window_segment_sum_bwd"] += 1
    return dh


class _PairFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dst, dptr, sperm, sptr):
        ctx.save_for_backward(src, dst, dptr, sperm, sptr)
        ctx.n = x.shape[0]
        return pair_fwd(x, src, dst)

    @staticmethod
    def backward(ctx, dg):
        src, dst, dptr, sperm, sptr = ctx.saved_tensors
        dx = pair_bwd(dg, src, dst, dptr, sperm, sptr, ctx.n)
        return dx, None, None, None, None, None


class _WindowSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, dst, dptr, n: int):
        ctx.save_for_backward(dst, dptr)
        ctx.dtype = h.dtype
        return wsum_fwd(h, dst, dptr, n)

    @staticmethod
    def backward(ctx, g):
        dst, dptr = ctx.saved_tensors
        dh = wsum_bwd(g.float(), dst, ctx.dtype)
        # a pad row is in no sum: its gradient is 0, not g at its dst row
        keep = real_rows(dptr, dh.shape[0])[:, None]
        return torch.where(keep, dh, dh.new_zeros(())), None, None, None


def ew_pair_features(x, ewt):
    """g[e] = [x_i || x_j - x_i] for edge e = (j -> i) of the plan `ewt`
    (`ops.plans.ew_train_of`): x [N, C] f32/bf16 -> [E, 2C] in x's type."""
    src, dst, dptr, sperm, sptr = ewt
    return _PairFeatures.apply(x, src, dst, dptr, sperm, sptr)


def ew_window_segment_sum_n(h, ewt, n_nodes: int):
    """Per-destination-node sum of the plan's edge rows: h [E, C] f32/bf16
    -> [n_nodes, C] f32."""
    return _WindowSegmentSum.apply(h, ewt[1], ewt[2], n_nodes)
