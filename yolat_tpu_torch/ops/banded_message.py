"""Banded message sums over one edge family (kernels 5 and 6).

Counterpart of `yolat_tpu/ops/banded_message.py`: `banded_message_sum`
(:262, the Pallas `_kernel` at :181) and `banded_message_sum_both` (:417,
`_kernel_both` at :335), with their oracles (:498-539). Per node, the SUM
over the family's edges at the plan's sorted endpoint (`own`) of the
folded-BN message

  h = relu(sc1 . (x_own @ W_own + x_oth @ W_halo + attr @ W_attr))
  [second stage: h = relu(sc2 . (h @ W2))]

and, for `_both`, also the sum of the same single-stage h at the other
endpoint. It covers YOLaT++'s super-edge clique level
([s_i || s_j - s_i || attr] with W_own = Wa - Wb, W_halo = Wb) and both
directions of its curve level ([attr || x_src || x_dst]); the caller
divides by the endpoint's population for a mean
(`eval/fast_forward.fast_forward_pp`).

The plan is `ops.plans.bm_of`'s: the real edges sorted by `own`, absolute
node rows, per-node offsets. It exists for every edge list, so there is no
second route for families the TPU plan cannot band.

Rounding points, shared by the CUDA kernels (`csrc/banded_message.cu`)
and the plain versions, and taken from the TPU kernels (:199-204, :240,
:247, :387): the weights are cast to x's type; x_own @ W_own and
x_oth @ W_halo are each accumulated in f32 and rounded to x's type; attr
is rounded to x's type and attr @ W_attr stays f32; their sum, the
scale/shift (read as f32) and the ReLU are f32; h is rounded to x's type
before the second stage and before every sum; the sums are f32. At f32
every rounding is the identity. The jnp oracles (:498-539) round
elsewhere: they add the three products in x's type.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.plans import BandedPlan

H_KERNEL = 64  # message width the CUDA kernels are compiled for


def plan_tensors(plan: dict, device="cpu", transpose: bool = False):
    """An `ops.plans.banded_plan` dict (numpy) -> the `BandedPlan` of
    tensors on `device`; `transpose` adds the sorted list's transpose by the
    other endpoint, which kernel 6 reads."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    tperm = tptr = None
    if transpose:
        oth = np.asarray(plan["oth"], np.int64)
        n = plan["nptr"].shape[0] - 1
        tperm = t(np.argsort(oth, kind="stable").astype(np.int32))
        tptr = t(np.concatenate([[0], np.cumsum(
            np.bincount(oth, minlength=n))]).astype(np.int32))
    return BandedPlan((t(plan["own"]), t(plan["oth"]), t(plan["attr"]), None,
                       t(plan["nptr"]), t(plan["cnode"]), 0, tperm, tptr))


def message_rows_plain(x, bm, w_own, w_halo, w_attr, sc1, w2=None, sc2=None):
    """The per-edge messages of the plan's sorted list, [E, H] f32 holding
    values of x's type, and their own / other node rows (long)."""
    own, oth, attr = bm.rows()
    dt = x.dtype
    p_own = (x[own].float() @ w_own.to(dt).float()).to(dt).float()
    p_oth = (x[oth].float() @ w_halo.to(dt).float()).to(dt).float()
    pa = attr.to(dt).float() @ w_attr.to(dt).float()
    sc1 = sc1.float()
    h = torch.relu(((p_own + p_oth) + pa) * sc1[0] + sc1[1])
    if w2 is not None:
        sc2 = sc2.float()
        h = torch.relu((h.to(dt).float() @ w2.to(dt).float()) * sc2[0] + sc2[1])
    return h.to(dt).float(), own, oth


def banded_message_sum_plain(x, bm, w_own, w_halo, w_attr, sc1, w2=None,
                             sc2=None):
    """Plain PyTorch version of kernel 5: x [N, C] f32/bf16, bm an
    `ops.plans.BandedPlan`, w_own/w_halo [C, H], w_attr [A, H], sc1 [2, H],
    optional second stage w2 [H, H], sc2 [2, H] -> [N, H] f32."""
    h, own, _ = message_rows_plain(x, bm, w_own, w_halo, w_attr, sc1, w2, sc2)
    out = torch.zeros(x.shape[0], h.shape[1], dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, own, h)


def banded_message_sum_both_plain(x, bm, w_own, w_halo, w_attr, sc1):
    """Plain PyTorch version of kernel 6 -> (own_sum, oth_sum), each
    [N, H] f32, of the single-stage message."""
    h, own, oth = message_rows_plain(x, bm, w_own, w_halo, w_attr, sc1)
    zeros = torch.zeros(x.shape[0], h.shape[1], dtype=torch.float32,
                        device=x.device)
    return (zeros.clone().index_add_(0, own, h),
            zeros.index_add_(0, oth, h))


def _i32(name, t, shape, device):
    if t.dtype != torch.int32 or t.device != device or tuple(t.shape) != shape:
        raise TypeError(f"{name}: {t.dtype}{tuple(t.shape)} on {t.device}, "
                        f"want int32{shape} on {device}")
    return t.contiguous()


def _launch(x, bm, w_own, w_halo, w_attr, sc1, w2, sc2, both: bool):
    """Check the arguments and launch the banded kernel; returns out, or
    (out, out_oth) when `both`."""
    what = "banded_message_sum_both" if both else "banded_message_sum"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no route for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: float32 or bfloat16")
    n, c = x.shape
    e, na = bm.attr.shape
    h = w_own.shape[-1]
    two = w2 is not None
    if h != H_KERNEL or tuple(w_own.shape) != (c, h) \
            or tuple(w_halo.shape) != (c, h) or tuple(w_attr.shape) != (na, h) \
            or tuple(sc1.shape) != (2, h) \
            or (two and (tuple(w2.shape) != (h, h) or sc2 is None
                         or tuple(sc2.shape) != (2, h))):
        raise ValueError(
            f"{what} shapes: x {tuple(x.shape)}, attr {tuple(bm.attr.shape)}, "
            f"w_own {tuple(w_own.shape)}, w_halo {tuple(w_halo.shape)}, w_attr "
            f"{tuple(w_attr.shape)}, sc1 {tuple(sc1.shape)}; needs H == "
            f"{H_KERNEL}")
    if both and (bm.perm is not None or bm.tperm is None or two):
        raise ValueError(f"{what} needs a plan sorted in place with its "
                         "transpose (ops.plans.bm_of(batch, 'cwd_')) and a "
                         "single-stage message")
    dev = x.device
    own, oth = _i32("own", bm.own, (e,), dev), _i32("oth", bm.oth, (e,), dev)
    nptr = _i32("nptr", bm.nptr, (n + 1,), dev)
    perm = None if bm.perm is None else _i32("perm", bm.perm, (e,), dev)
    if bm.cnode is not None:
        cnode = _i32("cnode", bm.cnode, tuple(bm.cnode.shape), dev)
        nc = cnode.shape[0] - 1
    else:
        if bm.wn <= 0:
            raise ValueError(f"{what}: a plan without node cuts needs wn > 0")
        cnode, nc = None, -(-n // bm.wn)
    if bm.attr.dtype != torch.float32 or bm.attr.device != dev:
        raise TypeError(f"attr: {bm.attr.dtype} on {bm.attr.device}, want "
                        f"float32 on {dev}")
    for name, t in (("w_own", w_own), ("w_halo", w_halo), ("w_attr", w_attr),
                    ("sc1", sc1)) + ((("w2", w2), ("sc2", sc2)) if two else ()):
        if t.device != dev or not t.is_floating_point():
            raise TypeError(f"{name}: {t.dtype} on {t.device}, want a float "
                            f"tensor on {dev}")
    out = torch.empty(n, h, dtype=torch.float32, device=dev)
    out_oth = torch.empty_like(out) if both else None
    if n == 0 or nc <= 0:
        return (out, out_oth) if both else out
    lib = _build.library()
    smem = lib.yk_banded_message_smem_bytes(c, na)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"{what}: C={c} needs {smem} bytes of shared memory "
                         f"(> {_build.SMEM_LIMIT})")
    x = x.contiguous()
    attr = bm.attr.contiguous()
    ws = [t.to(x.dtype).contiguous() for t in (w_own, w_halo, w_attr)]
    # the scale/shift pairs are read as f32 whatever their type, as the TPU
    # kernel reads them (banded_message.py:205-208)
    sc1c = sc1.float().contiguous()
    w2c = w2.to(x.dtype).contiguous() if two else None
    sc2c = sc2.float().contiguous() if two else None
    hbuf = tperm = tptr = None
    if both:
        # never empty: the C entry point takes kernel 6 for a non-null hbuf
        hbuf = torch.empty(max(e, 1), h, dtype=x.dtype, device=dev)
        tperm = _i32("tperm", bm.tperm, (e,), dev)
        tptr = _i32("tptr", bm.tptr, (n + 1,), dev)

    def p(t):
        return None if t is None else _build.ptr(t)

    rc = lib.yk_banded_message_sum(
        p(x), p(own), p(oth), p(attr), p(perm), p(nptr), p(cnode), p(ws[0]),
        p(ws[1]), p(ws[2]), p(sc1c), p(w2c), p(sc2c), p(out), p(hbuf),
        p(tperm), p(tptr), p(out_oth), n, c, na, nc, int(bm.wn),
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(lib, rc, what)
    _build.launch_counts[what] += 1
    return (out, out_oth) if both else out


def banded_message_sum(x, bm, w_own, w_halo, w_attr, sc1, w2=None, sc2=None):
    """Kernel 5 on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return banded_message_sum_plain(x, bm, w_own, w_halo, w_attr, sc1,
                                        w2, sc2)
    return _launch(x, bm, w_own, w_halo, w_attr, sc1, w2, sc2, both=False)


def banded_message_sum_both(x, bm, w_own, w_halo, w_attr, sc1):
    """Kernel 6 on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return banded_message_sum_both_plain(x, bm, w_own, w_halo, w_attr, sc1)
    return _launch(x, bm, w_own, w_halo, w_attr, sc1, None, None, both=True)
