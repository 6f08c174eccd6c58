"""Edge-window message sum: the serving conv's edge pipeline (kernel 1).

Counterpart of `yolat_tpu/ops/edge_window.py:184-264`
(`edge_window_message_sum`, the Pallas `_kernel` at :125, and its oracle
`edge_window_message_sum_reference`). Per node, the SUM over incoming
edges of the folded-BN message MLP
  relu(relu([x_i || x_j - x_i || attr] @ W1 * sc1[0] + sc1[1]) @ W2
       * sc2[0] + sc2[1]),
over the plan of `ops.plans.edge_window_plan` (real edges, dst-sorted,
per-window offsets). The caller divides by the in-degree and adds the
`lin_r` term (`eval/fast_forward.py`).

`edge_window_message_sum` launches the CUDA kernel
(`csrc/edge_window.cu`) for CUDA tensors and runs
`edge_window_message_sum_plain` for CPU tensors; any other device raises.
A bf16 x takes the kernel's tensor-core route (`edge_window_tc_kernel`,
wgmma), an f32 x its IEEE FMA route (`edge_window_kernel`); a failed build
or launch raises, with no fallback to the other route or to the plain
version. Both follow the TPU kernel's rounding: W1 split as (W1a - W1b,
W1b, W1c) in x's type, x_i/x_j/attr, h1 and h2 rounded to x's type, f32
sums.

`edge_window_decomp` is the same kernel with parts of its row loads
switched off, the counterpart of the probe kernel of
`scripts/ew_kernel_decomp.py:41-105` (kernel 12; timed by
`yolat_tpu_torch.scripts.ew_kernel_decomp`). Each variant computes kernel
1's function on transformed inputs (`decomp_inputs`): `full` on the inputs
as they are, `noband` on the plan with src := dst (x_j = x_i, as the
probe's `ohs = ohl`), `noonehot` on x filled with 0.001 in x's type (no row
of x read). Nothing on a serving or training path calls it.
"""

from __future__ import annotations

import torch

from yolat_tpu_torch.ops import _build

H_KERNEL = 64  # message width the CUDA kernel is compiled for
# the decomposition variants, by their index in the C entry point
VARIANTS = ("full", "noband", "noonehot")
NOONEHOT_VALUE = 0.001  # what the noonehot variant reads for every x value


def _split_w1(w1, c: int, dtype):
    """[W1a; W1b; W1c] -> [W1a - W1b; W1b; W1c], formed in `dtype` as the
    TPU kernel forms it (edge_window.py:139-140)."""
    w1 = w1.to(dtype)
    return torch.cat([w1[:c] - w1[c:2 * c], w1[c:]], dim=0)


def edge_window_message_sum_plain(x, ew, w1, sc1, w2, sc2):
    """Plain PyTorch version: x [N, C] f32/bf16, ew = (src [E], dst [E],
    attr [E, A], wptr [NW + 1], wn) from `ops.plans.ew_of`, w1 [2C+A, H],
    sc1/sc2 [2, H], w2 [H, H] -> [N, H] f32. Rows past wptr[-1] (the
    capacity padding of `ops.plans.pad_plans`) are left out, as the
    kernel's windows leave them out."""
    e = int(ew[3][-1])
    src, dst, attr = (t[:e] for t in ew[:3])
    n, c = x.shape
    dt = x.dtype
    w1s = _split_w1(w1, c, dt).float()
    w2f = w2.to(dt).float()
    sc1, sc2 = sc1.float(), sc2.float()
    dst = dst.long()
    x_i, x_j = x[dst].float(), x[src.long()].float()
    a = attr.to(dt).float()
    h = x_i @ w1s[:c] + x_j @ w1s[c:2 * c] + a @ w1s[2 * c:]
    h = torch.relu(h * sc1[0] + sc1[1]).to(dt).float()
    h = torch.relu((h @ w2f) * sc2[0] + sc2[1]).to(dt).float()
    out = torch.zeros(n, h.shape[-1], dtype=torch.float32, device=x.device)
    return out.index_add_(0, dst, h)


def edge_window_message_sum(x, ew, w1, sc1, w2, sc2):
    """Kernel 1 on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return edge_window_message_sum_plain(x, ew, w1, sc1, w2, sc2)
    return _launch("edge_window_message_sum", None, x, ew, w1, sc1, w2, sc2)


def decomp_inputs(x, ew, variant: str):
    """(x, ew) on which kernel 1 computes what `variant` computes."""
    if variant == "full":
        return x, ew
    if variant == "noband":
        return x, (ew[1],) + tuple(ew[1:])
    if variant == "noonehot":
        return torch.full_like(x, NOONEHOT_VALUE), ew
    raise ValueError(f"edge-window variant {variant!r}: one of {VARIANTS}")


def edge_window_decomp_plain(x, ew, w1, sc1, w2, sc2, variant: str):
    """Plain PyTorch version of the decomposition variants: kernel 1's
    plain version on the variant's inputs."""
    return edge_window_message_sum_plain(*decomp_inputs(x, ew, variant), w1,
                                         sc1, w2, sc2)


def edge_window_decomp(x, ew, w1, sc1, w2, sc2, variant: str):
    """Kernel 12 (a variant of kernel 1) on CUDA tensors, its plain version
    on CPU tensors."""
    if variant not in VARIANTS:
        raise ValueError(f"edge-window variant {variant!r}: one of {VARIANTS}")
    if x.device.type == "cpu":
        return edge_window_decomp_plain(x, ew, w1, sc1, w2, sc2, variant)
    return _launch("edge_window_decomp", VARIANTS.index(variant), x, ew, w1,
                   sc1, w2, sc2)


def route_info(c: int, na: int, wn: int, dtype) -> dict:
    """The shared memory per CTA (bytes) and the CTAs per SM of the route
    that x of `dtype` takes at these shapes (CUDA occupancy query; needs
    the card)."""
    lib = _build.library()
    bf16 = int(dtype == torch.bfloat16)
    ctas = lib.yk_edge_window_ctas_per_sm(c, na, wn, bf16)
    if ctas < 0:
        _build.check(lib, -ctas, "edge_window occupancy query")
    return {"smem_bytes": lib.yk_edge_window_smem_bytes(c, na, wn, bf16),
            "ctas_per_sm": ctas}


def _launch(name, variant, x, ew, w1, sc1, w2, sc2):
    """Check the inputs and launch kernel 1 (variant None) or its
    decomposition variant; counts the launch under `name`."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no route for {x.device}")
    src, dst, attr, wptr, wn = ew
    n, c = x.shape
    e, na = attr.shape
    h = w2.shape[-1]
    nw = wptr.shape[0] - 1
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: float32 or bfloat16")
    if h != H_KERNEL or nw != -(-n // wn) or tuple(src.shape) != (e,) \
            or tuple(dst.shape) != (e,) or tuple(w1.shape) != (2 * c + na, h) \
            or tuple(w2.shape) != (h, h) or tuple(sc1.shape) != (2, h) \
            or tuple(sc2.shape) != (2, h):
        raise ValueError(
            f"{name} shapes: x {tuple(x.shape)}, plan "
            f"{tuple(src.shape)}/{tuple(attr.shape)}/{tuple(wptr.shape)} at "
            f"wn={wn}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}; needs "
            f"H == {H_KERNEL} and ceil(N / wn) windows")
    for tname, t, dt in (("src", src, torch.int32), ("dst", dst, torch.int32),
                         ("attr", attr, torch.float32),
                         ("wptr", wptr, torch.int32)):
        if t.dtype != dt or t.device != x.device:
            raise TypeError(f"{tname}: {t.dtype} on {t.device}, want {dt} on "
                            f"{x.device}")
    for tname, t in (("w1", w1), ("w2", w2), ("sc1", sc1), ("sc2", sc2)):
        if t.device != x.device or not t.is_floating_point():
            raise TypeError(f"{tname}: {t.dtype} on {t.device}, want a float "
                            f"tensor on {x.device}")
    out = torch.empty(n, h, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _build.library()
    bf16 = int(x.dtype == torch.bfloat16)
    smem = lib.yk_edge_window_smem_bytes(c, na, wn, bf16)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"edge window of WN={wn}, C={c} needs {smem} bytes "
                         f"of shared memory (> {_build.SMEM_LIMIT})")
    x = x.contiguous()
    w1s = _split_w1(w1, c, x.dtype).contiguous()
    w2c = w2.to(x.dtype).contiguous()
    ins = [t.contiguous() for t in (src, dst, attr, wptr)]
    # the scale/shift pairs are read as f32 whatever their type, as the
    # TPU kernel reads them (edge_window.py:142-143)
    sc1c, sc2c = sc1.float().contiguous(), sc2.float().contiguous()
    args = (_build.ptr(x), *[_build.ptr(t) for t in ins], _build.ptr(w1s),
            _build.ptr(sc1c), _build.ptr(w2c), _build.ptr(sc2c),
            _build.ptr(out), n, c, nw, wn, na, bf16, _build.stream_of(x))
    if variant is None:
        rc = lib.yk_edge_window_message_sum(*args)
    else:
        rc = lib.yk_edge_window_decomp(variant, *args)
    _build.check(lib, rc, name)
    _build.launch_counts[name] += 1
    return out
