"""Fused fusion-MLP + 8-row block max: the pool head (kernels 2 and 3).

Counterparts of `yolat_tpu/ops/pallas_kernels.py:255-312`
(`folded_mlp_block_max2`, the serving head) and `:196-252`
(`folded_mlp_block_max`, the forward of the fused training head,
`ops/fused_pool_train.py`): relu((x @ W) * sc[0] + sc[1]) max-reduced over
each `block`-row group of masked rows, without materialising the
[N, H] MLP output; the serving form also returns the masked block max of
x itself. Fully masked blocks come out at -1e30 in x's type; the caller's
segment max maps them to 0 (`eval/fast_forward.py`,
`ops/fused_pool_train.py`).

Each wrapper launches the CUDA kernel (`csrc/block_max.cu`) for CUDA
tensors and runs its plain version for CPU tensors; any other device
raises. The plain versions compute the rows through `folded_rows`, which
the training backward's plain version (`ops/fused_pool_train.py`) also
recomputes through, so each route finds the max's winners in its own
forward's bits.
"""

from __future__ import annotations

import torch

from yolat_tpu_torch.ops import _build

NEG = -1e30
ROWS, COLS = 64, 128  # the CUDA kernel's tile


def acc_type(x):
    """The plain routes' accumulation type: float64 for a float64 x (the
    reference a smoke check holds the card's routes to), else float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def folded_rows(x, w, sc):
    """(z, y) [N, H] of the plain pool head in `acc_type(x)`: z = x @ W
    (W in x's type, f32 products and sums for f32 and bf16 x), y = z *
    sc[0] + sc[1]."""
    acc = acc_type(x)
    z = x.to(acc) @ w.to(x.dtype).to(acc)
    return z, z * sc[0].to(acc) + sc[1].to(acc)


def folded_mlp_block_max_plain(x, node_maskf, w, sc, block: int = 8):
    """Plain PyTorch version of kernel 3: x [N, Cin] f32/bf16,
    node_maskf [N, 1] f32, w [Cin, H], sc [2, H] -> [N/block, H] in
    x.dtype."""
    _, y = folded_rows(x, w, sc)
    h = torch.where(node_maskf > 0.0, torch.relu(y), torch.full_like(y, NEG))
    return h.reshape(x.shape[0] // block, block, -1).amax(dim=1).to(x.dtype)


def folded_mlp_block_max2_plain(x, node_maskf, w, sc, block: int = 8):
    """Plain PyTorch version of kernel 2: x [N, Cin] f32/bf16, node_maskf
    [N, 1] f32, w [Cin, H], sc [2, H] -> ([N/block, H], [N/block, Cin]) in
    x.dtype."""
    n, ci = x.shape
    bh = folded_mlp_block_max_plain(x, node_maskf, w, sc, block)
    xm = torch.where(node_maskf > 0.0, x, torch.full_like(x, NEG))
    bx = xm.reshape(n // block, block, ci).amax(dim=1)
    return bh, bx


def _launch(name, x, node_maskf, w, sc, block, with_x):
    """Device, type and shape checks, then one launch of kernel 3
    (`yk_folded_mlp_block_max`) or, with_x, kernel 2
    (`yk_folded_mlp_block_max2`) on CUDA tensors; returns (outh, outx or
    None)."""
    n, ci = x.shape
    h = w.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: float32 or bfloat16")
    if block != 8 or n % ROWS or h % COLS or tuple(w.shape) != (ci, h) \
            or tuple(sc.shape) != (2, h) or tuple(node_maskf.shape) != (n, 1):
        raise ValueError(
            f"{name} shapes: x {tuple(x.shape)}, w {tuple(w.shape)}, sc "
            f"{tuple(sc.shape)}, mask {tuple(node_maskf.shape)}, block "
            f"{block}; needs block 8, N % {ROWS} == 0, H % {COLS} == 0")
    for arg, t in (("node_maskf", node_maskf), ("w", w), ("sc", sc)):
        if t.device != x.device:
            raise TypeError(f"{arg} on {t.device}, x on {x.device}")
    if node_maskf.dtype != torch.float32:
        raise TypeError(f"node_maskf dtype {node_maskf.dtype}: float32")
    lib = _build.library()
    if lib.yk_block_max_smem_bytes(ci) > _build.SMEM_LIMIT:
        raise ValueError(f"Cin={ci} exceeds the kernel's shared memory")
    x = x.contiguous()
    wc = w.to(x.dtype).contiguous()
    scf = sc.float().contiguous()
    outh = torch.empty(n // block, h, dtype=x.dtype, device=x.device)
    outx = (torch.empty(n // block, ci, dtype=x.dtype, device=x.device)
            if with_x else None)
    outs = (outh, outx) if with_x else (outh,)
    rc = getattr(lib, f"yk_{name}")(
        _build.ptr(x), _build.ptr(node_maskf.contiguous()), _build.ptr(wc),
        _build.ptr(scf), *map(_build.ptr, outs), n, ci, h,
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(lib, rc, name)
    return outh, outx


def folded_mlp_block_max(x, node_maskf, w, sc, block: int = 8):
    """Kernel 3 on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return folded_mlp_block_max_plain(x, node_maskf, w, sc, block)
    if x.device.type != "cuda":
        raise ValueError(f"folded_mlp_block_max: no route for {x.device}")
    out, _ = _launch("folded_mlp_block_max", x, node_maskf, w, sc, block,
                     with_x=False)
    _build.launch_counts["folded_mlp_block_max"] += 1
    return out


def folded_mlp_block_max2(x, node_maskf, w, sc, block: int = 8):
    """Kernel 2 on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return folded_mlp_block_max2_plain(x, node_maskf, w, sc, block)
    if x.device.type != "cuda":
        raise ValueError(f"folded_mlp_block_max2: no route for {x.device}")
    bh, bx = _launch("folded_mlp_block_max2", x, node_maskf, w, sc, block,
                     with_x=True)
    _build.launch_counts["folded_mlp_block_max2"] += 1
    return bh, bx
