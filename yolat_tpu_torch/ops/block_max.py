"""Fused fusion-MLP + 8-row block max: the serving pool head (kernel 2).

Counterpart of `yolat_tpu/ops/pallas_kernels.py:255-312`
(`folded_mlp_block_max2`): relu((x @ W) * sc[0] + sc[1]) max-reduced over
each `block`-row group of masked rows, without materialising the
[N, H] MLP output, plus the masked block max of x itself. Fully masked
blocks come out at -1e30 in x's type; the caller's segment max maps
them to 0 (`eval/fast_forward.py`).

`folded_mlp_block_max2` launches the CUDA kernel (`csrc/block_max.cu`)
for CUDA tensors and runs `folded_mlp_block_max2_plain` for CPU tensors;
any other device raises.
"""

from __future__ import annotations

import torch

from yolat_tpu_torch.ops import _build

NEG = -1e30
ROWS, COLS = 64, 128  # the CUDA kernel's tile


def folded_mlp_block_max2_plain(x, node_maskf, w, sc, block: int = 8):
    """Plain PyTorch version: x [N, Cin] f32/bf16, node_maskf [N, 1] f32,
    w [Cin, H], sc [2, H] -> ([N/block, H], [N/block, Cin]) in x.dtype."""
    n, ci = x.shape
    h = (x.float() @ w.to(x.dtype).float())
    h = torch.relu(h * sc[0].float() + sc[1].float())
    m = node_maskf > 0.0
    h = torch.where(m, h, torch.full_like(h, NEG))
    bh = h.reshape(n // block, block, -1).amax(dim=1).to(x.dtype)
    xm = torch.where(m, x, torch.full_like(x, NEG))
    bx = xm.reshape(n // block, block, ci).amax(dim=1)
    return bh, bx


def folded_mlp_block_max2(x, node_maskf, w, sc, block: int = 8):
    """Kernel 2 on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return folded_mlp_block_max2_plain(x, node_maskf, w, sc, block)
    if x.device.type != "cuda":
        raise ValueError(f"folded_mlp_block_max2: no route for {x.device}")
    n, ci = x.shape
    h = w.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: float32 or bfloat16")
    if block != 8 or n % ROWS or h % COLS or tuple(w.shape) != (ci, h) \
            or tuple(sc.shape) != (2, h) or tuple(node_maskf.shape) != (n, 1):
        raise ValueError(
            f"folded_mlp_block_max2 shapes: x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}, sc {tuple(sc.shape)}, mask "
            f"{tuple(node_maskf.shape)}, block {block}; needs block 8, "
            f"N % {ROWS} == 0, H % {COLS} == 0")
    for name, t in (("node_maskf", node_maskf), ("w", w), ("sc", sc)):
        if t.device != x.device:
            raise TypeError(f"{name} on {t.device}, x on {x.device}")
    if node_maskf.dtype != torch.float32:
        raise TypeError(f"node_maskf dtype {node_maskf.dtype}: float32")
    lib = _build.library()
    if lib.yk_block_max_smem_bytes(ci) > _build.SMEM_LIMIT:
        raise ValueError(f"Cin={ci} exceeds the kernel's shared memory")
    x = x.contiguous()
    wc = w.to(x.dtype).contiguous()
    scf = sc.float().contiguous()
    m = node_maskf.contiguous()
    bh = torch.empty(n // block, h, dtype=x.dtype, device=x.device)
    bx = torch.empty(n // block, ci, dtype=x.dtype, device=x.device)
    rc = lib.yk_folded_mlp_block_max2(
        _build.ptr(x), _build.ptr(m), _build.ptr(wc), _build.ptr(scf),
        _build.ptr(bh), _build.ptr(bx), n, ci, h,
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(lib, rc, "folded_mlp_block_max2")
    _build.launch_counts["folded_mlp_block_max2"] += 1
    return bh, bx
