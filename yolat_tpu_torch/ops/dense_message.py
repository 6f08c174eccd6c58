"""Fused dense-table conv: the serving conv over the per-node neighbour
table (kernel 4).

Counterpart of `yolat_tpu/ops/pallas_kernels.py:82-191`
(`fused_dense_message`, the Pallas `_fused_message_kernel` at :38, and its
oracle `fused_dense_message_reference`). Per node i, over its neighbour
slots k < D (`data/packing.add_dense_neighbors`):

  h(i,k) = relu(relu([x_i || x_nbr - x_i || attr] @ W1 * sc1[0] + sc1[1])
                @ W2 * sc2[0] + sc2[1])
  out_i  = sum_k mask(i,k) h(i,k) / max(sum_k mask(i,k), 1) + x_i @ Wr + br

so, unlike the edge-window message sum, the mean and the `lin_r` skip are
inside: the engine adds nothing on this route. A node with every slot
masked (padding) comes out as x_i @ Wr + br.

`fused_dense_message` launches the CUDA kernel (`csrc/dense_message.cu`)
for CUDA tensors, at any N, and runs `fused_dense_message_plain` for CPU
tensors; any other device raises. Both follow the TPU kernel's rounding
(:63-78, :113-123, :164-167): x's type is the compute type; W1 is split by
input rows and W1a - W1b is formed in f32, then rounded; s_i = x @ (W1a -
W1b), h1 and the masked h2 are rounded to the compute type before the next
product or sum; products and sums are f32; sc1, sc2 and br are read as f32.
"""

from __future__ import annotations

import torch

from yolat_tpu_torch.ops import _build

H_KERNEL = 64  # message width the CUDA kernel is compiled for


def _split_w1(w1, c: int, dtype):
    """[W1a; W1b; W1c] -> [W1a - W1b; W1b; W1c], the difference formed in
    f32 and then rounded to `dtype` (pallas_kernels.py:121-123, :164)."""
    w1 = w1.float()
    return torch.cat([w1[:c] - w1[c:2 * c], w1[c:]], dim=0).to(dtype)


def fused_dense_message_plain(x, nbr_idx, nbr_attr, nbr_mask, w1, sc1, w2,
                              sc2, wr, br):
    """Plain PyTorch version: x [N, C] f32/bf16, nbr_idx [N, D] i32,
    nbr_attr [N, D, A], nbr_mask [N, D] bool, w1 [2C+A, H], sc1/sc2 [2, H],
    w2 [H, H], wr [C, H], br [H] -> [N, H] f32."""
    n, c = x.shape
    d = nbr_idx.shape[1]
    dt = x.dtype
    w1s = _split_w1(w1, c, dt).float()
    sc1, sc2 = sc1.float(), sc2.float()
    xf = x.float()
    s_i = (xf @ w1s[:c]).to(dt).float()
    x_nbr = xf.index_select(0, nbr_idx.reshape(-1).long()).reshape(n, d, c)
    pre = (x_nbr @ w1s[c:2 * c] + nbr_attr.to(dt).float() @ w1s[2 * c:]
           + s_i[:, None, :])
    h = torch.relu(pre * sc1[0] + sc1[1]).to(dt).float()
    h = torch.relu((h @ w2.to(dt).float()) * sc2[0] + sc2[1])
    m = nbr_mask.float()[..., None]
    agg = (h * m).to(dt).float().sum(dim=1) * (
        1.0 / torch.clamp(m.sum(dim=1), min=1.0))
    return agg + xf @ wr.to(dt).float() + br.float().reshape(1, -1)


def fused_dense_message(x, nbr_idx, nbr_attr, nbr_mask, w1, sc1, w2, sc2, wr,
                        br):
    """Kernel 4 on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_dense_message_plain(x, nbr_idx, nbr_attr, nbr_mask, w1,
                                         sc1, w2, sc2, wr, br)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dense_message: no route for {x.device}")
    n, c = x.shape
    h = w2.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: float32 or bfloat16")
    if nbr_idx.dim() != 2 or nbr_attr.dim() != 3:
        raise ValueError(f"fused_dense_message: nbr_idx {tuple(nbr_idx.shape)}, "
                         f"nbr_attr {tuple(nbr_attr.shape)}; want [N, D] and "
                         "[N, D, A]")
    d, na = nbr_idx.shape[1], nbr_attr.shape[2]
    if h != H_KERNEL or tuple(nbr_idx.shape) != (n, d) \
            or tuple(nbr_attr.shape) != (n, d, na) \
            or tuple(nbr_mask.shape) != (n, d) \
            or tuple(w1.shape) != (2 * c + na, h) or tuple(w2.shape) != (h, h) \
            or tuple(sc1.shape) != (2, h) or tuple(sc2.shape) != (2, h) \
            or tuple(wr.shape) != (c, h) or br.numel() != h:
        raise ValueError(
            f"fused_dense_message shapes: x {tuple(x.shape)}, table "
            f"{tuple(nbr_idx.shape)}/{tuple(nbr_attr.shape)}/"
            f"{tuple(nbr_mask.shape)}, w1 {tuple(w1.shape)}, w2 "
            f"{tuple(w2.shape)}, wr {tuple(wr.shape)}, br {tuple(br.shape)}; "
            f"needs H == {H_KERNEL}")
    if nbr_idx.dtype != torch.int32 or nbr_mask.dtype != torch.bool \
            or not nbr_attr.is_floating_point():
        raise TypeError(f"nbr_idx {nbr_idx.dtype} (want int32), nbr_mask "
                        f"{nbr_mask.dtype} (want bool), nbr_attr "
                        f"{nbr_attr.dtype} (want a float type)")
    for name, t in (("nbr_idx", nbr_idx), ("nbr_attr", nbr_attr),
                    ("nbr_mask", nbr_mask), ("w1", w1), ("w2", w2),
                    ("sc1", sc1), ("sc2", sc2), ("wr", wr), ("br", br)):
        if t.device != x.device:
            raise TypeError(f"{name} on {t.device}, x on {x.device}")
    out = torch.empty(n, h, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _build.library()
    smem = lib.yk_dense_message_smem_bytes(c, na)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"dense message at C={c} needs {smem} bytes of "
                         f"shared memory (> {_build.SMEM_LIMIT})")
    ins = [x.contiguous(), nbr_idx.contiguous(),
           nbr_attr.float().contiguous(), nbr_mask.contiguous(),
           _split_w1(w1, c, x.dtype).contiguous(), sc1.float().contiguous(),
           w2.to(x.dtype).contiguous(), sc2.float().contiguous(),
           wr.to(x.dtype).contiguous(), br.float().contiguous()]
    # two CTAs of this kernel's shared memory fit one SM; they loop over tiles
    max_ctas = 2 * torch.cuda.get_device_properties(
        x.device).multi_processor_count
    rc = lib.yk_fused_dense_message(
        *[_build.ptr(t) for t in ins], _build.ptr(out), n, c, d, na, max_ctas,
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(lib, rc, "fused_dense_message")
    _build.launch_counts["fused_dense_message"] += 1
    return out
