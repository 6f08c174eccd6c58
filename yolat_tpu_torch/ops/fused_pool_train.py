"""Fused training pool head: Dense -> masked BatchNorm (train) -> ReLU ->
per-proposal segment max, with no [N, H] activation in device memory.

Counterpart of `yolat_tpu/ops/fused_pool_train.py` (`_stats` :71-91, the
forward :111-128, the closed-form backward :131-192, the backward kernel
`_bwd_kernel` :198-283, `fused_pool_available` :286-290). The fusion MLP
[N, Cin=128] -> [N, H=1024] of the pool head is the train step's widest
layer; the unfused route writes and re-reads [N, H] three times.

Forward: BN train moments in closed form from the Gram matrix of the
masked rows (f32), the normalisation folded into a per-column scale and
shift with the Dense bias, then relu + 8-row block max through kernel 3
(`ops/block_max.folded_mlp_block_max`) and a sorted segment max over the
aligned pool plan's block owners; empty proposals give 0.

Backward (`FusedPoolTrain.backward`): kernel 11 (`fused_pool_train_bwd`,
`csrc/fused_pool_train.cu`) recomputes z = x @ W per tile, marks each
row that attains its proposal's stored maximum (every tied row gets the
full cotangent, as `ops/segment.segment_max` does) with y > 0, and emits
x^T s, s @ W^T and the column sums of u and u*z; the BN chain rule is
then closed form over [Cin, H]-sized tensors (the Gram matrix, gram @ W
and xm @ (W diag(c2) W^T) stay torch.matmul, as the JAX package left
them to XLA).

Data parallel (`yolat_tpu/ops/fused_pool_train.py:84-87, 158-174`): with
a process group, `_stats` sums (n, zsum, zsq) over its ranks (one packed
[2H + 1] tensor) before the scale and shift kernel 3 folds in, and the
backward sums (usum, uzraw) over them between kernel 11 and the epilogue,
so c1 and c2 come from global sums; dW, db, dgamma and dbeta stay local
(the DP step averages them), db with the local mask count n_l, as in
JAX. Kernels 3 and 11 do not change, and their plain versions take the
same sums, so both routes run this code.

Routes: CUDA tensors take kernels 3 and 11, CPU tensors their plain
versions (`folded_mlp_block_max_plain`, `fused_pool_train_bwd_plain`),
each route recomputing in its own forward's bits; any other device
raises. `route="plain"` forces the plain pair whatever the device, only
to compare the two routes on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.block_max import (NEG, acc_type,
                                           folded_mlp_block_max,
                                           folded_mlp_block_max_plain,
                                           folded_rows)
from yolat_tpu_torch.ops.plans import POOL_BLOCK, plan_aligned

BN_EPS = 1e-5
TILE = 512          # row multiple the fused head needs (fused_pool_train.py:68)
ROWS, COLS = 64, 128  # kernel 11's tile
CI_MAX = 128
KCHUNKS = 32        # row chunks of kernel 11's x^T s pass


def _sum_over(group, *parts):
    """Each part summed over the ranks of `group` in one collective."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return out


def _stats(xm, maskf, w, b, group=None):
    """Closed-form masked BN train moments of z = x@W + b (f32, or float64
    for a float64 xm): mean, var (biased), count (clamped at 1), the
    masked row sum sx and the Gram matrix x^T x (both local). With a
    group, the count and the moments are summed over its ranks."""
    acc = acc_type(xm)
    xf, wf, bf = xm.to(acc), w.to(acc), b.to(acc)
    n = maskf.to(acc).sum()
    sx = xf.sum(dim=0)
    sxw = sx @ wf
    gram = xf.t() @ xf
    zsum = sxw + n * bf
    zsq = (wf * (gram @ wf)).sum(dim=0) + 2.0 * bf * sxw + n * bf * bf
    if group is not None:
        n, zsum, zsq = _sum_over(group, n, zsum, zsq)
    n = torch.clamp(n, min=1.0)
    mean = zsum / n
    var = torch.clamp(zsq / n - mean * mean, min=0.0)
    return mean, var, n, sx, gram


def _scale_shift(mean, var, b, gamma, beta):
    """[2, H] in mean's type (f32, or float64 on the float64 plain route):
    the BN scale and shift folded with the Dense bias."""
    acc = mean.dtype
    inv = torch.rsqrt(var + BN_EPS) * gamma.to(acc)
    return torch.stack([inv, b.to(acc) * inv + beta.to(acc) - mean * inv])


def fused_pool_train_bwd_plain(xm, maskf, w, sc, pooled_b, gp_b,
                               block: int = POOL_BLOCK):
    """Plain PyTorch version of kernel 11: xm [N, Cin] (masked rows),
    maskf [N, 1] f32, w [Cin, H], sc [2, H] f32, pooled_b [N/8, H] in xm's
    type, gp_b [N/8, H] f32 -> (dw_u [Cin, H] f32, dx_s [N, Cin] in xm's
    type, sum u [H] f32, sum u*z [H] f32); for a float64 xm every f32
    above is float64. Recomputes through `folded_rows`, as
    `folded_mlp_block_max_plain` computes."""
    acc = acc_type(xm)
    z, y = folded_rows(xm, w, sc)
    a = torch.where(maskf > 0.0, torch.relu(y), torch.full_like(y, NEG))
    # compare at the stored precision: the recompute rounded as the
    # forward rounded its block maxima
    aq = a.to(pooled_b.dtype).to(acc)
    pr = pooled_b.to(acc).repeat_interleave(block, dim=0)
    gr = gp_b.to(acc).repeat_interleave(block, dim=0)
    u = torch.where((aq == pr) & (y > 0.0), gr, torch.zeros_like(gr))
    s = (u * sc[0].to(acc)).to(xm.dtype).to(acc)
    dw_u = xm.to(acc).t() @ s
    dx_s = (s @ w.to(xm.dtype).to(acc).t()).to(xm.dtype)
    return dw_u, dx_s, u.sum(dim=0), (u * z).sum(dim=0)


def fused_pool_train_bwd(xm, maskf, w, sc, pooled_b, gp_b,
                         block: int = POOL_BLOCK):
    """Kernel 11 on CUDA tensors, its plain version on CPU tensors."""
    if xm.device.type == "cpu":
        return fused_pool_train_bwd_plain(xm, maskf, w, sc, pooled_b, gp_b,
                                          block)
    if xm.device.type != "cuda":
        raise ValueError(f"fused_pool_train_bwd: no route for {xm.device}")
    n, ci = xm.shape
    h = w.shape[1]
    if xm.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {xm.dtype}: float32 or bfloat16")
    if pooled_b.dtype != xm.dtype or maskf.dtype != torch.float32:
        raise TypeError(f"pooled_b {pooled_b.dtype} (want {xm.dtype}), maskf "
                        f"{maskf.dtype} (want float32)")
    if block != POOL_BLOCK or n % ROWS or h % COLS or ci % 8 or ci > CI_MAX \
            or tuple(w.shape) != (ci, h) or tuple(sc.shape) != (2, h) \
            or tuple(maskf.shape) != (n, 1) \
            or tuple(pooled_b.shape) != (n // block, h) \
            or tuple(gp_b.shape) != (n // block, h):
        raise ValueError(
            f"fused_pool_train_bwd shapes: x {tuple(xm.shape)}, w "
            f"{tuple(w.shape)}, sc {tuple(sc.shape)}, pooled_b "
            f"{tuple(pooled_b.shape)}, gp_b {tuple(gp_b.shape)}; needs block "
            f"8, N % {ROWS} == 0, H % {COLS} == 0, Cin % 8 == 0, "
            f"Cin <= {CI_MAX}")
    for arg, t in (("maskf", maskf), ("w", w), ("sc", sc),
                   ("pooled_b", pooled_b), ("gp_b", gp_b)):
        if t.device != xm.device:
            raise TypeError(f"{arg} on {t.device}, x on {xm.device}")
    lib = _build.library()
    if lib.yk_fused_pool_train_smem_bytes(ci) > _build.SMEM_LIMIT:
        raise ValueError(f"Cin={ci} exceeds kernel 11's shared memory")
    tiles = n // ROWS
    k = min(KCHUNKS, tiles)
    dev = xm.device
    # the bf16 kernels copy x, W, sc and the block refs in 16-byte pieces
    x = _build.aligned16(xm.contiguous())
    wc = _build.aligned16(w.to(x.dtype).contiguous())
    scf = _build.aligned16(sc.float().contiguous())
    pb = _build.aligned16(pooled_b.contiguous())
    gb = _build.aligned16(gp_b.float().contiguous())
    dw_u = torch.empty(ci, h, dtype=torch.float32, device=dev)
    dx_s = torch.empty(n, ci, dtype=x.dtype, device=dev)
    sums = torch.empty(2, h, dtype=torch.float32, device=dev)
    part_u = torch.empty(tiles, 2, h, dtype=torch.float32, device=dev)
    part_w = torch.empty(k, ci, h, dtype=torch.float32, device=dev)
    rc = lib.yk_fused_pool_train_bwd(
        _build.ptr(x), _build.ptr(maskf.contiguous()), _build.ptr(wc),
        _build.ptr(scf), _build.ptr(pb), _build.ptr(gb), _build.ptr(dw_u),
        _build.ptr(dx_s), _build.ptr(sums), _build.ptr(part_u),
        _build.ptr(part_w), n, ci, h, k, int(x.dtype == torch.bfloat16),
        _build.stream_of(x))
    _build.check(lib, rc, "fused_pool_train_bwd")
    _build.launch_counts["fused_pool_train_bwd"] += 1
    return dw_u, dx_s, sums[0], sums[1]


class FusedPoolTrain(torch.autograd.Function):
    """(x [N, Cin], maskf [N, 1] f32, W [Cin, H], b [H], gamma [H],
    beta [H], blk_first [N/8] sorted block owners, n_prop, route, group)
    -> pooled [P, H] in x's type, mean [H], var [H] (biased), count (f32
    scalar; over the group's ranks with a group). Only pooled carries a
    gradient; mean/var/count feed the BN running statistics."""

    @staticmethod
    def forward(ctx, x, maskf, w, b, gamma, beta, blk_first, n_prop: int,
                route: str = "kernel", group=None):
        if route not in ("kernel", "plain"):
            raise ValueError(f"route {route!r}: 'kernel' or 'plain'")
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"fused_pool_train: no route for {x.device}")
        xm = x * maskf.to(x.dtype)
        mean, var, n, sx, gram = _stats(xm, maskf, w, b, group)
        sc = _scale_shift(mean, var, b, gamma, beta)
        block_max = (folded_mlp_block_max if route == "kernel"
                     else folded_mlp_block_max_plain)
        bred = block_max(xm, maskf, w, sc, block=POOL_BLOCK)
        h = bred.shape[1]
        idx = blk_first.long()[:, None].expand(-1, h)
        acc = acc_type(x)
        raw = torch.full((n_prop, h), NEG, dtype=acc,
                         device=x.device).scatter_reduce_(
            0, idx, bred.to(acc), "amax", include_self=True)
        pooled = torch.where(raw <= NEG / 2, torch.zeros_like(raw),
                             raw).to(x.dtype)
        # sc is kept, not rebuilt: at f32 the backward finds the winners
        # by exact equality with maxima computed from these very bits
        ctx.save_for_backward(xm, maskf, w, b, blk_first, mean, var, n, sx,
                              gram, sc, pooled)
        ctx.route, ctx.group = route, group
        ctx.gamma_dtype, ctx.beta_dtype = gamma.dtype, beta.dtype
        ctx.mark_non_differentiable(mean, var, n)
        return pooled, mean, var, n

    @staticmethod
    def backward(ctx, gp, _gmean, _gvar, _gn):
        (xm, maskf, w, b, blk_first, mean, var, n, sx, gram, sc,
         pooled) = ctx.saved_tensors
        acc = mean.dtype
        bf, wf = b.to(acc), w.to(acc)
        inv_sig = torch.rsqrt(var + BN_EPS)
        inv = sc[0]  # inv_sig * gamma
        # pooled stays in its stored type: the recompute is compared at
        # the precision the forward stored
        pooled_b = pooled[blk_first.long()]
        gp_b = gp.to(acc)[blk_first.long()]
        bwd = (fused_pool_train_bwd if ctx.route == "kernel"
               else fused_pool_train_bwd_plain)
        dw_u, dx_s, usum, uzraw = bwd(xm, maskf, w, sc, pooled_b, gp_b)
        # u-sums with z' = x@W (no bias): sum u*z adds b * sum u. The BN
        # coupling constants c1, c2 come from the sums over all ranks (the
        # moments are global); the parameter gradients stay local
        usum_g, uzraw_g = ((usum, uzraw) if ctx.group is None
                           else _sum_over(ctx.group, usum, uzraw))
        uzsum_g = uzraw_g + bf * usum_g
        szc = (uzsum_g * inv - mean * (usum_g * inv)) / (var + BN_EPS)
        c2 = -szc / n
        c1 = -(usum_g * inv / n) - mean * c2
        uzsum = uzraw + bf * usum
        n_l = torch.clamp(maskf.to(acc).sum(), min=1.0)  # the local count
        dw = dw_u + sx[:, None] * (c1 + bf * c2)[None, :] + (gram @ wf) * c2
        db = usum * inv + n_l * c1 + c2 * (sx @ wf + n_l * bf)
        dgamma = (uzsum - mean * usum) * inv_sig
        dbeta = usum
        m2 = (wf * c2[None, :]) @ wf.t()
        mrow = maskf.to(acc)
        dx = (dx_s.to(acc) + mrow * ((c1 + bf * c2) @ wf.t())[None, :]
              + xm.to(acc) @ m2)
        # rows enter as xm = x * mask, so only masked-in rows get gradient
        dx = (dx * mrow).to(xm.dtype)
        return (dx, None, dw.to(w.dtype), db.to(b.dtype),
                dgamma.to(ctx.gamma_dtype), dbeta.to(ctx.beta_dtype), None,
                None, None, None)


def fused_pool_train(x, maskf, w, b, gamma, beta, blk_first, n_prop: int,
                     route: str = "kernel", group=None):
    """The fused head; see FusedPoolTrain. w is [Cin, H] (the JAX Dense
    kernel layout); group syncs the batch moments over its ranks."""
    return FusedPoolTrain.apply(x, maskf, w, b, gamma, beta, blk_first,
                                n_prop, route, group)


def fused_pool_available(n_rows: int, plan) -> bool:
    """Routing predicate: an aligned pool plan and N % 512 == 0."""
    return plan is not None and plan_aligned(plan) and n_rows % TILE == 0
