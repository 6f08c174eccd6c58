"""The NMS fixed point on the device (kernel N1) and its plain loop.

Counterpart of the `lax.while_loop`s of `yolat_tpu/ops/nms.py:211`
(`_fixpoint_nms`) and :297 (`_class_fixpoint_nms`), which XLA runs on the
device. Both iterate

  kept = valid & ~any_j(j suppresses i & kept_j)

from kept = valid until nothing changes. Suppression comes only from a
better rank, so the fixed point is unique and the kernel's booleans equal
the plain loop's exactly.

  fixpoint_kept(sup, valid)          sup [B, C, C] bool: sup[b, i, j] = j
                                     outranks and overlaps i; valid [B, C]
  classfix_kept(overb, rank, cand)   overb [B, M, M] bool: overb[b, j, i] =
                                     box j overlaps box i; rank [B, K, M]
                                     int32; cand [B, K, M] bool; j suppresses
                                     i when kept_j, overb[b, j, i] and
                                     rank_j < rank_i (the compare is in the
                                     kernel)

Each wrapper launches `csrc/nms_fixpoint.cu` (one thread block per image,
or per image and class) for CUDA tensors and runs its plain version, the
loop that reads back one flag per sweep, for CPU tensors; any other device
raises. The kernel never reads back: a serving step that calls it can be
captured as a CUDA graph.
"""

from __future__ import annotations

import torch

from yolat_tpu_torch.ops import _build


def fixpoint_kept_plain(sup, valid):
    def step(kept):
        return valid & ~(sup & kept[:, None, :]).any(dim=2)

    prev, kept = valid, step(valid)
    while bool((kept != prev).any()):
        prev, kept = kept, step(kept)
    return kept


def classfix_kept_plain(overb, rank, cand):
    big = torch.full_like(rank[:, :, :, None], rank.shape[2])

    def step(kept):
        # the best (lowest) rank among the kept boxes j that overlap i; i
        # itself contributes its own rank, never below it
        kj = kept[:, :, :, None] & overb[:, None, :, :]   # [B, K, Mj, Mi]
        mn = torch.where(kj, rank[:, :, :, None], big).amin(dim=2)
        return cand & ~(mn < rank)

    prev, kept = cand, step(cand)
    while bool((kept != prev).any()):
        prev, kept = kept, step(kept)
    return kept


def _check(name: str, t, dtype, shape, ref) -> None:
    if t.dtype != dtype or t.device != ref.device or tuple(t.shape) != shape:
        raise TypeError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                        f"want {dtype} {shape} on {ref.device}")


def _device(t, name: str) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain loop."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no route for {t.device}")
    return True


def fixpoint_kept(sup, valid):
    """kept [B, C] bool: the fixed point of `fixpoint` NMS."""
    if not _device(sup, "nms_fixpoint"):
        return fixpoint_kept_plain(sup, valid)
    b, c = valid.shape
    _check("sup", sup, torch.bool, (b, c, c), valid)
    _check("valid", valid, torch.bool, (b, c), valid)
    sup, valid = sup.contiguous(), valid.contiguous()
    kept = torch.empty_like(valid)
    if kept.numel() == 0:
        return kept
    lib = _build.library()
    _build.check(lib, lib.yk_nms_fixpoint(
        _build.ptr(sup), _build.ptr(valid), _build.ptr(kept), b, c,
        _build.stream_of(sup)), "nms_fixpoint")
    _build.launch_counts["nms_fixpoint"] += 1
    return kept


def classfix_kept(overb, rank, cand):
    """kept [B, K, M] bool: the fixed point of `classfix` NMS."""
    if not _device(overb, "nms_classfix"):
        return classfix_kept_plain(overb, rank, cand)
    b, k, m = cand.shape
    _check("overb", overb, torch.bool, (b, m, m), cand)
    _check("rank", rank, torch.int32, (b, k, m), cand)
    _check("cand", cand, torch.bool, (b, k, m), cand)
    # the kernel reads a row per box i: box j overlaps box i at [b, i, j]
    ovt = overb.transpose(1, 2).contiguous()
    rank, cand = rank.contiguous(), cand.contiguous()
    kept = torch.empty_like(cand)
    if kept.numel() == 0:
        return kept
    lib = _build.library()
    _build.check(lib, lib.yk_nms_classfix(
        _build.ptr(ovt), _build.ptr(rank), _build.ptr(cand), _build.ptr(kept),
        b, k, m, _build.stream_of(cand)), "nms_classfix")
    _build.launch_counts["nms_classfix"] += 1
    return kept
