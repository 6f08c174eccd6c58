"""Host-to-device staging of packed numpy batches, for steps that run
from fixed device buffers (CUDA graphs).

Counterpart of the pack / unpack of `yolat_tpu/eval/predict.py:289-371`
(`make_serving_fn`), which the port's serving fn (`eval/predict.py`) and
scan train step (`train/loop.py`) share: a batch's kept arrays as
16-byte-aligned segments of one uint8 buffer (`PackSpec`), four rotating
host buffers (pinned on the card) and one non-blocking transfer into a
device buffer that stays put (`StagedBuffers`), and outputs queued back to
fresh host memory behind the step (`fetch`). A step is bound to one shape
signature (`batch_signature`).
"""

from __future__ import annotations

import numpy as np
import torch

# floats the bf16 serving engine casts to bf16 before any arithmetic (a
# gather or a concatenation at most in between: `fast_forward` reads pos
# through x = [0 | pos] and `.to(bf16)`, `fast_forward_pp` through that and
# `pos.to(x.dtype)`; kernel 4 and its plain version round nbr_attr to x's
# type first): they cross as bf16, and bf16(f32(bf16(v))) = bf16(v), so the
# detections are bit-identical. Extend only after the same audit and with
# the exact-parity test passing.
BF16_WIRE = ("pos", "nbr_attr")


def batch_signature(batch: dict) -> tuple:
    """A numpy batch's key set and shapes: a serving fn or a train step is
    bound to one (`yolat_tpu/cli/infer.py:223-228`). Batches of one loader
    share it once their plans are at capacity (`ops.plans.pad_plans`)."""
    return tuple(sorted((k, np.shape(v)) for k, v in batch.items()))


class PackSpec:
    """16-byte-aligned segments of one uint8 buffer, one per kept key:
    bool rides as uint8, and with `bf16_wire` the `BF16_WIRE` floats as
    bf16 (half the bytes), upcast to f32 after the transfer."""

    def __init__(self, example: dict, keys, bf16_wire: bool = False):
        self.entries = []
        off = 0
        for k in keys:
            a = np.asarray(example[k])
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            wire = (torch.bfloat16 if bf16_wire and k in BF16_WIRE
                    and dtype == torch.float32 else
                    torch.uint8 if dtype == torch.bool else dtype)
            nb = a.size * wire.itemsize
            self.entries.append((k, a.shape, dtype, wire, off, nb))
            off += (nb + 15) // 16 * 16
        self.total = off

    def pack(self, batch: dict, row) -> None:
        """Write a numpy batch's kept arrays into `row` (uint8 [total],
        host memory); raises on a shape or type off the spec."""
        for k, shape, dtype, wire, o, nb in self.entries:
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
                raise ValueError(
                    f"batch[{k!r}] {t.dtype} {tuple(t.shape)} is not the pack "
                    f"spec's {dtype} {tuple(shape)}: a serving or train "
                    "step is bound to one shape signature; make one per "
                    "signature")
            if nb == 0:
                continue
            if wire != dtype:
                t = t.to(wire) if wire == torch.bfloat16 else t.view(wire)
            row[o:o + nb].copy_(t.reshape(-1).view(torch.uint8))

    def unpack(self, row) -> dict:
        """Views of `row` (uint8 [total]) as the batch's tensors."""
        out = {}
        for k, shape, dtype, wire, o, nb in self.entries:
            if nb == 0:  # an empty array (the aligned pool plan's boundary)
                out[k] = row.new_empty(shape, dtype=dtype)
                continue
            v = row[o:o + nb].view(wire).reshape(shape)
            out[k] = v.view(dtype) if dtype == torch.bool else v.to(dtype)
        return out


class Fetched:
    """A step's outputs on their way to the host: `numpy()` waits for the
    copy (on the card it was queued behind the step) and returns arrays."""

    def __init__(self, host: dict, event=None):
        self.host, self.event = host, event

    def numpy(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return {k: v.numpy() for k, v in self.host.items()}


class StagedBuffers:
    """Four rotating host buffers [rows, total] (pinned on the card) and,
    on the card, one device buffer the step reads: `stage(batches)` packs
    the batches (a short list repeats its last row), copies them over in
    one non-blocking transfer and returns the device buffer. A host buffer
    is packed again only after its transfer has finished."""

    def __init__(self, spec: PackSpec, rows: int, device):
        self.spec, self.rows, self.device = spec, rows, torch.device(device)
        cuda = self.device.type == "cuda"
        self.host = [torch.empty((rows, spec.total), dtype=torch.uint8,
                                 pin_memory=cuda) for _ in range(4)]
        self.done = [None] * 4
        self.slot = 0
        self.dev = (torch.zeros((rows, spec.total), dtype=torch.uint8,
                                device=self.device) if cuda else None)

    def stage(self, batches):
        if not 1 <= len(batches) <= self.rows:
            raise ValueError(f"{len(batches)} batches for {self.rows} rows")
        i = self.slot
        self.slot = (i + 1) % len(self.host)
        buf = self.host[i]
        if self.done[i] is not None:
            self.done[i].synchronize()
        for r, b in enumerate(batches):
            self.spec.pack(b, buf[r])
        for r in range(len(batches), self.rows):
            buf[r].copy_(buf[len(batches) - 1])
        if self.dev is None:
            return buf
        self.dev.copy_(buf, non_blocking=True)
        self.done[i] = torch.cuda.Event()
        self.done[i].record()
        return self.dev


def fetch(out: dict) -> Fetched:
    """Queue the copy of a step's device outputs to fresh host memory
    (pinned, so the copy does not wait) behind the step; CPU outputs are
    fetched as they are."""
    first = next(iter(out.values()))
    if first.device.type != "cuda":
        return Fetched(dict(out))
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            for k, v in out.items()}
    for k, v in out.items():
        host[k].copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return Fetched(host, event)
