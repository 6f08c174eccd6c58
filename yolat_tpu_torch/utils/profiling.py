"""Tracing and profiling tools.

Counterpart of `yolat_tpu/utils/profiling.py:1-67`, on torch:

  * trace(log_dir, device=None): a context manager around
    `torch.profiler.profile`, CPU activity always and CUDA activity when
    `device` is a CUDA device; at exit it writes a Chrome trace
    (`<host>_<pid>.<stamp>.pt.trace.json`) into `log_dir` through
    `torch.profiler.tensorboard_trace_handler`, where the JAX package
    writes a TensorBoard profile (`jax.profiler.start_trace`). It yields
    the profile. The profiler drops records in a long-lived process that
    has run much on the card (`scripts/source_edits.py`, `MARGIN`): a
    reading that must hold every record takes a process of its own.
  * timed(fn, *args, iters=10, warmup=1, **kw): mean seconds per call, as
    JAX computes it: `warmup` calls, each drained, then `iters` calls
    queued back to back and one drain of all their outputs. The drain is
    `torch.cuda.synchronize` on the device of every CUDA tensor in the
    outputs (nested dicts, lists and tuples); CPU tensors need none.
  * cost_analysis(fn, *args, **kw): the floating-point operations of one
    call, counted by `torch.utils.flop_counter.FlopCounterMode`, as
    {"flops", "bytes_accessed": None, "raw": per-op counts}. Two stated
    differences from XLA's count: it counts the matmul family only
    (matmuls, convolutions, attention; not elementwise ops or
    reductions), and it has no count of bytes. It sees only what goes
    through PyTorch's dispatcher: the port's kernels launch through ctypes
    and a CUDA graph replays outside it, so a call that launches a port
    kernel (`ops._build.launch_counts` moved) or replays a graph
    (`ops._build.graph_counts`) raises instead of returning a count that
    leaves their work out. Count the plain route instead, for example the
    module on the CPU at the same shapes.
  * ThroughputMeter: items per second since construction.
"""

from __future__ import annotations

import contextlib
import time

import torch

from yolat_tpu_torch.ops import _build


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def _drain(tree) -> None:
    """Wait for the work behind every CUDA tensor in `tree`."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)


def timed(fn, *args, iters: int = 10, warmup: int = 1, **kw) -> float:
    """Mean wall-clock seconds per call with full pipeline drain."""
    for _ in range(warmup):
        _drain(fn(*args, **kw))
    t0 = time.perf_counter()
    outs = [fn(*args, **kw) for _ in range(iters)]
    _drain(outs)
    return (time.perf_counter() - t0) / iters


def _counts() -> tuple:
    return dict(_build.launch_counts), _build.graph_counts["replayed"]


def cost_analysis(fn, *args, **kw) -> dict:
    """Floating-point operations of one call of fn at these args (matmul
    family only; no bytes). Raises if the call launched a kernel of the
    port or replayed a CUDA graph, whose work the count cannot see."""
    from torch.utils.flop_counter import FlopCounterMode

    launches, replays = _counts()
    with FlopCounterMode(display=False) as mode:
        fn(*args, **kw)
    after, after_replays = _counts()
    moved = {k: v - launches.get(k, 0) for k, v in after.items()
             if v != launches.get(k, 0)}
    if moved or after_replays != replays:
        raise RuntimeError(
            f"cost_analysis: the call launched port kernels {moved} and "
            f"replayed {after_replays - replays} CUDA graphs, whose work "
            "FlopCounterMode cannot see (ctypes launches and graph replays "
            "bypass the dispatcher); count the plain route, for example the "
            "module on the CPU at the same shapes")
    raw = {str(op): int(n) for op, n in
           mode.get_flop_counts().get("Global", {}).items()}
    return {"flops": mode.get_total_flops(), "bytes_accessed": None,
            "raw": raw}


class ThroughputMeter:
    def __init__(self):
        self.n = 0
        self.t0 = time.perf_counter()

    def update(self, n: int):
        self.n += n

    @property
    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.n / dt if dt > 0 else 0.0
