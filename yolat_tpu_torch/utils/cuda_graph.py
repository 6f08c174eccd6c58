"""One step captured as a CUDA graph, with launch counts that replays keep.

On the card a serving batch or a train step is a few hundred to a few
thousand kernels; launched eagerly, the host's issue time is most of the
step's wall. The JAX package compiles one program per shape signature and
dispatches it once per step; the port's counterpart is one CUDA graph per
shape signature, captured once and replayed.

`CapturedStep(fn)` captures `fn()` (all its inputs in tensors that stay
put: the caller copies each step's inputs into them) on the device's side
stream (`side_stream`, one for every capture); a
call that would synchronise with the host, from any thread, fails the
capture, which raises: nothing falls back to eager (the loader's prefetch
thread packs with numpy and makes no CUDA call). `replay()` runs the graph on
the current stream and returns `fn`'s outputs, which the next replay
overwrites. The kernel wrappers count a launch when they are called, so a
capture counts launches that did not run: they are taken off
`_build.launch_counts` at capture and added back at each replay (the
warm-up call is set-up, and its launches are taken off too), and
`_build.graph_counts` counts captures and replays. Generators `fn` draws
from (augmentation, dropout) are registered with the graph, so each replay
advances them as the eager step would.
"""

from __future__ import annotations

import functools

import torch

from yolat_tpu_torch.ops import _build


@functools.cache
def side_stream(index: int) -> torch.cuda.Stream:
    """The side stream of every capture on device `index` (and of the
    train step's checked eager call). cuBLAS keeps a workspace per handle
    and stream, made at the stream's first matmul: made inside a capture,
    it comes from that graph's private pool and keeps the pool alive after
    the graph is freed, and a new stream per capture makes a new one each
    time. So one stream serves every capture, and its first matmuls run
    here, outside any capture."""
    stream = torch.cuda.Stream(device=index)
    with torch.cuda.stream(stream):
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.ones(64, 64, device=f"cuda:{index}", dtype=dtype)
            torch.nn.functional.linear(a, a, a[0])
            torch.matmul(a, a)
    stream.synchronize()
    return stream


class CapturedStep:
    """`fn` as a CUDA graph. With `warmup`, `fn()` runs once on the side
    stream first (lazy initialisation: handles, kernel attributes,
    optimizer state); a caller whose first call is a real step that must
    not run twice runs that step itself and passes warmup=False."""

    def __init__(self, fn, generators=(), warmup: bool = True):
        stream = side_stream(torch.cuda.current_device())
        stream.wait_stream(torch.cuda.current_stream())
        before = dict(_build.launch_counts)
        if warmup:
            with torch.cuda.stream(stream):
                fn()
            torch.cuda.current_stream().wait_stream(stream)
            # set-up, not the path: its launches are not counted
            _build.launch_counts.update(before)
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        with torch.cuda.graph(self.graph, stream=stream):
            self.out = fn()
        self.launches = {k: v - before[k]
                         for k, v in _build.launch_counts.items()}
        _build.launch_counts.update(before)  # the capture ran nothing
        _build.graph_counts["captured"] += 1

    def pool_bytes(self) -> int:
        """Device memory the graph's private pool holds: the segments the
        caching allocator's snapshot files under its pool id."""
        pool = tuple(self.graph.pool())
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    def replay(self):
        self.graph.replay()
        for k, n in self.launches.items():
            _build.launch_counts[k] += n
        _build.graph_counts["replayed"] += 1
        return self.out
