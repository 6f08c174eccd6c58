"""The profiler's device time of kernel calls and of their library calls,
warm and L2-flushed, in a process of its own.

  python -m yolat_tpu_torch.scripts.profiled_calls SPECS

SPECS is a file written by `torch.save` of {key: (function, args)}: the
function is "module:name" (a wrapper of the port, as
"yolat_tpu_torch.ops.edge_window_train:pair_fwd") or the name of one of
this module's library calls (`LIBRARY`), and args its positional
arguments (tensors on the card, ints, dtypes). For each key it reads the
profiler's device time per call (`source_edits.call_us`, 40 calls after
three that are not profiled): back to back ("warm"), and each after a
write of FLUSH_BYTES of scratch memory that the profiler does not count
("flushed"). Prints one JSON line {"times": {key: [warm ms, flushed ms]}}.

`in_child` writes the file and runs this module in a new process. That is
what `chip_smoke.py` does for kernels 7-10b: inside its own process, after
the CLIs and earlier readings have run there, the profiler drops records
(one of a profile's records, or all of them) in most runs, whatever the
margin; in a new process `scripts/profiler_records.py` sees no profile
drop a record with `source_edits.MARGIN` (PERF.md §7).
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile

# L2-flushed readings write this much scratch memory before every call
# (the H100's L2 holds 50 MB)
FLUSH_BYTES = 128 << 20
REPS = 40
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def l2_flush(dev):
    """A callable that writes FLUSH_BYTES of scratch memory (one
    device-to-device copy), so that the next call finds its inputs in
    device memory, not in L2."""
    import torch

    src = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    return lambda: dst.copy_(src)


def gather(x, i):
    return x.index_select(0, i)


def gather2(x, i, j):
    return x.index_select(0, i), x.index_select(0, j)


def index_add(n, c, i, a):
    import torch

    return torch.zeros(n, c, device=a.device).index_add_(0, i, a)


def index_add2(n, c, i, a, j, b):
    return index_add(n, c, i, a).index_add_(0, j, b)


LIBRARY = {f.__name__: f for f in (gather, gather2, index_add, index_add2)}


def _function(name: str):
    if name in LIBRARY:
        return LIBRARY[name]
    module, fn = name.split(":")
    return getattr(importlib.import_module(module), fn)


def run(specs: dict) -> dict:
    """{key: [warm ms, flushed ms]} of each of `specs` in this process."""
    import torch

    from yolat_tpu_torch.scripts.source_edits import call_us

    flush = l2_flush("cuda")
    out = {}
    for key, (name, args) in specs.items():
        fn = _function(name)
        call = lambda fn=fn, args=args: fn(*args)
        out[key] = [call_us(call, REPS) / 1e3, call_us(call, REPS, flush) / 1e3]
    torch.cuda.synchronize()
    return out


def in_child(specs: dict) -> dict:
    """`run(specs)` in a new process (this module as a program); raises
    with the child's output if it fails."""
    import torch

    os.makedirs(os.path.join(_REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(_REPO, "build")) as d:
        path = os.path.join(d, "specs.pt")
        torch.save(specs, path)
        r = subprocess.run(
            [sys.executable, "-m", "yolat_tpu_torch.scripts.profiled_calls",
             path], cwd=_REPO, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"profiled_calls failed ({r.returncode}):\n"
                           f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])["times"]


def main(argv=None) -> dict:
    import torch

    (path,) = sys.argv[1:] if argv is None else argv
    specs = torch.load(path, map_location="cuda", weights_only=False)
    times = run(specs)
    print(json.dumps({"times": times}), flush=True)
    return times


if __name__ == "__main__":
    main()
