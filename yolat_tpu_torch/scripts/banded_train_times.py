"""The profiler's device time of the banded training kernels (7, 7b, 8, 8b)
and of their library calls on the bench batch, warm and L2-flushed, with
ptxas's registers and spills of their kernels.

  python -m yolat_tpu_torch.scripts.banded_train_times [--rounds R]

On a machine with a CUDA card. It packs the bench batch as `chip_smoke.py`
phase 14 does (8 bench-scale synthetic floorplans, the first batch of 4,
packed for the banded YOLaT++ training route: the `sew_` plan with its
transpose), makes seeded random inputs at C = 64 in float32 and bf16, and
reads the same calls as phase 14 through `scripts/profiled_calls.py` (40
calls after three unprofiled ones, back to back and each after a 128 MB
L2-flushing write, in a process of its own), `rounds` times. Prints one JSON
line: {"nvidia_smi", "n", "e", "times": {key: [[warm ms, flushed ms], ...
per round]}, "bound_ms": {key: ms}, "ptxas": {function: registers and
spills}}. It uses only what the port had before these kernels' redesign, so
a copy of it times an older tree of the repo the same way (run it from that
tree's root); compare two trees only within one call, in turns.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

# the kernels of the banded training route, as ptxas names them in
# ptxas.log (kernels 8 and 8b run kernel 10's bodies since their redesign)
KERNELS = ("gather_pair_kernel", "gather_bwd_kernel", "scatter_own_kernel",
           "scatter_own_bwd_kernel", "wsum_fwd_kernel", "wsum_bwd_kernel")
C = 64
PEAK_BYTES = 3.35e12  # H100 SXM data sheet, bytes/s
BT = "yolat_tpu_torch.ops.banded_train:"


def bench_plan(dev):
    """The bench batch's `sew_` plan with its transpose, and its node
    count."""
    import torch

    from yolat_tpu_torch.cli.profile import write_bench_svgs
    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import PackedLoader, train_plans_for
    from yolat_tpu_torch.data.packing import finalize_batch, to_device
    from yolat_tpu_torch.ops.plans import bm_of

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(repo, "build")) as d:
        write_bench_svgs(d, 8)
        ds = SESYDDataset(d, "train", bbox_sampling_step=10)
        cfg = Config(arch="yolat_pp", n_classes=ds.n_classes,
                     pp_banded_super=True)
        batch = finalize_batch(to_device(next(iter(PackedLoader(
            ds, batch_size=4, prefetch=0, **train_plans_for(cfg)))), dev))
    bm = bm_of(batch, "sew_")
    if bm is None or bm.tperm is None:
        raise RuntimeError("the bench batch lacks the sew_ plan's transpose")
    return bm, int(batch["pos"].shape[0])


def specs_and_bounds(bm, n: int, dev, seed: int = 14):
    """({key: (function, args)} as phase 14 reads them, {key: bound ms}):
    each kernel and its library call, float32 and bf16, at C = 64. A
    gather's bound counts the node rows its indices reach."""
    import torch

    own, oth, nptr, tperm, tptr = bm.own, bm.oth, bm.nptr, bm.tperm, bm.tptr
    ownl, othl = own.long(), oth.long()
    e, c = bm.n_edges, C
    n_pair = int(torch.unique(torch.cat([ownl, othl])).numel())
    n_own = int(torch.unique(ownl).numel())
    gen = torch.Generator(device=dev).manual_seed(seed)
    specs, bounds = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        s = 4 if dt == torch.float32 else 2
        tag = "f32" if dt == torch.float32 else "bf16"
        x = torch.randn(n, c, device=dev, generator=gen).to(dt)
        g_own, g_oth, rows = (torch.randn(e, c, device=dev, generator=gen
                                          ).to(dt) for _ in range(3))
        g = torch.randn(n, c, device=dev, generator=gen)
        calls = {
            "banded_gather": (
                (BT + "gather_fwd", (x, own, oth)),
                ("gather2", (x, ownl, othl)),
                s * (n_pair * c + 2 * e * c) + 8 * e),
            "banded_gather_bwd": (
                (BT + "gather_bwd",
                 (g_own, g_oth, own, oth, nptr, tperm, tptr, n)),
                ("index_add2", (n, c, ownl, g_own.float(), othl,
                                g_oth.float())),
                s * (2 * e * c + n * c) + 4 * (2 * (n + 1) + e)),
            "banded_scatter_own": (
                (BT + "scatter_own_fwd", (rows, own, nptr, n)),
                ("index_add", (n, c, ownl, rows.float())),
                s * e * c + 4 * (n + 1) + 4 * n * c),
            "banded_scatter_own_bwd": (
                (BT + "scatter_own_bwd", (g, own, dt)),
                ("gather", (g, ownl)),
                4 * n_own * c + 4 * e + s * e * c)}
        for name, (kspec, lspec, nbytes) in calls.items():
            key = f"{name} {tag} C={c}"
            specs[key], specs[key + " library"] = kspec, lspec
            bounds[key] = nbytes / PEAK_BYTES * 1e3
    return specs, bounds


def ptxas_report(log: str) -> dict:
    """{function: {registers, spill_stores, spill_loads}} of the banded
    training route's kernels in `nvcc -Xptxas -v` output."""
    out = {}
    for m in re.finditer(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, "
            r"(\d+) bytes spill loads.*?Used (\d+) registers", log, re.S):
        fn = m.group(1)
        if any(re.search(rf"\d{k}I", fn) for k in KERNELS):
            out[fn] = dict(registers=int(m.group(4)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
    return out


def main(argv=None) -> dict:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("banded_train_times: CUDA is not available")
    from yolat_tpu_torch.ops import _build
    from yolat_tpu_torch.scripts.profiled_calls import in_child

    dev = torch.device("cuda")
    _build.library()
    with open(os.path.join(os.path.dirname(_build.library_path()),
                           "ptxas.log")) as f:
        ptxas = ptxas_report(f.read())
    bm, n = bench_plan(dev)
    specs, bounds = specs_and_bounds(bm, n, dev)
    times = {k: [] for k in specs}
    for _ in range(args.rounds):
        for k, v in in_child(specs).items():
            times[k].append(v)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    out = dict(nvidia_smi=smi, n=n, e=bm.n_edges, times=times,
               bound_ms=bounds, ptxas=ptxas)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
