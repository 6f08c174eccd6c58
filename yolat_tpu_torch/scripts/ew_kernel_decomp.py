"""Decompose kernel 1's time on the card: the full edge-window kernel
against variants with its row gathers switched off.

  python -m yolat_tpu_torch.scripts.ew_kernel_decomp [--device cuda]
      [--n_svgs 8] [--batch_size 4] [--reps 40]

Counterpart of `scripts/ew_kernel_decomp.py` (kernel 12, the Pallas probe
kernel `main.make.kern`, :41-105). Writes the bench-scale synthetic
floorplans (seed 7, 2000x1500, 6 rooms, 1-3 symbols per room, sampling step
10; the set of `bench.py:71-99`) into a temporary directory under build/,
packs batch 0 with the edge-window plan (`ops/plans.edge_window_plan`, 256
destination nodes per window) and draws x [N, 64], w1 [132, 64], w2 [64, 64]
and sc1 = sc2 = [ones; zeros] from `np.random.default_rng(0)` as the JAX
probe does (:26-31), x and the weights in bf16. Then it times the three
variants of `ops.edge_window.edge_window_decomp` (kernel 1's CUDA kernel
with parts of its row loads switched off):

  full      kernel 1 itself;
  noband    the source-row gather off (x_j = x_i, the probe's ohs = ohl);
  noonehot  both row gathers off (x_i = x_j = 0.001; the probe replaces its
            one-hot matrices by 0.001, which on the TPU makes x_i and x_j
            0.001-scaled window sums: the port's variant computes a defined
            function, kernel 1 on x filled with 0.001);

each as the median of `--reps` CUDA-event spans of one launch, the variants
in turns (the order rotates every repetition), in one call. Prints one JSON
line: N, E (real edges), C, wn, nw, `<variant>_us`, the shares
`gather_src_us` = full - noband and `gather_both_us` = full - noonehot, each
variant's bound (`<variant>_bound_us` and `_bound_by`: the larger of its
bytes, each input read once and the output written once, over 3.35 TB/s
and its MLP's operations over the 989 TFLOP/s of the bf16 tensor cores; NVIDIA's
H100 SXM data sheet) and `device`, the card's
`nvidia-smi --query-gpu=name,power.limit` line. The JAX probe's `eb` (the
per-window edge capacity) and `gsz` (windows per grid step) have no
counterpart: the port's plan has neither a capacity nor window groups.

`--device cpu` runs the plain versions and times them on the host clock
(`device` then says so); it exists for the tests. `--device cuda` without
a card raises, and a failed build or launch raises.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from yolat_tpu_torch.cli.profile import nvidia_smi, write_bench_svgs
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.ops.edge_window import VARIANTS, edge_window_decomp
from yolat_tpu_torch.ops.plans import ew_of

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
C = H = 64  # the serving conv's second layer, as the JAX probe takes it
N_ATTR = 4
# NVIDIA's H100 SXM data sheet: HBM bytes/s, dense bf16 tensor-core FLOP/s
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12


def bench_plan(root: str, n_svgs: int, batch_size: int, dev):
    """Batch 0 of the bench set: (N, the edge-window plan on `dev`)."""
    write_bench_svgs(root, n_svgs)
    ds = SESYDDataset(root, "train", bbox_sampling_step=10)
    nb = next(iter(PackedLoader(ds, batch_size=batch_size, prefetch=0)))
    ew = ew_of(nb)
    return nb["pos"].shape[0], tuple(torch.from_numpy(a).to(dev)
                                     for a in ew[:4]) + (ew[4],)


def probe_inputs(n: int, dev, dtype=torch.bfloat16):
    """x, w1, sc1, w2, sc2 drawn as `scripts/ew_kernel_decomp.py:26-31`
    (x and the weights in `dtype`, the scale/shift pairs in f32)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, C))
    w1 = rng.normal(size=(2 * C + N_ATTR, H)) * 0.1
    sc1 = np.stack([np.ones(H), np.zeros(H)])
    w2 = rng.normal(size=(H, H)) * 0.1
    t = lambda a: torch.from_numpy(a).to(dev, dtype)
    sc = torch.from_numpy(sc1).to(dev, torch.float32)
    return t(x), t(w1), sc, t(w2), sc


def variant_work(variant: str, n: int, c: int, e: int, nw: int,
                 itemsize: int, h: int = H, na: int = N_ATTR):
    """(bytes, operations) one call of `variant` needs: x once (none for
    noonehot), per edge dst (and src for full) and the attributes, the
    window offsets, weights and scale/shift pairs once, the [n, h] f32
    output once; the two MLP stages' multiply-adds over the real edges."""
    x_bytes = 0 if variant == "noonehot" else n * c * itemsize
    idx = 8 if variant == "full" else 4
    nbytes = (x_bytes + e * (idx + 4 * na) + 4 * (nw + 1)
              + itemsize * ((2 * c + na) * h + h * h) + 4 * 4 * h + 4 * n * h)
    return nbytes, e * (2 * (2 * c + na) * h + 2 * h * h)


def variant_bound_us(variant: str, n: int, c: int, e: int, nw: int,
                     itemsize: int) -> tuple:
    nbytes, ops = variant_work(variant, n, c, e, nw, itemsize)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e6, ops / PEAK_BF16 * 1e6
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _spans_us(fns: dict, reps: int, cuda: bool) -> dict:
    """Median span (us) of one call of each fn, in turns."""
    names = list(fns)
    for v in names:  # warm-up (and the build, at the first launch)
        fns[v]()
    spans = {v: [] for v in names}
    if cuda:
        torch.cuda.synchronize()
    for r in range(reps):
        for v in names[r % len(names):] + names[:r % len(names)]:
            if cuda:
                s = torch.cuda.Event(enable_timing=True)
                t = torch.cuda.Event(enable_timing=True)
                s.record()
                fns[v]()
                t.record()
                spans[v].append((s, t))
            else:
                t0 = time.perf_counter()
                fns[v]()
                spans[v].append(time.perf_counter() - t0)
    if cuda:
        torch.cuda.synchronize()
        return {v: statistics.median(s.elapsed_time(t) * 1e3
                                     for s, t in spans[v]) for v in names}
    return {v: statistics.median(spans[v]) * 1e6 for v in names}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--n_svgs", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--reps", type=int, default=40)
    args = p.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device (--device cpu runs "
                           "the plain versions, for the tests)")
    dev = torch.device(args.device)

    os.makedirs(os.path.join(_REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(_REPO, "build")) as work:
        n, ew = bench_plan(os.path.join(work, "svgs"), args.n_svgs,
                           args.batch_size, dev)
    x, w1, sc1, w2, sc2 = probe_inputs(n, dev)
    e, nw = ew[0].shape[0], ew[3].shape[0] - 1
    times = _spans_us({v: (lambda v=v: edge_window_decomp(
        x, ew, w1, sc1, w2, sc2, v)) for v in VARIANTS}, args.reps, cuda)

    res = {"N": n, "E": e, "C": C, "wn": ew[4], "nw": nw,
           "dtype": "bfloat16", "reps": args.reps}
    res.update({f"{v}_us": times[v] for v in VARIANTS})
    res["gather_src_us"] = times["full"] - times["noband"]
    res["gather_both_us"] = times["full"] - times["noonehot"]
    for v in VARIANTS:
        res[f"{v}_bound_us"], res[f"{v}_bound_by"] = variant_bound_us(
            v, n, C, e, nw, x.element_size())
    res["device"] = (nvidia_smi() if cuda else
                     "cpu: plain versions, host clock (not a device time)")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
