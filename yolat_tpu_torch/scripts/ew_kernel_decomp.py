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
variants of `ops.edge_window.edge_window_decomp` (kernel 1's CUDA kernel,
at bf16 its tensor-core route `edge_window_tc_kernel`, with parts of its
row loads switched off):

  full      kernel 1 itself;
  noband    the source-row gather off (x_j = x_i, the probe's ohs = ohl);
  noonehot  both row gathers off (x_i = x_j = 0.001; the probe replaces its
            one-hot matrices by 0.001, which on the TPU makes x_i and x_j
            0.001-scaled window sums: the port's variant computes a defined
            function, kernel 1 on x filled with 0.001);

each as the median over 3 rounds of the profiler's device time per
launch of the variant's kernel (`source_edits.device_us`: torch.profiler,
CUDA activity, over `--reps` calls of the wrapper after 3 that are not
profiled), the variants in turns (the order rotates every round), in one
call; a profile that misses records raises (`source_edits`). The kernel
runs shorter than its wrapper's host work (~0.1 ms a call), so a CUDA-event
span of one call would time the host.
Prints one JSON line: N, E (real edges), C, wn, nw, `<variant>_us`, the shares
`gather_src_us` = full - noband and `gather_both_us` = full - noonehot, each
variant's bound (`<variant>_bound_us` and `_bound_by`: the larger of its
bytes, each input read once and the output written once, over 3.35 TB/s
and its MLP's operations over the 989 TFLOP/s of the bf16 tensor cores; NVIDIA's
H100 SXM data sheet) and `device`, the card's
`nvidia-smi --query-gpu=name,power.limit` line. The JAX probe's `eb` (the
per-window edge capacity) and `gsz` (windows per grid step) have no
counterpart: the port's plan has neither a capacity nor window groups.

Run as a program on the card, it also times kernel 1's bf16 route with
one part taken out, for what the template variants cannot switch off
(`main(edits=True)`; `main()`, as `chip_smoke.py` phase 17 calls it, runs
the variants only). An edit is `csrc/edge_window.cu` with one or two
statements of `edge_window_tc_kernel` replaced (each must match exactly
once, so an edit of the kernel that moves one fails here first):

  k1_base        kernel 1 as it is;
  k1_tiles0      no edge tile: each CTA's fixed cost (shared memory
                 zeroed, weights staged, the window's nodes marked, the
                 zero rows of nodes without an in-edge written);
  k1_noproduct   neither product (the first stage's accumulator zero, the
                 second stage's the rounded first-stage values);
  k1_noepilogue  neither epilogue (no fold, ReLU or rounding: h = acc);
  k1_nosum       no per-node sum (the tile's rows are not added or
                 stored).

Each is built by `source_edits` with the package's nvcc flags into its own
library under build/ew_kernel_decomp/ (one nvcc per edit, all started
together) and called through its C entry point on the probe's inputs, not
through the wrapper (its launches are not counted); its outputs are
wrong by design and only its time is read, as above, the edits in turns.
The line then also holds `edits_us` {edit: µs}.

`--device cpu` runs the plain versions and times them on the host clock,
the median of `--reps` calls (`device` then says so); it exists for the
tests. `--device cuda` without
a card raises, and a failed build or launch raises.
"""

from __future__ import annotations

import argparse
import ctypes
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
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.edge_window import (VARIANTS, _split_w1,
                                             edge_window_decomp)
from yolat_tpu_torch.ops.plans import ew_of
from yolat_tpu_torch.scripts import source_edits

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
C = H = 64  # the serving conv's second layer, as the JAX probe takes it
N_ATTR = 4
# NVIDIA's H100 SXM data sheet: HBM bytes/s, dense bf16 tensor-core FLOP/s
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12
ROUNDS = 3  # rounds of `--reps` profiled calls per variant
KERNEL = "edge_window_tc_kernel"  # the bf16 route the variants launch
OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "ew_kernel_decomp")
_SRC = "edge_window.cu"
_EPI1 = ("      h[i] = yk::round_to<bf16>(fmaxf(fmaf(acc[i], sc_s[col], "
         "sc_s[H + col]), 0.f));")
_EPI2 = ("      h[i] = yk::round_to<bf16>(\n          fmaxf(fmaf(acc[i], "
         "sc_s[2 * H + col], sc_s[3 * H + col]), 0.f));")
# the edit list of `source_edits`
EDITS = (
    ("k1_base", _SRC, ()),
    ("k1_tiles0", _SRC, ((_SRC, "for (int t = 0; t < n_tiles; ++t) {",
                          "for (int t = 0; t < 0; ++t) {"),)),
    ("k1_noproduct", _SRC, (
        (_SRC, "yk::msg_tile_bf16(a_s + buf * TM * kp, w1_s, kp, acc);",
         "for (int i = 0; i < 32; ++i) acc[i] = 0.f;"),
        (_SRC, "yk::msg_stage2_bf16(h, w2_s, acc);",
         "for (int i = 0; i < 32; ++i) acc[i] = h[i];"))),
    ("k1_noepilogue", _SRC, ((_SRC, _EPI1, "      h[i] = acc[i];"),
                             (_SRC, _EPI2, "      h[i] = acc[i];"))),
    ("k1_nosum", _SRC, ((_SRC, ("    yk::msg_run_sum(\n        h_s, node_s + buf * TM,",
                                "  }\n  yk::cp_async_wait<0>();\n}"), ""),)),
)
SIGS = {_SRC: {"yk_edge_window_message_sum": [ctypes.c_void_p] * 10
               + [ctypes.c_int] * 6 + [ctypes.c_void_p]}}


def edit_calls(libs: dict, x, ew, w1, sc1, w2, sc2) -> dict:
    """{edit: a call of its kernel 1 on these inputs (bf16)}."""
    src, dst, attr, wptr, wn = ew
    n, c = x.shape
    out = torch.empty(n, H, device=x.device)
    w1s = _split_w1(w1, c, x.dtype).contiguous()
    P = _build.ptr
    args = (P(x), P(src), P(dst), P(attr), P(wptr), P(w1s), P(sc1),
            P(w2.contiguous()), P(sc2), P(out), n, c, wptr.shape[0] - 1, wn,
            attr.shape[1], 1, _build.stream_of(x))

    def call(name, lib):
        source_edits.check(lib.yk_edge_window_message_sum(*args), name)

    return {name: (lambda name=name, lib=lib: call(name, lib))
            for name, lib in libs.items()}


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


def _host_us(fns: dict, reps: int) -> dict:
    """Median host-clock span (us) of one call of each fn, in turns."""
    names = list(fns)
    for v in names:  # warm-up
        fns[v]()
    spans = {v: [] for v in names}
    for r in range(reps):
        for v in names[r % len(names):] + names[:r % len(names)]:
            t0 = time.perf_counter()
            fns[v]()
            spans[v].append(time.perf_counter() - t0)
    return {v: statistics.median(spans[v]) * 1e6 for v in names}


def _device_us(fns: dict, reps: int) -> dict:
    """Median over ROUNDS rounds of the profiler's device time (us) per
    launch of each fn's edge-window kernel over `reps` calls
    (`source_edits.device_us`), fns in turns, the order rotated each
    round; raises unless each profile holds that kernel."""
    names = list(fns)
    us = {v: [] for v in names}
    for r in range(ROUNDS):
        for v in names[r % len(names):] + names[:r % len(names)]:
            t = source_edits.device_us(fns[v], reps)
            if KERNEL not in t:
                raise RuntimeError(f"{v}: no {KERNEL} in the profile: {sorted(t)}")
            us[v].append(t[KERNEL])
    return {v: statistics.median(us[v]) for v in names}


def main(argv=None, edits: bool = False) -> dict:
    """The probe; with `edits` (as a program) on the card also the source
    edits."""
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
    fns = {v: (lambda v=v: edge_window_decomp(x, ew, w1, sc1, w2, sc2, v))
           for v in VARIANTS}
    times = _device_us(fns, args.reps) if cuda else _host_us(fns, args.reps)

    res = {"N": n, "E": e, "C": C, "wn": ew[4], "nw": nw,
           "dtype": "bfloat16", "reps": args.reps,
           "timing": ("profiler device time per launch" if cuda
                      else "host clock per call")}
    res.update({f"{v}_us": times[v] for v in VARIANTS})
    res["gather_src_us"] = times["full"] - times["noband"]
    res["gather_both_us"] = times["full"] - times["noonehot"]
    for v in VARIANTS:
        res[f"{v}_bound_us"], res[f"{v}_bound_by"] = variant_bound_us(
            v, n, C, e, nw, x.element_size())
    if cuda and edits:
        libs = source_edits.build(source_edits.variant_sources(EDITS), OUT, SIGS)
        res["edits_us"] = _device_us(
            edit_calls(libs, x, ew, w1, sc1, w2, sc2), args.reps)
    res["device"] = (nvidia_smi() if cuda else
                     "cpu: plain versions, host clock (not a device time)")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(edits=True)
