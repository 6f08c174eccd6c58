"""Decompose kernel 7b's time on the card (the banded gather's backward,
`csrc/banded_train.cu`, `gather_bwd_kernel`) against variants with one part
taken out or one design choice changed.

  python -m yolat_tpu_torch.scripts.banded_train_decomp [--rounds 2]
      [--reps 40] [--variants b7_base,b7_own,...]

A variant is `csrc/banded_train.cu` with one statement replaced (each
replacement must match exactly once, so an edit of the kernel that moves it
fails here first):

  b7_base     kernel 7b as it is;
  b7_own      the own run only (every node's other run taken as empty);
  b7_oth      the other run only (every own run taken as empty);
  b7_notperm  the other run's rows read at tperm's positions, contiguous,
              not through tperm (the same bytes, no indirection);
  b7_step2    two rows of each run in flight a step, not four;
  b7_clamp    each tperm index clamped right after its load, where the
              compiler may wait for it before the step's rows are
              requested;
  b7_256      256-thread blocks with no bound on the registers.

Each variant is built with the package's nvcc flags into its own library
under build/banded_train_decomp/ (one nvcc per variant, all started
together) and called through its C entry point on the bench batch's `sew_`
plan, packed as `scripts/banded_train_times` packs it (N 72704, E 207658),
at C = 64 in float32 and bf16 on seeded normal cotangents. A variant's
outputs are wrong by design where it takes a part out; only its time is
read: the profiler's device time per call over `--reps` calls, each after a
128 MB L2-flushing write that is not counted (`source_edits.call_us`), the
variants in turns, `--rounds` times. Prints one JSON line: `us` {type:
{variant: [µs per round]}}, `N`, `E`, and `device`, the card's `nvidia-smi
--query-gpu=name,power.limit` line. Needs a CUDA device; a failed build or
launch raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

import torch

from yolat_tpu_torch.cli.profile import nvidia_smi
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.scripts import source_edits
from yolat_tpu_torch.scripts.banded_train_times import bench_plan
from yolat_tpu_torch.scripts.profiled_calls import l2_flush

C = 64
OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "banded_train_decomp")
_SRC = "banded_train.cu"
_ENDS = ("const int i1 = clampi(__ldg(nptr + v + 1), e), "
         "q1 = clampi(__ldg(tptr + v + 1), e);")
_ROW = "ld16(oth_in + clampi(r[j], e - 1) * p)"
# the edit list of `source_edits`
EDITS = (
    ("b7_base", _SRC, ()),
    ("b7_own", _SRC, ((_SRC, _ENDS, "const int i1 = clampi(__ldg(nptr + v + 1), "
                                    "e), q1 = q;"),)),
    ("b7_oth", _SRC, ((_SRC, _ENDS, "const int i1 = i, q1 = clampi(__ldg(tptr + "
                                    "v + 1), e);"),)),
    ("b7_notperm", _SRC, ((_SRC, _ROW, "ld16(oth_in + (q + j) * p)"),)),
    ("b7_step2", _SRC, ((_SRC, "constexpr int STEP = 4;",
                         "constexpr int STEP = 2;"),)),
    ("b7_clamp", _SRC, (
        (_SRC, "r[j] = q + j < q1 ? __ldg(tperm + q + j) : 0;",
         "r[j] = q + j < q1 ? clampi(__ldg(tperm + q + j), e - 1) : 0;"),
        (_SRC, "r[j] = q + STEP + j < q1 ? __ldg(tperm + q + STEP + j) : 0;",
         "r[j] = q + STEP + j < q1 ? clampi(__ldg(tperm + q + STEP + j), e - 1)"
         " : 0;"),
        (_SRC, _ROW, "ld16(oth_in + r[j] * p)"))),
    ("b7_256", _SRC, (
        (_SRC, "constexpr int BWD_THREADS = 128;",
         "constexpr int BWD_THREADS = 256;"),
        (_SRC, "__launch_bounds__(BWD_THREADS, bwd_blocks<T>())",
         "__launch_bounds__(BWD_THREADS)"))),
)
SIGS = {_SRC: {"yk_banded_gather_bwd": [ctypes.c_void_p] * 6
               + [ctypes.c_int] * 4 + [ctypes.c_void_p]}}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--reps", type=int, default=40)
    p.add_argument("--variants", default=",".join(e[0] for e in EDITS),
                   help="comma-separated variants to build and time")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("banded_train_decomp needs a CUDA device")

    wanted = args.variants.split(",")
    libs = source_edits.build(
        {k: v for k, v in source_edits.variant_sources(EDITS).items()
         if k in wanted}, OUT, SIGS)
    dev = torch.device("cuda")
    bm, n = bench_plan(dev)
    e = bm.n_edges
    flush = l2_flush(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    P = _build.ptr
    us: dict = {}
    for dt in (torch.float32, torch.bfloat16):
        g_own, g_oth = (torch.randn(e, C, device=dev, generator=gen).to(dt)
                        for _ in range(2))
        dx = torch.empty(n, C, dtype=dt, device=dev)
        st = _build.stream_of(dx)
        tag = "f32" if dt == torch.float32 else "bf16"

        def call(name, lib):
            source_edits.check(lib.yk_banded_gather_bwd(
                P(g_own), P(g_oth), P(bm.nptr), P(bm.tperm), P(bm.tptr), P(dx),
                n, e, C, int(dt == torch.bfloat16), st), name)

        for _ in range(args.rounds):
            for name, lib in libs.items():
                t = source_edits.call_us(lambda: call(name, lib), args.reps,
                                         flush)
                us.setdefault(tag, {}).setdefault(name, []).append(t)
    res = {"us": us, "N": n, "E": e, "device": nvidia_smi()}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
