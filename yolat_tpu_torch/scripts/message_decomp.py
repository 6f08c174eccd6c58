"""Decompose kernel 5's bf16 time on the card (the banded message sum on the
tensor cores, `csrc/banded_message.cu`, `banded_tc_kernel`) against
variants with one part taken out.

  python -m yolat_tpu_torch.scripts.message_decomp [--rounds 2] [--reps 20]
      [--variants k5_base,k5_nofix,...]

A variant is `csrc/banded_message.cu` or `csrc/common.cuh` with one
statement replaced (each replacement must match exactly once, so an edit of
the kernel that moves it fails here first):

  k5_base    kernel 5 as it is;
  k5_nofix   no near-midpoint repair (MSG_TIE 0: no element is recomputed
             by the FMA chain);
  k5_tie16, k5_tie32, k5_tie64
             the repair's window narrowed from 128 f32 ulps to 16, 32, 64;
  k5_noown   no p_own product (nor its repair);
  k5_nooth   no p_oth product (nor its repair);
  k5_nosum   no per-node sum (the tile's rows are not added or stored).

Each variant is built with the package's nvcc flags into its own library
under build/message_decomp/ (one nvcc per variant, all started together)
and called through its C entry point, single stage, at bf16, on a clique
family of the bench batch's size: N 72704 nodes, C 64, all-pairs edges over
runs of 2-9 nodes with gaps of 0-9 (about 200000 edges, seed 0), planned by
`ops.plans.banded_plan`; x = |N(0, 1)|, weights 0.2 N(0, 1), scale from
U(0.5, 1.5), shift 0.1 N(0, 1). A variant's outputs are wrong by design;
only its time is read: the profiler's device time per launch over `--reps`
calls, the variants in turns, `--rounds` times. For the base and the
window variants it also counts `flips`: the elements of the per-edge
messages h (kernel 6's stored rows, [E, 64] bf16, on the same family and
its transpose) that differ from the plain version's
(`ops.banded_message.message_rows_plain`): each is a product rounded to
the other neighbouring bf16 value. Prints one JSON line: `us` {variant:
[µs per round]}, `flips` {variant: count}, the family's `N`, `E` and
thread blocks, and `device`, the card's `nvidia-smi
--query-gpu=name,power.limit` line. Needs a CUDA device; a failed build or
launch raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

import numpy as np
import torch

from yolat_tpu_torch.cli.profile import nvidia_smi
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.banded_message import (message_rows_plain,
                                                plan_tensors)
from yolat_tpu_torch.ops.plans import banded_plan
from yolat_tpu_torch.scripts import source_edits

N, C, H, A = 72704, 64, 64, 4
OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "message_decomp")
_SRC = "banded_message.cu"
_ZERO = "for (int i = 0; i < 32; ++i) {}[i] = 0.f;"
_TIE = "constexpr uint32_t MSG_TIE = 128;"
# the edit list of `source_edits`
EDITS = (
    ("k5_base", _SRC, ()),
    ("k5_nofix", _SRC, (("common.cuh", _TIE, "constexpr uint32_t MSG_TIE = 0;"),)),
    *((f"k5_tie{t}", _SRC, (("common.cuh", _TIE,
                              f"constexpr uint32_t MSG_TIE = {t};"),))
      for t in (16, 32, 64)),
    ("k5_noown", _SRC, ((_SRC, "yk::msg_tile_issue(ao, wo_s, kc, acc_o);",
                         _ZERO.format("acc_o")),)),
    ("k5_nooth", _SRC, ((_SRC, "yk::msg_tile_issue(ax, wh_s, kc, acc);",
                         _ZERO.format("acc")),)),
    ("k5_nosum", _SRC, ((_SRC, ("    yk::msg_run_sum(\n        h_s, nd, r1, cnt,",
                                "    if constexpr (BOTH) {\n      for (int i = tid; i < cnt"),
                         ""),)),
)
SIGS = {_SRC: {"yk_banded_message_sum": [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6
               + [ctypes.c_void_p]}}


def clique_family(seed: int = 0):
    """All-pairs edges over runs of 2-9 nodes with gaps of 0-9 nodes:
    (edge [E, 2] i32, attr [E, A] f32)."""
    rng = np.random.default_rng(seed)
    edges, lo = [], 0
    while True:
        m = int(rng.integers(2, 10))
        if lo + m > N:
            break
        ids = np.arange(lo, lo + m)
        a, b = np.meshgrid(ids, ids)
        edges.append(np.stack([a[a != b], b[a != b]], axis=1))
        lo += m + int(rng.integers(0, 10))
    edge = np.concatenate(edges).astype(np.int32)
    return edge, rng.normal(size=(len(edge), A)).astype(np.float32)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--variants", default=",".join(e[0] for e in EDITS),
                   help="comma-separated variants to build and time")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("message_decomp needs a CUDA device")

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
    wanted = args.variants.split(",")
    libs = source_edits.build(
        {k: v for k, v in source_edits.variant_sources(EDITS).items() if k in wanted},
        OUT, SIGS)
    dev = torch.device("cuda")
    edge, attr = clique_family()
    bm = plan_tensors(banded_plan(edge, np.ones(len(edge), bool), attr, N,
                                  transpose=True), dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(N, C, device=dev, generator=g).abs().bfloat16()
    w = [(torch.randn(k, H, device=dev, generator=g) * 0.2).bfloat16()
         for k in (C, C, A)]
    sc1 = torch.stack([torch.rand(H, device=dev, generator=g) + 0.5,
                       torch.randn(H, device=dev, generator=g) * 0.1]).contiguous()
    out = torch.empty(N, H, device=dev)
    nc = bm.cnode.shape[0] - 1
    P, st = _build.ptr, _build.stream_of(x)

    def call(name, lib):
        source_edits.check(lib.yk_banded_message_sum(
            P(x), P(bm.own), P(bm.oth), P(bm.attr), None, P(bm.nptr), P(bm.cnode),
            *map(P, w), P(sc1), None, None, P(out), None, None, None, None,
            N, C, A, nc, 0, 1, st), name)

    # the per-edge messages of kernel 6 against the plain version's
    h_plain = message_rows_plain(x, bm, *w, sc1)[0]
    hbuf = torch.empty(bm.n_edges, H, dtype=torch.bfloat16, device=dev)
    out_oth = torch.empty_like(out)
    flips = {}
    for name, lib in libs.items():
        if name == "k5_base" or name == "k5_nofix" or name.startswith("k5_tie"):
            source_edits.check(lib.yk_banded_message_sum(
                P(x), P(bm.own), P(bm.oth), P(bm.attr), None, P(bm.nptr),
                P(bm.cnode), *map(P, w), P(sc1), None, None, P(out), P(hbuf),
                P(bm.tperm), P(bm.tptr), P(out_oth), N, C, A, nc, 0, 1, st), name)
            flips[name] = int((hbuf.float() != h_plain).sum())

    us: dict = {}
    for _ in range(args.rounds):
        for name, lib in libs.items():
            t = source_edits.device_us(lambda: call(name, lib), args.reps)
            us.setdefault(name, []).append(t["banded_tc_kernel"])
    res = {"us": us, "flips": flips, "N": N, "E": int(bm.n_edges), "blocks": nc,
           "device": nvidia_smi()}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
