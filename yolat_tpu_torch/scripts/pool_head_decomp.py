"""Decompose the pool-head kernels' bf16 time on the card: the tensor-core
block max (kernels 2 and 3) and the fused head's backward (kernel 11)
against variants with one part taken out.

  python -m yolat_tpu_torch.scripts.pool_head_decomp [--rounds 2] [--reps 20]

A variant is `csrc/block_max.cu` or `csrc/fused_pool_train.cu` with one
statement replaced (each replacement must match exactly once, so an edit of
the kernels that moves it fails here first):

  bm_base    kernels 2 and 3 as they are;
  bm_nomma   z from a cheap formula of the tile index instead of the wgmma
             product (the epilogue, the loads and the stores stay);
  bm_mma2    the product twice;
  bm_noepi   the epilogue (scale/shift, ReLU, mask, rounding, the block max
             over 8 lanes) replaced by a sum of z that feeds no output;
  bm_per1    one row tile per CTA instead of a chunk of tiles;
  bm_noload  no copy of the next x tile (each CTA's later tiles read a stale
             buffer);
  k11_base   kernel 11 as it is (pass A rows, pass B dW, pass C sums);
  k11_nozA   no z product in pass A;
  k11_nodx   no dx = s W^T product in pass A;
  k11_noldA  no copy of pass A's next W slab and block references;
  k11_nozB   no z product in pass B.

Each variant is built with the package's nvcc flags into its own library
under build/pool_head_decomp/ (one nvcc per variant, all started
together) and called through its C entry point on the bench shapes: x
[72704, 128] bf16 from N(0, 1), W [128, 1024] bf16 from 0.1 N(0, 1), 80%
of the rows unmasked, sc[0] from U(0.5, 1.5) and sc[1] from 0.1 N(0, 1),
kernel 11 on kernel 2's own block maxima and N(0, 1) cotangents (a seeded
generator on the card).
A variant's outputs are wrong by design; only its time is read. Each
kernel's time is the profiler's device time per launch over `--reps` calls,
the variants in turns, `--rounds` times. Prints one JSON line: `us` {variant
(kernel 2 / 3 of the block max as `bm_*` / `bm_* (no x)`): {kernel: [µs per
round]}} and `device`, the card's `nvidia-smi --query-gpu=name,power.limit`
line. Needs a CUDA device; a failed build or launch raises.
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

N, CI, H, KCHUNKS = 72704, 128, 1024, 32
OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "pool_head_decomp")
_SYN = ("for (int i = 0; i < 64; ++i) z[i] = (float)(({t} * 64 + i + tid) & 255)"
        " * 1e-2f - 1.f;")
_BM_Z = "yk::pool_z_tile_bf16(xt, w_s, kp, z);"
_BM, _K11 = "block_max.cu", "fused_pool_train.cu"
# the edit list of `source_edits`
EDITS = (
    ("bm_base", _BM, ()),
    ("bm_nomma", _BM, ((_BM, _BM_Z, _SYN.format(t="t")),)),
    ("bm_mma2", _BM, ((_BM, _BM_Z, _BM_Z + " " + _BM_Z),)),
    ("bm_noepi", _BM, ((_BM,
      ("    // rows 16 warp + g (block 2 warp)", "    __syncthreads();\n"
       "    {  // [BLOCK, COLS] bf16"),
      "    { float zs = 0.f; for (int i = 0; i < 64; ++i) zs += z[i];\n"
      "      if (zs == 1234.5f) o_s[tid] = __float2bfloat16(zs); }\n"),)),
    ("bm_per1", _BM, ((_BM, "const int per = (tiles + fit - 1) / fit;",
                       "const int per = 1;"),)),
    ("bm_noload", _BM, ((_BM, "load_tile(t + 1, buf ^ 1);",
                         "yk::cp_async_commit();"),)),
    ("k11_base", _K11, ()),
    ("k11_nozA", _K11, ((_K11, "yk::pool_z_tile_bf16(x_s, wb, kp, z);",
                         _SYN.format(t="sl")),)),
    ("k11_nodx", _K11, ((_K11,
      "yk::wgmma_rs<0>(dacc, a[kk], yk::gmma_desc(wa + kk * 256, 128, 16 * COLS), 1);",
      "dacc[kk] += __uint_as_float(a[kk][0]);"),)),
    ("k11_noldA", _K11, ((_K11, "load_slab(sl + 1, buf ^ 1);",
                          "yk::cp_async_commit();"),)),
    ("k11_nozB", _K11, ((_K11, "yk::pool_z_tile_bf16(xt, w_s, kp, z);",
                         _SYN.format(t="t")),)),
)
_VP, _I = ctypes.c_void_p, ctypes.c_int
SIGS = {_BM: {"yk_folded_mlp_block_max2": [_VP] * 6 + [_I] * 4 + [_VP],
              "yk_folded_mlp_block_max": [_VP] * 5 + [_I] * 4 + [_VP]},
        _K11: {"yk_fused_pool_train_bwd": [_VP] * 11 + [_I] * 5 + [_VP]}}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("pool_head_decomp needs a CUDA device")

    libs = source_edits.build(source_edits.variant_sources(EDITS), OUT, SIGS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(N, CI, device=dev, generator=g).bfloat16()
    m = (torch.rand(N, 1, device=dev, generator=g) < 0.8).float()
    w = (torch.randn(CI, H, device=dev, generator=g) * 0.1).bfloat16()
    sc = torch.stack([torch.rand(H, device=dev, generator=g) + 0.5,
                      torch.randn(H, device=dev, generator=g) * 0.1]).contiguous()
    outh = torch.empty(N // 8, H, dtype=torch.bfloat16, device=dev)
    outx = torch.empty(N // 8, CI, dtype=torch.bfloat16, device=dev)
    pb = torch.empty_like(outh)
    source_edits.check(libs["bm_base"].yk_folded_mlp_block_max2(
        *map(_build.ptr, (x, m, w, sc, pb, outx)), N, CI, H, 1, _build.stream_of(x)),
        "bm_base")
    gp = torch.randn(N // 8, H, device=dev, generator=g)
    scratch = (torch.empty(CI, H, device=dev),
               torch.empty(N, CI, dtype=torch.bfloat16, device=dev),
               torch.empty(2, H, device=dev), torch.empty(N // 64, 2, H, device=dev),
               torch.empty(KCHUNKS, CI, H, device=dev))
    st = _build.stream_of(x)
    P = _build.ptr

    def call(name, lib, with_x):
        if name.startswith("bm") and with_x:
            rc = lib.yk_folded_mlp_block_max2(P(x), P(m), P(w), P(sc), P(outh), P(outx),
                                              N, CI, H, 1, st)
        elif name.startswith("bm"):
            rc = lib.yk_folded_mlp_block_max(P(x), P(m), P(w), P(sc), P(outh),
                                             N, CI, H, 1, st)
        else:
            rc = lib.yk_fused_pool_train_bwd(P(x), P(m), P(w), P(sc), P(pb), P(gp),
                                             *map(P, scratch), N, CI, H, KCHUNKS, 1, st)
        source_edits.check(rc, name)

    us: dict = {}
    for _ in range(args.rounds):
        for name, lib in libs.items():
            for with_x in ((True, False) if name.startswith("bm") else (True,)):
                t = source_edits.device_us(lambda: call(name, lib, with_x), args.reps)
                key = name if with_x else f"{name} (no x)"
                for kern, v in t.items():
                    us.setdefault(key, {}).setdefault(kern, []).append(v)
    res = {"us": us, "device": nvidia_smi()}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
