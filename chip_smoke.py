#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (yolat_tpu_torch) on one GPU.

  python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100. Imports
no jax. Phases, each of which raises on failure (non-zero exit):
  1. device: CUDA present; the card's name and power limit from
     nvidia-smi; TF32 off for matmuls and cuDNN;
  2. build: nvcc builds the kernels from yolat_tpu_torch/csrc;
  3. kernels: on one packed batch of 4 bench-scale synthetic floorplans
     (2000x1500, 6 rooms, 1-3 symbols per room, seed 7, sampling step 10),
     each kernel against its plain PyTorch version at the shapes the
     serving path gives it, f32 and bf16, with median times;
  4. serve: a seeded random canonical detector (64 channels, 2 blocks,
     17 classes, randomised BN statistics) saved as a reference-format
     .pth and served through `yolat_tpu_torch.cli.infer` on the 8 SVGs
     in fast_bf16 mode; both kernels must launch, one record per SVG;
     kernel-route logits must match the plain route and the module
     forward on the card.
Everything it runs comes from yolat_tpu_torch, the synthetic SVG writer
included: it imports neither jax nor the JAX package yolat_tpu.
The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_SVGS = 8
BATCH = 4


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> list:
    """Device times (ms) of `reps` calls of fn, after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def paired_ms(kernel_fn, plain_fn) -> tuple:
    """Median ms of kernel and plain versions, timed in turns
    plain, kernel, kernel, plain."""
    p = time_ms(plain_fn)
    k = time_ms(kernel_fn)
    k += time_ms(kernel_fn)
    p += time_ms(plain_fn)
    return statistics.median(k), statistics.median(p)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def kernel_phase(folded, batch, dev_line):
    """Each kernel vs its plain version at the serving shapes; returns
    {kernel name: dict(max_abs_err, ms, plain_ms)} (ms at bf16, summed over
    the kernel's calls in one forward)."""
    import torch

    from yolat_tpu_torch.ops.block_max import (folded_mlp_block_max2,
                                               folded_mlp_block_max2_plain)
    from yolat_tpu_torch.ops.edge_window import (edge_window_message_sum,
                                                 edge_window_message_sum_plain)
    from yolat_tpu_torch.ops.plans import ew_of

    ew = ew_of(batch)
    cnt = torch.clamp(batch["dst_count"].float(), min=1.0)[:, None]
    maskf = batch["node_mask"].float()[:, None]
    res = {"edge_window_message_sum": dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0),
           "folded_mlp_block_max2": dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        f = batch["x"].to(dt)
        feats = []
        for i, c in enumerate(folded["convs"]):
            c = {k: v.to(dt) for k, v in c.items()}  # as fast_forward casts
            args = (f, ew, c["w1"], c["sc1"], c["w2"], c["sc2"])
            got = edge_window_message_sum(*args)
            want = edge_window_message_sum_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if dt == torch.float32:
                ok = bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
                tol = "|err| <= 1e-4 + 1e-4|ref|"
            else:
                ok = err <= 5e-3 * scale
                tol = "max|err| <= 5e-3 max|ref|"
            ms, pms = paired_ms(lambda: edge_window_message_sum(*args),
                                lambda: edge_window_message_sum_plain(*args))
            print(f"kernel edge_window_message_sum conv{i} {name} x{tuple(f.shape)} "
                  f"E={ew[0].shape[0]} in {ew[3].shape[0] - 1} windows of "
                  f"{ew[4]}: max_abs_err={err:.3e}, max_rel_err="
                  f"{err / scale:.3e} of max|ref|={scale:.3e} ({tol}) "
                  f"{'ok' if ok else 'FAIL'}; "
                  f"kernel {ms:.4f} ms, plain {pms:.4f} ms [{dev_line}]")
            check(ok, f"edge_window_message_sum conv{i} {name} disagrees")
            r = res["edge_window_message_sum"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if dt == torch.bfloat16:
                r["ms"] += ms
                r["plain_ms"] += pms
            f = ((got / cnt).to(dt) + f @ c["wr"] + c["br"].reshape(1, -1))
            feats.append(f)
        cat = torch.cat(feats, dim=1)
        w, sc = folded["fusion_block"]
        args = (cat, maskf, w.to(dt), sc.to(dt))
        gh, gx = folded_mlp_block_max2(*args)
        wh, wx = folded_mlp_block_max2_plain(*args)
        torch.cuda.synchronize()
        err = max((gh.float() - wh.float()).abs().max().item(),
                  (gx.float() - wx.float()).abs().max().item())
        rtol = 1e-4 if dt == torch.float32 else 1e-2
        ok = bool(((gh.float() - wh.float()).abs()
                   <= 1e-4 + rtol * wh.float().abs()).all()) and torch.equal(gx, wx)
        ms, pms = paired_ms(lambda: folded_mlp_block_max2(*args),
                            lambda: folded_mlp_block_max2_plain(*args))
        print(f"kernel folded_mlp_block_max2 {name} x{tuple(cat.shape)} -> "
              f"{tuple(gh.shape)}+{tuple(gx.shape)}: max_abs_err={err:.3e} "
              f"(|err| <= 1e-4 + {rtol:g}|ref|, x max exact) "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms [{dev_line}]")
        check(ok, f"folded_mlp_block_max2 {name} disagrees")
        r = res["folded_mlp_block_max2"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if dt == torch.bfloat16:
            r["ms"], r["plain_ms"] = ms, pms
    return res


def route_phase(model, folded, batch, dev_line):
    """Kernel-route logits vs the plain route and the module forward."""
    import torch

    from yolat_tpu_torch.eval.fast_forward import fast_forward

    with torch.no_grad():
        ref, _ = model(batch)
        k32, _ = fast_forward(folded, batch)
        p32, _ = fast_forward(folded, batch, plain=True)
        k16, _ = fast_forward(folded, batch, bf16=True)
        p16, _ = fast_forward(folded, batch, bf16=True, plain=True)
    torch.cuda.synchronize()
    m = batch["proposal_mask"]
    check(k16.shape == ref.shape and bool(torch.isfinite(k16).all())
          and bool(torch.isfinite(k32).all()), "finite logits of the right shape")
    scale = max(1.0, ref[m].abs().max().item())
    e_mod = (k32 - ref)[m].abs().max().item()
    e_32 = (k32 - p32)[m].abs().max().item()
    e_16 = (k16 - p16)[m].abs().max().item()
    e_16f = (k16 - ref)[m].abs().max().item()
    print(f"route logits {tuple(ref.shape)} (max|ref|={scale:.3e}): "
          f"f32 kernel route vs module forward {e_mod:.3e} (<= 1e-4 scale), "
          f"f32 kernel vs plain route {e_32:.3e} (<= 1e-4 scale), "
          f"bf16 kernel vs plain route {e_16:.3e} (<= 3e-2 scale), "
          f"bf16 kernel route vs f32 module {e_16f:.3e} [{dev_line}]")
    check(e_mod <= 1e-4 * scale, "f32 kernel route disagrees with the module")
    check(e_32 <= 1e-4 * scale, "f32 kernel route disagrees with the plain route")
    check(e_16 <= 3e-2 * scale, "bf16 kernel route disagrees with the plain route")


def serve_phase(root, ckpt, work, dev_line):
    """The CLI on the SVGs; returns the launch counts of its first run."""
    from yolat_tpu_torch.cli import infer
    from yolat_tpu_torch.ops import _build

    out = os.path.join(work, "detections.jsonl")
    argv = ["--input_dir", root, "--pretrained_model", ckpt, "--out", out,
            "--serve_mode", "fast_bf16", "--device", "cuda", "--conf_th", "0.0",
            "--batch_size", str(BATCH)]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    infer.main(argv)
    cold = N_SVGS / (time.perf_counter() - t0)
    counts = dict(_build.launch_counts)
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    check(len(recs) == N_SVGS, f"{len(recs)} records for {N_SVGS} SVGs")
    for r in recs:
        check("error" not in r and r["width"] > 0, f"bad record {r.get('file')}")
        for d in r["detections"]:
            check(len(d["box"]) == 4 and all(map(_finite, d["box"]))
                  and 0.0 <= d["score"] <= 1.0, "bad detection")
    n_det = sum(len(r["detections"]) for r in recs)
    check(all(v > 0 for v in counts.values()), f"kernel launches {counts}")
    t0 = time.perf_counter()
    infer.main(argv)
    warm = N_SVGS / (time.perf_counter() - t0)
    print(f"serve: {N_SVGS} SVGs -> {len(recs)} records, {n_det} detections; "
          f"launches {counts}; "
          f"{cold:.3f} SVGs/s first run, {warm:.3f} SVGs/s second run "
          f"(end to end through the CLI, preprocessing caches warm) [{dev_line}]")
    return counts


def _finite(v) -> bool:
    return v == v and abs(v) != float("inf")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from yolat_tpu_torch.cli.profile import write_bench_svgs
    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import PackedLoader
    from yolat_tpu_torch.data.packing import finalize_batch, to_device
    from yolat_tpu_torch.eval.fast_forward import fold_params
    from yolat_tpu_torch.nn.model import seeded_model
    from yolat_tpu_torch.ops import _build
    from yolat_tpu_torch.ops.plans import ew_of

    # 1. device
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    dev_line = f"nvidia-smi: {smi}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {kind}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(dev_line)
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {_build.library_path()} in {time.perf_counter() - t0:.2f} s")

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as work:
        root = os.path.join(work, "svgs")
        t0 = time.perf_counter()
        write_bench_svgs(root, N_SVGS)
        ds = SESYDDataset(root, "train", bbox_sampling_step=10)
        batches = list(PackedLoader(ds, batch_size=BATCH))
        check(all(ew_of(b) is not None for b in batches),
              "every packed batch carries an edge-window plan")
        print(f"data: {N_SVGS} SVGs -> {len(batches)} batches, N="
              f"{batches[0]['pos'].shape[0]} nodes, E={batches[0]['edge'].shape[0]} "
              f"edges, P={batches[0]['labels'].shape[0]} proposals per batch "
              f"({time.perf_counter() - t0:.1f} s host preprocessing)")

        cfg = Config(n_classes=ds.n_classes)
        model = seeded_model(cfg).to(dev)
        folded = fold_params(model, dev)
        batch = finalize_batch(to_device(batches[0], dev))

        # 3. kernels
        res = kernel_phase(folded, batch, dev_line)
        route_phase(model, folded, batch, dev_line)

        # 4. serve
        ckpt = os.path.join(work, "model.pth")
        torch.save({"state_dict": {k: v.cpu() for k, v in
                                   model.state_dict().items()}, "epoch": 0}, ckpt)
        counts = serve_phase(root, ckpt, work, dev_line)

    sources = {"edge_window_message_sum": (
                   "yolat_tpu_torch/csrc/edge_window.cu",
                   "yolat_tpu/ops/edge_window.py:185"),
               "folded_mlp_block_max2": (
                   "yolat_tpu_torch/csrc/block_max.cu",
                   "yolat_tpu/ops/pallas_kernels.py:274")}
    kernels = [{"name": k, "route": "cuda", "source": sources[k][0],
                "replaces": sources[k][1], "launches": counts[k],
                "max_abs_err": res[k]["max_abs_err"], "ms": res[k]["ms"],
                "plain_ms": res[k]["plain_ms"]} for k in sources]
    print(json.dumps({"kernels": kernels}))
    print(dev_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
