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
     forward on the card;
  5. training kernels: on the same batch, the fusion input cat [N, 128]
     of a train-mode forward of the seeded model; kernel 3 against its
     plain version (f32, bf16); the fused pool head's kernel route
     (kernel 3 -> kernel 11) against its plain route for pooled, the
     batch statistics and all five gradients under a fixed random
     cotangent (relative Frobenius error 1e-5 at f32, 5e-4 at bf16);
     the kernel route against the unfused composition (Linear -> masked
     BN -> ReLU -> segment max, torch autograd) at f32 (1e-5); kernel
     11 twice, bit-identical; paired median times;
  6. train: 8 bench-scale training SVGs and 2 test SVGs through
     `yolat_tpu_torch.cli.train` (bf16, fused head, augmentation on,
     batch 4, full width) for a few steps; losses finite, kernels 3 and
     11 launched once per step, a checkpoint and an evaluation written;
     the trained weights exported as a reference .pth and served through
     `cli.infer`, one record per SVG.
Everything it runs comes from yolat_tpu_torch, the synthetic SVG writer
included: it imports neither jax nor the JAX package yolat_tpu.
The kernels line (a JSON object describing each kernel; launches are
counted over the path that runs it: phase 4 for the serving kernels,
phase 6 for the training kernels) comes before the nvidia-smi line; the
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
TRAIN_STEPS = 8
# relative Frobenius limits of the fused head: kernel route vs plain route
# by dtype name, and the f32 kernel route vs the unfused composition
HEAD_TOL = {"f32": 1e-5, "bf16": 5e-4}
UNFUSED_TOL = 1e-5


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
    check(counts["edge_window_message_sum"] > 0
          and counts["folded_mlp_block_max2"] > 0, f"kernel launches {counts}")
    t0 = time.perf_counter()
    infer.main(argv)
    warm = N_SVGS / (time.perf_counter() - t0)
    print(f"serve: {N_SVGS} SVGs -> {len(recs)} records, {n_det} detections; "
          f"launches {counts}; "
          f"{cold:.3f} SVGs/s first run, {warm:.3f} SVGs/s second run "
          f"(end to end through the CLI, preprocessing caches warm) [{dev_line}]")
    return counts


def _rel(a, b, ref=None) -> float:
    """||a - b|| / ||ref or b||, in f32."""
    ref = b if ref is None else ref
    return ((a.float() - b.float()).norm()
            / max(ref.float().norm().item(), 1e-30)).item()


def _head_run(cat, maskf, lin, bn, blk_first, n_prop, cot, dtype, route):
    """The fused head on `route`: (pooled, mean, var) and the gradients
    of sum(pooled * cot) wrt x, W, b, gamma, beta."""
    import torch

    from yolat_tpu_torch.ops.fused_pool_train import fused_pool_train

    leaves = [cat.detach().clone().requires_grad_(True),
              lin.weight.detach().t().contiguous().requires_grad_(True),
              lin.bias.detach().clone().requires_grad_(True),
              bn.weight.detach().clone().requires_grad_(True),
              bn.bias.detach().clone().requires_grad_(True)]
    x, w, b, g, be = leaves
    pooled, mean, var, _ = fused_pool_train(
        x.to(dtype), maskf, w.to(dtype), b, g, be, blk_first, n_prop, route)
    (pooled.float() * cot).sum().backward()
    torch.cuda.synchronize()
    return ({"pooled": pooled.detach(), "mean": mean, "var": var},
            dict(zip(("dx", "dW", "db", "dgamma", "dbeta"),
                     (t.grad for t in leaves))))


def _unfused_run(cat, mask, lin, bn, batch, n_prop, cot):
    """Linear -> masked train-mode BN -> ReLU -> segment max (torch
    autograd through the port's modules) at f32."""
    import torch

    from yolat_tpu_torch.nn.layers import MLP
    from yolat_tpu_torch.ops.plans import plan_of
    from yolat_tpu_torch.ops.segment import segment_max

    mlp = MLP([cat.shape[1], lin.weight.shape[0]]).to(cat.device).train()
    x = cat.detach().clone().requires_grad_(True)
    w = lin.weight.detach().t().contiguous().requires_grad_(True)
    b = lin.bias.detach().clone().requires_grad_(True)
    g = bn.weight.detach().clone().requires_grad_(True)
    be = bn.bias.detach().clone().requires_grad_(True)
    a = torch.func.functional_call(
        mlp, {"0.weight": w.t(), "0.bias": b, "1.weight": g, "1.bias": be},
        (x * mask[:, None].float(), mask))
    pooled = segment_max(a, batch["bbox_idx"], n_prop, mask=mask,
                         plan=plan_of(batch))
    (pooled * cot).sum().backward()
    torch.cuda.synchronize()
    return ({"pooled": pooled.detach()},
            dict(zip(("dx", "dW", "db", "dgamma", "dbeta"),
                     (t.grad for t in (x, w, b, g, be)))))


def train_kernel_phase(model, batch, dev_line):
    """Kernels 3 and 11 at the bench batch's training shapes; returns
    {kernel name: dict(max_abs_err, ms, plain_ms)} (ms at bf16; kernel
    11's max_abs_err is the largest gradient error of the f32 head)."""
    import torch

    from yolat_tpu_torch.ops.block_max import (folded_mlp_block_max,
                                               folded_mlp_block_max_plain)
    from yolat_tpu_torch.ops.fused_pool_train import (
        _scale_shift, _stats, fused_pool_train_bwd,
        fused_pool_train_bwd_plain)
    from yolat_tpu_torch.ops.plans import plan_of

    model.train()
    with torch.no_grad():
        cat, _ = model.cls_net.features(batch)
    lin, bn = model.cls_net.fusion_block[0], model.cls_net.fusion_block[1]
    mask = batch["node_mask"]
    maskf = mask.float()[:, None]
    blk_first = plan_of(batch)[0]
    n_prop = batch["labels"].shape[0]
    h = lin.weight.shape[0]
    cot = torch.randn(n_prop, h, generator=torch.Generator().manual_seed(5)
                      ).to(cat.device)
    res = {"folded_mlp_block_max": dict(max_abs_err=0.0),
           "fused_pool_train_bwd": dict(max_abs_err=0.0)}
    print(f"train kernels: cat {tuple(cat.shape)} -> H {h}, "
          f"{blk_first.shape[0]} blocks, {n_prop} proposals")

    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        x = (cat * maskf).to(dt)
        w = lin.weight.detach().t().contiguous().to(dt)
        mean, var, _, _, _ = _stats(x, maskf, w, lin.bias.detach())
        sc = _scale_shift(mean, var, lin.bias.detach(), bn.weight.detach(),
                          bn.bias.detach())
        got = folded_mlp_block_max(x, maskf, w, sc)
        want = folded_mlp_block_max_plain(x, maskf, w, sc)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rtol = 1e-4 if dt == torch.float32 else 1e-2
        ok = bool(((got.float() - want.float()).abs()
                   <= 1e-4 + rtol * want.float().abs()).all())
        ms, pms = paired_ms(lambda: folded_mlp_block_max(x, maskf, w, sc),
                            lambda: folded_mlp_block_max_plain(x, maskf, w, sc))
        print(f"kernel folded_mlp_block_max {name} x{tuple(x.shape)} -> "
              f"{tuple(got.shape)}: max_abs_err={err:.3e} (|err| <= 1e-4 + "
              f"{rtol:g}|ref|) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms [{dev_line}]")
        check(ok, f"folded_mlp_block_max {name} disagrees")
        r = res["folded_mlp_block_max"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if dt == torch.bfloat16:
            r["ms"], r["plain_ms"] = ms, pms

        # the whole fused head: kernel route vs plain route
        kv, kg = _head_run(cat, maskf, lin, bn, blk_first, n_prop, cot, dt,
                           "kernel")
        pv, pg = _head_run(cat, maskf, lin, bn, blk_first, n_prop, cot, dt,
                           "plain")
        # f32: sound runs read <= 6.9e-7; bf16: <= 7.2e-5 with one bf16
        # winner flip, while a kernel 11 that keeps s = u*sc0 in f32
        # instead of rounding it to bf16 reads 2.6e-3 (dx), 2.9e-3 (dW)
        tol = HEAD_TOL[name]
        errs = {k: _rel(kv[k], pv[k]) for k in kv}
        errs.update({k: _rel(kg[k], pg[k], pg["dbeta"] if k == "db" else None)
                     for k in kg})
        abs_err = max((kg[k].float() - pg[k].float()).abs().max().item()
                      for k in kg)
        check(all(torch.isfinite(t.float()).all() for t in
                  list(kv.values()) + list(kg.values())), "finite head outputs")
        check(kg["dW"].abs().max().item() > 0, "winners found (dW nonzero)")
        print(f"fused head {name}, kernel route vs plain route, relative "
              f"Frobenius error (db against ||dbeta||; <= {tol:g}): "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; max abs grad err {abs_err:.3e}")
        check(all(v <= tol for v in errs.values()),
              f"fused head {name}: kernel route disagrees with the plain route")
        if dt == torch.float32:
            # at bf16 a rounding flip at a bf16 boundary can move a winner
            # between the routes, so the element-wise error of the
            # kernels line is the f32 one
            res["fused_pool_train_bwd"]["max_abs_err"] = abs_err

        # kernel 11 alone: bit-identical runs, paired times
        pooled_b = kv["pooled"][blk_first.long()]
        gp_b = cot[blk_first.long()]
        ppb = folded_mlp_block_max_plain(x, maskf, w, sc)  # plain's own bits
        raw = torch.full((n_prop, h), -1e30, device=x.device).scatter_reduce_(
            0, blk_first.long()[:, None].expand(-1, h), ppb.float(), "amax")
        ppooled_b = torch.where(raw <= -5e29, torch.zeros_like(raw),
                                raw).to(dt)[blk_first.long()]
        a1 = fused_pool_train_bwd(x, maskf, w, sc, pooled_b, gp_b)
        a2 = fused_pool_train_bwd(x, maskf, w, sc, pooled_b, gp_b)
        torch.cuda.synchronize()
        same = all(torch.equal(p, q) for p, q in zip(a1, a2))
        check(same, f"kernel 11 {name}: two runs differ")
        ms, pms = paired_ms(
            lambda: fused_pool_train_bwd(x, maskf, w, sc, pooled_b, gp_b),
            lambda: fused_pool_train_bwd_plain(x, maskf, w, sc, ppooled_b,
                                               gp_b))
        print(f"kernel fused_pool_train_bwd {name}: two runs bit-identical "
              f"{same}; kernel {ms:.4f} ms, plain {pms:.4f} ms [{dev_line}]")
        if dt == torch.bfloat16:
            res["fused_pool_train_bwd"].update(ms=ms, plain_ms=pms)

    # the kernel route against the unfused composition, f32
    kv, kg = _head_run(cat, maskf, lin, bn, blk_first, n_prop, cot,
                       torch.float32, "kernel")
    uv, ug = _unfused_run(cat, mask, lin, bn, batch, n_prop, cot)
    errs = {"pooled": _rel(kv["pooled"], uv["pooled"])}
    errs.update({k: _rel(kg[k], ug[k], ug["dbeta"] if k == "db" else None)
                 for k in kg})
    # sound runs read <= 1.6e-6: cuBLAS and torch's BN sum in other orders
    print(f"fused head f32, kernel route vs unfused composition, relative "
          f"Frobenius error (<= {UNFUSED_TOL:g}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    check(all(v <= UNFUSED_TOL for v in errs.values()),
          "fused head disagrees with the unfused composition")
    model.eval()
    return res


def train_phase(work, dev_line):
    """cli.train on bench-scale SVGs (bf16, fused head), then the trained
    weights through cli.infer; returns the train path's launch counts."""
    from yolat_tpu_torch.cli import infer
    from yolat_tpu_torch.cli import train as train_cli
    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.synthetic import write_dataset
    from yolat_tpu_torch.nn.model import build_model
    from yolat_tpu_torch.ops import _build
    from yolat_tpu_torch.train.checkpoint import (CheckpointManager,
                                                  load_train_state,
                                                  save_reference_checkpoint)

    root = os.path.join(work, "train_svgs")
    write_dataset(root, n_train=N_SVGS, n_test=2, seed=11, width=2000.0,
                  height=1500.0, n_rooms=6, symbols_per_room=(1, 3))
    argv = ["--data_dir", root, "--device", "cuda", "--dtype", "bfloat16",
            "--fused_head_train", "true", "--data_aug", "true",
            "--batch_size", str(BATCH), "--n_filters", "64",
            "--max_steps", str(TRAIN_STEPS), "--root_dir",
            os.path.join(work, "log"), "--print_freq", "1"]
    _build.reset_launch_counts()
    res = train_cli.main(argv)
    counts = dict(_build.launch_counts)
    check(res["steps"] == TRAIN_STEPS, f"{res['steps']} train steps")
    check(len(res["losses"]) == TRAIN_STEPS
          and all(v == v and abs(v) != float("inf") for v in res["losses"]),
          f"finite losses {res['losses']}")
    check(counts["folded_mlp_block_max"] == TRAIN_STEPS
          and counts["fused_pool_train_bwd"] == TRAIN_STEPS,
          f"training kernels launched once per step: {counts}")
    for k in ("map_50", "map_all", "top1_acc"):
        check(k in res and res[k] == res[k], f"evaluation result {k}")
    ckdir = os.path.join(res["exp_dir"], "checkpoint")
    check(os.path.exists(os.path.join(ckdir, "ckpt_best.pt")),
          "a best checkpoint was written")
    secs = res["train_seconds"]
    print(f"train: {res['steps']} bf16 steps (fused head, augmentation on, "
          f"batch {BATCH}, 64 channels) in {secs:.3f} s = "
          f"{res['steps'] / secs:.3f} steps/s, {res['images'] / secs:.3f} "
          f"images/s (first steps included); losses "
          f"{[round(v, 4) for v in res['losses']]}; MAP@0.5 "
          f"{res['map_50']:.4f}, top1 {res['top1_acc']:.4f}; launches "
          f"{counts} [{dev_line}]")

    state, epoch, _ = CheckpointManager(ckdir).restore("best")
    model = build_model(Config(n_classes=SESYDDataset(root).n_classes))
    load_train_state(state, model)
    pth = os.path.join(work, "trained.pth")
    save_reference_checkpoint(model, pth, epoch)
    out = os.path.join(work, "trained.jsonl")
    infer.main(["--data_dir", root, "--phase", "train", "--pretrained_model",
                pth, "--out", out, "--device", "cuda", "--conf_th", "0.0",
                "--batch_size", str(BATCH)])
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    check(len(recs) == N_SVGS and all("error" not in r for r in recs),
          f"{len(recs)} records for {N_SVGS} trained-on SVGs")
    print(f"served the trained checkpoint (epoch {epoch}): {len(recs)} "
          f"records, {sum(len(r['detections']) for r in recs)} detections")
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

        # 5. training kernels
        res.update(train_kernel_phase(model, batch, dev_line))

        # 6. train
        counts.update({k: v for k, v in train_phase(work, dev_line).items()
                       if k in ("folded_mlp_block_max",
                                "fused_pool_train_bwd")})

    # 7. kernels line
    sources = {"edge_window_message_sum": (
                   "yolat_tpu_torch/csrc/edge_window.cu",
                   "yolat_tpu/ops/edge_window.py:185"),
               "folded_mlp_block_max2": (
                   "yolat_tpu_torch/csrc/block_max.cu",
                   "yolat_tpu/ops/pallas_kernels.py:274"),
               "folded_mlp_block_max": (
                   "yolat_tpu_torch/csrc/block_max.cu",
                   "yolat_tpu/ops/pallas_kernels.py:213"),
               "fused_pool_train_bwd": (
                   "yolat_tpu_torch/csrc/fused_pool_train.cu",
                   "yolat_tpu/ops/fused_pool_train.py:198")}
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
