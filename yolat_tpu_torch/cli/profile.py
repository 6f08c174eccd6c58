"""Per-stage times of the serving and training paths on one CUDA device.

  python -m yolat_tpu_torch.cli.profile [--n_svgs 8] [--batch_size 4]
      [--reps 20] [--stages serve,serve_dense,serve_pp,train]
      [--train_layout sparse|window|dense] [--out profile.json]

Writes bench-scale synthetic floorplans (seed 7, 2000x1500, 6 rooms, 1-3
symbols per room, sampling step 10; the batch of `bench.py:82-84`) into a
temporary directory under build/ and times each stage of the loop of
`yolat_tpu_torch.cli.infer` with a seeded random canonical detector:

  host    cold load per image (parse, graph, proposals, cache write),
          cached load per image, CompactFile per image, pack_files per
          batch (with the edge-window plan, with its transpose for the
          window training layout, with the dense neighbour table, and with
          none of them), to_device per batch;
  device  predict wall per batch for each serve mode (synchronised, the
          detections' copy to the host included) and the forward alone;
  trace   torch.profiler (CUDA activity) over `--reps` fast_bf16 predicts:
          device kernel time per predict, the profiled wall per predict,
          the top kernels and the port's own kernels by name. The profiler
          slows the host, so its wall is not the serving wall; `idle_share_estimate` is 1 - kernel time
          per predict / unprofiled predict wall, both from this run;
  train   the train step (`train/loop.make_train_step`, Adam, augmentation
          on) on the packed batch already on the device, from the
          reference init: median synchronised wall per step for bf16 with
          the fused pool head (kernels 3 and 11), bf16 unfused and f32
          fused; then torch.profiler over `--reps` bf16 fused steps, as
          for predict (host packing is not in these numbers: `cli.train`'s
          rate includes it). With `--train_layout window` (or dense) the
          arms are that layout and the sparse one, unfused head, bf16 and
          f32, in turns, and both bf16 arms are traced;
  serve_dense  predict and forward on the dense route (the batch carries
          the neighbour table and no edge-window plan, so the convs take
          kernel 4), fast_bf16 and fast, beside the edge-window route in
          the same call;
  serve_pp  YOLaT++ serving (`fast_forward_pp`, seeded open-gate models):
          CompactFile and pack_files with the super-edge family and the
          banded plans; predict and forward for the per-edge checkpoint
          (kernels 1, 2, 5, 6), its two-pass curve route (kernel 5 three
          times, no kernel 6) and the factored checkpoint (kernels 1, 2,
          6), fast_bf16 and fast, in turns; a trace of the per-edge and of
          the factored fast_bf16 predict.

It has no JAX counterpart module: the JAX package timed its stages in
`bench.py`, whose batch this is. Host times are medians of `--reps`
calls (loads: of every image). Prints
one line per stage and, last, one JSON object with every number and the
card's `nvidia-smi` name and power limit (also written to `--out`).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import tempfile
import time

import torch

from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader, extra_plans_for
from yolat_tpu_torch.data.packing import (CompactFile, add_dense_neighbors,
                                          finalize_batch, pack_files,
                                          to_device)
from yolat_tpu_torch.data.synthetic import write_dataset
from yolat_tpu_torch.eval.fast_forward import (fast_forward, fast_forward_pp,
                                               fold_params, fold_params_pp)
from yolat_tpu_torch.eval.predict import img_slot_cap, make_predict_core
from yolat_tpu_torch.nn.model import seeded_model
from yolat_tpu_torch.train.loop import make_train_step
from yolat_tpu_torch.train.optim import make_optimizer
from yolat_tpu_torch.train.trainer import init_model

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# the __global__ functions of yolat_tpu_torch/csrc/*.cu
_OWN_KERNEL_RE = re.compile(
    r"\b(edge_window_kernel|block_max_kernel|bwd_rows_kernel|bwd_dw_kernel"
    r"|sum_parts_kernel|dense_message_kernel|pair_fwd_kernel|pair_bwd_kernel"
    r"|wsum_fwd_kernel|wsum_bwd_kernel|banded_kernel|sum_rows_by_perm_kernel)"
    r"(<[^>(]*>)?")


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int, sync: bool = False) -> float:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def write_bench_svgs(root: str, n: int) -> None:
    write_dataset(root, n_train=n, n_test=0, seed=7, width=2000.0,
                  height=1500.0, n_rooms=6, symbols_per_room=(1, 3))


def _host_stages(root: str, batch_size: int, reps: int, res: dict,
                 pp: bool = False):
    ds = SESYDDataset(root, "train", bbox_sampling_step=10)
    cold = []
    for i in range(len(ds)):
        t0 = time.perf_counter()
        ds.load(i)
        cold.append((time.perf_counter() - t0) * 1e3)
    res["cold_load_ms_per_image"] = statistics.median(cold)
    res["cached_load_ms_per_image"] = statistics.median(
        [_median_ms(lambda: ds.load(i), 3) for i in range(len(ds))])
    loads = [ds.load(i) for i in range(batch_size)]
    res["compact_file_ms_per_image"] = statistics.median(
        [_median_ms(lambda: CompactFile(f), 3) for f, _, _ in loads])
    loader = PackedLoader(ds, batch_size=batch_size, prefetch=0)
    cfs = [CompactFile(f) for f, _, _ in loads]
    args = (cfs, [g for _, g, _ in loads], [w for _, _, w in loads], loader.pad)
    res["pack_ms_per_batch"] = _median_ms(lambda: pack_files(*args), reps)
    res["pack_no_ew_plan_ms_per_batch"] = _median_ms(
        lambda: pack_files(*args, edge_window=False), reps)
    res["pack_ew_transpose_ms_per_batch"] = _median_ms(
        lambda: pack_files(*args, ew_transpose=True), reps)

    def dense():
        return add_dense_neighbors(pack_files(*args, edge_window=False),
                                   d_max=loader.d_max, files=cfs)

    res["pack_dense_ms_per_batch"] = _median_ms(dense, reps)
    packs = {"sparse": pack_files(*args),
             "window": pack_files(*args, ew_transpose=True),
             "dense": dense()}
    if pp:  # what a YOLaT++ arch asks of the loader
        opts = extra_plans_for(Config(arch="yolat_pp"))
        res["compact_file_pp_ms_per_image"] = statistics.median(
            [_median_ms(lambda: CompactFile(f, super_family=True), 3)
             for f, _, _ in loads])
        pp_loader = PackedLoader(ds, batch_size=batch_size, prefetch=0, **opts)
        pp_args = ([CompactFile(f, super_family=True) for f, _, _ in loads],
                   ) + args[1:3] + (pp_loader.pad,)
        res["pack_pp_ms_per_batch"] = _median_ms(
            lambda: pack_files(*pp_args, **opts), reps)
        packs["pp"] = pack_files(*pp_args, **opts)
    return ds, packs


def _serve_stages(nb, n_classes: int, dev, reps: int, res: dict) -> None:
    res["to_device_ms_per_batch"] = _median_ms(
        lambda: to_device(nb, dev), reps, sync=True)
    res["batch_bytes"] = int(sum(getattr(v, "nbytes", 0) for v in nb.values()))
    cfg = Config(n_classes=n_classes)
    model = seeded_model(cfg).to(dev)
    folded = fold_params(model, dev)
    batch = to_device(nb, dev)
    cap = img_slot_cap(nb)

    for mode in ("fast_bf16", "fast", "module"):
        fast = mode != "module"
        predict = make_predict_core(
            cfg, folded=folded if fast else None, model=model,
            bf16=mode == "fast_bf16", img_slots=cap, detections_only=True)

        def run(predict=predict):
            {k: v.cpu() for k, v in predict(batch).items()}

        def fwd(fast=fast, bf16=mode == "fast_bf16"):
            with torch.no_grad():
                fb = finalize_batch(batch)
                return fast_forward(folded, fb, bf16=bf16) if fast else model(fb)

        for _ in range(3):
            run()
        res[f"predict_{mode}_ms_per_batch"] = _median_ms(run, reps, True)
        res[f"forward_{mode}_ms_per_batch"] = _median_ms(fwd, reps, True)

    predict = make_predict_core(cfg, folded=folded, bf16=True, img_slots=cap,
                                detections_only=True)
    res["trace"] = _trace(lambda: {k: v.cpu() for k, v in
                                   predict(batch).items()}, reps)
    busy = res["trace"]["device_busy_ms_per_call"]
    res["idle_share_estimate"] = (
        None if busy is None
        else 1.0 - busy / res["predict_fast_bf16_ms_per_batch"])


def _serve_dense_stage(packs, n_classes: int, dev, reps: int, res: dict) -> None:
    """The dense route (kernel 4) beside the edge-window route (kernel 1),
    in turns, on batches of the same files."""
    cfg = Config(n_classes=n_classes)
    model = seeded_model(cfg).to(dev)
    folded = fold_params(model, dev)
    cap = img_slot_cap(packs["sparse"])
    runs = {}
    for route, nb in (("window", packs["sparse"]), ("dense", packs["dense"])):
        batch = to_device(nb, dev)
        for mode in ("fast_bf16", "fast"):
            predict = make_predict_core(cfg, folded=folded,
                                        bf16=mode == "fast_bf16",
                                        img_slots=cap, detections_only=True)

            def run(predict=predict, batch=batch):
                {k: v.cpu() for k, v in predict(batch).items()}

            def fwd(batch=batch, bf16=mode == "fast_bf16"):
                with torch.no_grad():
                    return fast_forward(folded, finalize_batch(batch),
                                        bf16=bf16)

            for _ in range(3):
                run()
            runs[f"predict_{mode}_{route}_route"] = run
            runs[f"forward_{mode}_{route}_route"] = fwd
    names = list(runs)
    times = {k: [] for k in names}
    for order in (names, names[::-1]):  # each arm early and late once
        for k in order:
            times[k].append(_median_ms(runs[k], reps, True))
    for k in names:
        res[f"{k}_ms_per_batch"] = statistics.median(times[k])
    res["dense_trace"] = _trace(runs["predict_fast_bf16_dense_route"], reps)
    busy = res["dense_trace"]["device_busy_ms_per_call"]
    res["dense_idle_share_estimate"] = (
        None if busy is None
        else 1.0 - busy / res["predict_fast_bf16_dense_route_ms_per_batch"])


def _serve_pp_stage(nb, n_classes: int, dev, reps: int, res: dict) -> None:
    """YOLaT++ serving: the per-edge checkpoint (curve level fused and in
    two passes) and the factored one, in turns, on one packed batch."""
    batch = to_device(nb, dev)
    cap = img_slot_cap(nb)
    res["pp_shapes"] = {"E_super": int(nb["super_mask"].sum()),
                        "E_super_padded": int(nb["edge_super"].shape[0]),
                        "sew_blocks": int(nb["sew_cnode"].shape[0]) - 1}
    res["pp_batch_bytes"] = int(sum(getattr(v, "nbytes", 0)
                                    for v in nb.values()))
    runs = {}
    for variant, factored in (("per_edge", False), ("factored", True)):
        cfg = Config(arch="yolat_pp", n_classes=n_classes,
                     pp_factored_prim=factored)
        folded = fold_params_pp(seeded_model(cfg).to(dev), dev)
        for mode in ("fast_bf16", "fast"):
            bf16 = mode == "fast_bf16"
            predict = make_predict_core(cfg, folded=folded, bf16=bf16,
                                        img_slots=cap, detections_only=True)

            def run(predict=predict):
                {k: v.cpu() for k, v in predict(batch).items()}

            def fwd(folded=folded, bf16=bf16, fused=True):
                with torch.no_grad():
                    return fast_forward_pp(folded, finalize_batch(batch),
                                           bf16=bf16, curve_fused=fused)

            for _ in range(3):
                run()
            runs[f"predict_pp_{variant}_{mode}"] = run
            runs[f"forward_pp_{variant}_{mode}"] = fwd
            if not factored:
                runs[f"forward_pp_two_pass_{mode}"] = (
                    lambda fwd=fwd: fwd(fused=False))
    names = list(runs)
    times = {k: [] for k in names}
    for order in (names, names[::-1]):  # each arm early and late once
        for k in order:
            times[k].append(_median_ms(runs[k], reps, True))
    for k in names:
        res[f"{k}_ms_per_batch"] = statistics.median(times[k])
    for variant in ("per_edge", "factored"):
        key = f"pp_{variant}_trace"
        res[key] = _trace(runs[f"predict_pp_{variant}_fast_bf16"], reps)
        busy = res[key]["device_busy_ms_per_call"]
        res[f"pp_{variant}_idle_share_estimate"] = (
            None if busy is None else 1.0 - busy / res[
                f"predict_pp_{variant}_fast_bf16_ms_per_batch"])


def _trace(fn, reps: int) -> dict:
    """torch.profiler (CPU + CUDA activity) over `reps` calls of fn: device
    kernel time per call, the profiled wall per call, the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    per_name: dict = {}
    for e in kernels:
        per_name[e.name] = (per_name.get(e.name, 0.0)
                            + e.time_range.elapsed_us() / 1e3 / reps)
    busy = sum(per_name.values()) if kernels else None  # None: no device trace
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])
    own = [[m.group(0), v] for k, v in ranked
           for m in [_OWN_KERNEL_RE.search(k)] if m]
    return {"device_kernels_per_call": len(kernels) / reps,
            "device_busy_ms_per_call": busy,
            "profiled_wall_ms_per_call": span,
            "top_kernels_ms_per_call": [[k, v] for k, v in ranked[:12]],
            "own_kernels_ms_per_call": own}


def _train_stage(packs, n_classes: int, dev, reps: int, res: dict,
                 layout: str = "sparse") -> None:
    if layout == "sparse":
        arms = (("bf16_fused", dict(dtype="bfloat16", fused_head_train=True)),
                ("bf16_unfused", dict(dtype="bfloat16")),
                ("f32_fused", dict(fused_head_train=True)))
        traced = ("bf16_fused",)
    else:
        arms = tuple((f"{dt}_{lay}", dict(dtype=name, train_layout=lay))
                     for dt, name in (("bf16", "bfloat16"), ("f32", "float32"))
                     for lay in ("sparse", layout))
        traced = ("bf16_sparse", f"bf16_{layout}")
    steps = {}
    for name, kw in arms:
        cfg = Config(n_classes=n_classes, data_aug=True, **kw)
        batch = to_device(packs[cfg.train_layout], dev)
        model = init_model(cfg, dev)
        opt = make_optimizer(cfg.optimizer, model.parameters(), cfg.lr,
                             cfg.weight_decay)
        step = make_train_step(cfg, model, opt)
        gen = torch.Generator(device=dev).manual_seed(0)

        def run(step=step, gen=gen, batch=batch):
            step(batch, gen)

        for _ in range(3):
            run()
        steps[name] = run
    times = {name: [] for name in steps}
    names = list(steps)
    # with more than one layout, every arm runs early and late once
    for order in ((names,) if layout == "sparse" else (names, names[::-1])):
        for name in order:
            times[name].append(_median_ms(steps[name], reps, sync=True))
    for name in names:
        res[f"train_step_{name}_ms"] = statistics.median(times[name])
    for name in traced:
        key = "train_trace" if name == traced[-1] else f"train_trace_{name}"
        res[key] = _trace(steps[name], reps)
        busy = res[key]["device_busy_ms_per_call"]
        res[key.replace("trace", "idle_share_estimate")] = (
            None if busy is None
            else 1.0 - busy / res[f"train_step_{name}_ms"])


def _print_trace(name: str, t: dict) -> None:
    print(f"{name}: {t['device_kernels_per_call']:.0f} kernels, device busy "
          f"{t['device_busy_ms_per_call']} ms, profiled wall "
          f"{t['profiled_wall_ms_per_call']} ms per call")
    for kname, ms in t["top_kernels_ms_per_call"]:
        print(f"  {ms:9.4f} ms/call  {kname[:100]}")
    print("  own kernels: " + ", ".join(
        f"{kname} {ms:.4f}" for kname, ms in t["own_kernels_ms_per_call"]))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n_svgs", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--stages", default="serve,train")
    p.add_argument("--train_layout", default="sparse",
                   choices=("sparse", "window", "dense"))
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile needs a CUDA device")
    stages = set(args.stages.split(","))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    res: dict = {"device": nvidia_smi()}

    os.makedirs(os.path.join(_REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(_REPO, "build")) as work:
        root = os.path.join(work, "svgs")
        write_bench_svgs(root, args.n_svgs)
        ds, packs = _host_stages(root, args.batch_size, args.reps, res,
                                 pp="serve_pp" in stages)
    nb = packs["sparse"]
    res["shapes"] = {"N": int(nb["pos"].shape[0]),
                     "E": int(nb["edge_mask"].sum()),
                     "E_padded": int(nb["edge"].shape[0]),
                     "D": int(packs["dense"]["nbr_idx"].shape[1]),
                     "P": int(nb["labels"].shape[0])}
    if "serve" in stages:
        _serve_stages(nb, ds.n_classes, dev, args.reps, res)
    if "serve_dense" in stages:
        _serve_dense_stage(packs, ds.n_classes, dev, args.reps, res)
    if "serve_pp" in stages:
        _serve_pp_stage(packs["pp"], ds.n_classes, dev, args.reps, res)
    if "train" in stages:
        _train_stage(packs, ds.n_classes, dev, args.reps, res,
                     args.train_layout)

    traces = [k for k in res if "trace" in k]
    for k, v in res.items():
        if k not in traces:
            print(f"{k}: {v}")
    for name in traces:
        _print_trace(name, res[name])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
