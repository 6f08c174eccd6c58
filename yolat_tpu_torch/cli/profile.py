"""Per-stage times of the serving and training paths on one CUDA device.

  python -m yolat_tpu_torch.cli.profile [--n_svgs 8] [--batch_size 4]
      [--reps 20] [--stages serve,train] [--out profile.json]

Writes bench-scale synthetic floorplans (seed 7, 2000x1500, 6 rooms, 1-3
symbols per room, sampling step 10; the batch of `bench.py:82-84`) into a
temporary directory under build/ and times each stage of the loop of
`yolat_tpu_torch.cli.infer` with a seeded random canonical detector:

  host    cold load per image (parse, graph, proposals, cache write),
          cached load per image, CompactFile per image, pack_files per
          batch (with and without the edge-window plan), to_device per batch;
  device  predict wall per batch for each serve mode (synchronised, the
          detections' copy to the host included) and the forward alone;
  trace   torch.profiler (CUDA activity) over `--reps` fast_bf16 predicts:
          device kernel time per predict, the profiled wall per predict
          and the top kernels. The profiler slows the host, so its wall is
          not the serving wall; `idle_share_estimate` is 1 - kernel time
          per predict / unprofiled predict wall, both from this run;
  train   the train step (`train/loop.make_train_step`, Adam, augmentation
          on) on the packed batch already on the device, from the
          reference init: median synchronised wall per step for bf16 with
          the fused pool head (kernels 3 and 11), bf16 unfused and f32
          fused; then torch.profiler over `--reps` bf16 fused steps, as
          for predict (host packing is not in these numbers: `cli.train`'s
          rate includes it).

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
import statistics
import subprocess
import tempfile
import time

import torch

from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.packing import (CompactFile, finalize_batch,
                                          pack_files, to_device)
from yolat_tpu_torch.data.synthetic import write_dataset
from yolat_tpu_torch.eval.fast_forward import fast_forward, fold_params
from yolat_tpu_torch.eval.predict import img_slot_cap, make_predict_core
from yolat_tpu_torch.nn.model import seeded_model
from yolat_tpu_torch.train.loop import make_train_step
from yolat_tpu_torch.train.optim import make_optimizer
from yolat_tpu_torch.train.trainer import init_model

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


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


def _host_stages(root: str, batch_size: int, reps: int, res: dict):
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
    return ds, pack_files(*args)


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
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    return {"device_kernels_per_call": len(kernels) / reps,
            "device_busy_ms_per_call": busy,
            "profiled_wall_ms_per_call": span,
            "top_kernels_ms_per_call": [[k, v] for k, v in top]}


def _train_stage(nb, n_classes: int, dev, reps: int, res: dict) -> None:
    batch = to_device(nb, dev)
    arms = (("bf16_fused", dict(dtype="bfloat16", fused_head_train=True)),
            ("bf16_unfused", dict(dtype="bfloat16")),
            ("f32_fused", dict(fused_head_train=True)))
    steps = {}
    for name, kw in arms:
        cfg = Config(n_classes=n_classes, data_aug=True, **kw)
        model = init_model(cfg, dev)
        opt = make_optimizer(cfg.optimizer, model.parameters(), cfg.lr,
                             cfg.weight_decay)
        step = make_train_step(cfg, model, opt)
        gen = torch.Generator(device=dev).manual_seed(0)

        def run(step=step, gen=gen):
            step(batch, gen)

        for _ in range(3):
            run()
        steps[name] = run
        res[f"train_step_{name}_ms"] = _median_ms(run, reps, sync=True)
    res["train_trace"] = _trace(steps["bf16_fused"], reps)
    busy = res["train_trace"]["device_busy_ms_per_call"]
    res["train_idle_share_estimate"] = (
        None if busy is None else 1.0 - busy / res["train_step_bf16_fused_ms"])


def _print_trace(name: str, t: dict) -> None:
    print(f"{name}: {t['device_kernels_per_call']:.0f} kernels, device busy "
          f"{t['device_busy_ms_per_call']} ms, profiled wall "
          f"{t['profiled_wall_ms_per_call']} ms per call")
    for kname, ms in t["top_kernels_ms_per_call"]:
        print(f"  {ms:9.4f} ms/call  {kname[:100]}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n_svgs", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--stages", default="serve,train")
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
        ds, nb = _host_stages(root, args.batch_size, args.reps, res)
    res["shapes"] = {"N": int(nb["pos"].shape[0]),
                     "E": int(nb["edge_mask"].sum()),
                     "P": int(nb["labels"].shape[0])}
    if "serve" in stages:
        _serve_stages(nb, ds.n_classes, dev, args.reps, res)
    if "train" in stages:
        _train_stage(nb, ds.n_classes, dev, args.reps, res)

    for k, v in res.items():
        if k not in ("trace", "train_trace"):
            print(f"{k}: {v}")
    for name in ("trace", "train_trace"):
        if name in res:
            _print_trace(name, res[name])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
