"""Bulk inference CLI: SVGs in, one JSON line of detections per SVG out.

Counterpart of `yolat_tpu/cli/infer.py`, on PyTorch and one CUDA device:

  python -m yolat_tpu_torch.cli.infer --input_dir DIR \
      --pretrained_model ckpt.pth [--out detections.jsonl] [--conf_th 0.5] \
      [--serve_mode fast|fast_bf16|module] [--device cuda]
      [--conv NAME --act relu|leakyrelu|gelu|none --norm batch|layer|none]
      [--preproc_workers N] [--chunk 8]
      [--arch yolat_pp [--pp_factored_prim true] | --profile yolat_pp_fast]

Records are those of the JAX CLI:
  {"file": ..., "width": ..., "height": ...,
   "detections": [{"box": [x0, y0, x1, y1], "score": s, "class": name}]}
(unparseable SVGs become {"file", "error", "detections": []} records with
--skip_errors, the default). The checkpoint is a reference-format `.pth`
({'state_dict': ...}, the keys of the reference SparseCADGCN; for
`--arch yolat_pp` the keys of `nn.yolat_pp.YOLaTPlusPlus`, with
`super_edge_mlp`, or `super_fact_mlp` under `--pp_factored_prim true` /
`--profile yolat_pp_fast`). A checkpoint of another `--conv`, `--act` or
`--norm` than attr_edge_gp2 with ReLU and BatchNorm serves with
`--serve_mode module`; the fast modes refuse it. `--device` defaults to
cuda and raises when CUDA is absent; the CLI never moves to the CPU on
its own. The end line prints SVGs/s and the launch counts of the serving kernels: 1 and 2, and
for YOLaT++ also 5 and 6. `--preproc_workers N` runs the validation
pass and the loader's cold loads in N spawn processes (`_validate_files`,
`PackedLoader(preproc_workers=)`); the records are those of N = 0.
`--chunk K` (default 8, as the JAX CLI's) serves K loader batches per
dispatch through `eval/predict.make_serving_fn`: their kept arrays in one
buffer and one transfer, and on the card one CUDA graph per (slot cap,
shape signature) over K predict bodies; chunks never mix signatures, and
a chunk's records are written after the next chunk is dispatched (a
one-deep result pipeline, `yolat_tpu/cli/infer.py:197-310`). The records
do not depend on K. The end line also prints the graphs captured and
replayed. Not ported here: Orbax checkpoints.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from yolat_tpu_torch.cli.train import _bool, explicit_flags
from yolat_tpu_torch.config import (PP_ARCHS, PROFILES, Config,
                                    apply_profile, check_serve_mode)
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader, extra_plans_for
from yolat_tpu_torch.eval import fast_forward as ff
from yolat_tpu_torch.data.staging import batch_signature
from yolat_tpu_torch.eval.predict import img_slot_cap, make_serving_fn
from yolat_tpu_torch.nn.model import build_model, load_reference_checkpoint
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.plans import pad_plans


def build_parser() -> argparse.ArgumentParser:
    d = Config()
    p = argparse.ArgumentParser(description="yolat_tpu_torch bulk inference")
    p.add_argument("--input_dir", default="", type=str,
                   help="directory of *.svg (recursive); overrides --data_dir "
                        "manifests; GT sidecars not required")
    p.add_argument("--data_dir", default=d.data_dir, type=str)
    p.add_argument("--phase", default="test", type=str)
    p.add_argument("--mode", default=None,
                   choices=(None, "floorplan", "diagram", "chart"))
    p.add_argument("--out", default="detections.jsonl", type=str)
    p.add_argument("--conf_th", default=0.5, type=float)
    p.add_argument("--serve_mode", default="fast_bf16",
                   choices=("fast", "fast_bf16", "module"))
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--pretrained_model", default="", type=str)
    p.add_argument("--batch_size", default=d.batch_size, type=int)
    p.add_argument("--bbox_sampling_step", default=d.bbox_sampling_step, type=int)
    p.add_argument("--arch", default=d.arch, type=str)
    p.add_argument("--conv", default=d.conv, type=str)
    p.add_argument("--act", default=d.act, type=str)
    p.add_argument("--norm", default=d.norm, type=str)
    p.add_argument("--pp_factored_prim", default=d.pp_factored_prim,
                   type=_bool,
                   help="the YOLaT++ checkpoint holds super_fact_mlp (the "
                        "primitive level as a prefix sum per proposal)")
    p.add_argument("--profile", default=d.profile, type=str,
                   choices=("",) + tuple(PROFILES),
                   help="named flag bundle; flags typed beside it keep "
                        "their values")
    p.add_argument("--in_channels", default=d.in_channels, type=int)
    p.add_argument("--n_filters", default=d.n_filters, type=int)
    p.add_argument("--n_blocks", default=d.n_blocks, type=int)
    p.add_argument("--n_blocks_out", default=d.n_blocks_out, type=int)
    p.add_argument("--classifier", default=d.classifier, type=str)
    p.add_argument("--nms_algorithm", default=d.nms_algorithm, type=str,
                   choices=("fixpoint", "loop", "classfix"))
    p.add_argument("--nms_topk", default=d.nms_topk, type=int)
    p.add_argument("--preproc_workers", default=0, type=int,
                   help="host preprocessing processes (0 = in-process)")
    p.add_argument("--chunk", default=8, type=int,
                   help="loader batches per dispatch (one transfer, on the "
                        "card one CUDA graph of that many predict bodies); "
                        "1 = per batch")
    p.add_argument("--skip_errors", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="unparseable SVGs become {'error': ...} records "
                        "(--input_dir mode only)")
    return p


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available "
                           "(pass --device cpu to serve on the CPU)")
    return dev


_PROBE_DS = None


def _probe_init(ctor_kwargs: dict):
    global _PROBE_DS
    _PROBE_DS = SESYDDataset(**ctor_kwargs)


def _probe_load(i: int):
    try:
        _PROBE_DS.load(i)
        return i, None
    except Exception as e:  # one bad SVG must not abort the whole job
        return i, f"{type(e).__name__}: {e}"


def _validate_files(probe, workers: int):
    """Load every file once (warming the on-disk graph/proposal caches the
    loader reads); files that fail become (path, error) pairs. With
    workers > 1 the pass runs in a spawn process pool."""
    if workers > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(
                workers, initializer=_probe_init,
                initargs=(probe.ctor_kwargs(),)) as pool:
            results = pool.map(_probe_load, range(len(probe.files)))
    else:
        _probe_init(probe.ctor_kwargs())
        results = [_probe_load(i) for i in range(len(probe.files))]
    good, bad = [], []
    for i, err in results:
        if err is None:
            good.append(probe.files[i])
        else:
            bad.append((probe.files[i], err))
    return good, bad


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = _device(args.device)
    if not args.pretrained_model:
        raise SystemExit("--pretrained_model is required for inference")
    bad: list = []
    if args.input_dir:
        files = sorted(glob.glob(os.path.join(args.input_dir, "**", "*.svg"),
                                 recursive=True))
        if not files:
            raise FileNotFoundError(f"no .svg files under {args.input_dir}")
        kw = dict(mode=args.mode, bbox_sampling_step=args.bbox_sampling_step,
                  require_gt=False)
        if args.skip_errors:
            files, bad = _validate_files(
                SESYDDataset(args.input_dir, files=files, **kw),
                args.preproc_workers)
        ds = SESYDDataset(args.input_dir, files=files, **kw) if files else None
    else:
        ds = SESYDDataset(args.data_dir, args.phase,
                          bbox_sampling_step=args.bbox_sampling_step,
                          require_gt=False)

    cfg = _config(args, explicit_flags(build_parser(), argv),
                  ds.n_classes if ds is not None else 1)
    check_serve_mode(cfg, args.serve_mode)
    launched = dict(_build.launch_counts)  # this run's launches are the rise
    graphs = dict(_build.graph_counts)
    t_start = time.perf_counter()
    n_images = 0
    with open(args.out, "w") as out_f:
        for path, err in bad:
            out_f.write(json.dumps({"file": os.path.relpath(path, args.input_dir),
                                    "error": err, "detections": []}) + "\n")
        if ds is not None:
            n_images = _serve(args, cfg, ds, device, out_f)
    wall = time.perf_counter() - t_start
    counts = {k: v - launched[k] for k, v in _build.launch_counts.items()}
    skipped = f", {len(bad)} skipped with errors" if bad else ""
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    shown = ("edge_window_message_sum", "folded_mlp_block_max2") + (
        ("banded_message_sum", "banded_message_sum_both")
        if cfg.arch in PP_ARCHS else ())
    graphed = {k: v - graphs[k] for k, v in _build.graph_counts.items()}
    print(f"{n_images} SVGs -> {args.out}: {n_images / wall:.2f} SVGs/sec "
          f"end-to-end on {name}{skipped}; kernel launches: "
          + ", ".join(f"{k}={counts[k]}" for k in shown)
          + f"; CUDA graphs captured={graphed['captured']}, "
          f"replayed={graphed['replayed']}")
    return counts


def _config(args, explicit: set, n_classes: int) -> Config:
    """The serving Config of the parsed flags; `explicit` (the flags the
    user typed) keep their values under --profile."""
    kw = dict(arch=args.arch, conv=args.conv, act=args.act, norm=args.norm,
              in_channels=args.in_channels,
              n_filters=args.n_filters, n_blocks=args.n_blocks,
              n_blocks_out=args.n_blocks_out, classifier=args.classifier,
              nms_algorithm=args.nms_algorithm, nms_topk=args.nms_topk,
              pp_factored_prim=args.pp_factored_prim, profile=args.profile,
              data_dir=args.data_dir, n_classes=n_classes)
    if args.profile:
        kw = apply_profile(kw, args.profile, explicit)
    return Config(**kw)


def _serve(args, cfg, ds, device, out_f) -> int:
    id2name = [""] * (ds.n_classes - 1)
    for cname, cid in ds.class_dict.items():
        if cid < len(id2name):
            id2name[cid] = cname
    model = load_reference_checkpoint(build_model(cfg), args.pretrained_model)
    model = model.to(device).eval()
    fast = args.serve_mode != "module"
    folded = ff.fold_params_for(cfg, model, device) if fast else None
    # the plans are built whenever the kernel route reads them
    loader = PackedLoader(ds, batch_size=args.batch_size, edge_window=fast,
                          cache_files=False,
                          preproc_workers=args.preproc_workers,
                          **extra_plans_for(cfg))
    chunk = max(1, args.chunk)
    predict_by_key: dict = {}

    def get_predict(cap, batch):
        key = (cap, batch_signature(batch))
        if key not in predict_by_key:
            predict_by_key[key] = make_serving_fn(
                cfg, batch, chunk=chunk if chunk > 1 else None, device=device,
                folded=folded, model=model,
                bf16=args.serve_mode == "fast_bf16", max_det=cfg.max_det,
                img_slots=cap, detections_only=True)
        return predict_by_key[key]

    n = 0

    def write_rows(det, batch):
        nonlocal n
        for img in range(int(batch["n_images"])):
            path = ds.files[n]
            n += 1
            keep = det["valid"][img] & (det["scores"][img] >= args.conf_th)
            dets = [{"box": [round(float(c), 2)
                             for c in det["boxes"][img][d]],
                     "score": round(float(det["scores"][img][d]), 4),
                     "class": id2name[int(det["classes"][img][d])]}
                    for d in np.flatnonzero(keep)]
            w, h = batch["wh"][img]
            out_f.write(json.dumps({
                "file": (os.path.relpath(path, ds.root) if ds.root
                         else path),
                "width": float(w), "height": float(h),
                "detections": dets,
            }) + "\n")

    def consume(fetched, batches):
        """Write one dispatched chunk's records; called after the next
        chunk's dispatch, so the fetch and the host formatting overlap
        the device."""
        det = fetched.numpy()
        if chunk > 1:  # [K, B, ...]
            for i, b in enumerate(batches):
                write_rows({k: v[i] for k, v in det.items()}, b)
        else:
            write_rows(det, batches[0])

    pending: list = []
    buf: list = []
    caps: list = []

    def flush():
        if not buf:
            return
        fn = get_predict(max(caps), buf[0])
        out = fn(list(buf))[0] if chunk > 1 else fn(buf[0])
        pending.append((out, list(buf)))
        buf.clear()
        caps.clear()
        while len(pending) > 1:
            consume(*pending.pop(0))

    try:
        for batch in loader:
            b = pad_plans(batch)
            if buf and batch_signature(b) != batch_signature(buf[0]):
                flush()  # chunks never mix signatures
            buf.append(b)
            # the exact per-image NMS slot cap (eval/runner.py:40); a chunk
            # takes its largest, which gives the same detections
            caps.append(img_slot_cap(b))
            if len(buf) >= chunk:
                flush()
        flush()
        while pending:
            consume(*pending.pop(0))
    finally:
        loader.close()
    return n


if __name__ == "__main__":
    main()
