"""Bulk inference CLI: SVGs in, one JSON line of detections per SVG out.

Counterpart of `yolat_tpu/cli/infer.py`, on PyTorch and one CUDA device:

  python -m yolat_tpu_torch.cli.infer --input_dir DIR \
      --pretrained_model ckpt.pth [--out detections.jsonl] [--conf_th 0.5] \
      [--serve_mode fast|fast_bf16|module] [--device cuda]

Records are those of the JAX CLI:
  {"file": ..., "width": ..., "height": ...,
   "detections": [{"box": [x0, y0, x1, y1], "score": s, "class": name}]}
(unparseable SVGs become {"file", "error", "detections": []} records with
--skip_errors, the default). The checkpoint is a reference-format `.pth`
({'state_dict': ...}, the keys of the reference SparseCADGCN). `--device`
defaults to cuda and raises when CUDA is absent; the CLI never moves to
the CPU on its own. The end line prints SVGs/s and the launch counts of
both kernels.
Not ported here: Orbax checkpoints, the chunked single-buffer dispatch of
`make_serving_fn` and the multi-process preprocessing pool.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.eval import fast_forward as ff
from yolat_tpu_torch.eval.predict import img_slot_cap, make_predict_core
from yolat_tpu_torch.nn.model import build_model, load_reference_checkpoint
from yolat_tpu_torch.ops import _build


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
    p.add_argument("--in_channels", default=d.in_channels, type=int)
    p.add_argument("--n_filters", default=d.n_filters, type=int)
    p.add_argument("--n_blocks", default=d.n_blocks, type=int)
    p.add_argument("--n_blocks_out", default=d.n_blocks_out, type=int)
    p.add_argument("--classifier", default=d.classifier, type=str)
    p.add_argument("--nms_algorithm", default=d.nms_algorithm, type=str,
                   choices=("fixpoint", "loop"))
    p.add_argument("--nms_topk", default=d.nms_topk, type=int)
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


def _probe(ds):
    """Load every file once (warming the on-disk graph/proposal caches);
    files that fail become (path, error) pairs."""
    good, bad = [], []
    for i, path in enumerate(ds.files):
        try:
            ds.load(i)
            good.append(path)
        except Exception as e:  # one bad SVG must not abort the whole job
            bad.append((path, f"{type(e).__name__}: {e}"))
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
            files, bad = _probe(SESYDDataset(args.input_dir, files=files, **kw))
        ds = SESYDDataset(args.input_dir, files=files, **kw) if files else None
    else:
        ds = SESYDDataset(args.data_dir, args.phase,
                          bbox_sampling_step=args.bbox_sampling_step,
                          require_gt=False)

    launched = dict(_build.launch_counts)  # this run's launches are the rise
    t_start = time.perf_counter()
    n_images = 0
    with open(args.out, "w") as out_f:
        for path, err in bad:
            out_f.write(json.dumps({"file": os.path.relpath(path, args.input_dir),
                                    "error": err, "detections": []}) + "\n")
        if ds is not None:
            n_images = _serve(args, ds, device, out_f)
    wall = time.perf_counter() - t_start
    counts = {k: v - launched[k] for k, v in _build.launch_counts.items()}
    skipped = f", {len(bad)} skipped with errors" if bad else ""
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"{n_images} SVGs -> {args.out}: {n_images / wall:.2f} SVGs/sec "
          f"end-to-end on {name}{skipped}; kernel launches: "
          f"edge_window_message_sum={counts['edge_window_message_sum']}, "
          f"folded_mlp_block_max2={counts['folded_mlp_block_max2']}")


def _serve(args, ds, device, out_f) -> int:
    cfg = Config(arch=args.arch, conv=args.conv, in_channels=args.in_channels,
                 n_filters=args.n_filters, n_blocks=args.n_blocks,
                 n_blocks_out=args.n_blocks_out, classifier=args.classifier,
                 nms_algorithm=args.nms_algorithm, nms_topk=args.nms_topk,
                 n_classes=ds.n_classes)
    id2name = [""] * (ds.n_classes - 1)
    for cname, cid in ds.class_dict.items():
        if cid < len(id2name):
            id2name[cid] = cname
    model = load_reference_checkpoint(build_model(cfg), args.pretrained_model)
    model = model.to(device).eval()
    fast = args.serve_mode != "module"
    folded = ff.fold_params(model, device) if fast else None
    # the plan is built whenever the kernel route reads it
    loader = PackedLoader(ds, batch_size=args.batch_size, edge_window=fast,
                          cache_files=False)
    n = 0
    for batch in loader:
        # the exact per-image NMS slot cap of this batch (eval/runner.py:40)
        predict = make_predict_core(
            cfg, folded=folded, model=model,
            bf16=args.serve_mode == "fast_bf16", max_det=cfg.max_det,
            img_slots=img_slot_cap(batch), detections_only=True)
        det = predict(to_device(batch, device))
        det = {k: v.cpu().numpy() for k, v in det.items()}
        for img in range(int(batch["n_images"])):
            path = ds.files[n]
            n += 1
            keep = det["valid"][img] & (det["scores"][img] >= args.conf_th)
            dets = [{"box": [round(float(c), 2) for c in det["boxes"][img][d]],
                     "score": round(float(det["scores"][img][d]), 4),
                     "class": id2name[int(det["classes"][img][d])]}
                    for d in np.flatnonzero(keep)]
            w, h = batch["wh"][img]
            out_f.write(json.dumps({
                "file": os.path.relpath(path, ds.root) if ds.root else path,
                "width": float(w), "height": float(h), "detections": dets,
            }) + "\n")
    return n


if __name__ == "__main__":
    main()
