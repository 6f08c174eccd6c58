"""Bad-case visualisation driver.

Counterpart of `yolat_tpu/cli/detect_badcase.py` (the reference's
cad_recognition/detect_badcase.py): draw only the images with false
positives or false negatives. Detections above `--conf_th` are matched to
the GT greedily (`eval/metrics.batch_statistics`, the eval protocol's TP
matching, at `--iou_th`); the FN are the GT boxes that no TP of their class
covers (each TP covers its best same-class GT by the "+1"-pixel IoU).
Unmatched detections draw red, matched ones green, missed GT blue.

  python -m yolat_tpu_torch.cli.detect_badcase --data_dir DIR
      --pretrained_model ckpt_dir|ckpt_dir/ckpt_<tag>|ref.pth
      [--out_dir output_badcase] [--conf_th 0.5] [--iou_th 0.5]
      [--max_images N] [--device cuda]

The test partition, batch 1, manifest order, packed as `cli.test` packs
it; the eval-mode module predicts, as the JAX CLI's `make_predict_fn(cfg,
max_det)` (`eval/runner.batch_predictor`, route 'flax'). Prints
`rendered N badcase images to DIR`. `--device` defaults to cuda and raises
when CUDA is absent. Drawing needs matplotlib: without it `main` raises
before the first image. `badcase(argv, render=)` is the loop itself, with
the renderer as an argument.
"""

from __future__ import annotations

import os

import numpy as np

from yolat_tpu_torch.cli.detect import draw_svg, png_name, require_matplotlib
from yolat_tpu_torch.cli.test import load_checkpoint, serving_loader
from yolat_tpu_torch.cli.train import (build_parser, config_from_args,
                                       device_from_arg)
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.eval.metrics import _iou_plus1, batch_statistics
from yolat_tpu_torch.eval.runner import batch_predictor


def render_badcase(svg_path, width, height, det, gt, out_path):
    """det: [(box, 'tp' | 'fp')], gt: the missed GT boxes."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 12 * height / width))
    draw_svg(ax, svg_path, "0.7")

    def rect(box, color, label):
        ax.add_patch(patches.Rectangle(
            (box[0], box[1]), box[2] - box[0], box[3] - box[1],
            linewidth=2, edgecolor=color, facecolor="none"))
        ax.text(box[0], box[1], label, color=color, fontsize=8)

    for box, kind in det:
        rect(box, "green" if kind == "tp" else "red",
             "TP" if kind == "tp" else "FP")
    for box in gt:
        rect(box, "blue", "FN")
    ax.set_xlim(0, width)
    ax.set_ylim(height, 0)
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def missed_gt(boxes, tp, classes, gt_px, gt_labels):
    """The FN: the GT boxes that no TP covers, where a TP covers the GT of
    its own class with the largest "+1"-pixel IoU
    (`yolat_tpu/cli/detect_badcase.py:94-104`)."""
    covered = np.zeros(len(gt_px), bool)
    for b, t, c in zip(boxes, tp, classes):
        if not t:
            continue
        iou = _iou_plus1(b, gt_px)
        j = int(np.argmax(np.where(gt_labels == c, iou, 0)))
        covered[j] = True
    return gt_px[~covered]


def badcase(argv=None, render=render_badcase) -> dict:
    """The CLI's loop: `render(svg_path, width, height, det, missed,
    out_path)` per image with an FP or an FN. Returns {n_bad, images:
    [{file, out_path, det, missed}] of the drawn images}."""
    p = build_parser()
    p.description = "yolat_tpu_torch badcase visualisation"
    p.add_argument("--out_dir", default="output_badcase", type=str)
    p.add_argument("--conf_th", default=0.5, type=float)
    p.add_argument("--iou_th", default=0.5, type=float)
    p.add_argument("--max_images", default=0, type=int)
    args = p.parse_args(argv)
    device = device_from_arg(args.device)
    cfg = config_from_args(args, argv)

    ds = SESYDDataset(cfg.data_dir, "test",
                      bbox_sampling_step=cfg.bbox_sampling_step)
    cfg = cfg.replace(n_classes=ds.n_classes, train_layout="sparse")
    loader = serving_loader(cfg, ds, 1, "flax", prefetch=0)
    model, _, _ = load_checkpoint(cfg, device)
    predict = batch_predictor(cfg, model, "flax", device, cfg.max_det)

    os.makedirs(args.out_dir, exist_ok=True)
    drawn = []
    for i, batch in enumerate(loader):
        if args.max_images and i >= args.max_images:
            break
        out = predict(batch)
        valid = out["valid"][0] & (out["scores"][0] > args.conf_th)
        boxes = out["boxes"][0][valid]
        scores = out["scores"][0][valid]
        classes = out["classes"][0][valid]
        w, h = batch["wh"][0]
        gmask = batch["gt_mask"][0]
        gt_px = batch["gt_bbox"][0][gmask] * np.array([w, h, w, h])
        gt_labels = batch["gt_labels"][0][gmask]

        tp, _, _ = batch_statistics(boxes, scores, classes, gt_px, gt_labels,
                                    args.iou_th)
        det = [(b, "tp" if t else "fp") for b, t in zip(boxes, tp)]
        missed = missed_gt(boxes, tp, classes, gt_px, gt_labels)

        if (tp == 0).any() or len(missed):
            out_path = os.path.join(args.out_dir, png_name(ds.files[i]))
            render(ds.files[i], w, h, det, missed, out_path)
            drawn.append({"file": ds.files[i], "out_path": out_path,
                          "det": det, "missed": missed})
    print(f"rendered {len(drawn)} badcase images to {args.out_dir}")
    return {"n_bad": len(drawn), "images": drawn}


def main(argv=None) -> dict:
    require_matplotlib("cli.detect_badcase")
    return badcase(argv, render=render_badcase)


if __name__ == "__main__":
    main()
