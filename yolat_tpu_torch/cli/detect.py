"""Detection + visualisation driver.

Counterpart of `yolat_tpu/cli/detect.py` (the reference's
cad_recognition/detect.py): predict each image of the test partition,
time the warm per-image inference, and draw the detection boxes over the
image (the reference overlays the sibling .tiff raster, detect.py:384-429;
SESYD rasters are not redistributable, so the SVG primitives are drawn
instead), one PNG per image:

  python -m yolat_tpu_torch.cli.detect --data_dir DIR
      --pretrained_model ckpt_dir|ckpt_dir/ckpt_<tag>|ref.pth
      [--out_dir output_all] [--conf_th 0.75] [--max_images N]
      [--merge_nms] [--serve_mode flax|fast|fast_bf16]
      [--dense_layout true] [--device cuda]
      [--arch yolat_pp [--pp_factored_prim true] | --profile yolat_pp_fast]

Batch 1, manifest order, packed as `cli.test` packs it
(`cli.test.serving_loader`: the edge-window plan; the dense table under
`--dense_layout true`, the JAX CLI's default layout). The weights are
restored by `cli.test.load_checkpoint`. Prediction takes the route of
`eval/runner.evaluate` (`batch_predictor`): `flax` the eval-mode module,
`fast` / `fast_bf16` the folded-BN engine with its kernels through
`make_serving_fn`, on the card one CUDA graph per (slot cap, batch
signature). `--merge_nms` replaces the hard NMS by the weighted merge
(`eval/merge_nms`) over the kept proposals at `--conf_th`. Prints the
parameter count, one `<svg>: <n> detections` line per image, the warm mean
inference time (calls 2 onward, each synchronised by the fetch of its
detections) and last the launch counts of the serving kernels and the
CUDA graphs captured and replayed. `--device` defaults to cuda and raises
when CUDA is absent. Drawing needs matplotlib: without it `main` raises
before the first image. `detect(argv, render=)` is the loop itself, with
the renderer as an argument. Stated difference: no "compiled forward
flops" line (the JAX CLI reads XLA's cost analysis, which has no
counterpart here).
"""

from __future__ import annotations

import os
import time

import numpy as np

from yolat_tpu_torch.cli.test import (add_serving_flags, load_checkpoint,
                                      serving_loader)
from yolat_tpu_torch.cli.train import (build_parser, config_from_args,
                                       device_from_arg)
from yolat_tpu_torch.config import PP_ARCHS
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.eval.merge_nms import merge_nms
from yolat_tpu_torch.eval.runner import batch_predictor
from yolat_tpu_torch.ops import _build

# the serving kernels the end line counts (YOLaT++ adds kernels 5 and 6)
KERNELS = ("edge_window_message_sum", "folded_mlp_block_max2",
           "fused_dense_message", "nms_fixpoint", "nms_classfix")
PP_KERNELS = ("banded_message_sum", "banded_message_sum_both")


def require_matplotlib(what: str) -> None:
    """Raise, naming matplotlib, where it does not import: the drivers
    never skip their drawing silently."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            f"{what} draws its overlays with matplotlib, which is not "
            "installed here (cli.infer writes the detections without "
            "drawing)") from e


def draw_svg(ax, svg_path: str, color: str) -> None:
    """The SVG's primitives as polylines, 12 points per cubic."""
    from yolat_tpu_torch.geom.bezier import shape_to_cubics
    from yolat_tpu_torch.geom.svg_io import SVGDocument

    doc = SVGDocument.from_file(svg_path)
    for shape in doc.shapes:
        for seg in shape_to_cubics(shape):
            t = np.linspace(0, 1, 12)[:, None]
            pts = ((1 - t) ** 3 * seg[0] + 3 * (1 - t) ** 2 * t * seg[1]
                   + 3 * (1 - t) * t ** 2 * seg[2] + t ** 3 * seg[3])
            ax.plot(pts[:, 0], pts[:, 1], color=color, linewidth=0.8)


def render_detections(svg_path, width, height, boxes, scores, classes,
                      class_names, out_path, score_th=0.75):
    """Matplotlib overlay: SVG primitives as lines + detection rectangles."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 12 * height / width))
    draw_svg(ax, svg_path, "0.6")

    cmap = (plt.cm.get_cmap("tab20") if hasattr(plt.cm, "get_cmap")
            else plt.get_cmap("tab20"))
    for box, score, cls in zip(boxes, scores, classes):
        if score < score_th:
            continue
        color = cmap(int(cls) % 20)
        ax.add_patch(
            patches.Rectangle(
                (box[0], box[1]), box[2] - box[0], box[3] - box[1],
                linewidth=2, edgecolor=color, facecolor="none",
            )
        )
        ax.text(box[0], box[1], f"{class_names[int(cls)]} {score:.2f}",
                color=color, fontsize=8)
    ax.set_xlim(0, width)
    ax.set_ylim(height, 0)
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def png_name(svg_path: str) -> str:
    """`<dir>_<file>.png`: the folder's name keeps two partitions' files
    apart in one output dir."""
    return (os.path.basename(os.path.dirname(svg_path)) + "_"
            + os.path.basename(svg_path).replace(".svg", ".png"))


def build_detect_parser():
    p = build_parser()
    p.description = "yolat_tpu_torch detection + visualisation"
    add_serving_flags(p)
    p.add_argument("--out_dir", default="output_all", type=str)
    p.add_argument("--conf_th", default=0.75, type=float)
    p.add_argument("--max_images", default=0, type=int)
    p.add_argument("--merge_nms", action="store_true",
                   help="weighted-merge NMS on the kept proposals (the "
                        "reference detect.py post-processing) instead of "
                        "hard NMS")
    return p


def detect(argv=None, render=render_detections) -> dict:
    """The CLI's loop: `render(svg_path, width, height, boxes, scores,
    classes, class_names, out_path, score_th=)` per image. Returns
    {params, images: [{file, out_path, boxes, scores, classes, score_th,
    outputs (the predict dict)}], times_s (per call),
    set_up (per call: it made a serving fn, on the card a graph capture),
    launches, graphs, serving_fns}."""
    args = build_detect_parser().parse_args(argv)
    device = device_from_arg(args.device)
    cfg = config_from_args(args, argv)
    ds = SESYDDataset(cfg.data_dir, "test",
                      bbox_sampling_step=cfg.bbox_sampling_step)
    cfg = cfg.replace(n_classes=ds.n_classes, train_layout="sparse")
    # packed inline: a loop cut by --max_images leaves no producer behind
    loader = serving_loader(cfg, ds, 1, args.serve_mode, prefetch=0)
    model, _, _ = load_checkpoint(cfg, device)
    if device.type == "cuda" and args.serve_mode != "flax":
        _build.library()  # the kernels are built before the first image
    predict = batch_predictor(cfg, model, args.serve_mode, device,
                              cfg.max_det)

    # the reference prints the parameter count at detect.py:211-212
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.3f} M")

    class_names = [""] * cfg.n_classes
    for k, v in ds.class_dict.items():
        class_names[v] = k

    os.makedirs(args.out_dir, exist_ok=True)
    launched = dict(_build.launch_counts)  # this run's launches are the rise
    graphs = dict(_build.graph_counts)
    times, set_up, images = [], [], []
    for i, batch in enumerate(loader):
        if args.max_images and i >= args.max_images:
            break
        n_fns = len(predict.serving_fns)
        t0 = time.perf_counter()
        out = predict(batch)  # numpy: the fetch synchronises
        times.append(time.perf_counter() - t0)
        set_up.append(len(predict.serving_fns) > n_fns)

        svg_path = ds.files[i]
        w, h = batch["wh"][0]
        if args.merge_nms:
            kept = out["kept"]
            m = merge_nms(out["prop_boxes"][kept], out["prop_obj"][kept],
                          out["prop_cls"][kept], conf_thres=args.conf_th,
                          nms_thres=0.4)
            det_boxes, det_scores, det_classes = (
                m["boxes"], m["obj_conf"] * m["cls_conf"], m["classes"])
            score_th = 0.0
        else:
            valid = out["valid"][0]
            det_boxes = out["boxes"][0][valid]
            det_scores = out["scores"][0][valid]
            det_classes = out["classes"][0][valid]
            score_th = args.conf_th
        out_path = os.path.join(args.out_dir, png_name(svg_path))
        render(svg_path, w, h, det_boxes, det_scores, det_classes,
               class_names, out_path, score_th=score_th)
        print(f"{svg_path}: {len(det_boxes)} detections")
        images.append({"file": svg_path, "out_path": out_path,
                       "boxes": det_boxes, "scores": det_scores,
                       "classes": det_classes, "score_th": score_th,
                       "outputs": out})

    if len(times) > 1:
        # skip the first call (the kernels' first launch, a graph's
        # capture); the reference's "mean inference time" (detect.py:373)
        # is likewise a warm mean
        warm = times[1:]
        print(f"mean inference time: {1000 * sum(warm) / len(warm):.2f} ms")
    elif times:
        print(f"inference time: {1000 * times[0]:.2f} ms (single image, "
              "includes the first call's set-up)")
    counts = {k: v - launched[k] for k, v in _build.launch_counts.items()}
    graphed = {k: v - graphs[k] for k, v in _build.graph_counts.items()}
    shown = KERNELS + (PP_KERNELS if cfg.arch in PP_ARCHS else ())
    print(f"{len(images)} images ({args.serve_mode}, "
          f"{'dense table' if cfg.dense_layout else 'edge window'}, "
          f"{cfg.nms_algorithm}); kernel launches: "
          + ", ".join(f"{k}={counts[k]}" for k in shown)
          + f"; CUDA graphs captured={graphed['captured']}, "
          f"replayed={graphed['replayed']}")
    return {"params": n_params, "images": images, "times_s": times,
            "set_up": set_up, "launches": counts, "graphs": graphed,
            "serving_fns": len(predict.serving_fns)}


def main(argv=None) -> dict:
    require_matplotlib("cli.detect")
    return detect(argv, render=render_detections)


if __name__ == "__main__":
    main()
