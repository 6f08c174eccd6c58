"""Graph debug visualisation.

Counterpart of `yolat_tpu/cli/draw_graph.py` (the reference's
cad_recognition/draw_graph.py and the raster-debug blocks of its datasets,
graph_dict3.py:978-1046): render a built graph (shape edges, super edges
subsampled past `max_super` by `default_rng(0)`, nodes) over the SVG
frame, and print each file's graph statistics.

  python -m yolat_tpu_torch.cli.draw_graph --data_dir DIR
      [--partition train] [--max_images 4] [--out_dir graph_debug]

It runs on the host and needs matplotlib, imported inside `draw_graph`
only; without it the first drawing raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from yolat_tpu_torch.data.dataset import SESYDDataset


def draw_graph(graph, width, height, out_path, max_super=2000):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pos = np.asarray(graph["pos"]) * [width, height]
    is_control = np.asarray(graph["attr"]["is_control"]).reshape(-1) > 0.5

    fig, ax = plt.subplots(figsize=(12, 12 * height / width))
    for a, b in graph["edge"]["shape"]:
        ax.plot([pos[a, 0], pos[b, 0]], [pos[a, 1], pos[b, 1]],
                color="tab:blue", linewidth=1.0)
    sup = graph["edge"]["super"]
    if len(sup) > max_super:
        sel = np.random.default_rng(0).choice(len(sup), max_super,
                                              replace=False)
        sup = sup[sel]
    for a, b in sup:
        ax.plot([pos[a, 0], pos[b, 0]], [pos[a, 1], pos[b, 1]],
                color="tab:green", linewidth=0.2, alpha=0.3)
    ax.scatter(pos[~is_control, 0], pos[~is_control, 1], s=6, c="tab:blue")
    if is_control.any():
        ax.scatter(pos[is_control, 0], pos[is_control, 1], s=3,
                   c="tab:orange")
    ax.set_xlim(0, width)
    ax.set_ylim(height, 0)
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(description="yolat_tpu_torch graph debug viz")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", default="graph_debug", type=str)
    p.add_argument("--partition", default="train", type=str)
    p.add_argument("--max_images", default=4, type=int)
    args = p.parse_args(argv)

    ds = SESYDDataset(args.data_dir, args.partition)
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(min(args.max_images, len(ds))):
        g = ds._graph(ds.files[i])
        n = len(g["pos"])
        print(
            f"{ds.files[i]}: nodes={n} shape={len(g['edge']['shape'])} "
            f"control={len(g['edge']['control'])} "
            f"super={len(g['edge']['super'])} ccs={len(g['cc'])}"
        )
        name = os.path.basename(ds.files[i]).replace(".svg", "_graph.png")
        draw_graph(g, g["img_width"], g["img_height"],
                   os.path.join(args.out_dir, name))


if __name__ == "__main__":
    main()
