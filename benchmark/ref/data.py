"""The reference's host stage and batches: SVG -> graph -> proposals on
the frozen numpy path (`ref.geom`), then one plain batch of the real rows
of a few files, and the train-time augmentation.

What a batch holds (torch tensors on one device): pos [N, 2] float32 (the
proposal-normalised node positions), prop [N] (node -> proposal), src /
dst [E] (edge j -> i), e_attr [E, 4], labels [P], prop_img [P] (proposal
-> image slot), root_slot [P] (the root proposal of each proposal's
connected component), and for YOLaT++ super_src / super_dst [S] with
e_attr_super [S, 4]; n_prop, n_slots. No padding and no plan: every row
is real.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.ref.geom.graph_build import build_svg_graph
from benchmark.ref.geom.proposals import generate_proposals
from benchmark.ref.geom.svg_io import SVGDocument, read_ground_truth_boxes


def ground_truth(svg_path: str, width: float, height: float,
                 class_dict: dict):
    """(boxes [G, 4] normalised, labels [G]) from the file's XML."""
    return read_ground_truth_boxes(svg_path.replace(".svg", ".xml"), width,
                                   height, class_dict)


def load_file(svg_path: str, class_dict: dict, step: int):
    """The file's proposal set, from its SVG and XML."""
    graph = build_svg_graph(SVGDocument.from_file(svg_path), mode="floorplan")
    gt_bbox, gt_labels = ground_truth(svg_path, graph["img_width"],
                                      graph["img_height"], class_dict)
    n_classes = len(set(class_dict.values()))
    return generate_proposals(graph, gt_bbox, gt_labels, n_classes,
                              bbox_sampling_step=step)


def plain_batch(files: list, n_slots: int, super_family: bool,
                device) -> dict:
    """The real rows of `files` (proposal sets, one per image slot from 0),
    concatenated."""
    pos, prop, src, dst, attr, labels, img, root = ([] for _ in range(8))
    ssrc, sdst, sattr = [], [], []
    n_off = p_off = 0
    for k, f in enumerate(files):
        n, p = len(f.pos), len(f.labels)
        pos.append(np.asarray(f.pos, np.float32))
        prop.append(np.asarray(f.bbox_idx, np.int64) + p_off)
        e = np.asarray(f.edge, np.int64).reshape(-1, 2) + n_off
        src.append(e[:, 0])
        dst.append(e[:, 1])
        attr.append(np.asarray(f.e_attr, np.float32)[:, :4])
        labels.append(np.asarray(f.labels, np.int64))
        img.append(np.full(p, k, np.int64))
        root.append(np.repeat(np.asarray(f.root_of_cc, np.int64),
                              np.diff(np.asarray(f.cc_slice))) + p_off)
        if super_family:
            s = np.asarray(f.edge_super, np.int64).reshape(-1, 2) + n_off
            ssrc.append(s[:, 0])
            sdst.append(s[:, 1])
            sattr.append(np.asarray(f.e_attr_super, np.float32)[:, :4])
        n_off += n
        p_off += p

    def t(parts):
        return torch.from_numpy(np.concatenate(parts)).to(device)

    b = {"pos": t(pos), "prop": t(prop), "src": t(src), "dst": t(dst),
         "e_attr": t(attr), "labels": t(labels), "prop_img": t(img),
         "root_slot": t(root), "n_prop": p_off, "n_slots": n_slots}
    if super_family:
        b.update(super_src=t(ssrc), super_dst=t(sdst), e_attr_super=t(sattr))
    return b


def draw_augmentation(n_slots: int, generator: torch.Generator, device):
    """One step's augmentation draws, in the order the program's train
    step draws them (its `packing.draw_augmentation`): scale U[0.4, 1.6)
    [B], angle U[0, 2 pi) [B], translate U[-0.1, 0.1) [B, 2], axis flips
    [B, 2] with probability 1/2."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return (u(n_slots) * 1.2 + 0.4, u(n_slots) * 2.0 * np.pi,
            (u(n_slots, 2) * 2.0 - 1.0) * 0.1, u(n_slots, 2) < 0.5)


def augment(b: dict, aug) -> dict:
    """Each image's flip, rotation about the centre, translation and scale
    of its proposal-normalised positions (the reference's random_transfer,
    graph_dict3.py:283-298)."""
    scale, angle, translate, flips = aug
    img = b["prop_img"][b["prop"]]
    p = b["pos"] - 0.5
    p = torch.where(flips[img], -p, p)
    a = angle[img]
    cos, sin = torch.cos(a), torch.sin(a)
    p = torch.stack([p[:, 0] * cos - p[:, 1] * sin,
                     p[:, 0] * sin + p[:, 1] * cos], dim=1)
    p = (p + 0.5 + translate[img]) * scale[img][:, None]
    return {**b, "pos": p}
