"""Decide `correct`: the program's first train steps against the plain
reference's.

The program's set-up runs the cell's first `CHECK_STEPS` steps through the
window's own call and feed (`harness.TrainLoop`): the eager first step,
then graph replays. Its losses, the first gradient as its Adam read it
(the first moment after one step over 1 - beta1), the last step's (a
replay's: (m_last - beta1 m_before) / (1 - beta1), from the first moment
before and after it) and its parameters after the last step are kept. The
reference (the configuration's `reference`, here `ref.model`, and
`ref.data`) finds which corpus files each image
slot of those batches held (by their ground truth), works their graphs and
proposals out again from the SVGs on the numpy path, draws the
augmentation from a generator seeded as the program's, and runs the same
steps from the same starting weights in float32 with TF32 off.

Six numbers are compared, each with its limit (the configuration's
`limits`):
  loss_gap    the largest |L - L_ref| / |L_ref| over the steps;
  grad_gap    over the leaves, the median of the gap between the norms of
              the program's and the reference's first gradient, over the
              reference's norm of that leaf or of the median leaf,
              whichever is larger;
  grad_gap_worst  the largest of those gaps: a small leaf's, one whose
              gradient BatchNorm cancels nearly whole or a gate's, which a
              plain bf16 reference reads as the program does (PERF.md), so
              it swings from seed to seed and has a wide limit; it sees
              one leaf's gradient gone wrong, which the median does not;
  last_grad_gap, last_grad_gap_worst  the same two of the last step's
              gradient: the replayed step's gradients, which the first
              step's, run eagerly, do not see;
  change_gap  the same of the parameters' change over the steps, over the
              leaves whose first gradient in the reference is at least a
              thousandth of the median leaf's (the others, such as a bias
              under BatchNorm, move under Adam by round-off alone).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.ref import data as ref_data

NUMBERS = ("loss_gap", "grad_gap", "grad_gap_worst", "last_grad_gap",
           "last_grad_gap_worst", "change_gap")
ROUNDOFF_SHARE = 1e-3


class Unmatched(ValueError):
    """An image slot of a checked batch matches no corpus file (or more
    than one) by its ground truth."""


def match_slots(batches_gt: list, corpus_gt: list) -> list:
    """Per batch, the corpus index of each image slot's file, found by its
    ground-truth boxes and labels; raises where a slot matches no file."""
    out = []
    for gt_bbox, gt_labels, gt_mask, n_images in batches_gt:
        idx = []
        for k in range(n_images):
            m = gt_mask[k]
            box, lab = gt_bbox[k][m], gt_labels[k][m]
            hit = [i for i, (cb, cl) in enumerate(corpus_gt)
                   if len(cb) == len(box) and np.array_equal(cl, lab)
                   and np.allclose(cb.astype(np.float32), box, rtol=0,
                                   atol=1e-6)]
            if len(hit) != 1:
                raise Unmatched(f"an image slot matches {len(hit)} corpus "
                                "files by its ground truth")
            idx.append(hit[0])
        out.append(idx)
    return out


def reference_batches(cell, files: list, slots: list, seed: int,
                      device) -> list:
    """The reference's augmented plain batches of the steps."""
    from benchmark.corpus import FLOORPLAN_CLASSES

    mix = cell.mix
    loaded = {i: ref_data.load_file(files[i], FLOORPLAN_CLASSES,
                                    mix["bbox_sampling_step"])
              for i in sorted({i for s in slots for i in s})}
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    n_slots = mix["batch_size"]
    out = []
    for s in slots:
        b = ref_data.plain_batch([loaded[i] for i in s], n_slots,
                                 cell.reference.is_pp(cell.config), device)
        out.append(ref_data.augment(b, ref_data.draw_augmentation(
            n_slots, gen, device)))
    return out


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def _gaps(a: dict, b: dict, keys) -> dict:
    """|a - b| / max(b, the median leaf's b) per leaf."""
    med = float(np.median([b[k] for k in keys]))
    return {k: abs(a[k] - b[k]) / max(b[k], med, 1e-30) for k in keys}


def readings(prog: dict, ref: dict, weights: dict) -> dict:
    """The numbers of one run (module docstring), and what the look at
    them reads beside: each step's loss gap, the leaves of the worst
    gradient gaps and of the worst change, the leaves left out of the
    change. prog and ref: {'losses', 'grad1', 'grad_last', 'params'};
    weights: the starting weights of both."""
    steps = [abs(a - b) / max(abs(b), 1e-12)
             for a, b in zip(prog["losses"], ref["losses"])]
    gp, gr = _norms(prog["grad1"]), _norms(ref["grad1"])
    grad = _gaps(gp, gr, list(gr))
    lp, lr = _norms(prog["grad_last"]), _norms(ref["grad_last"])
    last = _gaps(lp, lr, list(lr))
    g_med = float(np.median(list(gr.values())))
    moved = [k for k in gr if gr[k] >= ROUNDOFF_SHARE * g_med]
    cp = _norms({k: prog["params"][k] - weights[k] for k in moved})
    cr = _norms({k: ref["params"][k] - weights[k] for k in moved})
    change = _gaps(cp, cr, moved)
    worst_g = max(grad, key=grad.get)
    worst_l = max(last, key=last.get)
    worst_c = max(change, key=change.get)
    return {"loss_gap": max(steps),
            "grad_gap": float(np.median(list(grad.values()))),
            "grad_gap_worst": grad[worst_g],
            "last_grad_gap": float(np.median(list(last.values()))),
            "last_grad_gap_worst": last[worst_l],
            "change_gap": change[worst_c],
            "loss_steps": steps, "grad_leaf": worst_g,
            "last_grad_leaf": worst_l, "change_leaf": worst_c,
            "left_out": len(gr) - len(moved)}


def judge(values: dict, limits: dict) -> bool:
    """Every number finite and within its limit."""
    return all(math.isfinite(values[k]) and values[k] <= limits[k]
               for k in NUMBERS)


def reference_inputs(cell, seed: int, files: list, batches_gt: list,
                     device) -> list:
    """The reference's batches of the files the program's first batches
    held, augmented as the program's steps drew it."""
    from benchmark.corpus import FLOORPLAN_CLASSES

    c = cell.mix["corpus"]
    corpus_gt = [ref_data.ground_truth(f, c["width"], c["height"],
                                       FLOORPLAN_CLASSES) for f in files]
    return reference_batches(cell, files, match_slots(batches_gt, corpus_gt),
                             seed, device)


def run_reference(cell, batches: list, weights: dict,
                  precision: str = "f32", fault=None) -> dict:
    """The reference's steps -> {'losses', 'grad1', 'grad_last',
    'params'}, with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return cell.reference.train_steps(cell.config, weights, batches,
                                      precision, fault)
