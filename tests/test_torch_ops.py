"""Port ops (segment reductions, NMS, IoU) against yolat_tpu's on the same
seeded numpy inputs.

Tolerances: segment sums/means accumulate in a different order than XLA,
so f32 results agree to ~1e-6 relative (rtol 1e-5); max is exact. NMS
must give identical detections; scores and boxes are copies of the
inputs, so they compare exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.ops import iou as jiou
from yolat_tpu.ops import segment as jseg
from yolat_tpu.ops.nms import single_image_nms as jax_nms
from yolat_tpu_torch.ops import iou as tiou
from yolat_tpu_torch.ops import segment as tseg
from yolat_tpu_torch.ops.nms import batched_nms, single_image_nms
from yolat_tpu_torch.ops.plans import pool_plan


def _seg_case(kind, seed=0, c=6):
    """(data, segment ids, mask, n_segments, plan or None); segment 3 is
    always empty."""
    rng = np.random.default_rng(seed)
    if kind == "aligned":
        runs = rng.integers(1, 4, 12) * 8
        runs[3] = 0
        seg = np.repeat(np.arange(12), runs).astype(np.int32)
        plan = pool_plan(seg, 12, cap=0)
    else:
        seg = np.sort(rng.integers(0, 12, 200)).astype(np.int32)
        seg[seg == 3] = 4
        plan = pool_plan(seg, 12) if kind == "boundary" else None
    data = rng.normal(size=(len(seg), c)).astype(np.float32)
    mask = rng.random(len(seg)) < 0.8
    return data, seg, mask, 12, plan


@pytest.mark.parametrize("kind", ["scatter", "aligned", "boundary"])
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_segment_ops_match_jax(kind, op):
    data, seg, mask, ns, plan = _seg_case(kind)
    jplan = None if plan is None else tuple(jnp.asarray(plan[k]) for k in (
        "pool_blk_first", "pool_blk_full", "pool_bnd_rows", "pool_bnd_seg",
        "pool_bnd_mask"))
    tplan = None if plan is None else tuple(torch.from_numpy(plan[k]) for k in (
        "pool_blk_first", "pool_blk_full", "pool_bnd_rows", "pool_bnd_seg",
        "pool_bnd_mask"))
    jf = getattr(jseg, f"segment_{op}")
    tf = getattr(tseg, f"segment_{op}")
    want = np.asarray(jf(jnp.asarray(data), jnp.asarray(seg), ns,
                         mask=jnp.asarray(mask), indices_are_sorted=True,
                         plan=jplan))
    got = tf(torch.from_numpy(data), torch.from_numpy(seg), ns,
             mask=torch.from_numpy(mask), plan=tplan).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got[3] == 0).all()  # the empty segment


def test_segment_mean_counts_and_max_concat():
    data, seg, mask, ns, _ = _seg_case("aligned", seed=1)
    counts = np.bincount(seg[mask], minlength=ns).astype(np.float32)
    want = np.asarray(jseg.segment_mean(jnp.asarray(data), jnp.asarray(seg), ns,
                                        mask=jnp.asarray(mask),
                                        counts=jnp.asarray(counts)))
    got = tseg.segment_mean(torch.from_numpy(data), torch.from_numpy(seg), ns,
                            mask=torch.from_numpy(mask),
                            counts=torch.from_numpy(counts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    parts = (data[:, :2], data[:, 2:])
    want = np.asarray(jseg.segment_max_concat(
        tuple(jnp.asarray(p) for p in parts), jnp.asarray(seg), ns,
        mask=jnp.asarray(mask)))
    got = tseg.segment_max_concat(tuple(torch.from_numpy(p) for p in parts),
                                  torch.from_numpy(seg), ns,
                                  mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)


def _nms_case(seed, m=60, k=4, ties=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, (m, 2)).astype(np.float32)
    wh = rng.uniform(5, 60, (m, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=1)
    cls = rng.uniform(0, 1, (m, k)).astype(np.float32)
    obj = rng.uniform(0.2, 1, m).astype(np.float32)
    if ties:  # exact score ties between overlapping and distant boxes
        cls = np.round(cls * 4) / 4
        obj[:] = 0.5
        boxes[1::2] = boxes[0::2] + 1.0
    valid = rng.random(m) < 0.9
    return boxes, cls, obj, valid


@pytest.mark.parametrize("algorithm", ["fixpoint", "loop", "classfix"])
@pytest.mark.parametrize("ties", [False, True])
def test_nms_matches_jax(algorithm, ties):
    boxes, cls, obj, valid = _nms_case(3, ties=ties)
    kw = dict(iou_thres=0.5, conf_thres=0.05, max_det=40,
              algorithm=algorithm, topk=128)
    want = jax_nms(*(jnp.asarray(a) for a in (boxes, cls, obj, valid)), **kw)
    got = single_image_nms(*(torch.from_numpy(a) for a in (boxes, cls, obj,
                                                          valid)), **kw)
    for key in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert int(got["valid"].sum()) > 5


@pytest.mark.parametrize("m,k,max_det", [(6, 2, 40), (60, 4, 500)])
def test_classfix_pads_past_its_candidates(m, k, max_det):
    """max_det above the M * K candidates (padded slots) or above the
    kept count (invalid tail), ties included: identical to JAX."""
    boxes, cls, obj, valid = _nms_case(8, m=m, k=k, ties=True)
    kw = dict(iou_thres=0.5, conf_thres=0.05, max_det=max_det,
              algorithm="classfix")
    want = jax_nms(*(jnp.asarray(a) for a in (boxes, cls, obj, valid)), **kw)
    got = single_image_nms(*(torch.from_numpy(a) for a in (boxes, cls, obj,
                                                          valid)), **kw)
    for key in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert 0 < int(got["valid"].sum()) < max_det


def test_classfix_keeps_what_the_loop_keeps():
    """Both are exact over all candidates: the same detections as sets
    (the loop orders equal scores by candidate index, classfix by class)."""
    boxes, cls, obj, valid = _nms_case(9)
    args = [torch.from_numpy(a) for a in (boxes, cls, obj, valid)]
    kw = dict(iou_thres=0.5, conf_thres=0.05, max_det=240)
    a = single_image_nms(*args, algorithm="classfix", **kw)
    b = single_image_nms(*args, algorithm="loop", **kw)
    assert int(a["valid"].sum()) == int(b["valid"].sum()) > 20
    for out in (a, b):
        out["key"] = sorted(zip(out["scores"][out["valid"]].tolist(),
                                out["classes"][out["valid"]].tolist()))
    assert a["key"] == b["key"]
    with pytest.raises(ValueError, match="classfix"):
        single_image_nms(*args, algorithm="greedy")


def test_nms_batched_equals_per_image(algorithm="fixpoint"):
    cases = [_nms_case(s) for s in (4, 5, 6)]
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*cases)]
    kw = dict(iou_thres=0.45, max_det=30, topk=256, algorithm=algorithm)
    out = batched_nms(*stacked, **kw)
    for i, case in enumerate(cases):
        one = single_image_nms(*(torch.from_numpy(a) for a in case), **kw)
        for key in one:
            assert torch.equal(out[key][i], one[key]), key


def test_classfix_batched_equals_per_image():
    test_nms_batched_equals_per_image("classfix")


def test_iou_and_inflation_match_jax():
    rng = np.random.default_rng(7)
    a = np.sort(rng.uniform(0, 50, (9, 4)).reshape(9, 2, 2), axis=1
                ).transpose(0, 2, 1).reshape(9, 4).astype(np.float32)
    b = a[::-1].copy() + 3.0
    for plus1 in (False, True):
        np.testing.assert_allclose(
            tiou.box_iou_matrix(torch.from_numpy(a), torch.from_numpy(b),
                                plus1=plus1).numpy(),
            np.asarray(jiou.box_iou_matrix(jnp.asarray(a), jnp.asarray(b),
                                           plus1=plus1)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tiou.inflate_boxes(torch.from_numpy(a)).numpy(),
                               np.asarray(jiou.inflate_boxes(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tiou.xywh_to_xyxy(torch.from_numpy(a)).numpy(),
                               np.asarray(jiou.xywh_to_xyxy(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-6)
