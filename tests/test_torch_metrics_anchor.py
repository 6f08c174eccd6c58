"""The port's `eval/metrics.batch_statistics_loop` and
`SESYDDataset.get_anchor` against the JAX package's.

The loop is held equal to yolat_tpu's loop and to the port's vectorised
`batch_statistics` in a seeded fuzz with score ties, duplicate boxes and
GTs, labels absent from the GT, an empty GT and no detections, at IoU
thresholds 0 to 0.95 (exact: the true-positive flags are 0/1 and scores
and labels pass through). `get_anchor` returns JAX's dict, exactly, on
synthetic floorplans, diagrams and charts (both datasets built with
`cache=False`, so neither reads the other's graph cache).
"""

import numpy as np
import pytest

from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.eval.metrics import batch_statistics_loop as jax_loop
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.synthetic import (write_chart_dataset,
                                            write_diagram_dataset)
from yolat_tpu_torch.eval.metrics import (batch_statistics,
                                          batch_statistics_loop)

THRESHOLDS = (0.0, 0.3, 0.5, 0.75, 0.95)


def _case(rng, d: int, g: int, n_labels: int):
    """Score-ordered detections over GT boxes: some detections near a GT,
    some duplicated, scores with ties, labels drawn from a wider set than
    the GT's."""
    gxy = rng.random((g, 2)) * 80
    gt = np.concatenate([gxy, gxy + rng.random((g, 2)) * 30 + 1], 1)
    if g > 2:
        gt[-1] = gt[0]  # a duplicate GT box
    xy = rng.random((d, 2)) * 80
    det = np.concatenate([xy, xy + rng.random((d, 2)) * 30 + 1], 1)
    for i in range(d):
        if g and rng.random() < 0.6:
            det[i] = gt[int(rng.integers(g))] + rng.normal(0, 2, 4)
    if d > 3:
        det[1] = det[0]  # a duplicate detection
    scores = np.sort(np.round(rng.random(d), 1))[::-1].copy()  # ties
    det_labels = rng.integers(0, n_labels + 2, d)  # some not in the GT
    gt_labels = rng.integers(0, n_labels, g)
    return det, scores, det_labels, gt, gt_labels


@pytest.mark.parametrize("seed", range(4))
def test_batch_statistics_loop_fuzz(seed):
    rng = np.random.default_rng(100 + seed)
    cases = [(0, 3), (5, 0), (0, 0)] + [
        (int(rng.integers(1, 40)), int(rng.integers(1, 12)))
        for _ in range(60)]
    n_tp = 0
    for d, g in cases:
        args = _case(rng, d, g, n_labels=int(rng.integers(1, 5)))
        for th in THRESHOLDS:
            tp, sc, lb = batch_statistics_loop(*args, th)
            want, wsc, wlb = jax_loop(*args, th)
            np.testing.assert_array_equal(tp, want)
            assert tp.dtype == want.dtype
            np.testing.assert_array_equal(sc, wsc)
            np.testing.assert_array_equal(lb, wlb)
            vec, _, _ = batch_statistics(*args, th)
            np.testing.assert_array_equal(vec, tp)
            n_tp += int(tp.sum())
    assert n_tp > 100  # the fuzz reaches matches, not only misses


@pytest.fixture(scope="module")
def diagram_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("anchor_diagrams")
    write_diagram_dataset(str(root), n_train=2, n_test=1, seed=4)
    return str(root)


@pytest.fixture(scope="module")
def chart_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("anchor_charts")
    write_chart_dataset(str(root), n_train=2, n_test=1, seed=5, width=900.0,
                        height=700.0, n_series=2, points_per_series=4)
    return str(root)


@pytest.mark.parametrize("which", ["floorplans", "diagrams", "charts"])
def test_get_anchor_matches_jax(which, request):
    root = request.getfixturevalue({"floorplans": "synthetic_root",
                                    "diagrams": "diagram_root",
                                    "charts": "chart_root"}[which])
    got = SESYDDataset(root, "train", cache=False).get_anchor()
    want = JaxDataset(root, "train", cache=False).get_anchor()
    assert got == want
    assert got and sum(v["count"] for v in got.values()) >= 2
    for stats in got.values():
        assert set(stats) == {"median", "mean", "max", "min", "count"}
