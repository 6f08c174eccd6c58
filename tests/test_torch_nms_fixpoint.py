"""Kernel N1, the NMS fixed point on the device (`ops/nms_fixpoint.py`).

On the CPU: the plain loops (the CPU route) against a sequential greedy
pass in numpy, on random suppression relations and on a chain that takes
one sweep per candidate, and `batched_nms` fixpoint / classfix against the
`loop` oracle. Marked `cuda` (skipped without a CUDA device; run on the
card with `python -m pytest --noconftest -q -m cuda
tests/test_torch_nms_fixpoint.py`): the kernel's kept sets equal to the
plain loop's, exactly (the fixed point is unique), on the same cases at
widths on both of its routes (16-byte rows and byte rows). This file
imports no jax.
"""

import numpy as np
import pytest
import torch

from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops import nms_fixpoint as nf
from yolat_tpu_torch.ops.nms import batched_nms


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _fix_case(seed, b, c, density=0.05):
    rng = np.random.default_rng(seed)
    sup = np.tril(rng.random((b, c, c)) < density, -1)
    valid = rng.random((b, c)) < 0.9
    return torch.from_numpy(sup), torch.from_numpy(valid)


def _chain(b, c):
    sup = np.zeros((b, c, c), bool)
    sup[:, np.arange(1, c), np.arange(c - 1)] = True
    return torch.from_numpy(sup), torch.ones(b, c, dtype=torch.bool)


def _greedy_fix(sup, valid):
    sup, valid = sup.numpy(), valid.numpy()
    kept = np.zeros_like(valid)
    for b in range(valid.shape[0]):
        for i in range(valid.shape[1]):  # rank order: j < i outranks i
            kept[b, i] = valid[b, i] and not (sup[b, i, :i] & kept[b, :i]).any()
    return kept


def _class_case(seed, b, k, m):
    rng = np.random.default_rng(seed)
    boxes = rng.random((b, m, 2)) * 10
    d = np.abs(boxes[:, :, None, :] - boxes[:, None, :, :]).max(-1)
    overb = d < 1.5  # symmetric, diagonal True
    rank = np.stack([np.stack([rng.permutation(m) for _ in range(k)])
                     for _ in range(b)]).astype(np.int32)
    cand = rng.random((b, k, m)) < 0.8
    return (torch.from_numpy(overb), torch.from_numpy(rank),
            torch.from_numpy(cand))


def _greedy_class(overb, rank, cand):
    overb, rank, cand = overb.numpy(), rank.numpy(), cand.numpy()
    kept = np.zeros_like(cand)
    for b in range(cand.shape[0]):
        for k in range(cand.shape[1]):
            for i in np.argsort(rank[b, k]):  # best rank first
                better = rank[b, k] < rank[b, k, i]
                kept[b, k, i] = cand[b, k, i] and not (
                    kept[b, k] & overb[b, :, i] & better).any()
    return kept


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_fixpoint_is_the_greedy_pass(seed):
    for sup, valid in (_fix_case(seed, 2, 96), _chain(2, 40)):
        got = nf.fixpoint_kept(sup, valid)
        np.testing.assert_array_equal(got.numpy(), _greedy_fix(sup, valid))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_classfix_is_the_greedy_pass(seed):
    args = _class_case(seed, 2, 3, 50)
    got = nf.classfix_kept(*args)
    np.testing.assert_array_equal(got.numpy(), _greedy_class(*args))


@pytest.mark.parametrize("algorithm", ["fixpoint", "classfix"])
def test_batched_nms_matches_the_loop_oracle(algorithm):
    rng = np.random.default_rng(7)
    b, m, k = 2, 60, 3
    xy = rng.random((b, m, 2)) * 50
    wh = rng.random((b, m, 2)) * 15 + 1
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                             .astype(np.float32))
    cls = torch.from_numpy(rng.random((b, m, k)).astype(np.float32))
    obj = torch.from_numpy(rng.random((b, m)).astype(np.float32))
    valid = torch.from_numpy(rng.random((b, m)) < 0.9)
    kw = dict(iou_thres=0.3, max_det=40, topk=m * k)
    _build.reset_launch_counts()
    got = batched_nms(boxes, cls, obj, valid, algorithm=algorithm, **kw)
    want = batched_nms(boxes, cls, obj, valid, algorithm="loop", **kw)
    for key in ("valid", "classes", "scores", "boxes"):
        assert torch.equal(got[key], want[key]), key
    assert got["valid"].sum() > 10
    assert _build.launch_counts["nms_" + algorithm] == 0  # CPU: plain loop


@pytest.mark.cuda
def test_kernel_matches_plain_loop(cuda_device):
    for c in (1024, 1000):  # the 16-byte route and the byte route
        for sup, valid in (_fix_case(3, 4, c), _chain(4, c)):
            sup, valid = sup.to(cuda_device), valid.to(cuda_device)
            before = _build.launch_counts["nms_fixpoint"]
            got = nf.fixpoint_kept(sup, valid)
            torch.cuda.synchronize()
            assert _build.launch_counts["nms_fixpoint"] == before + 1
            assert torch.equal(got, nf.fixpoint_kept_plain(sup, valid))
    for m in (512, 500):
        args = tuple(t.to(cuda_device) for t in _class_case(4, 4, 16, m))
        got = nf.classfix_kept(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, nf.classfix_kept_plain(*args))
    # an empty problem launches nothing and returns an empty set
    before = _build.launch_counts["nms_fixpoint"]
    empty = nf.fixpoint_kept(torch.zeros(0, 8, 8, dtype=torch.bool,
                                         device=cuda_device),
                             torch.zeros(0, 8, dtype=torch.bool,
                                         device=cuda_device))
    assert empty.shape == (0, 8)
    assert _build.launch_counts["nms_fixpoint"] == before
