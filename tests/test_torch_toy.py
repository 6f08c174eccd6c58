"""The port's `data/toy.py` against yolat_tpu's.

`random_packed_batch`: every key that both batches have is byte-equal
(dtype, shape and bytes) over seeds, 1-4 images, 1-3 CCs per image and a
given pad that rounds the nodes up to 512 (as tests/test_torch_pp_model.py
pads JAX's toy batch for the fused pool head), leaving out only the
plans (`ew_*`, `sew_*`), whose layout is the port's; those, and every other
key of the port's batch, equal what the port's `pack_files` gives for the
same files. The pads equal JAX's `PadSizes.for_files`. `ToyDataset` and
`toy_shape_sample` give JAX's arrays, exactly.
"""

import numpy as np
import pytest

from yolat_tpu.data.packing import PadSizes as JaxPadSizes
from yolat_tpu.data.toy import ToyDataset as JaxToyDataset
from yolat_tpu.data.toy import random_packed_batch as jax_random_packed_batch
from yolat_tpu.data.toy import toy_shape_sample as jax_toy_shape_sample
from yolat_tpu_torch.data.packing import CompactFile, pack_files
from yolat_tpu_torch.data.toy import (TOY_CLASSES, ToyDataset, _toy_scene,
                                      random_packed_batch, toy_batch,
                                      toy_shape_sample)
from yolat_tpu_torch.geom.proposals import generate_proposals
from yolat_tpu_torch.ops.plans import EW_BATCH_KEYS, SEW_KEYS


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _pad_key(p):
    return (p.n_nodes, p.n_edges, p.n_super, p.n_proposals, p.n_gt,
            p.n_images)


def _check_against_jax(got, want):
    shared = set(got) & set(want)
    plans = {k for k in shared if k.startswith(("ew_", "sew_"))}
    for k in sorted(shared - plans):
        _same(got[k], want[k], k)
    # what JAX has beyond the port: its own plan layout and two carried,
    # unread per-proposal fields
    assert set(want) - set(got) == {"ew_dst_loc", "ew_maskf", "ew_src_rel",
                                    "has_obj", "stat_feats"}
    assert set(EW_BATCH_KEYS) | set(SEW_KEYS) <= set(got)


def _port_pack(seed, n_images, ccs, pad, n_classes=17, step=4):
    """The port's pack_files over the toy's files, drawn as the toy draws
    them."""
    rng = np.random.default_rng(seed)
    files, gts, whs = [], [], []
    for _ in range(n_images):
        g, box, lab = _toy_scene(rng, ccs, n_classes)
        files.append(CompactFile(generate_proposals(
            g, box, lab, n_classes, bbox_sampling_step=step),
            super_family=True))
        gts.append((box, lab))
        whs.append((100.0, 100.0))
    return pack_files(files, gts, whs, pad, ew_transpose=True,
                      super_family=True)


@pytest.mark.parametrize("seed,n_images,ccs", [
    (0, 2, 3), (1, 1, 1), (2, 3, 2), (3, 4, 3), (4, 4, 1), (5, 2, 2)])
def test_random_packed_batch_matches_jax(seed, n_images, ccs):
    got, pad = random_packed_batch(seed=seed, n_images=n_images,
                                   ccs_per_image=ccs)
    want, jpad = jax_random_packed_batch(seed=seed, n_images=n_images,
                                         ccs_per_image=ccs)
    assert _pad_key(pad) == _pad_key(jpad)
    _check_against_jax(got, want)
    own = _port_pack(seed, n_images, ccs, pad)
    assert set(own) == set(got)
    for k in own:
        _same(got[k], own[k], k)


@pytest.mark.parametrize("seed", [0, 7])
def test_given_pad_matches_jax(seed):
    """The pad rounded up to 512 nodes, as the fused head needs
    (`toy_batch`), given back to `random_packed_batch` as it is."""
    got, pad = toy_batch(seed=seed)
    assert got["pos"].shape[0] == pad.n_nodes and pad.n_nodes % 512 == 0
    again, back = random_packed_batch(seed=seed, n_images=4, pad=pad)
    assert back is pad
    for k in got:
        _same(again[k], got[k], k)
    jpad = JaxPadSizes(pad.n_nodes, pad.n_edges, pad.n_super,
                       pad.n_proposals, pad.n_gt, pad.n_images)
    want, _ = jax_random_packed_batch(seed=seed, n_images=4, pad=jpad)
    _check_against_jax(got, want)


def test_random_packed_batch_options():
    got, pad = random_packed_batch(seed=3, n_images=2, ccs_per_image=2,
                                   n_classes=5, step=6)
    want, jpad = jax_random_packed_batch(seed=3, n_images=2,
                                         ccs_per_image=2, n_classes=5,
                                         step=6)
    assert _pad_key(pad) == _pad_key(jpad)
    _check_against_jax(got, want)
    assert got["labels"].max() <= 4


def test_toy_dataset_and_sample_match_jax():
    ds, jds = ToyDataset(n_samples=12, seed=3), JaxToyDataset(n_samples=12,
                                                              seed=3)
    assert len(ds) == len(jds) == 12
    kinds = set()
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert set(got) == set(want)
        assert got["label"] == want["label"]
        kinds.add(got["label"])
        for k in ("x", "pos", "edge", "labels"):
            _same(got[k], want[k], k)
    assert kinds == set(TOY_CLASSES.values())
    for seed in range(3):
        (g, lab), (jg, jlab) = (f(np.random.default_rng(seed)) for f in
                                (toy_shape_sample, jax_toy_shape_sample))
        assert lab == jlab
        _same(g["pos"], jg["pos"], "pos")
        _same(g["edge"]["shape"], jg["edge"]["shape"], "edge")
        _same(g["attr"]["is_control"], jg["attr"]["is_control"], "control")
