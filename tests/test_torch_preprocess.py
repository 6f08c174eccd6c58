"""The port's preprocessing pool, offline preprocess CLI and hierarchical
graph (yolat_tpu_torch.cli.preprocess, .geom.hierarchical,
PackedLoader(preproc_workers=), cli.infer --preproc_workers) against the
JAX package's and against their in-process runs.

`geom.hierarchical` equals the JAX module on the same graphs. The port's
`cli.preprocess --workers 2 --hierarchical` writes the same cache files,
stats.pkl and .hier pickles as the JAX CLI on a copy of the same tiny
set, and the same stats.pkl as its own `--workers 0`. A loader with
preproc_workers=2 packs the batches of preproc_workers=0 byte for byte,
and `cli.infer --preproc_workers 2` writes the records of
`--preproc_workers 0`.
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from tests.test_torch_native import _assert_identical
from yolat_tpu.cli import preprocess as jax_preprocess
from yolat_tpu.geom import hierarchical as jax_hier
from yolat_tpu.geom.graph_build import build_svg_graph as jax_build_graph
from yolat_tpu.geom.svg_io import SVGDocument as JaxDocument
from yolat_tpu_torch.cli import infer
from yolat_tpu_torch.cli import preprocess
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import CACHE_VERSION, SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.synthetic import write_dataset
from yolat_tpu_torch.geom import hierarchical
from yolat_tpu_torch.geom.graph_build import build_svg_graph
from yolat_tpu_torch.geom.svg_io import SVGDocument
from yolat_tpu_torch.nn.model import seeded_model


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """Two train and one test floorplan, small."""
    root = str(tmp_path_factory.mktemp("tiny_set"))
    write_dataset(root, n_train=2, n_test=1, seed=4, width=600.0,
                  height=450.0, n_rooms=2, symbols_per_room=(1, 2))
    return root


def _copy(root, dst):
    """A copy of the set's manifests and SVGs, without caches."""
    shutil.copytree(root, dst, ignore=shutil.ignore_patterns("*.pkl"))
    return str(dst)


@pytest.mark.parametrize("seed", range(4))
def test_transitive_reduction_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 6 + seed
    lo = rng.uniform(0, 1, (n, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 1.0, (n, 2))], 1)
    # box i contains box j: a DAG with chains of nested boxes
    contained = ((boxes[:, None, 0] <= boxes[None, :, 0])
                 & (boxes[:, None, 1] <= boxes[None, :, 1])
                 & (boxes[:, None, 2] >= boxes[None, :, 2])
                 & (boxes[:, None, 3] >= boxes[None, :, 3]))
    np.fill_diagonal(contained, False)
    got = hierarchical.transitive_reduction(contained)
    want = jax_hier.transitive_reduction(contained)
    _assert_identical(got, want)
    assert got.sum() <= contained.sum()


def test_hierarchical_graph_matches_jax(tiny_root):
    ds = SESYDDataset(tiny_root, "train", cache=False)
    for path in ds.files:
        got = hierarchical.build_hierarchical_graph(
            build_svg_graph(SVGDocument.from_file(path)))
        want = jax_hier.build_hierarchical_graph(
            jax_build_graph(JaxDocument.from_file(path)))
        assert got["n_super_nodes"] == len(got["cc"]) > 0
        _assert_identical(got, want)


def _caches(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".pkl"))


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_preprocess_cli_matches_jax(tiny_root, tmp_path):
    port = _copy(tiny_root, tmp_path / "port")
    serial = _copy(tiny_root, tmp_path / "serial")
    jax = _copy(tiny_root, tmp_path / "jax")
    args = ["--bbox_sampling_step", "10", "--hierarchical"]
    stats = preprocess.main(["--data_dir", port, "--workers", "2"] + args)
    assert preprocess.main(["--data_dir", serial, "--workers", "0"]
                           + args) == stats
    jax_preprocess.main(["--data_dir", jax, "--workers", "0"] + args)
    names = _caches(jax)
    assert names == _caches(port) == _caches(serial)
    hier = [n for n in names if n.endswith(f".hier.v{CACHE_VERSION}.pkl")]
    assert len(hier) == 3 and "stats.pkl" in names
    assert _load(os.path.join(port, "stats.pkl")) == stats == \
        _load(os.path.join(jax, "stats.pkl"))
    with open(os.path.join(port, "stats.pkl"), "rb") as f, \
            open(os.path.join(serial, "stats.pkl"), "rb") as g:
        assert f.read() == g.read()
    for n in hier:
        _assert_identical(_load(os.path.join(port, n)),
                          _load(os.path.join(jax, n)))
    # the caches the workers wrote are the ones the in-process load reads
    ds = SESYDDataset(port, "train", bbox_sampling_step=10)
    fresh = SESYDDataset(port, "train", bbox_sampling_step=10, cache=False)
    _assert_identical(ds.load(0)[0].to_dict(), fresh.load(0)[0].to_dict())


@pytest.mark.parametrize("super_family", [False, True])
def test_loader_workers_match_inline(tiny_root, tmp_path, super_family):
    root = _copy(tiny_root, tmp_path / "set")
    ds = SESYDDataset(root, "train", bbox_sampling_step=10)
    kw = dict(batch_size=1, prefetch=0, cache_files=False,
              super_family=super_family)
    pooled = PackedLoader(ds, preproc_workers=2, **kw)
    try:
        assert pooled._pool is not None  # the pad pass ran through it
        got = list(pooled)
    finally:
        pooled.close()
    assert pooled._pool is None
    want = list(PackedLoader(ds, preproc_workers=0, **kw))
    assert len(got) == len(want) == 2
    for b, w in zip(got, want):
        _assert_identical(b, w)


def test_infer_cli_workers_match_inline(tiny_root, tmp_path):
    cfg = Config(n_classes=SESYDDataset(tiny_root, "train").n_classes,
                 n_filters=8)
    ckpt = str(tmp_path / "model.pth")
    torch.save({"state_dict": seeded_model(cfg).state_dict()}, ckpt)
    recs = {}
    for w in ("2", "0"):  # each on a cold copy
        root = _copy(tiny_root, tmp_path / f"set{w}")
        out = str(tmp_path / f"det{w}.jsonl")
        infer.main(["--input_dir", root, "--pretrained_model", ckpt, "--out",
                    out, "--device", "cpu", "--n_filters", "8",
                    "--conf_th", "0", "--batch_size", "2",
                    "--preproc_workers", w])
        with open(out) as f:
            recs[w] = [json.loads(line) for line in f]
    assert len(recs["2"]) == 3 and recs["2"] == recs["0"]
    assert sum(len(r["detections"]) for r in recs["2"]) > 0
