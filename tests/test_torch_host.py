"""The port's host stage (yolat_tpu_torch.data.synthetic, .geom,
.data.dataset) against yolat_tpu's, which the port carries so that it
runs without the JAX package.

The synthetic writer is a copy: the same documents byte for byte. The
graph build and proposal generator are the numpy paths of the JAX
package's modules; the JAX package runs its native helper where it has
one, which computes the same values in another summation order —
integers and index structure equal, floats to the tolerance its own
native-vs-numpy tests hold (rtol 1e-9, atol 1e-8).
"""

import filecmp
import os

import numpy as np
import pytest

from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.synthetic import write_dataset as jax_write_dataset
from yolat_tpu.geom.graph_build import build_svg_graph as jax_build_graph
from yolat_tpu.geom.svg_io import SVGDocument as JaxDocument
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.synthetic import write_dataset
from yolat_tpu_torch.geom.graph_build import build_svg_graph
from yolat_tpu_torch.geom.svg_io import SVGDocument


def _assert_tree_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_tree_close(a, b, f"{path}[{i}]")
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-8,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)


def test_synthetic_writer_matches_jax(tmp_path):
    kw = dict(n_train=2, n_test=1, seed=3, width=900.0, height=700.0,
              n_rooms=3, symbols_per_room=(1, 3))
    write_dataset(str(tmp_path / "port"), **kw)
    jax_write_dataset(str(tmp_path / "jax"), **kw)
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(tmp_path / "jax")
    assert names == files(tmp_path / "port") and len(names) > 3
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "port", tmp_path / "jax",
                                           names, shallow=False)
    assert not mismatch and not errors


def test_graph_build_matches_jax(synthetic_root):
    ds = SESYDDataset(synthetic_root, "train", cache=False)
    for path in ds.files:
        _assert_tree_close(build_svg_graph(SVGDocument.from_file(path)),
                           jax_build_graph(JaxDocument.from_file(path)))


@pytest.mark.parametrize("partition", ["train", "test"])
def test_dataset_load_matches_jax(synthetic_root, partition):
    ds = SESYDDataset(synthetic_root, partition, bbox_sampling_step=10,
                      cache=False)
    jds = JaxDataset(synthetic_root, partition, bbox_sampling_step=10,
                     cache=False)
    assert ds.files == jds.files and ds.class_dict == jds.class_dict
    for i in range(len(ds)):
        (pf, gt, wh), (jpf, jgt, jwh) = ds.load(i), jds.load(i)
        assert pf.n_proposals == jpf.n_proposals > 0
        _assert_tree_close(pf.to_dict(), jpf.to_dict())
        _assert_tree_close(list(gt), list(jgt))
        assert wh == jwh


def test_dataset_cache_round_trip(tmp_path):
    write_dataset(str(tmp_path), n_train=1, n_test=0, seed=5, width=700.0,
                  height=500.0, n_rooms=2, symbols_per_room=(1, 2))
    fresh = SESYDDataset(str(tmp_path), "train", cache=False).load(0)
    ds = SESYDDataset(str(tmp_path), "train")
    first = ds.load(0)  # writes the graph and proposal caches
    assert any(f.endswith(".pkl") for _, _, fs in os.walk(tmp_path)
               for f in fs)
    again = ds.load(0)  # reads them
    for got in (first, again):
        _assert_tree_close(got[0].to_dict(), fresh[0].to_dict())
