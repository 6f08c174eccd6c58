"""The port's `data/deepgcn_utils.py` against yolat_tpu's.

Every helper gives the JAX package's result on the same seeded inputs,
exactly: the index helpers, `extract_node_feature` (add, mean, max; an
unknown reduce raises), the graph partition and its local edge lists, the
point-cloud augmentations at the same seeds, the OGB vocabulary and its
duck-typed featurisers. `PartNetDataset` reads an h5 archive that the test
writes (where h5py is installed) as JAX's does, raises FileNotFoundError
for a missing folder and ImportError naming h5py where h5py does not
import. The new modules of the port import without h5py, tensorboard and
jax (checked in a fresh process).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from yolat_tpu.data import deepgcn_utils as jd
from yolat_tpu_torch.data import deepgcn_utils as du

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_index_helpers():
    for a, b in (([1, 2, 3], [2, 3, 4]), ([5, 5, 1], [1]), ([], [3])):
        assert sorted(du.intersection(a, b)) == sorted(jd.intersection(a, b))
    for ids in ([3, 1, 2], [10, 4, 7, 0], [0]):
        assert du.process_indexes(ids) == jd.process_indexes(ids)
    _same(du.add_zeros(5), jd.add_zeros(5))
    _same(du.add_zeros(3, np.int32), jd.add_zeros(3, np.int32))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_extract_node_feature(dtype):
    rng = np.random.default_rng(0)
    src = rng.integers(0, 7, 40)
    src[src == 3] = 4  # a node with no edge
    attr = rng.normal(size=(40, 3)).astype(dtype)
    for reduce in ("add", "mean", "max"):
        _same(du.extract_node_feature(attr, src, 7, reduce),
              jd.extract_node_feature(attr, src, 7, reduce), reduce)
    with pytest.raises(ValueError, match="Unknown Aggregation"):
        du.extract_node_feature(attr, src, 7, "median")


def test_graph_partition():
    rng = np.random.default_rng(1)
    n = 60
    for seed in (2, 3):
        parts = du.random_partition_graph(n, cluster_number=5, rng=seed)
        _same(parts, jd.random_partition_graph(n, cluster_number=5,
                                               rng=seed))
    row, col = rng.integers(0, n, 200), rng.integers(0, n, 200)
    adj = sp.csr_matrix((np.ones(200), (row, col)), shape=(n, n))
    for batch_size in (1, 2):
        got = du.generate_sub_graphs(adj, parts, 5, batch_size)
        want = jd.generate_sub_graphs(adj, parts, 5, batch_size)
        assert len(got[0]) == len(want[0]) == 5 // batch_size
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            _same(a, b)
        for nodes, edges in zip(*got):
            assert edges.dtype == np.int64 and edges.shape[0] == 2
            if edges.size:
                assert edges.max() < len(nodes)


def test_pointcloud_augmentations():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    batch = rng.normal(size=(2, 16, 3)).astype(np.float32)
    for seed in (4, 5):
        _same(du.random_rotate(pts, rng=seed), jd.random_rotate(pts, rng=seed))
        _same(du.random_translate(batch, std=0.05, rng=seed),
              jd.random_translate(batch, std=0.05, rng=seed))
        _same(du.scale_translate_pointcloud(batch, rng=seed),
              jd.scale_translate_pointcloud(batch, rng=seed))
        for rot, tr in ((True, False), (False, True), (True, True)):
            _same(du.random_points_augmentation(pts, rot, tr, rng=seed,
                                                std=0.1),
                  jd.random_points_augmentation(pts, rot, tr, rng=seed,
                                                std=0.1))


class FakeAtom:
    def __init__(self, num=6, hyb="SP3", chiral="CHI_UNSPECIFIED"):
        self.num, self.hyb, self.chiral = num, hyb, chiral

    def GetAtomicNum(self): return self.num
    def GetChiralTag(self): return self.chiral
    def GetTotalDegree(self): return 4
    def GetFormalCharge(self): return -7  # off the list: 'misc'
    def GetTotalNumHs(self): return 1
    def GetNumRadicalElectrons(self): return 0
    def GetHybridization(self): return self.hyb
    def GetIsAromatic(self): return False
    def IsInRing(self): return True


class FakeBond:
    def GetBondType(self): return "QUADRUPLE"  # off the list: 'misc'
    def GetStereo(self): return "STEREOE"
    def GetIsConjugated(self): return True


def test_ogb_vocabulary():
    assert du.allowable_features == jd.allowable_features
    assert du.get_atom_feature_dims() == jd.get_atom_feature_dims()
    assert du.get_bond_feature_dims() == jd.get_bond_feature_dims()
    for atom in (FakeAtom(), FakeAtom(999, "SP2"),
                 FakeAtom(1, "S", "CHI_OTHER")):
        v = du.atom_to_feature_vector(atom)
        assert v == jd.atom_to_feature_vector(atom)
        assert (du.atom_feature_vector_to_dict(v)
                == jd.atom_feature_vector_to_dict(v))
    v = du.bond_to_feature_vector(FakeBond())
    assert v == jd.bond_to_feature_vector(FakeBond()) and v[0] == 4
    assert (du.bond_feature_vector_to_dict(v)
            == jd.bond_feature_vector_to_dict(v))
    assert du.safe_index([1, 2, "misc"], 7) == 2
    with pytest.raises(ValueError):
        du.atom_to_feature_vector(FakeAtom(chiral="CHI_NOPE"))


def test_partnet_reads_sem_seg_h5(tmp_path):
    h5py = pytest.importorskip("h5py")
    folder = tmp_path / "raw" / "sem_seg_h5" / "Bed-3"
    folder.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for i in range(2):
        with h5py.File(folder / f"train-{i:02d}.h5", "w") as f:
            f["data"] = rng.normal(size=(3, 64, 4)).astype(np.float64)
            f["label_seg"] = rng.integers(0, 5, (3, 64))
    with h5py.File(folder / "test-00.h5", "w") as f:
        f["data"] = rng.normal(size=(1, 64, 3)).astype(np.float32)
        f["label_seg"] = rng.integers(0, 5, (1, 64))
    for phase, n in (("train", 6), ("test", 1)):
        ds = du.PartNetDataset(str(tmp_path), obj_category="Bed", level=3,
                               phase=phase)
        jds = jd.PartNetDataset(str(tmp_path), obj_category="Bed", level=3,
                                phase=phase)
        assert len(ds) == len(jds) == n
        for i in range(n):
            for a, b in zip(ds[i], jds[i]):
                _same(a, b)
        assert ds[0][0].shape == (64, 3) and ds[0][0].dtype == np.float32
        assert ds[0][1].dtype == np.int32
    with pytest.raises(FileNotFoundError, match="application"):
        du.PartNetDataset(str(tmp_path), obj_category="Chair", level=3)


def test_partnet_refuses_without_h5py(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)  # import raises
    with pytest.raises(ImportError, match="h5py"):
        du.PartNetDataset(str(tmp_path))


NEW_MODULES = ("yolat_tpu_torch.utils.profiling", "yolat_tpu_torch.data.toy",
               "yolat_tpu_torch.data.legacy",
               "yolat_tpu_torch.data.deepgcn_utils",
               "yolat_tpu_torch.utils.experiment",
               "yolat_tpu_torch.eval.metrics",
               "yolat_tpu_torch.data.dataset")


def test_new_modules_import_without_optional_packages():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in NEW_MODULES)
            + "from yolat_tpu_torch.utils.experiment import ScalarWriter\n"
            "import tempfile\n"
            "d = tempfile.mkdtemp()\n"
            "ScalarWriter(d, use_tensorboard=False).close()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ("
            "'h5py', 'tensorboard', 'tensorflow', 'jax', 'jaxlib', 'flax', "
            "'yolat_tpu')]\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
