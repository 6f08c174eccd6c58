"""DeepGCN auxiliary utilities (reference utils/data_util.py).

Counterpart of `yolat_tpu/data/deepgcn_utils.py:1-290`: the same numpy
and scipy code, kept here so that the port imports nothing of the JAX
package. h5py is imported by `PartNetDataset` alone, when it is built.

The reference ships these as leftovers of the DeepGCN codebase YOLaT was
built on: OGB molecular feature vocab (utils/data_util.py:248-390),
random graph partitioning (:43-61), point-cloud augmentations (:63-96),
the PartNet dataset (:98-235), and small index helpers (:14-29). None are
used by the CAD detection path; they are provided for inventory
completeness as numpy-idiomatic equivalents:

- graph partition returns numpy node sets + local edge lists from a
  scipy CSR adjacency (no torch_sparse / torch_geometric),
- point-cloud augs are pure-numpy [N, C] (the reference's [B, C, N, 1]
  torch layout is a DenseDeepGCN artifact),
- PartNetDataset reads the same `sem_seg_h5` archives with h5py directly
  and yields (points [N, 3] f32, labels [N] i32) pairs,
- the OGB vocab is the public data contract (features.py of
  snap-stanford/ogb, reproduced at utils/data_util.py:248-282) and the
  atom/bond featurizers duck-type on rdkit-like objects so no rdkit
  import is needed.
"""

from __future__ import annotations

import glob as _glob
import os

import numpy as np

# ---------------------------------------------------------------------------
# small helpers (utils/data_util.py:14-29)


def intersection(lst1, lst2):
    return list(set(lst1) & set(lst2))


def process_indexes(idx_list):
    """Positions of the sorted ids within the original list."""
    idx_dict = {idx: i for i, idx in enumerate(idx_list)}
    return [idx_dict[i] for i in sorted(idx_dict.keys())]


def add_zeros(n_nodes: int, dtype=np.int64) -> np.ndarray:
    """The reference's `add_zeros` transform (zero int node features for
    featureless OGB graphs), returned as the array itself."""
    return np.zeros(n_nodes, dtype=dtype)


def extract_node_feature(edge_attr: np.ndarray, edge_src: np.ndarray,
                         n_nodes: int, reduce: str = "add") -> np.ndarray:
    """Aggregate edge attributes onto source nodes (utils/data_util.py:31-40
    routes this through torch_scatter; here: ops/segment semantics)."""
    edge_attr = np.asarray(edge_attr)
    out = np.zeros((n_nodes, edge_attr.shape[1]), edge_attr.dtype)
    if reduce in ("add", "mean"):
        np.add.at(out, edge_src, edge_attr)
        if reduce == "mean":
            cnt = np.bincount(edge_src, minlength=n_nodes).astype(
                edge_attr.dtype)
            out /= np.maximum(cnt, 1)[:, None]
    elif reduce == "max":
        np.maximum.at(out, edge_src, edge_attr)
    else:
        raise ValueError("Unknown Aggregation Type")
    return out


# ---------------------------------------------------------------------------
# random graph partition (utils/data_util.py:43-61)


def random_partition_graph(num_nodes: int, cluster_number: int = 10,
                           rng=None) -> np.ndarray:
    rng = np.random.default_rng(rng)
    return rng.integers(cluster_number, size=num_nodes)


def generate_sub_graphs(adj, parts: np.ndarray, cluster_number: int = 10,
                        batch_size: int = 1):
    """Split a scipy CSR adjacency into per-cluster node sets + LOCAL edge
    lists ([2, E] int64, matching the reference's from_scipy output)."""
    num_batches = cluster_number // batch_size
    sg_nodes, sg_edges = [], []
    for cluster in range(num_batches):
        nodes = np.where(parts == cluster)[0]
        sub = adj[nodes, :][:, nodes].tocoo()
        sg_nodes.append(nodes)
        sg_edges.append(np.stack([sub.row.astype(np.int64),
                                  sub.col.astype(np.int64)]))
    return sg_nodes, sg_edges


# ---------------------------------------------------------------------------
# point-cloud augmentations (utils/data_util.py:63-96), numpy [N, C] / [B, N, C]


def random_rotate(points: np.ndarray, rng=None) -> np.ndarray:
    rng = np.random.default_rng(rng)
    theta = rng.uniform(0, np.pi * 2)
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]], points.dtype)
    out = points.copy()
    out[..., 0:2] = points[..., 0:2] @ rot
    return out


def random_translate(points: np.ndarray, mean=0.0, std=0.02,
                     rng=None) -> np.ndarray:
    rng = np.random.default_rng(rng)
    return points + (rng.standard_normal(points.shape).astype(points.dtype)
                     * std + mean)


def random_points_augmentation(points, rotate=False, translate=False,
                               rng=None, **kwargs):
    if rotate:
        points = random_rotate(points, rng=rng)
    if translate:
        points = random_translate(points, rng=rng, **kwargs)
    return points


def scale_translate_pointcloud(pointcloud: np.ndarray,
                               shift=(-0.2, 0.2), scale=(2.0 / 3, 3.0 / 2),
                               rng=None) -> np.ndarray:
    """Per-batch-and-channel random scale + shift ([B, N, C])."""
    rng = np.random.default_rng(rng)
    B, _, C = pointcloud.shape
    s = scale[0] + rng.random((B, 1, C)) * (scale[1] - scale[0])
    t = shift[0] + rng.random((B, 1, C)) * (shift[1] - shift[0])
    return (pointcloud * s + t).astype(pointcloud.dtype)


# ---------------------------------------------------------------------------
# PartNet (utils/data_util.py:98-235): sem_seg_h5 archives -> numpy pairs


class PartNetDataset:
    """PartNet semantic-segmentation split reader.

    Reads the released `sem_seg_h5` archives (h5 files with `data`
    [B, N, 3] and `label_seg` [B, N]) for one object-category/level,
    mirroring the reference's directory convention
    `<root>/raw/sem_seg_h5/<Category>-<level>/<phase>-*.h5`. The data can
    only be obtained by application (the reference raises the same way,
    utils/data_util.py:162-167); yields (points f32 [N, 3], labels i32
    [N]) tuples.
    """

    def __init__(self, root: str, dataset: str = "sem_seg_h5",
                 obj_category: str = "Bed", level: int = 3,
                 phase: str = "train"):
        try:
            import h5py
        except ImportError as e:
            raise ImportError("PartNetDataset requires h5py") from e
        obj = f"{obj_category}-{level}"
        folder = os.path.join(root, "raw", dataset, obj)
        if not os.path.isdir(folder):
            raise FileNotFoundError(
                "PartNet can only be downloaded via application "
                "(https://cs.stanford.edu/~kaichun/partnet/); expected "
                f"h5 archives under {folder}")
        self.points, self.labels = [], []
        for path in sorted(_glob.glob(os.path.join(folder,
                                                   f"{phase}-*.h5"))):
            with h5py.File(path, "r") as f:
                pts = np.asarray(f["data"], np.float32)
                seg = np.asarray(f["label_seg"], np.int32)
            for i in range(len(pts)):
                self.points.append(pts[i, :, :3])
                self.labels.append(seg[i])

    def __len__(self):
        return len(self.points)

    def __getitem__(self, i):
        return self.points[i], self.labels[i]


# ---------------------------------------------------------------------------
# OGB molecular feature vocab — the public data contract
# (snap-stanford/ogb features.py, reproduced at utils/data_util.py:248-282)

allowable_features = {
    "possible_atomic_num_list": list(range(1, 119)) + ["misc"],
    "possible_chirality_list": [
        "CHI_UNSPECIFIED", "CHI_TETRAHEDRAL_CW",
        "CHI_TETRAHEDRAL_CCW", "CHI_OTHER",
    ],
    "possible_degree_list": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, "misc"],
    "possible_formal_charge_list": [-5, -4, -3, -2, -1, 0, 1, 2, 3, 4, 5,
                                    "misc"],
    "possible_numH_list": [0, 1, 2, 3, 4, 5, 6, 7, 8, "misc"],
    "possible_number_radical_e_list": [0, 1, 2, 3, 4, "misc"],
    "possible_hybridization_list": ["SP", "SP2", "SP3", "SP3D", "SP3D2",
                                    "misc"],
    "possible_is_aromatic_list": [False, True],
    "possible_is_in_ring_list": [False, True],
    "possible_bond_type_list": ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC",
                                "misc"],
    "possible_bond_stereo_list": [
        "STEREONONE", "STEREOZ", "STEREOE", "STEREOCIS", "STEREOTRANS",
        "STEREOANY",
    ],
    "possible_is_conjugated_list": [False, True],
}


def safe_index(lst, e):
    """Index of e in lst, or the last index ('misc') if absent."""
    try:
        return lst.index(e)
    except ValueError:
        return len(lst) - 1


def atom_to_feature_vector(atom):
    """rdkit-like atom object -> 9 vocab indices (duck-typed: any object
    with the rdkit Atom getters works, so rdkit itself is optional)."""
    f = allowable_features
    return [
        safe_index(f["possible_atomic_num_list"], atom.GetAtomicNum()),
        f["possible_chirality_list"].index(str(atom.GetChiralTag())),
        safe_index(f["possible_degree_list"], atom.GetTotalDegree()),
        safe_index(f["possible_formal_charge_list"], atom.GetFormalCharge()),
        safe_index(f["possible_numH_list"], atom.GetTotalNumHs()),
        safe_index(f["possible_number_radical_e_list"],
                   atom.GetNumRadicalElectrons()),
        safe_index(f["possible_hybridization_list"],
                   str(atom.GetHybridization())),
        f["possible_is_aromatic_list"].index(atom.GetIsAromatic()),
        f["possible_is_in_ring_list"].index(atom.IsInRing()),
    ]


def bond_to_feature_vector(bond):
    f = allowable_features
    return [
        safe_index(f["possible_bond_type_list"], str(bond.GetBondType())),
        f["possible_bond_stereo_list"].index(str(bond.GetStereo())),
        f["possible_is_conjugated_list"].index(bond.GetIsConjugated()),
    ]


def get_atom_feature_dims():
    f = allowable_features
    return list(map(len, [
        f["possible_atomic_num_list"], f["possible_chirality_list"],
        f["possible_degree_list"], f["possible_formal_charge_list"],
        f["possible_numH_list"], f["possible_number_radical_e_list"],
        f["possible_hybridization_list"], f["possible_is_aromatic_list"],
        f["possible_is_in_ring_list"],
    ]))


def get_bond_feature_dims():
    f = allowable_features
    return list(map(len, [
        f["possible_bond_type_list"], f["possible_bond_stereo_list"],
        f["possible_is_conjugated_list"],
    ]))


def atom_feature_vector_to_dict(atom_feature):
    f = allowable_features
    keys = [
        ("atomic_num", "possible_atomic_num_list"),
        ("chirality", "possible_chirality_list"),
        ("degree", "possible_degree_list"),
        ("formal_charge", "possible_formal_charge_list"),
        ("num_h", "possible_numH_list"),
        ("num_rad_e", "possible_number_radical_e_list"),
        ("hybridization", "possible_hybridization_list"),
        ("is_aromatic", "possible_is_aromatic_list"),
        ("is_in_ring", "possible_is_in_ring_list"),
    ]
    return {name: f[vocab][idx]
            for (name, vocab), idx in zip(keys, atom_feature)}


def bond_feature_vector_to_dict(bond_feature):
    f = allowable_features
    keys = [
        ("bond_type", "possible_bond_type_list"),
        ("bond_stereo", "possible_bond_stereo_list"),
        ("is_conjugated", "possible_is_conjugated_list"),
    ]
    return {name: f[vocab][idx]
            for (name, vocab), idx in zip(keys, bond_feature)}
