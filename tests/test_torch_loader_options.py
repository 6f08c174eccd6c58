"""The loader's training options against yolat_tpu's: mixup, buckets,
drop_last, a given pad, and their data-parallel rows.

Both host stages run their numpy paths (the JAX package's native helper is
switched off, the port runs under `_native.disabled()`, caches are off), so
every proposal set and every packed batch is bitwise equal. Each port
batch is held to row `rank` of the JAX loader's stacked batch on the keys
the port packs (the loaders pack no edge-window plan here: its layouts
differ and `tests/test_torch_packing.py` holds it), and each bucket's pads
to the JAX loader's after every step (mixup grows them).
"""

import numpy as np
import pytest

import yolat_tpu.geom._native as jax_native
from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.packing import PadSizes as JaxPadSizes
from yolat_tpu.geom.graph_build import build_svg_graph as jax_build_graph
from yolat_tpu.geom.proposals import mixup as jax_mixup
from yolat_tpu.geom.svg_io import SVGDocument as JaxDocument
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.packing import PadSizes
from yolat_tpu_torch.data.synthetic import write_diagram_dataset
from yolat_tpu_torch.geom import _native
from yolat_tpu_torch.geom.proposals import mixup


@pytest.fixture(scope="module")
def diagram_root(tmp_path_factory):
    """7 train diagrams of 4 and of 12 symbols, interleaved: at batch 2,
    two buckets of 4 and 3 files with their own pads, and a short window
    in each schedule."""
    root = tmp_path_factory.mktemp("torch_loader_options")
    write_diagram_dataset(str(root / "small"), n_train=4, n_test=1, seed=2,
                          n_symbols=4)
    write_diagram_dataset(str(root / "large"), n_train=3, n_test=0, seed=3,
                          n_symbols=12)
    small = [f"small/diagrams-syn/file_train_{i}.svg" for i in range(4)]
    large = [f"large/diagrams-syn/file_train_{i}.svg" for i in range(3)]
    train = [f for pair in zip(small, large + [None]) for f in pair if f]
    (root / "train_list.txt").write_text("\n".join(train) + "\n")
    (root / "test_list.txt").write_text(
        "small/diagrams-syn/file_test_0.svg\n")
    return str(root)


@pytest.fixture
def numpy_host(monkeypatch):
    """Both packages' host stages on their numpy paths."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)
    with _native.disabled():
        yield


def _datasets(root, do_mixup=False, seed=0):
    kw = dict(bbox_sampling_step=5, cache=False, do_mixup=do_mixup,
              seed=seed)
    return (SESYDDataset(root, "train", **kw),
            JaxDataset(root, "train", **kw))


def _pads(pad) -> tuple:
    return (pad.n_nodes, pad.n_edges, pad.n_proposals, pad.n_gt,
            pad.n_images)


def _assert_batch(got: dict, want: dict, row: int):
    for k in got:
        a, b = np.asarray(got[k]), np.asarray(want[k][row])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _assert_epochs(ports, jax_loader, epochs=2):
    """Every port loader (rank r of len(ports)) yields row r of each JAX
    batch, and the pads stand equal after every step; -> steps seen."""
    steps = 0
    for _ in range(epochs):
        its = [iter(p) for p in ports]
        for want in jax_loader:
            for r, it in enumerate(its):
                _assert_batch(next(it), want, r)
                assert ([_pads(p) for p in ports[r]._bucket_pads]
                        == [_pads(p) for p in jax_loader._bucket_pads])
            steps += 1
        for it in its:
            assert next(it, None) is None
    return steps


def _stripped_graph(path):
    """mixup's inputs: a diagram's graph with its control nodes stripped,
    as `generate_proposals` strips them."""
    g = jax_build_graph(JaxDocument.from_file(path), mode="diagram")
    keep = ~(np.asarray(g["attr"]["is_control"]).reshape(-1) > 0.5)
    o2n = np.cumsum(keep) - 1
    return ([[int(o2n[i]) for i in c] for c in g["cc"]],
            np.asarray(g["pos"], np.float64)[keep],
            o2n[np.asarray(g["edge"]["shape"], np.int64).reshape(-1, 2)],
            o2n[np.asarray(g["edge"]["super"], np.int64).reshape(-1, 2)],
            np.asarray(g["edge_attr"]["shape"], np.float64),
            np.asarray(g["edge_attr"]["super"], np.float64),
            np.asarray(g["attr"]["is_super"]).reshape(-1).astype(bool)[keep])


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_mixup_matches_jax(diagram_root, seed):
    path = SESYDDataset(diagram_root, "train").files[seed % 3]
    args = _stripped_graph(path)
    got = mixup(*args, np.random.default_rng(seed))
    want = jax_mixup(*args, np.random.default_rng(seed))
    assert len(got) == len(want) == 7
    cc, pos = got[0], got[1]
    assert cc == want[0] and len(cc) == 2 * len(args[0])
    # each new CC holds two source CCs side by side
    assert len(pos) == len(args[1]) + sum(len(c) for c in cc[len(args[0]):])
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_mixup_load_stream_matches_jax(diagram_root, numpy_host, tmp_path):
    ds, jds = _datasets(diagram_root, do_mixup=True, seed=4)
    seen = []
    for i in (0, 1, 0, 2, 1, 0):
        (pf, gt, wh), (jpf, jgt, jwh) = ds.load(i), jds.load(i)
        got, want = pf.to_dict(), jpf.to_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert wh == jwh
        if i == 0:
            seen.append(pf.pos)
    # each load draws anew
    assert not np.array_equal(seen[0][-8:], seen[1][-8:])
    # the graph cache stays, the proposals cache is bypassed
    write_diagram_dataset(str(tmp_path), n_train=1, n_test=0, seed=9)
    SESYDDataset(str(tmp_path), "train", bbox_sampling_step=5,
                 do_mixup=True).load(0)
    names = sorted(f.name for f in (tmp_path / "diagrams-syn").iterdir())
    assert any(".graph.v" in n for n in names)
    assert not any(".props" in n for n in names)
    assert "do_mixup" not in ds.ctor_kwargs()


@pytest.mark.parametrize("drop_last", [False, True])
def test_buckets_match_jax(diagram_root, numpy_host, drop_last):
    ds, jds = _datasets(diagram_root)
    port = PackedLoader(ds, batch_size=2, prefetch=0, edge_window=False,
                        shuffle=True, seed=5, buckets=2, drop_last=drop_last)
    jax_loader = JaxLoader(jds, batch_size=2, shuffle=True, seed=5,
                           prefetch=0, buckets=2, drop_last=drop_last)
    np.testing.assert_array_equal(port._bucket_of, jax_loader._bucket_of)
    assert sorted(np.bincount(port._bucket_of).tolist()) == [3, 4]
    pads = [_pads(p) for p in port._bucket_pads]
    assert pads == [_pads(p) for p in jax_loader._bucket_pads]
    assert pads[0] != pads[1] and _pads(port.pad) == _pads(jax_loader.pad)
    assert len(port) == len(jax_loader) == (3 if drop_last else 4)
    assert _assert_epochs([port], jax_loader) == 2 * len(port)
    # a batch never mixes buckets: its files are one bucket's
    for b, window in port.epoch_steps():
        assert (port._bucket_of[window] == b).all()


def test_given_pad_matches_jax(diagram_root, numpy_host):
    ds, jds = _datasets(diagram_root)
    pad = PadSizes(2048, 2048, 512, 32, 2)
    jpad = JaxPadSizes(2048, 2048, 16384, 512, 32, 2)  # its super edges
    port = PackedLoader(ds, batch_size=2, prefetch=0, edge_window=False,
                        dense=True, buckets=2, pad=pad)
    jax_loader = JaxLoader(jds, batch_size=2, shuffle=False, prefetch=0,
                           dense=True, buckets=2, pad=jpad)
    # one bucket, no manifest pass: the dense table falls back to 8 slots
    assert port.buckets == jax_loader.buckets == 1
    assert port.d_max == jax_loader.d_max == 8
    assert port.pad is pad and len(port) == len(jax_loader) == 4
    assert _assert_epochs([port], jax_loader, epochs=1) == 4
    got = next(iter(port))
    assert got["nbr_idx"].shape == (2048, 8) and got["pos"].shape == (2048, 2)


def test_mixup_loader_matches_jax(diagram_root, numpy_host):
    ds, jds = _datasets(diagram_root, do_mixup=True, seed=1)
    port = PackedLoader(ds, batch_size=2, prefetch=0, edge_window=False,
                        shuffle=True, seed=1, buckets=2, preproc_workers=2)
    jax_loader = JaxLoader(jds, batch_size=2, shuffle=True, seed=1,
                           prefetch=0, buckets=2, preproc_workers=2)
    assert not port.cache_files and port.preproc_workers == 0
    first = [_pads(p) for p in port._bucket_pads]
    assert first == [_pads(p) for p in jax_loader._bucket_pads]
    assert _assert_epochs([port], jax_loader) == 8
    # the pads only grow, and the growths are counted
    grown = [_pads(p) for p in port._bucket_pads]
    assert all(g >= f for a, b in zip(grown, first) for g, f in zip(a, b))
    assert port.pad_growths >= sum(a != b for a, b in zip(grown, first)) >= 1


@pytest.mark.parametrize("case", ["buckets", "mixup"])
def test_dp_ranks_match_jax(diagram_root, numpy_host, case):
    mix = case == "mixup"
    _, jds = _datasets(diagram_root, do_mixup=mix, seed=1)
    jax_loader = JaxLoader(jds, batch_size=2, n_devices=2, shuffle=True,
                           seed=1, prefetch=0, buckets=2)
    # one dataset per rank: under mixup each rank draws the whole stream
    ports = [PackedLoader(_datasets(diagram_root, do_mixup=mix, seed=1)[0],
                          batch_size=2, n_devices=2, rank=r, prefetch=0,
                          edge_window=False, shuffle=True, seed=1, buckets=2)
             for r in range(2)]
    for p in ports:
        np.testing.assert_array_equal(p._bucket_of, jax_loader._bucket_of)
        assert len(p) == len(jax_loader) == 2
    assert _assert_epochs(ports, jax_loader, epochs=1) == 2
    if mix:
        assert ports[0].pad_growths == ports[1].pad_growths >= 1


def test_mixup_refuses_several_nodes(diagram_root):
    ds, jds = _datasets(diagram_root, do_mixup=True)
    with pytest.raises(NotImplementedError, match="multi-host"):
        JaxLoader(jds, batch_size=2, n_hosts=2, host_id=0)
    with pytest.raises(NotImplementedError, match="multi-node"):
        PackedLoader(ds, batch_size=2, n_hosts=2, host_id=0)
    # one node takes it
    assert PackedLoader(_datasets(diagram_root, do_mixup=True)[0],
                        batch_size=2, prefetch=0).mixup
