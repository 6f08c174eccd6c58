"""The port's remaining CLIs against yolat_tpu's, on the CPU:
`cli.export_ckpt`, `cli.draw_graph` and `utils/viz`.

Export: yolat_tpu's canonical variables at width 16 (randomised BatchNorm
statistics) cross into a port model (`load_jax_variables`), which is saved
as a port checkpoint dir the way the trainer saves it (`train_state`,
`CheckpointManager.save`). The port's `cli.export_ckpt` writes a `.pth`
whose state dict equals, key for key and bit for bit, the one yolat_tpu's
`save_reference_checkpoint` writes for the same variables (no key
differs, none is missing or added), and the same epoch. `cli.infer` on
the exported `.pth` writes the records it
writes on a `.pth` of the model that `cli.test` restores from the
checkpoint dir.

Drawing: `cli.draw_graph`'s printed lines (each file's graph statistics)
equal yolat_tpu's, and its PNGs, `draw_graph` with the super edges
subsampled, and each `utils/viz` function's output on seeded inputs decode
(`matplotlib.image.imread`) to yolat_tpu's pixels exactly.
`get_points_colors_from_obj` returns yolat_tpu's arrays on a written
`.obj`. Each package draws from its own copy of the synthetic split.
"""

import contextlib
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.cli import draw_graph as jax_draw_graph
from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.packing import finalize_batch as jax_finalize
from yolat_tpu.nn.model import SparseCADGCN as JaxModel
from yolat_tpu.train.import_reference import \
    save_reference_checkpoint as jax_save_reference
from yolat_tpu.utils import viz as jax_viz
from yolat_tpu_torch.cli import draw_graph, export_ckpt, infer
from yolat_tpu_torch.cli import test as test_cli
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.nn.model import SparseCADGCN, load_jax_variables
from yolat_tpu_torch.train.checkpoint import (CheckpointManager,
                                              save_reference_checkpoint,
                                              train_state)
from yolat_tpu_torch.train.optim import make_optimizer, make_scheduler
from yolat_tpu_torch.utils import viz

WIDTH = 16


def _copy_split(src: str, dst: str) -> str:
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("*.pkl"))
    return dst


def _lines(main, argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def _jax_variables(root: str) -> dict:
    jds = JaxDataset(root, "test", bbox_sampling_step=10)
    jb = {k: v[0] for k, v in
          next(iter(JaxLoader(jds, batch_size=1, shuffle=False))).items()}
    jm = JaxModel(n_classes=jds.n_classes, channels=WIDTH, sorted_edges=True)
    variables = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(1)},
        jax_finalize(jax.tree.map(jnp.asarray, jb)), train=True))
    rng = np.random.default_rng(1)

    def bump(path, v):
        if path[-1].key == "mean":
            return rng.normal(size=v.shape).astype(np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(bump, variables)


def test_export_matches_jax_reference_pth(synthetic_root, tmp_path):
    variables = _jax_variables(synthetic_root)
    want_path = str(tmp_path / "jax.pth")
    jax_save_reference(variables, want_path, epoch=3)

    # a port checkpoint dir, as the trainer writes it
    cfg = Config(n_classes=17, n_filters=WIDTH)
    model = load_jax_variables(SparseCADGCN(17, channels=WIDTH), variables)
    opt = make_optimizer("adam", model.parameters(), 1e-3, 0.0)
    sched = make_scheduler(opt, 1e-3, cfg.lr_adjust_freq, cfg.lr_decay_rate, 1)
    ckpt = CheckpointManager(str(tmp_path / "exp" / "checkpoint"))
    ckpt.save(train_state(model, opt, sched, 12), 3, 0.25, is_best=True)
    ckpt.save(train_state(model, opt, sched, 16), 4, 0.25, is_best=False)

    out = str(tmp_path / "exported.pth")
    lines = _lines(export_ckpt.main, [
        "--pretrained_model", ckpt.ckpt_dir, "--n_filters", str(WIDTH),
        "--out", out])
    assert lines == [f"exported {ckpt.ckpt_dir} (tag best, epoch 3, best "
                     f"0.2500) -> {out}"]
    got = torch.load(out, weights_only=True)
    want = torch.load(want_path, weights_only=True)
    assert got["epoch"] == want["epoch"] == 3
    gsd, wsd = got["state_dict"], want["state_dict"]
    assert list(gsd) == list(wsd) and len(wsd) > 60  # the same keys, in order
    for k, w in wsd.items():
        assert gsd[k].dtype == w.dtype and torch.equal(gsd[k], w), k

    # another tag; a missing dir is refused
    lines = _lines(export_ckpt.main, [
        "--pretrained_model", ckpt.ckpt_dir, "--n_filters", str(WIDTH),
        "--tag", "4", "--out", out])
    assert "(tag 4, epoch 4, best 0.2500)" in lines[0]
    with pytest.raises(FileNotFoundError, match="checkpoint directory"):
        export_ckpt.main(["--pretrained_model", str(tmp_path / "none"),
                          "--out", out])

    # the exported file serves as the checkpoint dir does
    restored, epoch, _ = test_cli.load_checkpoint(
        cfg.replace(pretrained_model=ckpt.ckpt_dir), "cpu")
    assert epoch == 3  # tag 'best': epoch 4 did not improve
    direct = str(tmp_path / "restored.pth")
    save_reference_checkpoint(restored, direct)
    records = []
    for pth in (out, direct):
        jsonl = str(tmp_path / f"{os.path.basename(pth)}.jsonl")
        infer.main(["--data_dir", synthetic_root, "--phase", "test",
                    "--pretrained_model", pth, "--n_filters", str(WIDTH),
                    "--out", jsonl, "--device", "cpu", "--conf_th", "0.0",
                    "--serve_mode", "fast"])
        with open(jsonl) as f:
            records.append([json.loads(line) for line in f])
    assert len(records[0]) == 2 and any(r["detections"] for r in records[0])
    assert records[0] == records[1]


def test_draw_graph_matches_jax(synthetic_root, tmp_path):
    image = pytest.importorskip("matplotlib.image")
    jroot = _copy_split(synthetic_root, str(tmp_path / "jax_data"))
    proot = _copy_split(synthetic_root, str(tmp_path / "port_data"))
    jout, pout = str(tmp_path / "jax_png"), str(tmp_path / "port_png")
    jlines = _lines(jax_draw_graph.main, ["--data_dir", jroot, "--out_dir",
                                          jout, "--max_images", "2"])
    plines = _lines(draw_graph.main, ["--data_dir", proot, "--out_dir", pout,
                                      "--max_images", "2"])
    assert len(plines) == 2 and "nodes=" in plines[0]
    assert plines == [ln.replace(jroot, proot) for ln in jlines]
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(pout)) and len(names) == 2
    for name in names:
        np.testing.assert_array_equal(image.imread(os.path.join(pout, name)),
                                      image.imread(os.path.join(jout, name)))

    # the super edges subsampled past max_super (default_rng(0))
    ds = SESYDDataset(proot, "train")
    g = ds._graph(ds.files[0])
    assert len(g["edge"]["super"]) > 50
    args = (g, g["img_width"], g["img_height"])
    draw_graph.draw_graph(*args, str(tmp_path / "p.png"), max_super=50)
    jax_draw_graph.draw_graph(*args, str(tmp_path / "j.png"), max_super=50)
    np.testing.assert_array_equal(image.imread(str(tmp_path / "p.png")),
                                  image.imread(str(tmp_path / "j.png")))


def _write_obj(path: str, rng, n: int) -> None:
    with open(path, "w") as f:
        f.write("# coloured point cloud\n")
        for p, c in zip(rng.normal(size=(n, 3)), rng.uniform(size=(n, 3))):
            f.write("v " + " ".join(f"{x:.6f}" for x in (*p, *c)) + "\n")
        f.write("v 1 2 3\nf 1 2 3\n")  # no colour: skipped


def _obj_folders(tmp_path) -> list:
    """Two prediction folders with pred.obj, the first with gt.obj."""
    rng = np.random.default_rng(2)
    for sub in ("a", "b"):
        os.makedirs(tmp_path / sub)
        _write_obj(str(tmp_path / sub / "pred.obj"), rng, 20)
    _write_obj(str(tmp_path / "a" / "gt.obj"), rng, 20)
    return [str(tmp_path / "a"), str(tmp_path / "b")]


@pytest.mark.parametrize("limit", [1, 0.5])
def test_get_points_colors_from_obj_matches_jax(tmp_path, limit):
    path = os.path.join(_obj_folders(tmp_path)[0], "gt.obj")
    got = viz.get_points_colors_from_obj(path, limit)
    want = jax_viz.get_points_colors_from_obj(path, limit)
    assert got[0].shape == ((20 if limit == 1 else 10), 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


_RNG = np.random.default_rng(0)
PTS2, PTS3 = _RNG.normal(size=(40, 2)), _RNG.normal(size=(30, 3))
EDGES = _RNG.integers(0, 40, (25, 2))
RGB = _RNG.uniform(size=(30, 3))
VIZ_CALLS = {
    "points_2d": lambda m, p, _: m.plot_points(PTS2, np.arange(40) % 5, p),
    "points_3d": lambda m, p, _: m.plot_points(PTS3, None, p, size=9.0),
    "graph": lambda m, p, _: m.plot_graph(PTS2, EDGES, np.arange(40) % 3, p),
    "clouds_horizontal": lambda m, p, _: m.show_pointclouds(
        [PTS2, PTS3], [np.arange(40) % 4, RGB], text=("x", "y"), title="t",
        png_path=p),
    "clouds_vertical": lambda m, p, _: m.show_pointclouds(
        [PTS3], [RGB], title="v", png_path=p, orientation="vertical"),
    "part_seg": lambda m, p, folders: m.visualize_part_seg(
        "pred.obj", "gt.obj", folders, limit=1, text=("a", "b", "gt"),
        png_path=p),
}


@pytest.mark.parametrize("name", list(VIZ_CALLS))
def test_viz_matches_jax(tmp_path, name):
    image = pytest.importorskip("matplotlib.image")
    folders = _obj_folders(tmp_path)
    paths = [str(tmp_path / f"{side}.png") for side in ("port", "jax")]
    assert VIZ_CALLS[name](viz, paths[0], folders) == paths[0]
    assert VIZ_CALLS[name](jax_viz, paths[1], folders) == paths[1]
    got, want = (image.imread(p) for p in paths)
    assert (want < 1).any()
    np.testing.assert_array_equal(got, want)
