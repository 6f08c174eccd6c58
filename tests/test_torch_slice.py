"""The whole serving slice on the CPU: the port's predict against
yolat_tpu's make_predict_fn(fast=True) on the same packed synthetic batch
and weights, the port's inference CLI, and the window / dense slice: the
train CLI in the window layout, its checkpoint through the test CLI in the
other layouts, and the test CLI's AP table against yolat_tpu's evaluation
with classfix NMS on the dense route.

The weights start in the port (seeded torch init, randomised BN
statistics) and reach JAX through import_reference.convert_state_dict —
the reverse of the direction tests/test_torch_model.py checks. Each
package packs the batch with its own host stage.
Tolerance: the same detections (count, order, classes); boxes are the
same proposal geometry (rtol 1e-6); scores carry f32 forward noise
(rtol/atol 1e-5).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.eval.fast_forward import fold_params as jax_fold
from yolat_tpu.eval.predict import make_predict_fn
from yolat_tpu.eval.runner import evaluate as jax_evaluate
from yolat_tpu.train.config import Config as JaxConfig
from yolat_tpu.train.import_reference import convert_state_dict
from yolat_tpu_torch.cli import infer
from yolat_tpu_torch.cli import test as test_cli
from yolat_tpu_torch.cli import train as train_cli
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.eval.fast_forward import fold_params
from yolat_tpu_torch.eval.predict import img_slot_cap, make_predict_core
from yolat_tpu_torch.nn.model import seeded_model
from yolat_tpu_torch.train.checkpoint import save_reference_checkpoint

WIDTH = 16


def _port_model(n_classes, seed=0):
    cfg = Config(n_classes=n_classes, n_filters=WIDTH)
    return cfg, seeded_model(cfg, seed)


@pytest.mark.parametrize("partition", ["train", "test"])
def test_predict_matches_jax(synthetic_root, partition):
    ds = SESYDDataset(synthetic_root, partition, bbox_sampling_step=10,
                      cache=False)
    jds = JaxDataset(synthetic_root, partition, bbox_sampling_step=10)
    cfg, model = _port_model(ds.n_classes)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = convert_state_dict(sd)

    pb = next(iter(PackedLoader(ds, batch_size=4)))
    jb = {k: v[0] for k, v in
          next(iter(JaxLoader(jds, batch_size=4, shuffle=False))).items()}
    cap = img_slot_cap(pb)
    jcfg = JaxConfig(n_classes=ds.n_classes, n_filters=WIDTH)
    want = make_predict_fn(jcfg, fast=True, folded=jax_fold(variables),
                           img_slots=cap, detections_only=True)(
        jax.tree.map(jnp.asarray, variables), jb)
    got = make_predict_core(cfg, folded=fold_params(model), img_slots=cap,
                            detections_only=True)(to_device(pb, "cpu"))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert got["valid"].sum() > 10
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                               atol=1e-5)


def test_module_route_matches_fast_route(synthetic_root):
    ds = SESYDDataset(synthetic_root, "test", bbox_sampling_step=10)
    cfg, model = _port_model(ds.n_classes, seed=1)
    pb = to_device(next(iter(PackedLoader(ds, batch_size=4))), "cpu")
    fast = make_predict_core(cfg, folded=fold_params(model))(pb)
    slow = make_predict_core(cfg, model=model)(pb)
    torch.testing.assert_close(fast["pred_label"], slow["pred_label"])
    torch.testing.assert_close(fast["scores"], slow["scores"], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(fast["valid"], slow["valid"])


def test_cli_on_cpu_writes_one_record_per_svg(synthetic_root, tmp_path,
                                              capsys):
    cfg, model = _port_model(17)
    ckpt = tmp_path / "model.pth"
    torch.save({"state_dict": model.state_dict(), "epoch": 0}, ckpt)
    out = tmp_path / "det.jsonl"
    infer.main(["--input_dir", synthetic_root, "--pretrained_model", str(ckpt),
                "--out", str(out), "--serve_mode", "fast", "--device", "cpu",
                "--n_filters", str(WIDTH), "--conf_th", "0.0"])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    svgs = glob.glob(os.path.join(synthetic_root, "**", "*.svg"),
                     recursive=True)
    assert len(recs) == len(svgs)
    assert all("error" not in r and r["width"] > 0 for r in recs)
    assert sum(len(r["detections"]) for r in recs) > 0
    d = recs[0]["detections"][0]
    assert set(d) == {"box", "score", "class"} and len(d["box"]) == 4
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert f"{len(svgs)} SVGs" in line
    # CPU tensors take the plain versions: no kernel launch
    assert ("edge_window_message_sum=0, folded_mlp_block_max2=0" in line)


def test_cli_error_records_and_cuda_requirement(tmp_path):
    cfg, model = _port_model(17)
    ckpt = tmp_path / "model.pth"
    torch.save({"state_dict": model.state_dict()}, ckpt)
    svg_dir = tmp_path / "svgs"
    svg_dir.mkdir()
    (svg_dir / "broken.svg").write_text("<svg")
    out = tmp_path / "det.jsonl"
    infer.main(["--input_dir", str(svg_dir), "--pretrained_model", str(ckpt),
                "--out", str(out), "--device", "cpu", "--n_filters",
                str(WIDTH)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 1 and "error" in recs[0] and recs[0]["detections"] == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            infer.main(["--input_dir", str(svg_dir), "--pretrained_model",
                        str(ckpt), "--out", str(out)])


@pytest.fixture(scope="module")
def window_run(synthetic_root, tmp_path_factory):
    """Two steps of the train CLI in the window layout on the CPU."""
    root = tmp_path_factory.mktemp("window_run")
    res = train_cli.main(["--data_dir", synthetic_root, "--device", "cpu",
                          "--n_filters", "8", "--batch_size", "2",
                          "--max_steps", "2", "--train_layout", "window",
                          "--root_dir", str(root), "--print_freq", "1"])
    return res


def test_train_cli_window_layout_on_cpu(window_run, synthetic_root, tmp_path,
                                        capsys):
    res = window_run
    assert res["steps"] == 2 and all(np.isfinite(res["losses"]))
    assert res["eval_batches"] == 1
    # CPU tensors take the plain versions: no kernel launch
    assert not any(res["launches"].values())
    assert os.path.exists(os.path.join(res["exp_dir"], "checkpoint",
                                       "ckpt_best.pt"))
    train_cli.main(["--data_dir", synthetic_root, "--device", "cpu",
                    "--n_filters", "8", "--batch_size", "2", "--max_steps",
                    "1", "--train_layout", "dense", "--drop_edge", "0.2",
                    "--root_dir", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert ("ew_pair_features=0, ew_pair_features_bwd=0, "
            "ew_window_segment_sum=0, ew_window_segment_sum_bwd=0") in line
    # edge dropout would leave the window plan stale: refused at the start
    with pytest.raises(ValueError, match="drop_edge"):
        train_cli.main(["--data_dir", synthetic_root, "--device", "cpu",
                        "--train_layout", "window", "--drop_edge", "0.1",
                        "--root_dir", str(tmp_path)])


@pytest.mark.parametrize("mode,dense,nms", [
    ("fast", "true", "classfix"), ("fast_bf16", "false", "fixpoint"),
    ("flax", "true", "loop")])
def test_test_cli_serves_the_window_checkpoint(window_run, synthetic_root,
                                               capsys, mode, dense, nms):
    ck = os.path.join(window_run["exp_dir"], "checkpoint")
    res = test_cli.main(["--data_dir", synthetic_root, "--phase", "test",
                         "--device", "cpu", "--n_filters", "8",
                         "--batch_size", "2", "--pretrained_model", ck,
                         "--serve_mode", mode, "--dense_layout", dense,
                         "--nms_algorithm", nms])
    out = capsys.readouterr().out
    assert "MAP@0.50" in out and "MAP@ALL" in out and "armchair" in out
    assert "checkpoint epoch=1 best=" in out
    line = out.strip().splitlines()[-1]
    assert ("edge_window_message_sum=0, folded_mlp_block_max2=0, "
            "fused_dense_message=0") in line
    assert ("dense table" if dense == "true" else "edge window") in line
    assert len(res["map_per_th"]) == 10 and np.isfinite(res["map_all"])
    assert res["confusion"].sum() > 0


def test_test_cli_matches_jax_evaluation(synthetic_root, tmp_path, capsys):
    """A reference .pth through `cli.test --serve_mode fast --dense_layout
    true --nms_algorithm classfix` against yolat_tpu's evaluate on its fast
    route with classfix NMS: the same AP table (1e-9: the same host
    arithmetic over the same detections) and confusion matrix."""
    ds = SESYDDataset(synthetic_root, "test", bbox_sampling_step=10)
    jds = JaxDataset(synthetic_root, "test", bbox_sampling_step=10)
    cfg, model = _port_model(ds.n_classes, seed=2)
    with torch.no_grad():  # lean toward background so that proposals are kept
        model.prediction_cls[2][0].bias[-1] += 50.0
    pth = str(tmp_path / "ref.pth")
    save_reference_checkpoint(model, pth)
    got = test_cli.main(["--data_dir", synthetic_root, "--phase", "test",
                         "--device", "cpu", "--n_filters", str(WIDTH),
                         "--batch_size", "2", "--pretrained_model", pth,
                         "--serve_mode", "fast", "--dense_layout", "true",
                         "--nms_algorithm", "classfix"])
    assert "checkpoint epoch=0 best=nan" in capsys.readouterr().out
    variables = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    jcfg = JaxConfig(n_classes=ds.n_classes, n_filters=WIDTH,
                     nms_algorithm="classfix")
    jloader = JaxLoader(jds, batch_size=2, shuffle=False, dense=True)
    want = jax_evaluate(jcfg, jax.tree.map(jnp.asarray, variables), jloader,
                        serve="fast")
    assert got["top1_acc"] > 0
    for k in ("map_50", "map_all", "test_value", "top1_acc"):
        assert abs(got[k] - want[k]) <= 1e-9, k
    np.testing.assert_allclose(got["map_per_th"], want["map_per_th"],
                               atol=1e-9)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            test_cli.main(["--data_dir", synthetic_root,
                           "--pretrained_model", pth])
