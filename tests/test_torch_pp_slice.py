"""The YOLaT++ serving slice on the CPU: the port's predict against
yolat_tpu's make_predict_fn(fast=True) with arch 'yolat_pp' on the same
packed synthetic batch and weights (per-edge and factored), the port's
inference CLI against yolat_tpu's on the same checkpoint, and the test CLI.

The weights start in JAX (`create_state`, gates opened, BatchNorm
statistics randomised from a numpy seed) and reach the port through
`load_jax_variables`; each package packs the batch with its own host
stage. Tolerance: the same detections (count, order, classes); boxes are
the same proposal geometry (rtol 1e-6); scores carry f32 forward noise
(rtol/atol 1e-5; 1e-4 on the factored route, whose f32 prefix sum rounds
at the size of the running sum; in the CLI's records 2e-4: they are rounded
to 4 places).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.cli import infer as jax_infer
from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.eval.fast_forward import fold_params_for as jax_fold_for
from yolat_tpu.eval.predict import make_predict_fn
from yolat_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from yolat_tpu.train.config import Config as JaxConfig
from yolat_tpu.train.loop import create_state
from yolat_tpu.train.optim import make_optimizer
from yolat_tpu_torch.cli import infer
from yolat_tpu_torch.cli import test as test_cli
from yolat_tpu_torch.cli import train as train_cli
from yolat_tpu_torch.cli.train import build_parser, config_from_args
from yolat_tpu_torch.config import PP_GATES, Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader, extra_plans_for
from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.eval.fast_forward import fold_params_for
from yolat_tpu_torch.eval.predict import img_slot_cap, make_predict_core
from yolat_tpu_torch.nn.model import (build_model, load_jax_variables,
                                      seeded_model)
from yolat_tpu_torch.train.checkpoint import (CheckpointManager,
                                              save_reference_checkpoint,
                                              train_state)

WIDTH = 16


def _jax_state(jcfg, example, seed=0):
    """A JAX train state of jcfg's arch with open gates, randomised BN
    terms and a head leaning toward background (so proposals are kept)."""
    state = create_state(jcfg, make_optimizer(jcfg.optimizer, jcfg.lr,
                                              jcfg.weight_decay), example,
                         jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def bn(path, v):
        name, v = path[-1].key, np.asarray(v)
        if name == "var":
            return (0.5 + rng.random(v.shape)).astype(np.float32)
        if name == "mean":
            return (0.2 * rng.normal(size=v.shape)).astype(np.float32)
        return v

    stats = jax.tree_util.tree_map_with_path(
        bn, jax.device_get(state.batch_stats))
    params = jax.device_get(state.params)
    params = {k: (np.array(v) if k in PP_GATES else v)
              for k, v in params.items()}
    for i, g in enumerate(PP_GATES):
        params[g] = np.asarray(0.3 + 0.1 * i, np.float32)
    bias = np.array(params["pred_2"]["dense_0"]["bias"])
    bias[-1] += 3.0
    params["pred_2"] = {"dense_0": {**params["pred_2"]["dense_0"],
                                    "bias": bias}}
    return state.replace(params=params, batch_stats=stats)


def _configs(n_classes, factored):
    kw = dict(arch="yolat_pp", n_classes=n_classes, n_filters=WIDTH,
              pp_factored_prim=factored)
    return Config(**kw), JaxConfig(**kw)


@pytest.mark.parametrize("factored", [False, True])
def test_predict_matches_jax(synthetic_root, factored):
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10,
                      cache=False)
    jds = JaxDataset(synthetic_root, "train", bbox_sampling_step=10)
    cfg, jcfg = _configs(ds.n_classes, factored)
    pb = next(iter(PackedLoader(ds, batch_size=4, **extra_plans_for(cfg))))
    jb = {k: v[0] for k, v in
          next(iter(JaxLoader(jds, batch_size=4, shuffle=False))).items()}
    state = _jax_state(jcfg, jb)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    model = load_jax_variables(build_model(cfg), variables).eval()
    cap = img_slot_cap(pb)
    want = make_predict_fn(jcfg, fast=True, folded=jax_fold_for(jcfg, variables),
                           img_slots=cap, detections_only=True)(
        jax.tree.map(jnp.asarray, variables), jb)
    tb = to_device(pb, "cpu")
    got = make_predict_core(cfg, folded=fold_params_for(cfg, model),
                            img_slots=cap, detections_only=True)(tb)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert got["valid"].sum() > 10
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-6,
                               atol=1e-4)
    # the factored level's f32 prefix sum is taken in another order by
    # torch.cumsum than by XLA and rounds at the size of the running sum
    tol = 1e-4 if factored else 1e-5
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=tol,
                               atol=tol)
    # the module route gives the engine's detections
    slow = make_predict_core(cfg, model=model, img_slots=cap,
                             detections_only=True)(tb)
    assert np.array_equal(slow["valid"].numpy(), got["valid"])
    np.testing.assert_allclose(slow["scores"].numpy(), got["scores"],
                               rtol=1e-5, atol=1e-5)


def test_infer_cli_writes_the_jax_cli_records(synthetic_root, tmp_path,
                                              capsys):
    """One checkpoint, saved by each package in its own format, through
    both inference CLIs with --arch yolat_pp --serve_mode fast."""
    jds = JaxDataset(synthetic_root, "test", bbox_sampling_step=10)
    cfg, jcfg = _configs(jds.n_classes, False)
    jb = {k: v[0] for k, v in
          next(iter(JaxLoader(jds, batch_size=2, shuffle=False))).items()}
    state = _jax_state(jcfg, jb, seed=1)
    jdir = str(tmp_path / "jax_ckpt")
    JaxCheckpoints(jdir).save(state, 1, 0.0, True)
    model = load_jax_variables(build_model(cfg), {
        "params": state.params, "batch_stats": state.batch_stats})
    pth = str(tmp_path / "pp.pth")
    save_reference_checkpoint(model, pth)
    common = ["--input_dir", synthetic_root, "--bbox_sampling_step", "10",
              "--batch_size", "2", "--arch", "yolat_pp", "--n_filters",
              str(WIDTH), "--serve_mode", "fast", "--conf_th", "0.05"]
    want_out, got_out = str(tmp_path / "jax.jsonl"), str(tmp_path / "pt.jsonl")
    jax_infer.main(common + ["--pretrained_model", jdir, "--out", want_out,
                             "--chunk", "1"])
    capsys.readouterr()
    counts = infer.main(common + ["--pretrained_model", pth, "--out", got_out,
                                  "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    # CPU tensors take the plain versions: no kernel launch
    assert not any(counts.values())
    assert ("edge_window_message_sum=0, folded_mlp_block_max2=0, "
            "banded_message_sum=0, banded_message_sum_both=0") in line

    def records(path):
        with open(path) as f:
            return {r["file"]: r for r in map(json.loads, f)}

    want, got = records(want_out), records(got_out)
    svgs = glob.glob(os.path.join(synthetic_root, "**", "*.svg"),
                     recursive=True)
    assert set(got) == set(want) and len(got) == len(svgs)
    n_det = 0
    for name, w in want.items():
        g = got[name]
        assert (g["width"], g["height"]) == (w["width"], w["height"])
        assert len(g["detections"]) == len(w["detections"]), name
        for dg, dw in zip(g["detections"], w["detections"]):
            assert dg["class"] == dw["class"]
            np.testing.assert_allclose(dg["box"], dw["box"], atol=0.011)
            assert abs(dg["score"] - dw["score"]) <= 2e-4
        n_det += len(g["detections"])
    assert n_det > 5


@pytest.mark.parametrize("factored", [False, True])
def test_clis_serve_a_seeded_checkpoint(synthetic_root, tmp_path, capsys,
                                        factored):
    """cli.infer and cli.test on both checkpoint variants (the factored one
    through --profile yolat_pp_fast), from a `.pth` and from a checkpoint
    directory; a checkpoint of the other variant is refused."""
    cfg = Config(arch="yolat_pp", n_classes=17, n_filters=8,
                 pp_factored_prim=factored)
    model = seeded_model(cfg, seed=2)
    with torch.no_grad():
        model.prediction_cls[2][0].bias[-1] += 3.0
    pth = str(tmp_path / "pp.pth")
    save_reference_checkpoint(model, pth)
    flags = ["--profile", "yolat_pp_fast"] if factored else ["--arch",
                                                              "yolat_pp"]
    out = tmp_path / "det.jsonl"
    infer.main(["--input_dir", synthetic_root, "--pretrained_model", pth,
                "--out", str(out), "--device", "cpu", "--n_filters", "8",
                "--conf_th", "0.0"] + flags)
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 5 and all("error" not in r for r in recs)
    assert sum(len(r["detections"]) for r in recs) > 0

    ckdir = str(tmp_path / "ckpt")
    CheckpointManager(ckdir).save(train_state(
        model, torch.optim.Adam(model.parameters()), None, 7), 3, 0.25, True)
    base = ["--data_dir", synthetic_root, "--phase", "test", "--device",
            "cpu", "--n_filters", "8", "--batch_size", "2"]
    tables = {}
    for mode, ck in (("fast", pth), ("flax", ckdir), ("fast_bf16", ckdir)):
        tables[mode] = test_cli.main(base + flags + [
            "--pretrained_model", ck, "--serve_mode", mode])
        text = capsys.readouterr().out
        assert "MAP@0.50" in text and "MAP@ALL" in text
        assert ("checkpoint epoch=3 best=0.2500" if ck == ckdir
                else "checkpoint epoch=0 best=nan") in text
        assert "banded_message_sum=0, banded_message_sum_both=0" in \
            text.strip().splitlines()[-1]
        assert np.isfinite(tables[mode]["map_all"])
    # engine and module agree on what is kept and how it is labelled
    np.testing.assert_array_equal(tables["fast"]["confusion"],
                                  tables["flax"]["confusion"])
    assert tables["fast"]["confusion"].sum() > 0
    other = ["--arch", "yolat_pp"] if factored else ["--profile",
                                                      "yolat_pp_fast"]
    with pytest.raises(RuntimeError, match="super_(edge|fact)_mlp"):
        test_cli.main(base + other + ["--pretrained_model", pth])
    with pytest.raises(ValueError, match="no dense route"):
        test_cli.main(base + flags + ["--pretrained_model", pth,
                                      "--serve_mode", "fast",
                                      "--dense_layout", "true"])


def test_profile_bundle_and_refusals(synthetic_root, tmp_path):
    """--profile lays its bundle over the flags, typed flags win; training
    a YOLaT++ arch is refused before anything is built."""
    def cfg_of(argv):
        return config_from_args(build_parser().parse_args(argv), argv)

    cfg = cfg_of(["--profile", "yolat_pp_fast", "--data_dir", "x/floorplans"])
    assert (cfg.arch, cfg.pp_factored_prim, cfg.iou_aware_loss,
            cfg.iou_aware_mode, cfg.pos_class_weight) == (
        "yolat_pp", True, True, "rel", 1.0)
    cfg = cfg_of(["--profile", "yolat_pp_fast", "--data_dir", "x/charts",
                  "--pp_factored_prim", "false"])
    assert (cfg.pp_factored_prim, cfg.pos_class_weight) == (False, 16.0)
    assert cfg_of([]).arch == Config().arch and not cfg_of([]).profile
    with pytest.raises(NotImplementedError, match="training path"):
        train_cli.main(["--data_dir", synthetic_root, "--device", "cpu",
                        "--arch", "yolat_pp", "--root_dir", str(tmp_path)])
