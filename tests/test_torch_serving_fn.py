"""The port's transfer-fused serving (`eval/predict.make_serving_fn`) on the
CPU, where it runs the eager core through the same pack, unpack and chunk
code that feeds the CUDA graph on the card (the capture itself is checked
by `chip_smoke.py` phase 19):

  * the pack spec round-trips every dtype bit for bit, bool as uint8 and
    the bf16 wire (the value bf16(v), upcast);
  * each route's kept keys: the predict of the kept arrays alone is the
    predict of the whole batch, bit for bit, and the serving fn over the
    padded plans is the eager core over the unpadded batch, bit for bit,
    bf16 wire included (its audit: `data/staging.BF16_WIRE`);
  * `make_serving_fn(chunk=3)` against yolat_tpu's on the same packed
    synthetic batches and weights (a full chunk and a short one, the
    slice test's tolerances: the same detections, boxes rtol 1e-6,
    scores 1e-5), and against per-batch calls; a batch off the signature
    raises; the graph route refuses `loop` NMS;
  * `cli.infer --chunk 3` writes the records of `--chunk 1`, byte for
    byte.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.eval.fast_forward import fold_params as jax_fold
from yolat_tpu.eval.predict import make_serving_fn as jax_serving_fn
from yolat_tpu.train.config import Config as JaxConfig
from yolat_tpu.train.import_reference import convert_state_dict
from yolat_tpu_torch.cli import infer
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader, extra_plans_for
from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.data.staging import PackSpec, StagedBuffers
from yolat_tpu_torch.eval.fast_forward import fold_params_for
from yolat_tpu_torch.eval.predict import (img_slot_cap, kept_batch_keys,
                                          make_predict_core, make_serving_fn,
                                          serving_route)
from yolat_tpu_torch.nn.model import seeded_model
from yolat_tpu_torch.ops.plans import pad_plans

WIDTH = 16


@pytest.mark.parametrize("bf16_wire", [False, True])
def test_pack_unpack_round_trip(bf16_wire):
    rng = np.random.default_rng(0)
    batch = {"pos": rng.normal(size=(7, 2)).astype(np.float32),
             "nbr_attr": rng.normal(size=(3, 2, 4)).astype(np.float32),
             "e_attr": rng.normal(size=(5, 4)).astype(np.float32),
             "edge": rng.integers(-9, 9, (5, 2)).astype(np.int32),
             "big": rng.integers(0, 2 ** 40, 3).astype(np.int64),
             "tag": np.zeros(3, np.int8),
             "mask": rng.random(9) < 0.5,
             "empty": np.zeros(0, np.int32)}
    spec = PackSpec(batch, sorted(batch), bf16_wire=bf16_wire)
    assert all(o % 16 == 0 for *_, o, _ in spec.entries)
    staged = StagedBuffers(spec, 2, "cpu")
    rows = staged.stage([batch])  # a short list repeats its last row
    assert torch.equal(rows[0], rows[1])
    out = spec.unpack(rows[1])
    for k, a in batch.items():
        t = torch.from_numpy(a)
        if bf16_wire and k in ("pos", "nbr_attr"):
            t = t.to(torch.bfloat16).float()
            assert not torch.equal(t, torch.from_numpy(a))
        assert out[k].dtype == t.dtype and torch.equal(out[k], t), k
    with pytest.raises(ValueError, match="shape signature"):
        staged.stage([{**batch, "pos": batch["pos"][:6]}])
    with pytest.raises(ValueError, match="shape signature"):
        staged.stage([{**batch, "edge": batch["edge"].astype(np.int64)}])


@pytest.fixture(scope="module")
def served(synthetic_root):
    """Per route: (cfg, folded, numpy batches of one image each)."""
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    out = {}
    for route, cfg, kw in (
            ("plan", Config(n_classes=ds.n_classes, n_filters=WIDTH), {}),
            ("dense", Config(n_classes=ds.n_classes, n_filters=WIDTH),
             dict(edge_window=False, dense=True)),
            ("pp_per_edge", Config(arch="yolat_pp", n_classes=ds.n_classes,
                                   n_filters=WIDTH), {}),
            ("pp_factored", Config(arch="yolat_pp", n_classes=ds.n_classes,
                                   n_filters=WIDTH, pp_factored_prim=True),
             {})):
        folded = fold_params_for(cfg, seeded_model(cfg, 1))
        batches = list(PackedLoader(ds, batch_size=1, prefetch=0,
                                    **{**kw, **extra_plans_for(cfg)}))
        out[route] = (cfg, folded, batches)
    return out


def _np(d):
    return {k: v.numpy() for k, v in d.items()}


def _equal(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


ROUTES = ["plan", "dense", "pp_per_edge", "pp_factored"]


@pytest.mark.parametrize("route", ROUTES)
def test_kept_keys_are_all_a_route_reads(served, route):
    cfg, folded, batches = served[route]
    b = pad_plans(batches[0])
    assert serving_route(cfg, b, folded) == route
    keys = kept_batch_keys(route, b)
    assert set(keys) < set(b) and len(keys) < len(b) - 5
    core = make_predict_core(cfg, folded=folded, bf16=True,
                             img_slots=img_slot_cap(b))
    full = _np(core(to_device(b, "cpu")))
    kept = _np(core(to_device({k: b[k] for k in keys}, "cpu")))
    assert _equal(kept, full) and full["valid"].any()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("bf16", [False, True])
def test_serving_fn_is_the_eager_core(served, route, bf16):
    """Padded plans, kept keys, the bf16 wire: the detections of the
    unpadded batch through the eager core, bit for bit."""
    cfg, folded, batches = served[route]
    cap = max(img_slot_cap(b) for b in batches)
    kw = dict(folded=folded, bf16=bf16, img_slots=cap)
    core = make_predict_core(cfg, **kw)
    fn = make_serving_fn(cfg, pad_plans(batches[0]), device="cpu", **kw)
    assert fn.route == route
    for b in batches:
        want = _np(core(to_device(b, "cpu")))
        assert _equal(fn(pad_plans(b)).numpy(), want)


def test_chunked_serving_matches_jax(synthetic_root):
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    jds = JaxDataset(synthetic_root, "train", bbox_sampling_step=10)
    cfg = Config(n_classes=ds.n_classes, n_filters=WIDTH)
    model = seeded_model(cfg)
    variables = convert_state_dict({k: v.numpy() for k, v in
                                    model.state_dict().items()})
    batches = [pad_plans(b) for b in PackedLoader(ds, batch_size=1,
                                                  prefetch=0)]
    jbatches = [{k: v[0] for k, v in b.items()}
                for b in JaxLoader(jds, batch_size=1, shuffle=False)]
    assert len(batches) == len(jbatches) == 3
    cap = max(img_slot_cap(b) for b in batches)
    jcfg = JaxConfig(n_classes=ds.n_classes, n_filters=WIDTH)
    jfn = jax_serving_fn(jcfg, jax.tree.map(jnp.asarray, variables),
                         jbatches[0], chunk=3, fast=True,
                         folded=jax_fold(variables), img_slots=cap,
                         detections_only=True)
    fn = make_serving_fn(cfg, batches[0], chunk=3, device="cpu",
                         folded=fold_params_for(cfg, model), img_slots=cap,
                         detections_only=True)
    one = make_serving_fn(cfg, batches[0], device="cpu",
                          folded=fold_params_for(cfg, model), img_slots=cap,
                          detections_only=True)
    for rows in ([0, 1, 2], [2]):  # a full chunk, then a short one
        got, n = fn([batches[i] for i in rows])
        want, jn = jfn(jax.tree.map(jnp.asarray, variables),
                       [jbatches[i] for i in rows])
        assert n == jn == len(rows)
        got = got.numpy()
        want = {k: np.asarray(v) for k, v in want.items()}
        assert got["scores"].shape[0] == 3 and got["valid"][:n].sum() > 10
        for r in range(3):  # rows n: repeat the last batch on both sides
            np.testing.assert_array_equal(got["valid"][r], want["valid"][r])
            np.testing.assert_array_equal(got["classes"][r],
                                          want["classes"][r])
            np.testing.assert_allclose(got["boxes"][r], want["boxes"][r],
                                       rtol=1e-6, atol=1e-4)
            np.testing.assert_allclose(got["scores"][r], want["scores"][r],
                                       rtol=1e-5, atol=1e-5)
            per_batch = one(batches[rows[min(r, n - 1)]]).numpy()
            assert _equal({k: v[r] for k, v in got.items()}, per_batch)
    with pytest.raises(ValueError, match="shape signature"):
        fn([{**batches[0], "pos": batches[0]["pos"][:-8]}])
    with pytest.raises(ValueError, match="4 batches for 3 rows"):
        fn(batches + batches[:1])


def test_graph_route_refuses_loop_nms(served):
    cfg, folded, batches = served["plan"]
    with pytest.raises(ValueError, match="--nms_algorithm"):
        make_serving_fn(cfg.replace(nms_algorithm="loop"),
                        pad_plans(batches[0]), device="cuda", folded=folded)
    # the CPU route runs it eagerly, as the eager core does
    fn = make_serving_fn(cfg.replace(nms_algorithm="loop"),
                         pad_plans(batches[0]), device="cpu", folded=folded)
    assert fn(pad_plans(batches[0])).numpy()["valid"].any()


@pytest.mark.parametrize("mode", ["fast_bf16", "module"])
def test_cli_chunk_records_are_chunk_1s(synthetic_root, tmp_path, mode):
    cfg = Config(n_classes=17, n_filters=WIDTH)
    ckpt = tmp_path / "model.pth"
    torch.save({"state_dict": seeded_model(cfg, 2).state_dict(), "epoch": 0},
               ckpt)
    outs = []
    for chunk in (1, 3):
        out = tmp_path / f"det{chunk}.jsonl"
        infer.main(["--input_dir", synthetic_root, "--pretrained_model",
                    str(ckpt), "--out", str(out), "--serve_mode", mode,
                    "--device", "cpu", "--n_filters", str(WIDTH),
                    "--conf_th", "0.0", "--batch_size", "1",
                    "--chunk", str(chunk)])
        outs.append(out)
    assert filecmp.cmp(*outs, shallow=False)
    assert outs[0].read_text().count("\n") == 5  # 3 train + 2 test SVGs
