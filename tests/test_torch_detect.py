"""The port's detection CLIs against yolat_tpu's, on the CPU:
`cli.detect` (flax, fast, fast over the dense table, fast with
`--merge_nms`), `eval/merge_nms`, `render_detections`' pixels,
`cli.detect_badcase`, `cli.detect` under YOLaT++ against the port's own
predict core, and the refusals (`--device cuda` without CUDA, a driver
without matplotlib).

Weights: yolat_tpu's canonical detector at width 16 (`init`, randomised
BatchNorm statistics and affine terms, the background logit's bias raised
by 5 so that roots fall to background and their children are kept: 100+
detections per image, merges of several proposals), written once through
yolat_tpu's own `save_reference_checkpoint` and read by both CLIs. Each
package reads its own copy of the shared synthetic split (SVGs and
annotations only), so each builds its own graphs and caches.

The CLIs run with their renderers replaced by recorders (the JAX module is
patched in the test, not edited); per image the same SVG, output name,
width, height, class names and score threshold, the boxes at rtol 1e-6 /
atol 1e-4 and the scores at rtol/atol 1e-5, as tests/test_torch_slice.py.
Hard NMS compares each pair's IoU with the threshold in float32: where it
lies within float32 rounding of the threshold the two packages may decide
differently (on this split one pair reads 0.49999958 in float64 against
0.5; the port's IEEE division gives 0.49999952 and keeps the lower box,
XLA's CPU division suppresses it). So the detections are matched one to
one, and a detection left on one side must be such a pair: a detection of
its class kept by both, ranked above it, at an IoU within 1e-5 of the
threshold. At most 2% of an image's detections may be so explained; the
first image has none, and the test says how many it found.
"""

import contextlib
import io
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.cli import detect as jax_detect
from yolat_tpu.cli import detect_badcase as jax_badcase
from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.packing import finalize_batch as jax_finalize
from yolat_tpu.eval import merge_nms as jax_merge
from yolat_tpu.nn.model import SparseCADGCN as JaxModel
from yolat_tpu.train.import_reference import \
    save_reference_checkpoint as jax_save_reference
from yolat_tpu_torch.cli import detect
from yolat_tpu_torch.cli import detect_badcase
from yolat_tpu_torch.cli.test import serving_loader
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.packing import to_device
from yolat_tpu_torch.eval import merge_nms
from yolat_tpu_torch.eval.fast_forward import fold_params_for
from yolat_tpu_torch.eval.predict import make_predict_core
from yolat_tpu_torch.nn.model import seeded_model
from yolat_tpu_torch.train.checkpoint import save_reference_checkpoint

WIDTH = 16
IOU_THRES = 0.5  # Config.nms_iou of both packages
MODES = {"flax": ["--serve_mode", "flax"],
         "fast": ["--serve_mode", "fast"],
         "fast_dense": ["--serve_mode", "fast", "--dense_layout", "true"],
         "fast_merge_nms": ["--serve_mode", "fast", "--merge_nms"]}


def _copy_split(src: str, dst: str) -> str:
    """The split's SVGs, annotations and lists, without any cache."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("*.pkl"))
    return dst


def _randomise(variables, seed=0):
    rng = np.random.default_rng(seed)

    def bump(path, v):
        name = path[-1].key
        if name == "mean":
            return rng.normal(size=v.shape).astype(np.float32) * 0.5
        if name == "var":
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        if name in ("bias", "scale"):
            return v + rng.normal(size=v.shape).astype(np.float32) * 0.3
        return v

    return jax.tree_util.tree_map_with_path(bump, jax.tree.map(np.asarray,
                                                               variables))


@pytest.fixture(scope="module")
def setup(synthetic_root, tmp_path_factory):
    """-> (JAX data root, port data root, reference .pth, work dir)."""
    tmp = tmp_path_factory.mktemp("detect")
    jroot = _copy_split(synthetic_root, str(tmp / "jax_data"))
    proot = _copy_split(synthetic_root, str(tmp / "port_data"))
    jds = JaxDataset(jroot, "test", bbox_sampling_step=10)
    jb = {k: v[0] for k, v in
          next(iter(JaxLoader(jds, batch_size=1, shuffle=False))).items()}
    jm = JaxModel(n_classes=jds.n_classes, channels=WIDTH, sorted_edges=True)
    variables = _randomise(jm.init(
        {"params": jax.random.key(0)},
        jax_finalize(jax.tree.map(jnp.asarray, jb)), train=True))
    variables["params"]["pred_2"]["dense_0"]["bias"][-1] += 5.0
    pth = str(tmp / "reference.pth")
    jax_save_reference(variables, pth)
    return jroot, proot, pth, tmp


def _recorder(store: list):
    def render(svg_path, width, height, boxes, scores, classes, class_names,
               out_path, score_th=0.75):
        store.append(dict(svg=svg_path, w=width, h=height,
                          boxes=np.asarray(boxes), scores=np.asarray(scores),
                          classes=np.asarray(classes),
                          class_names=list(class_names),
                          out=os.path.basename(out_path), score_th=score_th))
    return render


def _run(main, argv) -> list:
    """main(argv)'s printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def runs(setup):
    """Per mode: (JAX records, JAX lines, port records, port lines)."""
    jroot, proot, pth, tmp = setup
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mode, flags in MODES.items():
            jrec, prec = [], []
            mp.setattr(jax_detect, "render_detections", _recorder(jrec))
            mp.setattr(detect, "render_detections", _recorder(prec))
            common = ["--bbox_sampling_step", "10", "--n_filters",
                      str(WIDTH), "--pretrained_model", pth, "--conf_th",
                      "0.0", "--max_images", "2"] + flags
            jlines = _run(jax_detect.main, common + [
                "--data_dir", jroot, "--out_dir", str(tmp / f"j_{mode}")])
            plines = _run(detect.main, common + [
                "--data_dir", proot, "--out_dir", str(tmp / f"p_{mode}"),
                "--device", "cpu"])
            out[mode] = (jrec, jlines, prec, plines)
    return out


def _iou64(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union


def match_detections(got, want, iou_thres=IOU_THRES) -> int:
    """Pair the detections of one image (module docstring); returns how
    many were left on one side, each explained by a pair at the NMS
    threshold."""
    unpaired = [list(range(len(got["boxes"]))), list(range(len(want["boxes"])))]
    pairs = []
    for i in list(unpaired[0]):
        for j in unpaired[1]:
            if (got["classes"][i] == want["classes"][j]
                    and np.allclose(got["boxes"][i], want["boxes"][j],
                                    rtol=1e-6, atol=1e-4)):
                pairs.append((i, j))
                unpaired[0].remove(i)
                unpaired[1].remove(j)
                break
    gi = np.array([i for i, _ in pairs], int)
    wj = np.array([j for _, j in pairs], int)
    np.testing.assert_allclose(got["boxes"][gi], want["boxes"][wj],
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got["scores"][gi], want["scores"][wj],
                               rtol=1e-5, atol=1e-5)
    for side, rec in zip(unpaired, (got, want)):
        both = gi if rec is got else wj
        for k in side:
            assert any(rec["classes"][p] == rec["classes"][k]
                       and rec["scores"][p] > rec["scores"][k]
                       and abs(_iou64(rec["boxes"][p], rec["boxes"][k])
                               - iou_thres) <= 1e-5 for p in both), \
                ("a detection on one side only, not at the threshold", k)
    n = len(unpaired[0]) + len(unpaired[1])
    assert n <= 0.02 * max(len(got["boxes"]), len(want["boxes"]))
    return n


@pytest.mark.parametrize("mode", list(MODES))
def test_detections_match_jax(runs, setup, mode):
    jroot, proot, _, _ = setup
    jrec, jlines, prec, plines = runs[mode]
    assert len(prec) == len(jrec) == 2
    flips = []
    for got, want in zip(prec, jrec):
        assert os.path.relpath(got["svg"], proot) == \
            os.path.relpath(want["svg"], jroot)
        assert got["out"] == want["out"]
        assert got["class_names"] == want["class_names"]
        assert (got["w"], got["h"]) == (want["w"], want["h"])
        assert got["score_th"] == want["score_th"]
        assert len(want["boxes"]) >= (20 if mode == "fast_merge_nms" else 100)
        flips.append(match_detections(got, want))
    assert flips[0] == 0, flips
    print(f"{mode}: detections left on one side at the NMS threshold: "
          f"{flips}")
    # one '<svg>: <n> detections' line per image, the counts drawn
    for rec, lines in ((prec, plines), (jrec, jlines)):
        shown = [ln for ln in lines if ln.endswith(" detections")]
        assert shown == [f"{r['svg']}: {len(r['boxes'])} detections"
                         for r in rec]


def test_printed_lines_match_jax(runs):
    for mode, (_, jlines, _, plines) in runs.items():
        params = [ln for ln in plines if ln.startswith("params: ")]
        assert params == [ln for ln in jlines if ln.startswith("params: ")]
        assert params == ["params: 1.293 M"], params
        assert any(ln.startswith("mean inference time: ") and
                   ln.endswith(" ms") for ln in plines), mode
        assert "kernel launches: edge_window_message_sum=0" in plines[-1]


def test_merge_nms_run_is_merge_nms_of_the_kept_proposals(setup):
    """`--merge_nms` draws merge_nms of the predict call's kept proposals,
    bit for bit, at --conf_th, with score threshold 0."""
    _, proot, pth, tmp = setup
    prec = []
    res = detect.detect(
        ["--data_dir", proot, "--bbox_sampling_step", "10", "--n_filters",
         str(WIDTH), "--pretrained_model", pth, "--conf_th", "0.05",
         "--max_images", "1", "--serve_mode", "fast", "--merge_nms",
         "--device", "cpu", "--out_dir", str(tmp / "p_merge")],
        render=_recorder(prec))
    (img,) = res["images"]
    out = img["outputs"]
    kept = out["kept"]
    m = merge_nms.merge_nms(out["prop_boxes"][kept], out["prop_obj"][kept],
                            out["prop_cls"][kept], conf_thres=0.05,
                            nms_thres=0.4)
    assert 0 < len(m["boxes"]) < int(kept.sum())
    for got in (prec[0], img):
        np.testing.assert_array_equal(got["boxes"], m["boxes"])
        np.testing.assert_array_equal(got["scores"],
                                      m["obj_conf"] * m["cls_conf"])
        np.testing.assert_array_equal(got["classes"], m["classes"])
    assert prec[0]["score_th"] == 0.0


def _merge_inputs(case: str, seed: int):
    rng = np.random.default_rng(seed)
    m, k = 60, 5
    xy = rng.uniform(0, 200, (m, 2))
    wh = rng.uniform(5, 60, (m, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    obj = rng.uniform(0, 1, m).astype(np.float32)
    cls = rng.dirichlet(np.ones(k), m).astype(np.float32)
    if case == "none_above":
        obj *= 0.4
    elif case == "one_class":
        cls = np.zeros((m, k), np.float32)
        cls[:, 2] = rng.uniform(0.5, 1, m)
    elif case == "ties":
        # equal scores (the stable order decides), duplicated boxes
        # (merged exactly), boxes on the +1-pixel IoU edge
        obj[:] = 0.9
        cls[:] = cls[0]
        boxes[10:20] = boxes[0]
        boxes[20:30] = boxes[1] + np.float32(0.5)
        # IoU exactly 0.4 = nms_thres ("+1" pixels: 40 / 100): not absorbed
        boxes[30] = (300, 300, 309, 309)
        boxes[31] = (300, 300, 309, 303)
    return boxes, obj, cls


@pytest.mark.parametrize("case", ["random", "none_above", "one_class",
                                  "ties"])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_nms_copy_matches_the_original(case, seed):
    boxes, obj, cls = _merge_inputs(case, seed)
    for conf, nms in ((0.5, 0.4), (0.0, 0.1), (0.3, 0.7)):
        got = merge_nms.merge_nms(boxes, obj, cls, conf_thres=conf,
                                  nms_thres=nms)
        want = jax_merge.merge_nms(boxes, obj, cls, conf_thres=conf,
                                   nms_thres=nms)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        if case == "none_above" and conf == 0.5:
            assert len(got["boxes"]) == 0
        elif conf == 0.0:
            assert 0 < len(got["boxes"]) < len(boxes)


def test_render_detections_pixels_match_jax(runs, setup, tmp_path):
    image = pytest.importorskip("matplotlib.image")
    jroot, _, _, _ = setup
    want = runs["fast"][0][0]  # the JAX records of the first image
    svg = os.path.join(jroot, os.path.relpath(want["svg"], jroot))
    args = (svg, want["w"], want["h"], want["boxes"], want["scores"],
            want["classes"], want["class_names"])
    paths = {}
    for name, fn in (("jax", jax_detect.render_detections),
                     ("port", detect.render_detections)):
        paths[name] = str(tmp_path / f"{name}.png")
        fn(*args, paths[name], score_th=0.1)
    got, ref = (image.imread(paths[k]) for k in ("port", "jax"))
    assert ref.shape[0] > 100 and (ref < 1).any()
    np.testing.assert_array_equal(got, ref)


def test_badcase_matches_jax(setup, tmp_path):
    jroot, proot, pth, _ = setup
    recs = {"jax": [], "port": []}

    def recorder(store):
        def render(svg_path, width, height, det, gt, out_path):
            store.append((svg_path, (width, height),
                          [(np.asarray(b), kind) for b, kind in det],
                          np.asarray(gt), os.path.basename(out_path)))
        return render

    common = ["--bbox_sampling_step", "10", "--n_filters", str(WIDTH),
              "--pretrained_model", pth, "--conf_th", "0.1",
              "--iou_th", "0.5"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_badcase, "render_badcase", recorder(recs["jax"]))
        mp.setattr(detect_badcase, "render_badcase", recorder(recs["port"]))
        jlines = _run(jax_badcase.main, common + [
            "--data_dir", jroot, "--out_dir", str(tmp_path / "j")])
        plines = _run(detect_badcase.main, common + [
            "--data_dir", proot, "--out_dir", str(tmp_path / "p"),
            "--device", "cpu"])
    assert jlines[-1].startswith("rendered 2 badcase images")
    assert plines[-1] == jlines[-1].replace(str(tmp_path / "j"),
                                            str(tmp_path / "p"))
    n_tp, flips = 0, 0
    for got, want in zip(recs["port"], recs["jax"]):
        assert os.path.relpath(got[0], proot) == \
            os.path.relpath(want[0], jroot)
        assert got[1] == want[1] and got[4] == want[4]
        flips += _match_labels(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])  # GT: packed arrays
        n_tp += sum(k == "tp" for _, k in got[2])
    assert n_tp > 0 and any(len(g[3]) for g in recs["port"])
    assert any(k == "fp" for g in recs["port"] for _, k in g[2])
    print(f"badcase: detections left on one side at the NMS threshold: "
          f"{flips}")


def test_missed_gt_takes_the_tp_class_only():
    """A TP covers the GT of its own class with the largest IoU, even where
    a GT of another class overlaps it more."""
    gt = np.array([[0, 0, 99, 99], [10, 0, 109, 99], [300, 300, 340, 340]],
                  np.float64)
    labels = np.array([1, 2, 1])
    boxes = np.array([[12, 0, 111, 99], [0, 0, 99, 99], [500, 500, 540, 540]])
    tp = np.array([1.0, 0.0, 0.0])
    missed = detect_badcase.missed_gt(boxes, tp, np.array([1, 2, 1]), gt,
                                      labels)
    np.testing.assert_array_equal(missed, gt[1:])  # GT 0 covered by class 1
    missed = detect_badcase.missed_gt(boxes, np.array([1.0, 1.0, 0.0]),
                                      np.array([1, 2, 1]), gt, labels)
    np.testing.assert_array_equal(missed, gt[2:])


def _match_labels(got, want) -> int:
    """The TP / FP labels of one image's detections, paired by box; a
    detection on one side only is an FP at the hard-NMS threshold against
    a detection both kept (module docstring; the renderer is given no
    classes). Returns how many were left."""
    left = list(range(len(want)))
    alone = []
    for gb, kind in got:
        j = next((j for j in left if np.allclose(gb, want[j][0], rtol=1e-6,
                                                 atol=1e-4)), None)
        if j is None:
            alone.append((gb, kind))
            continue
        left.remove(j)
        assert kind == want[j][1]
    alone += [want[j] for j in left]
    for box, kind in alone:
        assert kind == "fp" and any(
            abs(_iou64(box, b) - IOU_THRES) <= 1e-5 for b, _ in got), box
    assert len(alone) <= 0.02 * max(len(got), len(want))
    return len(alone)


def test_yolat_pp_detect_is_the_predict_core(synthetic_root, tmp_path):
    """`--arch yolat_pp --serve_mode fast` on a seeded open-gate port
    checkpoint: each image's detections are those of the port's
    `make_predict_core` over the engine on the same batch."""
    cfg = Config(arch="yolat_pp", n_classes=17, n_filters=WIDTH)
    model = seeded_model(cfg, seed=3)
    pth = str(tmp_path / "pp.pth")
    save_reference_checkpoint(model, pth)
    prec = []
    res = detect.detect(
        ["--data_dir", synthetic_root, "--bbox_sampling_step", "10",
         "--n_filters", str(WIDTH), "--pretrained_model", pth,
         "--arch", "yolat_pp", "--serve_mode", "fast", "--conf_th", "0.0",
         "--device", "cpu", "--out_dir", str(tmp_path / "out")],
        render=_recorder(prec))
    ds = SESYDDataset(synthetic_root, "test", bbox_sampling_step=10)
    assert len(prec) == len(ds) == len(res["images"]) == 2
    core = make_predict_core(cfg, folded=fold_params_for(cfg, model, "cpu"),
                             max_det=cfg.max_det)
    loader = serving_loader(cfg, ds, 1, "fast", prefetch=0)
    n = 0
    for got, batch in zip(prec, loader):
        want = {k: v.numpy() for k, v in core(to_device(batch, "cpu")).items()}
        valid = want["valid"][0]
        assert got["svg"] == ds.files[n]
        np.testing.assert_array_equal(got["classes"], want["classes"][0][valid])
        np.testing.assert_allclose(got["boxes"], want["boxes"][0][valid],
                                   rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(got["scores"], want["scores"][0][valid],
                                   rtol=1e-5, atol=1e-5)
        assert valid.sum() > 0
        n += 1
    assert n == 2


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where CUDA is absent")
@pytest.mark.parametrize("driver", [detect, detect_badcase])
def test_cuda_without_cuda_raises(setup, driver):
    _, proot, pth, tmp = setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.main(["--data_dir", proot, "--pretrained_model", pth,
                     "--n_filters", str(WIDTH), "--out_dir",
                     str(tmp / "never")])


@pytest.mark.parametrize("driver", [detect, detect_badcase])
def test_without_matplotlib_main_raises_before_the_first_image(
        setup, driver, monkeypatch):
    _, proot, pth, tmp = setup
    out_dir = tmp / f"no_mpl_{driver.__name__.rsplit('.', 1)[-1]}"
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    with pytest.raises(RuntimeError, match="matplotlib"):
        driver.main(["--data_dir", proot, "--pretrained_model", pth,
                     "--n_filters", str(WIDTH), "--device", "cpu",
                     "--out_dir", str(out_dir)])
    assert not out_dir.exists()
