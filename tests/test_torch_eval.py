"""The port's evaluation runner and metrics against yolat_tpu's on the CPU.

Both packages evaluate the same weights (JAX init at width 16 with
randomised BatchNorm statistics, moved across by `load_jax_variables`)
on the synthetic test split, each packing it with its own host stage. The
eval-mode module routes give the same detections (the classifier's
background bias is raised so that most proposals are right and many are
kept), so the AP table must
be the same: map_per_th / map_50 / map_all / test_value to 1e-9 (the same
float64 host arithmetic over the same detections), top1_acc and the
confusion matrix exactly. The metrics copy is held equal to the original
on random detections.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.packing import finalize_batch as jax_finalize
from yolat_tpu.eval import metrics as jax_metrics
from yolat_tpu.eval.runner import evaluate as jax_evaluate
from yolat_tpu.nn.model import SparseCADGCN as JaxModel
from yolat_tpu.train.config import Config as JaxConfig
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.eval import metrics
from yolat_tpu_torch.eval.runner import evaluate
from yolat_tpu_torch.nn.model import SparseCADGCN, load_jax_variables

WIDTH = 16


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
def tables(synthetic_root):
    jds = JaxDataset(synthetic_root, "test", bbox_sampling_step=10)
    jloader = JaxLoader(jds, batch_size=2, shuffle=False)
    jb = {k: v[0] for k, v in next(iter(jloader)).items()}
    jm = JaxModel(n_classes=jds.n_classes, channels=WIDTH, sorted_edges=True)
    variables = _randomise(jm.init(
        {"params": jax.random.key(0)},
        jax_finalize(jax.tree.map(jnp.asarray, jb)), train=True))
    # lean toward background, the label of most proposals, so the
    # proposal accuracy and the kept set are not trivially empty
    variables["params"]["pred_2"]["dense_0"]["bias"][-1] += 50.0
    jcfg = JaxConfig(n_classes=jds.n_classes, n_filters=WIDTH)
    want = jax_evaluate(jcfg, jax.tree.map(jnp.asarray, variables), jloader)

    ds = SESYDDataset(synthetic_root, "test", bbox_sampling_step=10)
    cfg = Config(n_classes=ds.n_classes, n_filters=WIDTH)
    model = load_jax_variables(SparseCADGCN(ds.n_classes, channels=WIDTH),
                               variables).train()
    loader = PackedLoader(ds, batch_size=2)
    got = evaluate(cfg, model, loader)
    assert model.training  # evaluate restores the mode it found
    fast = evaluate(cfg, model, loader, serve="fast_bf16")
    return got, want, fast


def test_ap_table_matches_jax(tables):
    got, want, _ = tables
    assert got["top1_acc"] > 0
    for k in ("map_50", "map_all", "test_value", "top1_acc"):
        assert abs(got[k] - want[k]) <= 1e-9, k
    np.testing.assert_allclose(got["map_per_th"], want["map_per_th"],
                               atol=1e-9)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])


def test_fast_route_gives_a_table(tables):
    _, _, fast = tables
    assert len(fast["map_per_th"]) == 10
    assert 0.0 <= fast["map_all"] <= 1.0 and 0.0 <= fast["top1_acc"] <= 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_copy_matches_the_original(seed):
    rng = np.random.default_rng(seed)
    ev, jev = metrics.Evaluator(5), jax_metrics.Evaluator(5)
    for _ in range(4):
        g = int(rng.integers(1, 6))
        gt = rng.uniform(0, 80, (g, 2))
        gt = np.concatenate([gt, gt + rng.uniform(5, 40, (g, 2))], axis=1)
        gl = rng.integers(0, 4, g)
        d = int(rng.integers(0, 12))
        det = gt[rng.integers(0, g, d)] + rng.normal(0, 3, (d, 4))
        sc = np.sort(rng.random(d))[::-1]
        dl = rng.integers(0, 4, d)
        for e in (ev, jev):
            e.add_image(det, sc, dl, gt, gl)
            e.add_proposals(rng.integers(0, 5, 9) * 0 + dl[:1].repeat(9)
                            if d else np.zeros(9, int), np.arange(9) % 5)
    a, b = ev.compute(), jev.compute()
    for k in ("map_per_th", "map_50", "map_all", "test_value", "top1_acc"):
        np.testing.assert_allclose(a[k], b[k], atol=1e-12, err_msg=k)
    np.testing.assert_array_equal(a["confusion"], b["confusion"])
