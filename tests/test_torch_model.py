"""The port's SparseCADGCN and folded serving engine against yolat_tpu's,
on the same packed synthetic batch and the same weights (JAX init at
narrow width 16, moved across by the port's export_state_dict ->
load_state_dict(strict=True)). Each package packs the batch with its own
host stage.

Tolerances:
  * f32 logits: the same math with sums in another order — atol/rtol 1e-4
    (measured ~5e-6 at a logit scale of ~5).
  * bf16 engine: both engines round activations to bf16 at each stage, but
    XLA and PyTorch round matmul outputs and fused epilogues at different
    points — max error <= 3e-2 * max|logit| (measured ~0.8%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.packing import finalize_batch as jax_finalize
from yolat_tpu.eval.fast_forward import fast_forward as jax_fast_forward
from yolat_tpu.eval.fast_forward import fold_params as jax_fold
from yolat_tpu.nn.model import SparseCADGCN as JaxModel
from yolat_tpu.train.import_reference import export_state_dict
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.packing import finalize_batch, to_device
from yolat_tpu_torch.eval import fast_forward as ff
from yolat_tpu_torch.nn import state_dict as port_state_dict
from yolat_tpu_torch.nn.model import SparseCADGCN, load_jax_variables

WIDTH = 16


def _randomise(variables, seed=0):
    """Non-trivial BN statistics and affine terms, so folding matters."""
    rng = np.random.default_rng(seed)

    def bump(path, v):
        name = path[-1].key
        if name == "mean":
            return rng.normal(size=v.shape).astype(np.float32) * 0.5
        if name == "var":
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        if name in ("bias", "scale"):
            return v + rng.normal(size=v.shape).astype(np.float32) * 0.1
        return v

    return jax.tree_util.tree_map_with_path(bump, jax.tree.map(np.asarray,
                                                               variables))


@pytest.fixture(scope="module")
def setup(synthetic_root):
    ds = SESYDDataset(synthetic_root, "test", bbox_sampling_step=10,
                      cache=False)
    jds = JaxDataset(synthetic_root, "test", bbox_sampling_step=10)
    jb = {k: v[0] for k, v in
          next(iter(JaxLoader(jds, batch_size=2, shuffle=False))).items()}
    jbatch = jax_finalize(jax.tree.map(jnp.asarray, jb))
    jm = JaxModel(n_classes=ds.n_classes, channels=WIDTH, sorted_edges=True)
    variables = _randomise(jm.init({"params": jax.random.key(0)}, jbatch,
                                   train=True))
    pm = load_jax_variables(SparseCADGCN(ds.n_classes, channels=WIDTH),
                            variables).eval()
    pb = next(iter(PackedLoader(ds, batch_size=2)))
    return dict(jm=jm, variables=variables, jbatch=jbatch, pm=pm,
                pbatch=pb, tbatch=finalize_batch(to_device(pb, "cpu")),
                mask=pb["proposal_mask"])


def test_state_dict_takes_the_reference_names(setup):
    sd = setup["pm"].state_dict()
    ref = export_state_dict(setup["variables"])
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == np.shape(v), k
    assert "cls_net.head.gconv.nn.4.running_var" in sd
    assert "prediction_cls.2.0.weight" in sd


def test_export_state_dict_matches_jax(setup):
    got = port_state_dict.export_state_dict(setup["variables"])
    want = export_state_dict(setup["variables"])
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_eval_logits_match_jax(setup):
    want, wbox = setup["jm"].apply(setup["variables"], setup["jbatch"],
                                   train=False)
    with torch.no_grad():
        got, gbox = setup["pm"](setup["tbatch"])
    m = setup["mask"]
    np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(gbox.numpy(), np.asarray(wbox))


def test_fold_params_match_jax(setup):
    want = jax_fold(setup["variables"])
    got = ff.fold_params(setup["pm"])
    for c_got, c_want in zip(got["convs"], want["convs"]):
        for k in ("w1", "sc1", "w2", "sc2", "wr", "br", "wn", "scn"):
            np.testing.assert_allclose(c_got[k].numpy(), np.asarray(c_want[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ("fusion_block", "fusion_block_super", "pred_0", "pred_1",
              "pred_2"):
        for a, b in zip(got[k], want[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("bf16", [False, True])
def test_fast_forward_matches_jax(setup, bf16):
    want, _ = jax_fast_forward(jax_fold(setup["variables"]), setup["jbatch"],
                               bf16=bf16)
    folded = ff.fold_params(setup["pm"])
    with torch.no_grad():
        got, _ = ff.fast_forward(folded, setup["tbatch"], bf16=bf16)
    assert got.dtype == torch.float32
    m = setup["mask"]
    got, want = got.numpy()[m], np.asarray(want)[m]
    if bf16:
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fast_forward_needs_the_edge_window_plan(setup):
    folded = ff.fold_params(setup["pm"])
    no_plan = {k: v for k, v in setup["tbatch"].items()
               if not k.startswith("ew_")}
    with pytest.raises(ValueError, match="edge-window plan"):
        ff.fast_forward(folded, no_plan)


def test_pool_head_needs_the_aligned_plan(setup):
    folded = ff.fold_params(setup["pm"])
    no_pool = {k: v for k, v in setup["tbatch"].items()
               if not k.startswith("pool_")}
    with pytest.raises(ValueError):
        ff.fast_forward(folded, no_pool)
