"""`--remat` (activation checkpointing of gp2's message MLP and the fusion
MLPs) in the port, on the CPU: against yolat_tpu's `remat=True` model,
against the port with remat off, its structure, and under data parallel.

  (i)   The port with remat on against JAX's `build_model` with
        `remat=True` on the same numpy batch, weights crossed through
        `load_jax_variables`, in the sparse, dense and window layouts: the
        loss, the gradients and the updated running statistics, at the
        rules of tests/test_torch_train.py's `test_train_step_matches_jax`
        (loss rtol 1e-5; gradients rtol 1e-3, atol 5e-3 of each tensor's
        largest, noise-level tensors at atol 1e-4; running statistics rtol
        1e-4, atol 1e-5). JAX's gradient is one jitted call with the batch
        as an argument.
  (ii)  The port with remat on against remat off from the same weights,
        through `train.loop.forward_loss` (so the bf16 step's
        `functional_call` over bf16 copies is on the path): f32 and bf16
        on the three layouts, the fused head (f32) and one single-stream
        conv (edge: only the fusion MLPs are wrapped). The loss and every
        gradient within 1e-6 relative (Frobenius); on this CPU they come
        out bit-equal. The running statistics bit-equal: the recompute
        does not move them a second time.
  (iii) Structure: the state-dict keys are the same with remat on and off
        and a checkpoint of one loads strictly into the other; `--remat`
        parses into `Config.remat`; YOLaT++ builds the same module under
        `remat=True` and checkpoints nothing, as its JAX module reads the
        field nowhere; eval mode and no_grad checkpoint nothing; a
        rematerialised MLP with dropout is refused.
  (iv)  Data parallel: two gloo ranks (tests/torch_dp_zoo_ranks.py, a
        FileStore, a 60 s group timeout, a 120 s join timeout: a hang fails
        this file; they start with the module and run beside (i)) at
        width 8, gp2 with remat against gp2 without, SGD, 2 steps: the
        ranks bit-identical, the DP step with remat bit-equal
        to the DP step without, identical shards against the single-device
        remat-off step bit for bit but the running variances (the unbiased
        correction of the global count, 2n / (2n - 1) for n / (n - 1):
        rtol 1e-2, as tests/test_torch_dp_zoo.py holds them on a split
        where a BatchNorm sees under a hundred rows), and the
        collectives a step: 21 without remat, 27 with it (the recompute
        sums the moments of the 6 rematerialised BatchNorms again, as
        `jax.checkpoint` recomputes its psum).
Every case counts the checkpoints that ran, so none passes vacuously.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_zoo_ranks
from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.packing import finalize_batch as jax_finalize
from yolat_tpu.data.synthetic import write_dataset
from yolat_tpu.nn.model import SparseCADGCN as JaxModel
from yolat_tpu.nn.model import detection_loss as jax_loss
from yolat_tpu.ops.edge_window import ew_of as jax_ew_of
from yolat_tpu.train.import_reference import export_state_dict
from yolat_tpu_torch.cli.train import build_parser, config_from_args
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader, train_plans_for
from yolat_tpu_torch.data.packing import finalize_batch, to_device
from yolat_tpu_torch.nn import layers
from yolat_tpu_torch.nn.model import (SparseCADGCN, build_model,
                                      load_jax_variables, seeded_model)
from yolat_tpu_torch.parallel.launch import spawn_ranks
from yolat_tpu_torch.train.loop import forward_loss, prepare_batch

WIDTH = 16
BATCH = 2
STEP = 5  # bbox_sampling_step: ~2k node rows an image
DENSE_KEYS = ("nbr_idx", "nbr_attr", "nbr_mask")
# checkpoints a train-mode forward runs at 2 blocks: 2 gp2 message MLPs,
# fusion_block (unfused) and fusion_block_super
CHECKPOINTS = {"gp2": 4, "gp2_fused": 3, "edge": 2}
DP_WIDTH = 8
DP_STEPS = 2
DP_WORLD = 2
JOIN_TIMEOUT_S = 120.0
# collectives a DP step: 10 BatchNorm moment sums forward, 10 backward, 1
# flat gradient buffer; with remat the recompute sums the moments of the 6
# rematerialised BatchNorms (2 per message MLP, 1 per fusion MLP) again
DP_COLLECTIVES = {"gp2": 21, "gp2_remat": 27}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors (under xdist the
    default pool per worker oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def checkpoints(monkeypatch):
    """The checkpoints run through `nn.layers.MLP` while the test runs."""
    seen = []

    def counted(*args, **kw):
        seen.append(1)
        return torch.utils.checkpoint.checkpoint(*args, **kw)

    monkeypatch.setattr(layers, "checkpoint", counted)
    return seen


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """Three small floorplans to train on (500x400, 2 rooms, as
    tests/test_torch_dp_zoo.py's): a batch of one has ~2k node rows."""
    root = str(tmp_path_factory.mktemp("remat"))
    write_dataset(root, n_train=3, n_test=1, seed=3, width=500.0,
                  height=400.0, n_rooms=2, symbols_per_room=(1, 2))
    return root


@pytest.fixture(autouse=True, scope="module")
def dp_runs(tiny_root):
    """(iv)'s two gloo ranks, started with the module's first test so that
    they run while the JAX oracles compile here; the DP test waits for
    them (a future of both ranks' results)."""
    n_classes = SESYDDataset(tiny_root, "train",
                             bbox_sampling_step=STEP).n_classes
    state = {k: v.numpy().copy() for k, v in seeded_model(Config(
        n_classes=n_classes, n_filters=DP_WIDTH), seed=6).state_dict().items()}
    cases = {name: dict(n_classes=n_classes, width=DP_WIDTH, lr=1e-2,
                        model=dict(remat=name == "gp2_remat"),
                        steps=DP_STEPS)
             for name in DP_COLLECTIVES}
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(
            spawn_ranks, torch_dp_zoo_ranks.zoo_scenarios, DP_WORLD,
            (tiny_root, DP_WORLD, cases, dict.fromkeys(cases, state),
             "cpu", STEP, 1, False), join_timeout_s=JOIN_TIMEOUT_S)


@pytest.fixture(scope="module")
def setup(synthetic_root):
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=STEP)
    jds = JaxDataset(synthetic_root, "train", bbox_sampling_step=STEP)
    jb = {k: v[0] for k, v in next(iter(JaxLoader(
        jds, batch_size=BATCH, shuffle=False, dense=True))).items()}
    # without its plan the JAX model takes the sparse branch silently
    assert jax_ew_of(jb) is not None and "nbr_idx" in jb
    pb = next(iter(PackedLoader(ds, batch_size=BATCH, ew_transpose=True,
                                dense=True)))
    jbatch = jax_finalize(jax.tree.map(jnp.asarray, jb))
    jm = JaxModel(n_classes=ds.n_classes, channels=WIDTH, sorted_edges=True,
                  remat=True)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda b: jm.init({"params": jax.random.key(0)}, b, train=True))(
            jbatch))
    raw = to_device(pb, "cpu")
    return dict(n_classes=ds.n_classes, variables=variables, jbatch=jbatch,
                raw=raw, tbatch=finalize_batch(raw))


def _layout(batch: dict, layout: str) -> dict:
    """The batch as the train step hands it to the model: the dense table
    only for the dense layout."""
    if layout == "dense":
        return batch
    return {k: v for k, v in batch.items() if k not in DENSE_KEYS}


def _frob(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    if not np.abs(ref).max() > 0:
        return float(np.abs(a).max())
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


# ---------------------------------------------------------------------------
# (i) against JAX with remat=True
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["sparse", "dense", "window"])
def test_remat_matches_jax_remat(setup, layout, checkpoints):
    window = layout == "window"
    jbatch = _layout(setup["jbatch"], layout)
    tbatch = _layout(setup["tbatch"], layout)
    assert (jax_ew_of(jbatch) is not None) and (
        ("nbr_idx" in jbatch) == (layout == "dense"))
    variables = setup["variables"]
    jm = JaxModel(n_classes=setup["n_classes"], channels=WIDTH,
                  sorted_edges=True, window_edges=window, remat=True)

    def loss_fn(params, batch):
        (logits, _), mut = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, mutable=["batch_stats"])
        return jax_loss(logits, batch["labels"],
                        batch["proposal_mask"])["loss"], mut

    (jloss, mut), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], jbatch)

    cfg = Config(n_classes=setup["n_classes"], n_filters=WIDTH, remat=True,
                 train_layout=layout)
    model = load_jax_variables(
        SparseCADGCN(setup["n_classes"], channels=WIDTH, window_edges=window,
                     remat=True), variables)
    loss = forward_loss(cfg, model, tbatch)["loss"]
    loss.backward()
    assert len(checkpoints) == CHECKPOINTS["gp2"]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = export_state_dict({"params": jax.tree.map(np.asarray, jgrads),
                              "batch_stats": variables["batch_stats"]})
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) <= set(want) and len(got) > 40
    for name, g in got.items():
        w = want[name]
        if np.abs(w).max() < 1e-4 and np.abs(g).max() < 1e-4:
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)
            continue
        np.testing.assert_allclose(g, w, rtol=1e-3,
                                   atol=5e-3 * np.abs(w).max(), err_msg=name)
    stats = export_state_dict({
        "params": variables["params"],
        "batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
    for name, v in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), stats[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# (ii) against the port with remat off
# ---------------------------------------------------------------------------


CASES = {
    "f32_sparse": dict(),
    "f32_dense": dict(train_layout="dense"),
    "f32_window": dict(train_layout="window"),
    "bf16_sparse": dict(dtype="bfloat16"),
    "bf16_dense": dict(dtype="bfloat16", train_layout="dense"),
    "bf16_window": dict(dtype="bfloat16", train_layout="window"),
    "f32_fused": dict(fused_head_train=True),
    "f32_edge": dict(conv="edge"),
}


def _step(cfg, batch):
    """forward_loss and backward of cfg's seeded model -> (loss, gradients,
    state dict after)."""
    model = seeded_model(cfg, seed=3)
    loss = forward_loss(cfg, model, prepare_batch(cfg, batch))["loss"]
    loss.backward()
    return (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
            model.state_dict())


@pytest.mark.parametrize("case", list(CASES))
def test_remat_matches_remat_off(setup, case, checkpoints):
    cfg = Config(n_classes=setup["n_classes"], n_filters=WIDTH, data_aug=False,
                 **CASES[case])
    batch = setup["raw"]
    off = _step(cfg, batch)
    assert not checkpoints
    on = _step(cfg.replace(remat=True), batch)
    kind = ("gp2_fused" if cfg.fused_head_train
            else "edge" if cfg.conv == "edge" else "gp2")
    assert len(checkpoints) == CHECKPOINTS[kind]
    assert abs(on[0].item() - off[0].item()) <= 1e-6 * abs(off[0].item())
    assert set(on[1]) == set(off[1])
    for name, g in off[1].items():
        assert _frob(on[1][name].float(), g.float()) <= 1e-6, name
    # the recompute moved no running statistic a second time
    for name, v in off[2].items():
        np.testing.assert_array_equal(on[2][name].numpy(), v.numpy(),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# (iii) structure
# ---------------------------------------------------------------------------


def _remat_mlps(model) -> list:
    return sorted(n for n, m in model.named_modules()
                  if isinstance(m, layers.MLP) and m.remat)


def test_state_dict_keys_and_checkpoints_interchange():
    for kw in (dict(), dict(fused_head_train=True), dict(conv="edge")):
        cfg = Config(n_filters=8, **kw)
        off = seeded_model(cfg, seed=1)
        on = seeded_model(cfg.replace(remat=True), seed=2)
        assert list(on.state_dict()) == list(off.state_dict())
        on.load_state_dict(off.state_dict(), strict=True)
        off.load_state_dict(seeded_model(cfg, seed=4).state_dict(),
                            strict=True)
        seeded_model(cfg, seed=5).load_state_dict(on.state_dict(),
                                                  strict=True)
    # what is wrapped: gp2's message MLPs and both fusion MLPs, nothing else
    assert _remat_mlps(build_model(Config(n_filters=8, remat=True))) == [
        "cls_net.backbone.0.body.gconv.nn", "cls_net.fusion_block",
        "cls_net.fusion_block_super", "cls_net.head.gconv.nn"]
    assert _remat_mlps(build_model(Config(n_filters=8, conv="edge",
                                          remat=True))) == [
        "cls_net.fusion_block", "cls_net.fusion_block_super"]
    assert not _remat_mlps(build_model(Config(n_filters=8)))


def test_remat_flag_parses():
    def cfg_of(argv):
        return config_from_args(build_parser().parse_args(argv), argv)

    assert cfg_of(["--remat", "true"]).remat is True
    assert cfg_of(["--remat", "0"]).remat is False
    assert cfg_of([]).remat is False


def test_yolat_pp_reads_no_remat(tiny_root, checkpoints):
    cfg = Config(arch="yolat_pp", n_filters=8, data_aug=False)
    on = build_model(cfg.replace(remat=True))
    assert list(on.state_dict()) == list(build_model(cfg).state_dict())
    assert not _remat_mlps(on)
    ds = SESYDDataset(tiny_root, "train", bbox_sampling_step=STEP)
    cfg = cfg.replace(n_classes=ds.n_classes, remat=True)
    pb = next(iter(PackedLoader(ds, batch_size=1, prefetch=0,
                                **train_plans_for(cfg))))
    model = seeded_model(cfg, seed=1)
    loss = forward_loss(cfg, model, prepare_batch(cfg, to_device(pb, "cpu")))
    loss["loss"].backward()
    assert np.isfinite(loss["loss"].item()) and not checkpoints


def test_eval_and_no_grad_checkpoint_nothing(setup, checkpoints):
    cfg = Config(n_classes=setup["n_classes"], n_filters=WIDTH, remat=True)
    model = seeded_model(cfg, seed=1)  # eval mode
    batch = _layout(setup["tbatch"], "sparse")
    plain = seeded_model(cfg.replace(remat=False), seed=1)
    logits, _ = model(batch)
    assert torch.equal(logits, plain(batch)[0])
    with torch.no_grad():
        model.train()(batch)
    assert not checkpoints
    model(batch)
    assert len(checkpoints) == CHECKPOINTS["gp2"]


def test_dropout_is_refused_under_remat():
    with pytest.raises(ValueError, match="no dropout"):
        layers.MLP([8, 8], drop=0.1, remat=True)
    assert layers.MLP([8, 8], drop=0.1).drop == 0.1


# ---------------------------------------------------------------------------
# (iv) data parallel
# ---------------------------------------------------------------------------


def _same(a, b, skip=()) -> None:
    assert a[0] == b[0]
    for k, v in b[1].items():
        if not k.endswith(skip):
            np.testing.assert_array_equal(a[1][k], v, err_msg=k)


def test_dp_remat_matches_remat_off(dp_runs):
    r0, r1 = ranks = dp_runs.result()
    assert r0["n_images"] == [1, 1] and r1["n_images"] == [1, 0]
    _same(r0["gp2_remat"]["dp"], r1["gp2_remat"]["dp"])  # one state
    for rank in ranks:
        _same(rank["gp2_remat"]["dp"], rank["gp2"]["dp"])
        for name, n in DP_COLLECTIVES.items():
            assert rank[name]["collectives"]["dp"] == n * DP_STEPS, name
    # identical shards against the single-device remat-off step
    ident, single = r0["gp2_remat"]["identical"], r0["gp2"]["single"]
    _same(ident, single, skip="running_var")
    for k, v in single[1].items():
        if k.endswith("running_var"):
            np.testing.assert_allclose(ident[1][k], v, rtol=1e-2, err_msg=k)
    assert r0["gp2"]["collectives"]["single"] == 0
