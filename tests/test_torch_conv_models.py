"""The port's SparseCADGCN with each of the twelve other convs of
`make_conv` against yolat_tpu's, on the CPU, and the surface around them:
`build_model` for all thirteen names at the canonical widths, the `.pth`
round trip per conv, every refusal of a flag combination, and the train
CLI on `--conv gat --act leakyrelu` restored and evaluated by the test
CLI.

Parity runs at 16 channels and 3 blocks (so the residual of the
single-stream Backbone runs), on one small image (500x400, 2 rooms) of a
synthetic dataset packed by each package's own host stage (the batches'
x equal), whose node
features x and edge attributes get the same seeded noise (0.1) in both
packages: the floorplan's repeated primitives give bitwise-equal feature
rows, exact ties in the node max pool whose compare-form gradient moves a
whole cotangent when rounding breaks one. The JAX variables come from
`jax.eval_shape` of the JAX init filled from a numpy seed (Kaiming scale,
BatchNorm statistics and affine terms away from the identity, so eval
mode is not train mode), and cross through `load_jax_variables`.
Tolerances (`tests/test_torch_model.py`, `tests/test_torch_train.py`,
`tests/torch_pp_train_common.py`):
  * logits, train and eval mode: rtol/atol 1e-4 at f32;
  * the loss: rtol 1e-5;
  * BatchNorm running statistics after the step: rtol 1e-4, atol 1e-5;
  * gradients of every parameter, through a float64 run of the port:
    with random weights in train mode these f32 gradients are
    ill-conditioned (ReLU gates and max-pool winners that rounding flips
    move entries by a whole cotangent; train-mode BatchNorm and SAGE's L2
    norm amplify the rest), so each f32 gradient is held to the port's
    float64 one by its relative Frobenius error per tensor, GRAD_TOL =
    3e-2, after `tests/torch_pp_train_common.py`, and so are the port's
    own f32 gradients; for gcn and gat (act, then BatchNorm:
    `TIE_PRONE`) f32 rounding decides the node max pool's ties on both
    packages, so their tensors before the pool are held at three times
    the port's own f32 error where that is larger (gcn's first-conv bias
    read 2.2 times), the tensors after it at GRAD_TOL; a tensor whose
    gradient is below 1e-4 on both sides (a Dense bias feeding a
    BatchNorm) at atol 1e-4.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.packing import finalize_batch as jax_finalize
from yolat_tpu.data.synthetic import write_dataset
from yolat_tpu.nn.model import SparseCADGCN as JaxModel
from yolat_tpu.nn.model import detection_loss as jax_loss
from yolat_tpu_torch.cli import infer as infer_cli
from yolat_tpu_torch.cli import test as test_cli
from yolat_tpu_torch.cli import train as train_cli
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader
from yolat_tpu_torch.data.packing import finalize_batch, to_device
from yolat_tpu_torch.nn.conv import CONV_NAMES
from yolat_tpu_torch.nn.model import (SparseCADGCN, build_model,
                                      detection_loss, load_jax_variables,
                                      load_reference_checkpoint,
                                      seeded_model)
from yolat_tpu_torch.nn.state_dict import export_state_dict
from yolat_tpu_torch.train.checkpoint import save_reference_checkpoint

WIDTH, BLOCKS = 16, 3
CONVS = CONV_NAMES[1:]
# (conv, act, norm): each conv at the defaults (the other activations
# and norms are held MLP by MLP in tests/test_torch_convs.py)
CASES = [(c, "relu", "batch") for c in CONVS]
# act -> BatchNorm convs: rows the activation zeroes share one value after
# the norm, so the node max pool has exact ties in many (proposal,
# channel) pairs (5309 of 19968 in cat for gcn on this batch; 0 for edge)
# and the compare-form max VJP gives each tied row the whole cotangent: a
# pre-activation that rounding puts on the other side of zero moves a
# row in or out of a tie and the gradient by a whole cotangent. Both f32
# runs then stand as far from the float64 gradient as each other (38% for
# the fusion BN shift of gcn)
TIE_PRONE = ("gcn", "gat")
# relative Frobenius error of an f32 gradient against the port's float64
# one (read <= 2.5e-2: JAX's f32 SAGE first-conv gradient; the port's own
# f32 gradients <= 1e-2 outside TIE_PRONE)
GRAD_TOL = 3e-2
# the tensors after the node max pool: their gradients see the pooled
# values, not which rows won
AFTER_POOL = ("prediction_cls.", "cls_net.fusion_block_super.")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: under pytest-xdist
    with several workers on one host, torch's default thread pool per
    worker oversubscribes the cores (the CLI test of
    `tests/test_torch_conv_models.py` read 16 times its one-process time
    with six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """Two small floorplans to train on and one to test (500x400, 2 rooms):
    a batch of one has ~2k node rows, so the eager JAX gradients stay
    cheap."""
    root = str(tmp_path_factory.mktemp("conv_zoo"))
    write_dataset(root, n_train=2, n_test=1, seed=3, width=500.0,
                  height=400.0, n_rooms=2, symbols_per_room=(1, 2))
    return root


@pytest.fixture(scope="module")
def batches(tiny_root):
    ds = SESYDDataset(tiny_root, "train", bbox_sampling_step=10)
    jds = JaxDataset(tiny_root, "train", bbox_sampling_step=10)
    pb = next(iter(PackedLoader(ds, batch_size=1)))
    jb = next(iter(JaxLoader(jds, batch_size=1, shuffle=False)))
    jbatch = jax_finalize(jax.tree.map(jnp.asarray,
                                       {k: v[0] for k, v in jb.items()}))
    tbatch = finalize_batch(to_device(pb, "cpu"))
    np.testing.assert_array_equal(tbatch["x"].numpy(), np.asarray(jbatch["x"]))
    rng = np.random.default_rng(7)
    for k in ("x", "e_attr"):
        noisy = tbatch[k].numpy() + rng.normal(
            size=tbatch[k].shape).astype(np.float32) * 0.1
        tbatch[k] = torch.from_numpy(noisy)
        jbatch[k] = jnp.asarray(noisy)
    return ds.n_classes, tbatch, jbatch


def _fill(shapes, seed):
    """Numpy values for a tree of ShapeDtypeStructs: Kaiming-normal
    kernels, biases and BatchNorm terms near their init, running
    statistics away from it, scalars (GIN's eps, GEN's t) near theirs."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel" or name in ("a_src", "a_dst"):
            fan_in = shape[-2] if len(shape) > 1 else 1
            return (rng.normal(size=shape) * np.sqrt(2.0 / fan_in)).astype(
                np.float32)
        if name == "mean":
            return (rng.normal(size=shape) * 0.5).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.normal(size=shape) * 0.1).astype(np.float32)
        if name == "t":
            return np.asarray(1.2, np.float32)
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_run(jm, variables, jbatch):
    """(loss, train logits, batch_stats after the step, gradients, eval
    logits) of the JAX model in one jitted call that takes the batch as
    an argument, as the JAX train step does: with the batch closed over
    as a constant, or at XLA's optimisation level 0, the JAX model's
    first-conv gradients part from its eager ones by 20-77% on this
    batch (cause unknown), while with it as an argument they agree with
    the eager ones and with the port's f32 and float64 gradients."""
    stats = variables.get("batch_stats", {})

    def loss_fn(params, b):
        (logits, _), mut = jm.apply({"params": params, "batch_stats": stats},
                                    b, train=True, mutable=["batch_stats"])
        loss = jax_loss(logits, b["labels"], b["proposal_mask"])["loss"]
        return loss, (logits, mut.get("batch_stats", {}))

    def run(params, b):
        (loss, (logits, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, b)
        eval_logits, _ = jm.apply({"params": params, "batch_stats": stats},
                                  b, train=False)
        return loss, logits, new_stats, grads, eval_logits

    return jax.tree.map(np.asarray,
                        jax.jit(run)(variables["params"], jbatch))


def _frob(a, ref) -> float:
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def _float64_grads(model, batch):
    """The detection loss's gradients with the module and the float batch
    fields in float64 (the weights are the f32 model's; in train mode the
    running statistics do not enter)."""
    m64 = copy.deepcopy(model).double()
    m64.zero_grad()
    b64 = {k: (v.double() if torch.is_tensor(v) and v.dtype == torch.float32
               else v) for k, v in batch.items()}
    logits = m64.train()(b64)[0]
    detection_loss(logits, batch["labels"],
                   batch["proposal_mask"])["loss"].backward()
    return {n: p.grad.numpy() for n, p in m64.named_parameters()}


@pytest.mark.parametrize("conv,act,norm", CASES)
def test_model_matches_jax(batches, conv, act, norm):
    n_classes, tbatch, jbatch = batches
    jm = JaxModel(n_classes=n_classes, channels=WIDTH, n_blocks=BLOCKS,
                  conv=conv, act=act, norm=norm, sorted_edges=True)
    shapes = jax.eval_shape(lambda b: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)}, b,
        train=True), jbatch)
    variables = _fill(shapes, seed=len(conv))
    loss, logits, new_stats, grads, eval_logits = _jax_run(jm, variables,
                                                           jbatch)
    model = load_jax_variables(
        SparseCADGCN(n_classes, channels=WIDTH, n_blocks=BLOCKS, conv=conv,
                     act=act, norm=norm), variables)
    m = tbatch["proposal_mask"].numpy()
    assert m.sum() > 10
    with torch.no_grad():
        got_eval = model.eval()(tbatch)[0].numpy()
    np.testing.assert_allclose(got_eval[m], eval_logits[m], rtol=1e-4,
                               atol=1e-4, err_msg="eval logits")
    got_logits = model.train()(tbatch)[0]
    got_loss = detection_loss(got_logits, tbatch["labels"],
                              tbatch["proposal_mask"])["loss"]
    got_loss.backward()
    np.testing.assert_allclose(got_logits.detach().numpy()[m], logits[m],
                               rtol=1e-4, atol=1e-4, err_msg="train logits")
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-5)

    def export(params, stats):
        return export_state_dict({"params": params, "batch_stats": stats},
                                 n_blocks=BLOCKS, conv=conv, act=act)

    want = export(grads, variables.get("batch_stats", {}))
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    got64 = _float64_grads(model, tbatch)
    assert set(got) == set(got64) <= set(want)
    for name, g64 in got64.items():
        w = want[name].reshape(g64.shape)
        if np.abs(w).max() < 1e-4 and np.abs(g64).max() < 1e-4:
            np.testing.assert_allclose(g64, w, atol=1e-4, err_msg=name)
            continue
        own = _frob(got[name], g64)
        # f32 rounding decides the pool's ties of gcn and gat, upstream of
        # the node max pool
        tied = conv in TIE_PRONE and not name.startswith(AFTER_POOL)
        limit = max(GRAD_TOL, 3 * own) if tied else GRAD_TOL
        assert _frob(w, g64) <= limit, (name, _frob(w, g64), own)
        assert own <= GRAD_TOL or tied, (name, own)
    stats = export(variables["params"], new_stats)
    moved = [n for n in stats if n.endswith("running_var")]
    assert moved or norm != "batch"
    for name, v in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), stats[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("conv", CONV_NAMES)
def test_build_model_builds_every_conv_at_full_width(conv):
    model = build_model(Config(conv=conv))
    assert model.cls_net.conv == conv and len(model.cls_net.backbone) == 1
    n = sum(p.numel() for p in model.parameters())
    assert 1.5e6 < n < 1.8e6, n  # the 1024-wide fusion and head dominate
    sd = model.state_dict()
    assert "cls_net.head.gconv" in next(iter(sd)) or any(
        k.startswith("cls_net.head.gconv.") for k in sd)
    assert "prediction_cls.2.0.weight" in sd


@pytest.mark.parametrize("conv", CONVS)
def test_pth_round_trip(conv, tmp_path):
    cfg = Config(conv=conv, n_filters=WIDTH, n_blocks=BLOCKS, n_classes=5)
    model = seeded_model(cfg, seed=3)
    with torch.no_grad():  # the conv's own parameters away from their init
        for name, p in model.named_parameters():
            if p.dim() == 0 or "a_src" in name:
                p.add_(0.25)
    path = str(tmp_path / "m.pth")
    save_reference_checkpoint(model, path)
    back = load_reference_checkpoint(build_model(cfg), path)
    want, got = model.state_dict(), back.state_dict()
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_canonical_keys_are_unchanged():
    """The defaults' Sequential indices: BatchNorm at 3k + 1, the bare
    classifier's Linear at k."""
    sd = build_model(Config(n_filters=WIDTH)).state_dict()
    for k in ("cls_net.head.gconv.nn.3.weight",
              "cls_net.head.gconv.nn.4.running_var",
              "cls_net.head.gconv.mlp_node.1.running_mean",
              "cls_net.fusion_block.1.weight",
              "prediction_cls.1.1.bias", "prediction_cls.2.0.weight"):
        assert k in sd, k
    assert not any(".2.weight" in k for k in sd if "fusion_block" in k)


def test_other_mlps_take_their_indices():
    sd = build_model(Config(conv="sage", act="gelu", norm="layer",
                            n_filters=WIDTH)).state_dict()
    assert "cls_net.fusion_block.1.weight" in sd  # LayerNorm
    assert "cls_net.fusion_block.1.running_mean" not in sd
    sd = build_model(Config(conv="gin", norm="none",
                            n_filters=WIDTH)).state_dict()
    assert "prediction_cls.0.0.weight" in sd
    assert not any(k.startswith("prediction_cls.0.1") for k in sd)
    assert "cls_net.head.gconv.eps" in sd


REFUSALS = [
    (dict(conv="edge", train_layout="window"), "train_layout window"),
    (dict(conv="gcn", train_layout="dense"), "train_layout dense"),
    (dict(conv="gin", train_layout="dense"), "train_layout dense"),
    (dict(conv="sage", train_layout="dense"), "train_layout dense"),
    (dict(conv="rsage", train_layout="dense"), "train_layout dense"),
    (dict(conv="gat", train_layout="dense"), "train_layout dense"),
    (dict(conv="gen", dense_layout=True), "dense_layout true"),
    (dict(fused_head_train=True, act="gelu"), "fused_head_train"),
    (dict(fused_head_train=True, norm="layer"), "fused_head_train"),
    # YOLaT++ takes every act and norm; another conv stays refused under
    # them
    (dict(arch="yolat_pp", act="leakyrelu", conv="gat"), "arch yolat_pp"),
    (dict(arch="yolat_pp", norm="layer", conv="sage"), "arch yolat_pp"),
    (dict(arch="yolat_pp", conv="edge"), "arch yolat_pp"),
    (dict(conv="dyn_edge"), "conv 'dyn_edge'"),
    (dict(act="swish"), "act 'swish'"),
    (dict(norm="instance"), "norm 'instance'"),
]


@pytest.mark.parametrize("kw,flag", REFUSALS)
def test_build_model_refuses(kw, flag):
    with pytest.raises((ValueError, NotImplementedError), match=flag):
        build_model(Config(n_filters=8, **kw))


def test_dense_convs_take_the_table():
    for conv in ("attr_edge_cf", "mr"):
        build_model(Config(conv=conv, train_layout="dense", n_filters=8))


def _argv(root, *extra):
    return ["--data_dir", root, "--device", "cpu", "--n_filters", "8",
            "--batch_size", "2", "--bbox_sampling_step", "10", *extra]


@pytest.mark.parametrize("mode,flags", [
    ("fast", ["--conv", "edge"]),
    ("fast_bf16", ["--act", "gelu"]),
    ("fast", ["--norm", "layer"]),
])
def test_test_cli_refuses_fast_serving(synthetic_root, mode, flags):
    with pytest.raises(ValueError, match=f"--serve_mode {mode}"):
        test_cli.main(_argv(synthetic_root, "--pretrained_model", "x",
                            "--serve_mode", mode, *flags))


def test_test_cli_refuses_the_dense_table(synthetic_root):
    with pytest.raises(ValueError, match="dense_layout true"):
        test_cli.main(_argv(synthetic_root, "--pretrained_model", "x",
                            "--conv", "gat", "--dense_layout", "true"))


def test_infer_and_detect_refuse_fast_serving(synthetic_root, tmp_path):
    from yolat_tpu_torch.cli import detect as detect_cli

    with pytest.raises(ValueError, match="--serve_mode fast_bf16"):
        infer_cli.main(["--data_dir", synthetic_root, "--device", "cpu",
                        "--pretrained_model", "x.pth", "--conv", "gcn",
                        "--out", str(tmp_path / "o.jsonl")])
    with pytest.raises(ValueError, match="--serve_mode fast"):
        detect_cli.detect(_argv(synthetic_root, "--pretrained_model", "x",
                                "--serve_mode", "fast", "--act",
                                "leakyrelu", "--out_dir", str(tmp_path)),
                          render=None)


def test_train_cli_refuses_other_graphs(synthetic_root, tmp_path):
    with pytest.raises(NotImplementedError, match="--graph bezier_cc"):
        train_cli.main(_argv(synthetic_root, "--graph", "bezier_cc",
                             "--root_dir", str(tmp_path)))


def test_unread_flags_are_carried(synthetic_root):
    argv = _argv(synthetic_root, "--bias", "false", "--k", "9",
                 "--epsilon", "0.3", "--stochastic", "false",
                 "--pos_edge_th", "0.01")
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(argv),
                                     argv)
    assert (cfg.bias, cfg.k, cfg.epsilon, cfg.stochastic, cfg.pos_edge_th) \
        == (False, 9, 0.3, False, 0.01)
    # nothing in the port reads them (k, epsilon, stochastic wait for the
    # kNN blocks), as nothing in the JAX package does
    pkg = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "yolat_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                for field in ("bias", "k", "epsilon", "stochastic",
                              "pos_edge_th"):
                    assert f"cfg.{field}\n" not in src
                    assert f"cfg.{field})" not in src
                    assert f"cfg.{field}," not in src


def test_train_cli_gat_leakyrelu_then_test_cli(tiny_root, tmp_path):
    """A few CPU steps of `cli.train --conv gat --act leakyrelu`; `cli.test`
    restores the last checkpoint (flax) with the same flags and evaluates
    it; the restored weights are the trained ones."""
    flags = ["--conv", "gat", "--act", "leakyrelu", "--n_blocks", "2"]
    res = train_cli.main(_argv(tiny_root, "--root_dir", str(tmp_path),
                               "--max_steps", "3", "--total_epochs", "3",
                               "--eval_start", "1", "--print_freq", "1",
                               *flags))
    assert res["steps"] == 3 and all(np.isfinite(res["losses"]))
    ckpt = os.path.join(res["exp_dir"], "checkpoint")
    last = sorted(f for f in os.listdir(ckpt) if f.startswith("ckpt_")
                  and f != "ckpt_best.pt")[-1][:-3]
    table = test_cli.main(_argv(tiny_root, "--phase", "test",
                                "--pretrained_model",
                                os.path.join(ckpt, last), *flags))
    assert len(table["map_per_th"]) == 10
    assert all(np.isfinite(table["map_per_th"]))
    assert np.isfinite(table["top1_acc"])
    model, _, _ = test_cli.load_checkpoint(
        train_cli.config_from_args(train_cli.build_parser().parse_args(
            _argv(tiny_root, "--pretrained_model",
                  os.path.join(ckpt, last), *flags)), []).replace(
            n_classes=SESYDDataset(tiny_root).n_classes), "cpu")
    assert model.cls_net.head.gconv.lin.weight.shape == (8, 5)
    fresh = build_model(Config(conv="gat", act="leakyrelu", n_filters=8,
                               n_classes=model.prediction_cls[2][0]
                               .weight.shape[0]))
    assert any(not torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), fresh.state_dict().values()))
