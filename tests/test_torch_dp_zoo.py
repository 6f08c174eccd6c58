"""The port's data-parallel train step with other convs than gp2, and with
YOLaT++ under another activation, against yolat_tpu's on the CPU.

Cases, each at width 8, f32, SGD (lr 1e-2) for 2 steps:
  * gat under --act leakyrelu (its activation, then BatchNorm);
  * gen (MsgNorm and a learned t, no BatchNorm in its MLP);
  * attr_edge_cf (8 octant MLPs, BatchNorm statistics over every edge);
  * edge under --norm layer (LayerNorm: nothing to sync but the fusion
    and head MLPs' LayerNorms, which hold no statistics);
  * YOLaT++ under --act leakyrelu --norm batch (every hierarchy, fusion
    and head BatchNorm synced; the gp2 convs ReLU);
  * edge under --fused_head_train true (kernels 3 and 11, their plain
    versions here, with the moments and u-sums summed over ranks).
JAX runs `make_dp_train_step` on a 2-device slice of the 8-device CPU
mesh (tests/conftest.py); the port runs `make_dp_train_step` in 2 rank
processes over gloo, all cases in one spawn (`parallel/launch.spawn_ranks`,
a FileStore, a 60 s group timeout, a 120 s join timeout: a hang fails this
file, not the run). Both take a small synthetic train split (3 files of
500x400, bbox_sampling_step 5) through their own loaders at batch 1 over 2 devices, unshuffled: step 1 gives the
ranks distinct files, step 2 the third file to rank 0 and an empty window
to rank 1. Weights start in JAX and cross through `load_jax_variables`.
data_aug off, dropout 0. Both packages' batches get the same seeded
noise on pos and e_attr of the real rows, as tests/test_torch_conv_models.py's
batch gets it on x and e_attr, to part the bit-equal rows of repeated
primitives (`_noise`). Every case runs under JAX: none needs
the single-device fallback.

Tolerances: the losses of both steps rtol 1e-5 and the running
statistics rtol 1e-4, atol 1e-5, as tests/test_torch_dp_train.py holds
gp2. The parameters: the 2-step SGD update of each tensor (lr times the
summed averaged gradients) by tests/test_torch_conv_models.py's float64
rule for the zoo's f32 gradients, since these f32 updates are
ill-conditioned on both sides: JAX's f32 update and the port's f32
update each within a relative Frobenius error of GRAD_TOL = 3e-2 per
tensor of the port's float64 DP update ('dp64'; read on this split: JAX
<= 1.5e-2 on gat, <= 3.7e-3 elsewhere, the port <= 6.7e-3), and a tensor
whose update stays below 2e-6 on both sides (a Dense bias feeding a
BatchNorm) at atol 2e-6. On the synthetic split at bbox step 10,
tests/test_torch_dp_train.py's direct rule (rtol 1e-3 over 5e-3 of the
largest update) parted JAX from the port in a few entries of gat,
attr_edge_cf and YOLaT++ (gate_point by 2.4%), as it parted JAX from
the float64 run. gat runs under --act leakyrelu: under relu the rows its
activation zeroes tie in the node max pool after the BatchNorm
(`TIE_PRONE` in tests/test_torch_conv_models.py). Identical shards on 2
ranks against the port's single-device step: bit for bit, losses and
state, but the running variances (the unbiased correction of the global
count, as `test_identical_shards_equal_one_device` of
tests/test_torch_dp_train.py states; rtol 1e-2 here, where a BatchNorm
may see 91 rows: see that test). A planted plain `dist.all_reduce`
(no backward) in MaskedBatchNorm must fail gat's comparison.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import torch_dp_zoo_ranks
from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.synthetic import write_dataset
from yolat_tpu.train.config import Config as JaxConfig
from yolat_tpu.train.loop import create_state
from yolat_tpu.train.loop import make_dp_train_step as jax_dp_step
from yolat_tpu_torch.nn.model import build_model, load_jax_variables
from yolat_tpu_torch.parallel.launch import spawn_ranks

WIDTH = 8
LR = 1e-2
STEPS = 2
WORLD = 2
STEP = 5  # bbox_sampling_step: ~100 proposals, 2048 node rows an image
JOIN_TIMEOUT_S = 120.0
# tests/test_torch_conv_models.py's float64 rule: relative Frobenius error
# of an f32 update against the port's float64 one
GRAD_TOL = 3e-2
CASES = {
    "gat": dict(conv="gat", act="leakyrelu"),
    "gen": dict(conv="gen"),
    "attr_edge_cf": dict(conv="attr_edge_cf"),
    "edge_layer": dict(conv="edge", norm="layer"),
    "pp_leakyrelu": dict(arch="yolat_pp", act="leakyrelu", norm="batch"),
    "edge_fused": dict(conv="edge", fused_head_train=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread in the test process (its torch work is the
    weight conversion), as tests/test_torch_conv_models.py; the ranks set
    their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_state(case: dict, variables) -> dict:
    model = load_jax_variables(
        build_model(torch_dp_zoo_ranks.case_config(case)),
        jax.tree.map(np.asarray, variables))
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


def _noise(jbs) -> list:
    """Per step {'pos', 'e_attr': [W, ...] seeded noise on the real rows
    (0.01 on pos in [0, 1], from which the model input x is made; 1e-3 on
    e_attr, whose entries reach 0.03)}, after
    tests/test_torch_conv_models.py's noise on x and e_attr: the
    floorplan's repeated primitives give bit-equal feature rows, exact
    ties in the node max pool, and the two packages' f32 rounding breaks
    some of them apart differently (without it gen, attr_edge_cf, gat and
    the fused head each part from JAX in 1-2 entries of a tensor)."""
    rng = np.random.default_rng(7)
    out = []
    for jb in jbs:
        out.append({k: (scale * rng.normal(size=jb[k].shape)
                        * jb[m][..., None]).astype(np.float32)
                    for k, m, scale in (("pos", "node_mask", 1e-2),
                                        ("e_attr", "edge_mask", 1e-3))})
    return out


def _variables(state) -> dict:
    return {"params": state.params, "batch_stats": state.batch_stats}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """Three small floorplans to train on (500x400, 2 rooms, as
    tests/test_torch_conv_models.py's): at STEP a batch of one has 2048
    node rows, so the ranks' 46 steps stay well inside the join
    timeout."""
    root = str(tmp_path_factory.mktemp("dp_zoo"))
    write_dataset(root, n_train=3, n_test=1, seed=3, width=500.0,
                  height=400.0, n_rooms=2, symbols_per_room=(1, 2))
    return root


@pytest.fixture(scope="module")
def runs(tiny_root):
    jds = JaxDataset(tiny_root, "train", bbox_sampling_step=STEP)
    n_classes = jds.n_classes
    shards = {}
    cases, states, jax_setups = {}, {}, {}
    for name, model_kw in CASES.items():
        extra = ("super",) if model_kw.get("arch") == "yolat_pp" else ()
        if extra not in shards:
            shards[extra] = list(JaxLoader(jds, batch_size=1,
                                           n_devices=WORLD, shuffle=False,
                                           prefetch=0, extra_plans=extra))
        jbs = shards[extra]
        assert len(jbs) == STEPS
        assert [int(n) for n in jbs[1]["n_images"]] == [1, 0]
        noise = _noise(jbs)
        jbs = [{**jb, **{k: jb[k] + v for k, v in nz.items()}}
               for jb, nz in zip(jbs, noise)]
        jcfg = JaxConfig(n_classes=n_classes, n_filters=WIDTH,
                         data_aug=False, **model_kw)
        tx = optax.sgd(LR)
        state = create_state(jcfg, tx, {k: v[0] for k, v in jbs[0].items()},
                             jax.random.key(0))
        cases[name] = dict(n_classes=n_classes, width=WIDTH, lr=LR,
                           model=model_kw, steps=STEPS, noise=noise)
        states[name] = _port_state(cases[name], _variables(state))
        jax_setups[name] = (jcfg, tx, state, jbs)
    cases["gat_fault"] = dict(cases["gat"], fault=True)
    states["gat_fault"] = states["gat"]

    def jax_run(jcfg, tx, state, jbs, case):
        step = jax_dp_step(jcfg, tx, Mesh(np.array(jax.devices()[:WORLD]),
                                          ("data",)))
        losses = []
        for jb in jbs[:STEPS]:
            state, m = step(state, jb, jax.random.key(1))
            losses.append(float(m["loss"]))
        return losses, _port_state(case, _variables(state))

    # the ranks run while JAX steps here
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn_ranks, torch_dp_zoo_ranks.zoo_scenarios,
                           WORLD, (tiny_root, WORLD, cases, states, "cpu",
                                   STEP),
                           join_timeout_s=JOIN_TIMEOUT_S)
        want = {name: jax_run(*jax_setups[name], cases[name])
                for name in CASES}
        ranks = port.result()
    return dict(jax=want, states=states, ranks=ranks)


def _frob(a, ref) -> float:
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def _hold(got: dict, got64: dict, want: dict, start: dict) -> None:
    """The rule of the module docstring: the running statistics directly;
    each parameter's 2-step update, JAX's f32 one and the port's f32 one,
    against the port's float64 one."""
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
            continue
        dw, d64 = w - start[name], got64[name] - start[name]
        if np.abs(dw).max() < 2e-6 and np.abs(d64).max() < 2e-6:
            np.testing.assert_allclose(d64, dw, atol=2e-6, err_msg=name)
            continue
        assert _frob(dw, d64) <= GRAD_TOL, (name, _frob(dw, d64))
        own = _frob(got[name] - start[name], d64)
        assert own <= GRAD_TOL, (name, own)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_jax(runs, name):
    want_losses, want = runs["jax"][name]
    for rank_out in runs["ranks"]:
        losses, got, _ = rank_out[name]["dp"]
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        _hold(got, rank_out[name]["dp64"][1], want, runs["states"][name])


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_one_state(runs, name):
    r0, r1 = (r[name]["dp"] for r in runs["ranks"])
    assert r0[0] == r1[0]
    for k, v in r0[1].items():
        np.testing.assert_array_equal(v, r1[1][k], err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_identical_shards_equal_one_device(runs, name):
    """As tests/test_torch_dp_train.py's test of the same name: bit for
    bit but the running variances, which take the unbiased correction of
    the global count, 2n / (2n - 1) for n / (n - 1). The head's
    BatchNorms normalise over one image's proposals, 91 and 113 at STEP,
    so over 2 steps the running variance parts by about 0.19 v / 2n, v
    the batch variance: rtol 1e-2 (read <= 2.5e-3)."""
    single_losses, want, _ = runs["ranks"][0][name]["single"]
    for rank_out in runs["ranks"]:
        losses, got, _ = rank_out[name]["identical"]
        assert losses == single_losses
        for k, v in want.items():
            if k.endswith("running_var"):
                np.testing.assert_allclose(got[k], v, rtol=1e-2, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_what_each_case_syncs(runs):
    """The fused case ran its head on the plain versions of kernels 3 and
    11 (CPU tensors: no launch); the LayerNorm and GEN cases hold the
    BatchNorms of the convs and MLPs that have one."""
    states = runs["states"]
    assert any(k.startswith("cls_net.fusion_block.1.running")
               for k in states["edge_fused"])
    assert not any(k.startswith("cls_net.fusion_block.1.running")
                   for k in states["edge_layer"])
    assert any(k.startswith("super_node_mlp.1.running")
               for k in states["pp_leakyrelu"])
    for name in CASES:
        assert runs["ranks"][0][name]["dp"][2] == (0, 0)
    assert runs["ranks"][0]["n_images"] == [1, 1]
    assert runs["ranks"][1]["n_images"] == [1, 0]


def test_planted_plain_all_reduce_fails(runs):
    """The same comparison on the faulted run must fail (its updates read
    3 to 1e7 times JAX's in relative Frobenius error); on the true run it
    passes (test_dp_step_matches_jax)."""
    losses, got, _ = runs["ranks"][0]["gat_fault"]["dp"]
    want_losses, want = runs["jax"]["gat"]
    np.testing.assert_allclose(losses[0], want_losses[0], rtol=1e-5)
    with pytest.raises(AssertionError):
        _hold(got, runs["ranks"][0]["gat"]["dp64"][1], want,
              runs["states"]["gat"])
