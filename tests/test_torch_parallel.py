"""The port's `parallel/` and the loader's data-parallel schedule against
yolat_tpu's on the CPU.

  * the loader: for (n_devices, host_id, n_hosts) in (2, 0, 1), (2, 0, 2),
    (2, 1, 2), (3, 0, 1), shuffled, over 2 epochs, rank r's batches equal
    row r of the JAX loader's stacked batches (the arrays both packages
    pack, bit for bit; an empty window an all-masked batch on both sides),
    host only;
  * the partition helpers: `random_partition_graph` and
    `generate_sub_graphs` equal to the JAX functions; `sharded_segment_sum`
    / `_mean` and `edge_sharded_gp2_layer` in 2 rank processes over gloo
    (`parallel/launch.spawn_ranks`, 60 s group timeout, 120 s join
    timeout) against the JAX functions in shard_map on 2 devices of the
    CPU mesh (tests/test_parallel.py:41-138), rtol 1e-5 / atol 1e-5 for
    the sums and 1e-4 / 1e-5 for the mean and the layer (the JAX tests'
    limits against their numpy references); the sums' gradient sums the
    ranks' cotangents;
  * the rank helpers: `replicate` gives every rank rank 0's values,
    `make_mesh` the world group or a smaller one; `shard_leading_axis`;
    `local_device_count`'s and the coordinator's errors; and
    `set_sync_group` sets every BatchNorm of both detectors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dp_ranks
from yolat_tpu.data.dataset import PackedLoader as JaxLoader
from yolat_tpu.data.dataset import SESYDDataset as JaxDataset
from yolat_tpu.data.dataset import stack_shards as jax_stack_shards
from yolat_tpu.parallel import partition as jax_partition
from yolat_tpu.parallel.mesh import make_mesh as jax_make_mesh
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader, stack_shards
from yolat_tpu_torch.nn.layers import MaskedBatchNorm
from yolat_tpu_torch.nn.model import build_model
from yolat_tpu_torch.ops.plans import pad_plans
from yolat_tpu_torch.parallel import partition
from yolat_tpu_torch.parallel.distributed import (initialize_from_config,
                                                  local_device_count,
                                                  parse_coordinator)
from yolat_tpu_torch.parallel.launch import spawn_ranks
from yolat_tpu_torch.parallel.mesh import set_sync_group, shard_leading_axis

WORLD = 2
# the arrays both packages pack (tests/test_torch_packing.py holds the rest)
KEYS = ("pos", "node_mask", "edge", "edge_mask", "labels", "proposal_mask",
        "image_id", "gt_bbox", "n_images")


@pytest.mark.parametrize("n_devices,host_id,n_hosts",
                         [(2, 0, 1), (2, 0, 2), (2, 1, 2), (3, 0, 1)])
def test_loader_windows_match_jax(synthetic_root, n_devices, host_id,
                                  n_hosts):
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    jds = JaxDataset(synthetic_root, "train", bbox_sampling_step=10)
    kw = dict(batch_size=1, n_devices=n_devices, shuffle=True, seed=3,
              host_id=host_id, n_hosts=n_hosts, prefetch=0)
    jax_loader = JaxLoader(jds, **kw)
    ports = [PackedLoader(ds, rank=r, **kw) for r in range(n_devices)]
    assert all(len(p) == len(jax_loader) for p in ports)
    for _ in range(2):  # epochs: a new shuffle each
        want = list(jax_loader)
        got = [list(p) for p in ports]
        assert [len(g) for g in got] == [len(want)] * n_devices
        assert len(want) == len(jax_loader)
        for step, stacked in enumerate(want):
            for r in range(n_devices):
                for k in KEYS:
                    np.testing.assert_array_equal(got[r][step][k],
                                                  stacked[k][r],
                                                  err_msg=(step, r, k))
    if n_devices == 3:  # 3 files, one step: every window holds one file
        assert [int(g[0]["n_images"]) for g in got] == [1, 1, 1]


def test_empty_window_and_stack_shards(synthetic_root):
    """3 files over 2 devices: the second step's second window is empty on
    both sides (an all-masked batch), and stack_shards stacks the ranks'
    batches as the JAX loader stacks its shards (all of them once the
    plans are at capacity: `ops.plans.pad_plans`)."""
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    jds = JaxDataset(synthetic_root, "train", bbox_sampling_step=10)
    want = list(JaxLoader(jds, batch_size=1, n_devices=WORLD, shuffle=False,
                          prefetch=0))
    got = [list(PackedLoader(ds, batch_size=1, n_devices=WORLD, rank=r,
                             prefetch=0)) for r in range(WORLD)]
    empty = got[1][1]
    assert int(empty["n_images"]) == 0
    assert not empty["node_mask"].any() and not empty["proposal_mask"].any()
    # the plans' lengths follow the batch: stacked at capacity
    full = stack_shards([pad_plans(got[0][1]), pad_plans(got[1][1])])
    assert set(full) == set(got[0][1])
    stacked = stack_shards([{k: got[r][1][k] for k in KEYS}
                            for r in range(WORLD)])
    jstacked = jax_stack_shards([{k: want[1][k][r] for k in KEYS}
                                 for r in range(WORLD)])
    for k in KEYS:
        np.testing.assert_array_equal(stacked[k], want[1][k], err_msg=k)
        np.testing.assert_array_equal(stacked[k], jstacked[k], err_msg=k)
        np.testing.assert_array_equal(full[k], stacked[k], err_msg=k)
        np.testing.assert_array_equal(
            shard_leading_axis(stacked, 1)[k], empty[k], err_msg=k)


def test_partition_helpers_match_jax():
    parts = partition.random_partition_graph(100, 10,
                                             np.random.default_rng(0))
    np.testing.assert_array_equal(parts, jax_partition.random_partition_graph(
        100, 10, np.random.default_rng(0)))
    rng = np.random.default_rng(1)
    edge = rng.integers(0, 50, size=(200, 2))
    parts = partition.random_partition_graph(50, 4, rng)
    got = partition.generate_sub_graphs(edge, parts, cluster_number=4,
                                        batch_size=2)
    want = jax_partition.generate_sub_graphs(edge, parts, cluster_number=4,
                                             batch_size=2)
    assert len(got) == len(want) == 2
    for (gn, ge), (wn, we) in zip(got, want):
        np.testing.assert_array_equal(gn, wn)
        np.testing.assert_array_equal(ge, we)


def _sharded_inputs():
    rng = np.random.default_rng(2)
    E, C, S = 32, 4, 6
    N, Ci, Co, A = 24, 5, 16, 4
    conv = {
        "w1": rng.normal(size=(2 * Ci + A, Co)).astype(np.float32) * 0.3,
        "sc1": np.stack([1.0 + 0.1 * rng.normal(size=Co),
                         0.1 * rng.normal(size=Co)]).astype(np.float32),
        "w2": rng.normal(size=(Co, Co)).astype(np.float32) * 0.3,
        "sc2": np.stack([np.ones(Co), np.zeros(Co)]).astype(np.float32),
        "wr": rng.normal(size=(Ci, Co)).astype(np.float32) * 0.3,
        "br": rng.normal(size=(Co,)).astype(np.float32),
    }
    sharded = {
        "data": rng.normal(size=(WORLD, E, C)).astype(np.float32),
        "seg": rng.integers(0, S, size=(WORLD, E)).astype(np.int32),
        "mask": rng.random((WORLD, E)) > 0.3,
        "edge": rng.integers(0, N, size=(WORLD, E, 2)).astype(np.int32),
        "e_attr": rng.normal(size=(WORLD, E, A)).astype(np.float32),
        "edge_mask": rng.random((WORLD, E)) > 0.2,
    }
    return dict(S=S, sharded=sharded, conv=conv,
                x=rng.normal(size=(N, Ci)).astype(np.float32))


@pytest.fixture(scope="module")
def sharded():
    data = _sharded_inputs()
    return data, spawn_ranks(torch_dp_ranks.sharded_ops, WORLD,
                             (WORLD, data), join_timeout_s=120.0)


def _jax_map(fn, n_in, *args):
    mesh = jax_make_mesh(WORLD)
    specs = (P("data"),) * n_in + (P(),) * (len(args) - n_in)
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=specs, out_specs=P(), check_vma=False))(
        *args))


def test_sharded_segment_sum_matches_jax(sharded):
    data, ranks = sharded
    sh, S = data["sharded"], data["S"]
    want = _jax_map(lambda d, s, m: jax_partition.sharded_segment_sum(
        d[0], s[0], S, "data", mask=m[0]), 3, sh["data"], sh["seg"],
        sh["mask"])
    for out in ranks:
        np.testing.assert_allclose(out["sum"], want, rtol=1e-5, atol=1e-5)


def test_sharded_segment_mean_matches_jax(sharded):
    data, ranks = sharded
    sh, S = data["sharded"], data["S"]
    want = _jax_map(lambda d, s: jax_partition.sharded_segment_mean(
        d[0], s[0], S, "data"), 2, sh["data"], sh["seg"])
    for out in ranks:
        np.testing.assert_allclose(out["mean"], want, rtol=1e-4, atol=1e-5)


def test_edge_sharded_gp2_layer_matches_jax(sharded):
    data, ranks = sharded
    sh = data["sharded"]
    want = _jax_map(
        lambda e, a, m, x, conv: jax_partition.edge_sharded_gp2_layer(
            conv, x, e[0], a[0], m[0], "data"), 3, sh["edge"], sh["e_attr"],
        sh["edge_mask"], data["x"], jax.tree.map(jnp.asarray, data["conv"]))
    for out in ranks:
        np.testing.assert_allclose(out["gp2"], want, rtol=1e-4, atol=1e-5)


def test_sum_over_ranks_gradient(sharded):
    """d(sum of the summed segments)/d(rank r's rows): every rank's
    cotangent reaches every row, so each row's gradient is the world."""
    _, ranks = sharded
    for out in ranks:
        np.testing.assert_array_equal(out["grad"],
                                      np.full_like(out["grad"], WORLD))


def test_rank_helpers(sharded):
    _, ranks = sharded
    for out in ranks:  # rank 0 filled its weight with 0, rank 1 with 1
        np.testing.assert_array_equal(out["replicated"], np.zeros((2, 3)))
    assert ranks[0]["mesh_world"] == WORLD and ranks[0]["mesh_one"] == 1


def test_device_count_and_coordinator_errors():
    with pytest.raises(ValueError, match="divide evenly"):
        local_device_count(Config(n_devices=3, n_processes=2))
    assert local_device_count(Config(n_devices=4, n_processes=2), "cpu") == 2
    need = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="local devices"):
        local_device_count(Config(n_devices=need))
    assert parse_coordinator("node0:29500") == ("node0", 29500)
    for bad in ("node0", ":1", "node0:x"):
        with pytest.raises(ValueError, match="host:port"):
            parse_coordinator(bad)
    with pytest.raises(ValueError, match="requires --coordinator"):
        initialize_from_config(Config(n_devices=4, n_processes=2), 0, "cpu")
    with pytest.raises(ValueError, match="local rank"):
        initialize_from_config(Config(n_devices=2), 2, "cpu")


@pytest.mark.parametrize("arch", ["centernet3cc_rpn_gp_iter2", "yolat_pp"])
def test_set_sync_group_sets_every_batchnorm(arch):
    model = build_model(Config(arch=arch, n_filters=8,
                               fused_head_train=True))
    n_bn = sum(isinstance(m, MaskedBatchNorm) for m in model.modules())
    assert n_bn >= 10
    marker = object()
    assert set_sync_group(model, marker) == n_bn
    assert all(m.sync_group is marker for m in model.modules()
               if isinstance(m, MaskedBatchNorm))
    assert set_sync_group(model, None) == n_bn
    assert all(getattr(m, "sync_group", None) is None
               for m in model.modules())
