"""The message-MLP kernels' bf16 route on the tensor cores, and the plain
versions they are held to, on the edge cases of that route.

At bf16, kernel 4 (`csrc/dense_message.cu`, `dense_message_tc_kernel`)
computes MLP rows for the used (node, slot) pairs only, compacted inside
the kernel per 64-node tile, and kernels 5 and 6 (`csrc/banded_message.cu`,
`banded_tc_kernel`) form p_own once per node and stream a node tile's
edges in tiles of 64; both run their products through `yk::msg_tile_bf16`
(wgmma m64n64k16) and sum per node in a fixed order (`yk::msg_run_sum`).
The f32 route stays on IEEE FMA.

Marked `cuda` (each skips through the `cuda_device` fixture where no CUDA
device is present; they import no jax):

  python -m pytest --noconftest -q -m cuda tests/test_torch_message_tc.py

  * kernel 4 against its plain version at f32 and bf16, C 5 and 64, D 1, 4,
    32 and 64 (an all-used node then fills a whole pair tile), N not a
    multiple of 64, with all-masked and all-used rows and
    used slots scattered over the row; at bf16 its own count of computed
    MLP rows equals the used slots; a table with no used slot (E = 0);
  * kernel 5 at C 5 and 64, single and two-stage, over clique edges with
    one node whose edges span several 64-edge tiles; kernel 6's own sum
    bit-equal to kernel 5's; E = 0;
  * two runs bit-identical; the bf16 instantiations carry HGMMA and the
    f32 ones neither tensor-core instruction (`cuobjdump -sass`).
Tolerances are those of tests/test_torch_kernels_cuda.py and chip_smoke.py:
kernel 4 |err| <= 1e-4 + 1e-4|ref| at f32 and 5e-3 max|ref| at bf16;
kernels 5 and 6 1e-5 max|ref| at f32 and 5e-4 at bf16.

Unmarked, on the CPU: the plain versions against the JAX package on the
same cases (kernel 4 through its jnp reference where N is no multiple of
the JAX block, as the JAX function routes it, and through the Pallas
kernel in interpret mode where it is; kernel 5 through the Pallas kernel
in interpret mode), and phase 2's match of kernel names to mangled
functions. jax is imported inside those tests, so the file imports on the
card, which has none.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.banded_message import (banded_message_sum,
                                                banded_message_sum_both,
                                                banded_message_sum_plain,
                                                plan_tensors)
from yolat_tpu_torch.ops.dense_message import (dense_message_work,
                                               fused_dense_message,
                                               fused_dense_message_plain)
from yolat_tpu_torch.ops.plans import banded_plan

H = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_msg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ---------------------------------------------------------------------------


def _dense_inputs(seed, c, d, n, used=True):
    """A neighbour table whose used slots are scattered over each row (at
    most 3 per node), rows 64..79 all used, the last 40 all masked; `used`
    False: no slot used."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((n, d), bool)
    if used:
        for i in range(n):
            mask[i, rng.choice(d, size=int(rng.integers(0, min(3, d) + 1)),
                               replace=False)] = True
        mask[64:80] = True
        mask[-40:] = False
    idx = np.where(mask, rng.integers(0, n, (n, d)), 0).astype(np.int32)
    attr = np.where(mask[..., None], rng.normal(size=(n, d, 4)),
                    0.0).astype(np.float32)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    sc = lambda: np.stack([rng.uniform(0.5, 1.5, H), rng.normal(size=H) * 0.1]
                          ).astype(np.float32)
    return (f(n, c), idx, attr, mask, f(2 * c + 4, H) * 0.3, sc(),
            f(H, H) * 0.3, sc(), f(c, H) * 0.3, f(H) * 0.1)


def _torch(args, dtype, dev="cpu"):
    t = [torch.from_numpy(a).to(dev) for a in args]
    t[0] = t[0].to(dtype)
    return t


def _banded_inputs(seed, c, n=1000, e=None, star=300, hub=700):
    """Clique edges over short node runs next to empty stretches, and `star`
    edges into node `hub` from sources within 150 rows of it (its edges
    span several 64-edge tiles); `e` = 0: no real edge.
    -> (x, edge, mask, attr, weights dict) as numpy arrays."""
    rng = np.random.default_rng(seed)
    edges, lo = [], 0
    while lo < n - 40:
        m = int(rng.integers(2, 14))
        ids = np.arange(lo, min(lo + m, n))
        a, b = np.meshgrid(ids, ids)
        edges.append(np.stack([a[a != b], b[a != b]], axis=1))
        lo += m + int(rng.integers(0, 30))
    src = np.setdiff1d(np.arange(hub - 150, hub + 150), [hub])
    src = rng.choice(src, size=star, replace=star > src.size)
    edges.append(np.stack([src, np.full(star, hub)], axis=1))
    edge = np.concatenate(edges).astype(np.int32)
    edge = edge[rng.permutation(len(edge))]
    mask = np.ones(len(edge), bool) if e is None else np.zeros(len(edge), bool)
    attr = rng.normal(size=(len(edge), 4)).astype(np.float32)
    w = {k: (rng.normal(size=s) * 0.2).astype(np.float32) for k, s in (
        ("w_own", (c, H)), ("w_halo", (c, H)), ("w_attr", (4, H)),
        ("w2", (H, H)))}
    for k in ("sc1", "sc2"):
        w[k] = np.stack([rng.uniform(0.5, 1.5, H),
                         rng.normal(size=H) * 0.1]).astype(np.float32)
    return rng.normal(size=(n, c)).astype(np.float32), edge, mask, attr, w


def _bargs(w, two_stage, conv):
    names = ("w_own", "w_halo", "w_attr", "sc1") + (
        ("w2", "sc2") if two_stage else ())
    return [conv(w[k]) for k in names]


def _dense_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = (got - want).abs().max().item()
        assert err <= 5e-3 * want.abs().max().item(), err


def _banded_close(got, want, dtype):
    tol = 1e-5 if dtype == torch.float32 else 5e-4
    err = (got - want).abs().max().item()
    assert err <= tol * max(want.abs().max().item(), 1e-30), err


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 4, 32, 64])
@pytest.mark.parametrize("c", [5, 64])
def test_dense_kernel_matches_plain(cuda_device, c, d, dtype):
    n = 1000  # not a multiple of the 64-node tile
    np_args = _dense_inputs(c + d, c, d, n)
    args = _torch(np_args, dtype, cuda_device)
    _build.reset_launch_counts()
    dense_message_work(reset=True)
    got = fused_dense_message(*args)
    rows, tiles = dense_message_work(reset=True)
    again = fused_dense_message(*args)
    want = fused_dense_message_plain(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_dense_message"] == 2
    assert got.dtype == torch.float32 and got.shape == (n, H)
    assert torch.equal(got, again)
    _dense_close(got, want, dtype)
    if dtype == torch.bfloat16:
        per_tile = np.add.reduceat(np_args[3].sum(1), np.arange(0, n, 64))
        assert rows == int(np_args[3].sum())  # used slots only, each once
        assert tiles == int((-(-per_tile // 64)).sum())
    else:
        assert rows == tiles == 0  # the f32 route does not count


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_kernel_without_used_slots(cuda_device, dtype):
    args = _torch(_dense_inputs(3, 64, 4, 200, used=False), dtype,
                  cuda_device)
    got = fused_dense_message(*args)
    want = fused_dense_message_plain(*args)
    torch.cuda.synchronize()
    _dense_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("two_stage", [False, True])
@pytest.mark.parametrize("c", [5, 64])
def test_banded_kernel_matches_plain(cuda_device, c, two_stage, dtype):
    dev = cuda_device
    x, edge, mask, attr, w = _banded_inputs(c + 2 * two_stage, c)
    n = x.shape[0]
    bm = plan_tensors(banded_plan(edge, mask, attr, n), dev)
    assert int((bm.nptr[701] - bm.nptr[700]).item()) > 3 * 64
    xt = torch.from_numpy(x).to(dev).to(dtype)
    args = _bargs(w, two_stage, lambda a: torch.from_numpy(a).to(dev))
    _build.reset_launch_counts()
    got = banded_message_sum(xt, bm, *args)
    again = banded_message_sum(xt, bm, *args)
    want = banded_message_sum_plain(xt, bm, *args)
    torch.cuda.synchronize()
    assert _build.launch_counts["banded_message_sum"] == 2
    assert torch.equal(got, again)
    deg = torch.bincount(bm.own.long(), minlength=n)
    assert (deg == 0).any() and not got[deg == 0].any()
    _banded_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [5, 64])
def test_banded_both_own_sum_is_kernel5s(cuda_device, c, dtype):
    dev = cuda_device
    x, edge, mask, attr, w = _banded_inputs(11 + c, c)
    n = x.shape[0]
    bm = plan_tensors(banded_plan(edge, mask, attr, n, transpose=True), dev)
    xt = torch.from_numpy(x).to(dev).to(dtype)
    args = _bargs(w, False, lambda a: torch.from_numpy(a).to(dev))
    own, oth = banded_message_sum_both(xt, bm, *args)
    own2, oth2 = banded_message_sum_both(xt, bm, *args)
    k5 = banded_message_sum(xt, bm, *args)
    torch.cuda.synchronize()
    assert torch.equal(own, k5)
    assert torch.equal(own, own2) and torch.equal(oth, oth2)
    bm_t = plan_tensors(banded_plan(edge, mask, attr, n, sortby=0), dev)
    _banded_close(oth, banded_message_sum_plain(
        xt, bm_t, args[1], args[0], args[2], args[3]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_kernels_without_edges(cuda_device, dtype):
    dev = cuda_device
    x, edge, mask, attr, w = _banded_inputs(5, 64, e=0)
    n = x.shape[0]
    bm = plan_tensors(banded_plan(edge, mask, attr, n, transpose=True), dev)
    assert bm.n_edges == 0
    xt = torch.from_numpy(x).to(dev).to(dtype)
    args = _bargs(w, True, lambda a: torch.from_numpy(a).to(dev))
    got = banded_message_sum(xt, bm, *args)
    own, oth = banded_message_sum_both(xt, bm, *args[:4])
    torch.cuda.synchronize()
    assert got.shape == own.shape == oth.shape == (n, H)
    assert not got.any() and not own.any() and not oth.any()


@pytest.mark.cuda
def test_message_kernels_carry_hgmma_at_bf16_only(cuda_device):
    """Phase 2 of chip_smoke.py on the built library: the bf16 kernels have
    HGMMA, spill nothing and keep wgmma unserialised; the f32 ones have
    neither tensor-core instruction."""
    cs = _chip_smoke()
    report = cs.tensor_core_report()
    for name in ("dense_message_tc_kernel", "banded_tc_kernel"):
        fns = cs.functions_of(name, report)
        assert len(fns) == (1 if name.startswith("dense") else 3), fns
        assert all(report[f]["HGMMA"] > 0 for f in fns)
    for name in ("dense_message_kernel", "banded_kernel"):
        fns = cs.functions_of(name, report)
        assert fns and all(report[f]["HGMMA"] + report[f]["HMMA"] == 0
                           for f in fns)


# ---------------------------------------------------------------------------
# on the CPU: the plain versions against the JAX package
# ---------------------------------------------------------------------------


def test_phase2_names_match_each_instantiation_only():
    cs = _chip_smoke()
    fns = [
        "_ZN50_GLOBAL__N__2e856bf1_17_banded_message_cu_164b4ba116banded_tc_"
        "kernelILb0ELb1EEEvPK13__nv_bfloat16PKiS5_PKfS5_S5_S5_i",
        "_ZN50_GLOBAL__N__2e856bf1_17_banded_message_cu_164b4ba113banded_"
        "kernelIfLb0ELb0EEEvPKT_PKiS6_PKfS6_S6_S6_i",
        "_ZN49_GLOBAL__N__ee4fd041_16_dense_message_cu_bf6d8c3323dense_"
        "message_tc_kernelEPK13__nv_bfloat16PKiPKfPKhS2_S6_S2_S6_S2_S6_Pfiiiiiii",
        "_ZN49_GLOBAL__N__ee4fd041_16_dense_message_cu_bf6d8c3320dense_"
        "message_kernelIfEEvPKT_PKiPKfPKhS3_S7_S3_S7_S3_S7_Pfiiiii"]
    assert cs.functions_of("banded_tc_kernel", fns) == [fns[0]]
    assert cs.functions_of("banded_kernel", fns) == [fns[1]]
    assert cs.functions_of("dense_message_tc_kernel", fns) == [fns[2]]
    assert cs.functions_of("dense_message_kernel", fns) == [fns[3]]
    assert set(cs.TC_KERNELS) >= {"dense_message_tc_kernel", "banded_tc_kernel"}
    assert set(cs.F32_KERNELS) >= {"dense_message_kernel", "banded_kernel"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,d,n", [(5, 32, 300), (64, 1, 256)])
def test_dense_plain_matches_jax(c, d, n, dtype):
    """D 32 sparsely used at C 5 (N 300: the JAX function's jnp reference)
    and D 1 at C 64 (N 256: its Pallas kernel in interpret mode). Against
    the Pallas kernel, which rounds at the same points: 1e-5 at f32, 2e-3
    of max|out| at bf16; against the reference, which neither rounds s_i
    nor h2, 1e-2 at bf16 (tests/test_torch_window_dense.py)."""
    import jax.numpy as jnp

    from yolat_tpu.ops.pallas_kernels import fused_dense_message as jax_dense

    np_args = _dense_inputs(c * d, c, d, n)
    want = np.asarray(jax_dense(*map(jnp.asarray, np_args), interpret=True,
                                bf16=dtype == "bfloat16"))
    got = fused_dense_message(*_torch(np_args, getattr(torch, dtype))).numpy()
    assert got.shape == want.shape == (n, H)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = 2e-3 if n % 256 == 0 else 1e-2
        assert np.abs(got - want).max() <= tol * np.abs(want).max()
    # all-masked rows are x @ wr + br
    x, wr, br = np_args[0], np_args[8], np_args[9]
    if dtype == "float32":
        np.testing.assert_allclose(got[-40:], x[-40:] @ wr + br, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("two_stage", [False, True])
def test_banded_plain_matches_jax_with_a_node_over_many_tiles(two_stage):
    """C 5, a hub node with 300 edges (more than four 64-edge tiles) inside
    the JAX plan's band; against the Pallas kernel in interpret mode at
    f32, 1e-5 of scale (tests/test_torch_pp_ops.py)."""
    import jax.numpy as jnp

    from yolat_tpu.ops.banded_message import banded_message_sum as jax_sum
    from yolat_tpu.ops.banded_message import banded_plan as jax_plan
    from yolat_tpu.ops.banded_message import bm_of as jax_bm_of

    n = 1024
    x, edge, mask, attr, w = _banded_inputs(17, 5, n=n)
    plan = jax_plan(edge, mask, attr, n, wn=512, pad=256, eblk=512)
    assert plan is not None
    jbm = jax_bm_of({**{k: jnp.asarray(v) for k, v in plan.items()},
                     "pos": jnp.zeros((n, 2))}, "")
    want = np.asarray(jax_sum(jnp.asarray(x), jbm,
                              *_bargs(w, two_stage, jnp.asarray),
                              interpret=True))
    bm = plan_tensors(banded_plan(edge, mask, attr, n))
    assert int(bm.nptr[701] - bm.nptr[700]) >= 300
    got = banded_message_sum(torch.from_numpy(x), bm,
                             *_bargs(w, two_stage, torch.from_numpy)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_message_decomp_variants_apply_to_the_sources():
    from yolat_tpu_torch.scripts import message_decomp, source_edits

    src = source_edits.variant_sources(message_decomp.EDITS)
    assert set(src) == {e[0] for e in message_decomp.EDITS}
    base = src["k5_base"]
    for name, files in src.items():
        assert (files == base) == (name == "k5_base"), name
    assert "MSG_TIE = 16;" in src["k5_tie16"][1]["common.cuh"]
    edge, attr = message_decomp.clique_family()
    assert 150_000 < len(edge) < 260_000 and attr.shape == (len(edge), 4)
    assert edge.max() < message_decomp.N
