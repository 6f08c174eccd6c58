"""Kernel 1's bf16 route on the tensor cores, and the plain version it is
held to, on the edge cases of that route.

At bf16, kernel 1 (`csrc/edge_window.cu`, `edge_window_tc_kernel`) streams
a window's dst-sorted edges in tiles of 64: the A operand [x[dst] | x[src]
| round(attr)] gathered into the tiled layout, both MLP stages on wgmma
(`yk::msg_tile_bf16`, `yk::msg_stage2_bf16`), a fixed-order per-node sum
(`yk::msg_run_sum`) with a carry for a node whose edges span tiles, and a
zero row for a node without an in-edge. The f32 route (`edge_window_kernel`)
stays on IEEE FMA. Kernel 12's probe variants are template instantiations
of the same two kernels.

Marked `cuda` (each skips through the `cuda_device` fixture where no CUDA
device is present; they import no jax):

  python -m pytest --noconftest -q -m cuda tests/test_torch_edge_window_tc.py

  * kernel 1 against its plain version at C 5 and 64, f32 and bf16, wn 64
    and 256, N = 1000 (no multiple of either), on a graph with a node whose
    in-edges span at least three 64-edge tiles and windows without an edge;
    two runs bit-identical; every node without an in-edge exactly 0;
  * no real edge at all (E = 0): every row 0;
  * kernel 12's variants bit-identical to kernel 1 on their inputs on the
    same graph at C 5 (the element-load route) and 64;
  * the bf16 instantiations carry HGMMA and the f32 ones neither
    tensor-core instruction (`cuobjdump -sass`, chip_smoke.py phase 2).
Tolerances are those of tests/test_torch_kernels_cuda.py and chip_smoke.py:
|err| <= 1e-4 + 1e-4|ref| at f32, max|err| <= 5e-3 max|ref| at bf16.

Unmarked, on the CPU: the plain version against the JAX function (its
Pallas kernel in interpret mode, N a multiple of 256) on the same kind of
graph, f32 and bf16, with the tolerances of tests/test_torch_kernels_plain.py
(1e-5 at f32; 2e-3 of max|out| at bf16, one bf16 ulp of an h value moved
by another f32 summation order); and phase 2's match of kernel names to
mangled functions. jax is imported inside those tests, so the file imports
on the card, which has none.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.edge_window import (VARIANTS, decomp_inputs,
                                             edge_window_decomp,
                                             edge_window_message_sum,
                                             edge_window_message_sum_plain)
from yolat_tpu_torch.ops.plans import EW_KEYS, edge_window_plan

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
    spec = importlib.util.spec_from_file_location("chip_smoke_ew", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ---------------------------------------------------------------------------


def _graph(seed, n, hub, star, empty, e=None, reach=30):
    """Edges with sources within `reach` rows of their destination, none
    into the node range `empty`, `star` more into node `hub` from sources
    within 100 rows of it, 15% of all masked out; `e` = 0: none real.
    -> (edge [E, 2] i32, mask [E] bool, attr [E, 4] f32)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, n)
    dst = dst[(dst < empty[0]) | (dst >= empty[1])]
    src = np.clip(dst + rng.integers(-reach, reach + 1, len(dst)), 0, n - 1)
    hsrc = np.clip(hub + rng.integers(-100, 101, star), 0, n - 1)
    src = np.concatenate([src, hsrc])
    dst = np.concatenate([dst, np.full(star, hub)])
    perm = rng.permutation(len(dst))
    edge = np.stack([src[perm], dst[perm]], axis=1).astype(np.int32)
    mask = rng.random(len(dst)) < 0.85
    mask[dst[perm] == hub] = True
    if e == 0:
        mask[:] = False
    attr = rng.normal(size=(len(dst), 4)).astype(np.float32)
    return edge, mask, attr


def _weights(seed, c):
    """x [., c] drawn later; w1 [2c+4, 64], sc1, w2 [64, 64], sc2."""
    rng = np.random.default_rng(seed)
    sc = lambda: np.stack([rng.uniform(0.5, 1.5, H),
                           rng.normal(size=H) * 0.1]).astype(np.float32)
    w1 = (rng.normal(size=(2 * c + 4, H)) * 0.3).astype(np.float32)
    sc1 = sc()
    w2 = (rng.normal(size=(H, H)) * 0.3).astype(np.float32)
    return w1, sc1, w2, sc()


def _port_inputs(seed, c, n, wn, dev, dtype, e=None):
    """Kernel 1's arguments on the card: a hub node (700) with 300
    in-edges, no edge into nodes [256, 512)."""
    edge, mask, attr = _graph(seed, n, hub=700, star=300, empty=(256, 512),
                              e=e)
    plan = edge_window_plan(edge, mask, attr, n, wn=wn)
    ew = tuple(torch.from_numpy(plan[k]).to(dev) for k in EW_KEYS) + (wn,)
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
    w = [torch.from_numpy(a).to(dev) for a in _weights(seed + 2, c)]
    return x.to(dev, dtype), ew, w


def _close(got, want, dtype):
    if dtype == torch.float32:
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all()), \
            (got - want).abs().max().item()
    else:
        err = (got - want).abs().max().item()
        assert err <= 5e-3 * want.abs().max().item(), err


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wn", [64, 256])
@pytest.mark.parametrize("c", [5, 64])
def test_kernel_matches_plain(cuda_device, c, wn, dtype):
    n = 1000  # no multiple of wn: the last window is partial
    x, ew, w = _port_inputs(c + wn, c, n, wn, cuda_device, dtype)
    dst = ew[1].long()
    deg = torch.bincount(dst, minlength=n)
    assert int(deg[700]) >= 2 * 64 + 2  # the hub's edges span >= 3 tiles
    assert int(deg[256:512].sum()) == 0 and int(deg.max()) == int(deg[700])
    _build.reset_launch_counts()
    got = edge_window_message_sum(x, ew, *w)
    again = edge_window_message_sum(x, ew, *w)
    want = edge_window_message_sum_plain(x, ew, *w)
    torch.cuda.synchronize()
    assert _build.launch_counts["edge_window_message_sum"] == 2
    assert got.dtype == torch.float32 and got.shape == (n, H)
    assert torch.equal(got, again)  # no atomics: bit-identical runs
    assert (deg == 0).any() and not got[deg == 0].any()
    assert got[700].abs().max() > 0
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_without_edges(cuda_device, dtype):
    x, ew, w = _port_inputs(4, 64, 1000, 256, cuda_device, dtype, e=0)
    assert ew[0].shape[0] == 0
    got = edge_window_message_sum(x, ew, *w)
    torch.cuda.synchronize()
    assert got.shape == (1000, H) and not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [5, 64])
def test_decomp_variants_are_kernel1_on_their_inputs(cuda_device, c, dtype):
    x, ew, w = _port_inputs(9, c, 1000, 256, cuda_device, dtype)
    full = edge_window_decomp(x, ew, *w, "full")
    for v in VARIANTS:
        got = edge_window_decomp(x, ew, *w, v)
        k1 = edge_window_message_sum(*decomp_inputs(x, ew, v), *w)
        torch.cuda.synchronize()
        assert torch.equal(got, k1), v
        assert v == "full" or not torch.equal(got, full), v


@pytest.mark.cuda
def test_kernel1_carries_hgmma_at_bf16_only(cuda_device):
    """Phase 2 of chip_smoke.py on the built library: the bf16 kernel (and
    its two probe variants) has HGMMA, spills nothing and keeps wgmma
    unserialised; the f32 one has neither tensor-core instruction."""
    cs = _chip_smoke()
    report = cs.tensor_core_report()
    fns = cs.functions_of("edge_window_tc_kernel", report)
    assert len(fns) == 3 and all(report[f]["HGMMA"] > 0 for f in fns), fns
    fns = cs.functions_of("edge_window_kernel", report)
    assert len(fns) == 3, fns
    assert all(report[f]["HGMMA"] + report[f]["HMMA"] == 0 for f in fns)


# ---------------------------------------------------------------------------
# on the CPU: the plain version against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [5, 64])
def test_plain_matches_pallas_with_a_hub_and_an_empty_window(c, dtype):
    """N 512 in windows of 128: node 300 takes 200 in-edges (four 64-edge
    tiles of the port's plan; within the JAX plan's band and capacity),
    window 1 takes none."""
    import jax.numpy as jnp

    from yolat_tpu.ops.edge_window import edge_window_message_sum as jax_ew
    from yolat_tpu.ops.edge_window import edge_window_plan as jax_plan

    n, wn = 512, 128
    edge, mask, attr = _graph(c, n, hub=300, star=200, empty=(128, 256))
    o = np.argsort(edge[:, 1], kind="stable")  # the JAX plan wants dst order
    jp = jax_plan(edge[o], mask[o], attr[o], n, wn=wn)
    assert jp is not None
    plan = edge_window_plan(edge, mask, attr, n, wn=wn)
    deg = np.bincount(plan["ew_dst"], minlength=n)
    assert deg[300] == deg.max() >= 3 * 64 + 2 and deg[128:256].sum() == 0
    rng = np.random.default_rng(c + 1)
    x = rng.normal(size=(n, c)).astype(np.float32)
    w = _weights(c + 2, c)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jax_ew(
        jnp.asarray(x, jdt),
        tuple(jnp.asarray(jp[k]) for k in ("ew_src_rel", "ew_dst_loc",
                                           "ew_attr", "ew_maskf")),
        jnp.asarray(w[0], jdt), jnp.asarray(w[1]), jnp.asarray(w[2], jdt),
        jnp.asarray(w[3]), interpret=True))
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(a) for a in w]
    ew = tuple(torch.from_numpy(plan[k]) for k in EW_KEYS) + (wn,)
    got = edge_window_message_sum(torch.from_numpy(x).to(tdt), ew,
                                  t[0].to(tdt), t[1], t[2].to(tdt),
                                  t[3]).numpy()
    assert got.shape == want.shape == (n, H)
    assert (got[deg == 0] == 0).all() and (want[deg == 0] == 0).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()


def test_phase2_names_match_each_instantiation_only():
    cs = _chip_smoke()
    ns = "_ZN46_GLOBAL__N__5f1c2a9e_14_edge_window_cu_8d6e4b2a"
    f32 = [f"{ns}18edge_window_kernelILi{v}EEEvPKfPKiS4_S2_S4_S2_S2_S2_S2_"
           "Pfiiii" for v in range(3)]
    tc = [f"{ns}21edge_window_tc_kernelILi{v}EEEvPK13__nv_bfloat16PKiS5_PKfS5_"
          "S2_S7_S2_S7_Pfiiiiii" for v in range(3)]
    other = ["_ZN52_GLOBAL__N__0a1b2c3d_20_edge_window_train_cu_9e8f7a6b15"
             "pair_fwd_kernelIfEEvPKT_PKiS6_PS1_iiii"]
    fns = f32 + tc + other
    assert cs.functions_of("edge_window_kernel", fns) == f32
    assert cs.functions_of("edge_window_tc_kernel", fns) == tc
    assert "edge_window_tc_kernel" in cs.TC_KERNELS
    assert "edge_window_kernel" in cs.F32_KERNELS


def test_probe_edits_apply_to_the_sources():
    from yolat_tpu_torch.scripts import ew_kernel_decomp, source_edits

    src = {k: files["edge_window.cu"] for k, (_, files) in
           source_edits.variant_sources(ew_kernel_decomp.EDITS).items()}
    assert set(src) == {e[0] for e in ew_kernel_decomp.EDITS}
    base = src["k1_base"]
    for name, text in src.items():
        assert (text == base) == (name == "k1_base"), name
        # every edit touches the tensor-core kernel only
        assert text.count("edge_window_tc_kernel") == base.count(
            "edge_window_tc_kernel"), name
    assert "yk::msg_run_sum(" not in src["k1_nosum"]
    assert "yk::msg_tile_bf16(a_s" not in src["k1_noproduct"]
    assert "for (int t = 0; t < 0; ++t)" in src["k1_tiles0"]
