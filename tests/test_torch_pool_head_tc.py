"""The pool-head kernels' bf16 route on the tensor cores, on the card.

At bf16 the block max (kernels 2 and 3, `csrc/block_max.cu`) and the fused
head's backward (kernel 11, `csrc/fused_pool_train.cu`) compute every
z = x @ W through one routine, `yk::pool_z_tile_bf16` (wgmma m64n128k16),
so kernel 11's recompute reproduces the forward's bits and finds a winner
in every pool block whose stored maximum is positive. Marked `cuda`; each
test skips (through the `cuda_device` fixture) where no CUDA device is
present. This file imports no jax:

  python -m pytest --noconftest -q -m cuda tests/test_torch_pool_head_tc.py

Unmarked, on any device: the plain routes' own winner completeness (the
plain backward recomputes through the plain forward), the wrapper's
16-byte alignment copy, the parsers that read the tensor-core
instructions and ptxas's report for `chip_smoke.py`, and the edits of the
decomposition probe (`scripts/pool_head_decomp.py`) against the sources.

Cin 8 and 72 are zero-padded to a multiple of 16 inside the kernels, Cin 13
takes the block max's element-wise loads; N 64 is one row tile. Tolerances
are those of tests/test_torch_kernels_cuda.py: the block max rounds only
its output (rtol 1e-2 against the plain version's f32 sums; the x block
max exact); the fused head's kernel route against its plain route within
a relative Frobenius error of 5e-4 per output and gradient.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops.block_max import (folded_mlp_block_max,
                                           folded_mlp_block_max2,
                                           folded_mlp_block_max2_plain)
from yolat_tpu_torch.ops.block_max import folded_mlp_block_max_plain
from yolat_tpu_torch.ops.fused_pool_train import (fused_pool_train,
                                                  fused_pool_train_bwd,
                                                  fused_pool_train_bwd_plain)
from yolat_tpu_torch.ops.plans import pool_plan

H = 1024


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n, ci, seed=0):
    """bf16 x (masked rows zero) and W, f32 node mask [n, 1] with the first
    two pool blocks masked out, f32 scale/shift [2, H]."""
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.8
    mask[:16] = False
    x = rng.normal(size=(n, ci)) * mask[:, None]
    w = rng.normal(size=(ci, H)) / np.sqrt(ci)
    sc = np.stack([rng.uniform(0.5, 1.5, H), rng.normal(size=H) * 0.1])
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return (t(x).to(torch.bfloat16), t(mask[:, None]), t(w).to(torch.bfloat16),
            t(sc))


@pytest.mark.cuda
@pytest.mark.parametrize("ci", [8, 72, 128])
def test_kernel11_finds_a_winner_in_every_positive_block(cuda_device, ci):
    x, m, w, sc = _inputs(cuda_device, 4096, ci, seed=ci)
    bred = folded_mlp_block_max(x, m, w, sc)  # kernel 3's stored maxima
    ones = torch.ones(bred.shape, device=cuda_device)
    _, _, usum, _ = fused_pool_train_bwd(x, m, w, sc, bred, ones)
    torch.cuda.synchronize()
    positive = (bred.float() > 0).sum(dim=0).float()
    assert positive.sum() > 0
    # each winner row adds its cotangent 1: at least one per such block
    short = (usum < positive).sum().item()
    assert short == 0, f"{short} of {H} columns lack winners"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("ci", [8, 13, 72, 128])
def test_tensor_core_block_max_matches_plain(cuda_device, ci, n):
    x, m, w, sc = _inputs(cuda_device, n, ci, seed=n + ci)
    _build.reset_launch_counts()
    gh, gx = folded_mlp_block_max2(x, m, w, sc)
    g3 = folded_mlp_block_max(x, m, w, sc)
    wh, wx = folded_mlp_block_max2_plain(x, m, w, sc)
    torch.cuda.synchronize()
    assert _build.launch_counts["folded_mlp_block_max2"] == 1
    assert _build.launch_counts["folded_mlp_block_max"] == 1
    assert gh.dtype == torch.bfloat16 and gh.shape == (n // 8, H)
    assert gx.shape == (n // 8, ci)
    torch.testing.assert_close(gh.float(), wh.float(), rtol=1e-2, atol=1e-4)
    assert torch.equal(gx, wx)
    assert torch.equal(g3, gh)  # one kernel behind both entry points
    assert (gh[:2].float() <= -1e30 / 2).all()


def _head_inputs(dev, ci, n=4096, seed=0):
    """Fused-head inputs on 8-aligned proposal runs, one proposal fully
    masked, three trailing proposals without rows."""
    rng = np.random.default_rng(seed)
    lens, left = [], n
    while left > 0:
        take = min(int(rng.integers(1, 7)) * 8, left)
        lens.append(take)
        left -= take
    seg = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    n_prop = len(lens) + 3
    blk_first = pool_plan(seg, n_prop, cap=0)["pool_blk_first"]
    mask = rng.random(n) > 0.15
    mask[seg == 2] = False
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return dict(x=t(rng.normal(size=(n, ci))), maskf=t(mask[:, None]),
                w=t(rng.normal(size=(ci, H)) / np.sqrt(ci)),
                b=t(rng.normal(size=H) * 0.1),
                gamma=t(1.0 + 0.2 * rng.normal(size=H)),
                beta=t(rng.normal(size=H) * 0.1),
                blk_first=torch.from_numpy(blk_first).to(dev), n_prop=n_prop,
                cot=t(rng.normal(size=(n_prop, H))))


def _head_route(inp, route):
    leaves = {k: inp[k].clone().requires_grad_(True)
              for k in ("x", "w", "b", "gamma", "beta")}
    pooled, mean, var, _ = fused_pool_train(
        leaves["x"].to(torch.bfloat16), inp["maskf"],
        leaves["w"].to(torch.bfloat16), leaves["b"], leaves["gamma"],
        leaves["beta"], inp["blk_first"], inp["n_prop"], route)
    (pooled.float() * inp["cot"]).sum().backward()
    out = {"pooled": pooled.float(), "mean": mean, "var": var}
    out.update({f"d{k}": v.grad for k, v in leaves.items()})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("ci", [8, 72, 128])
def test_tensor_core_fused_head_matches_plain_route(cuda_device, ci):
    inp = _head_inputs(cuda_device, ci, seed=ci)
    _build.reset_launch_counts()
    got = _head_route(inp, "kernel")
    torch.cuda.synchronize()
    assert _build.launch_counts["folded_mlp_block_max"] == 1
    assert _build.launch_counts["fused_pool_train_bwd"] == 1
    want = _head_route(inp, "plain")
    assert (got["pooled"][2] == 0).all() and (got["pooled"][-3:] == 0).all()
    assert got["dw"].abs().max() > 0  # winners were found
    errs = {}
    for k, v in want.items():
        assert torch.isfinite(got[k]).all(), k
        ref = want["dbeta"] if k == "db" else v
        errs[k] = ((got[k].float() - v.float()).norm()
                   / max(ref.float().norm(), 1e-9)).item()
    assert all(e <= 5e-4 for e in errs.values()), errs


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("ci", [8, 72, 128])
def test_tensor_core_kernel11_is_deterministic(cuda_device, ci, n):
    x, m, w, sc = _inputs(cuda_device, n, ci, seed=3 * ci + n)
    bred = folded_mlp_block_max(x, m, w, sc)
    gp_b = torch.from_numpy(np.random.default_rng(ci).normal(
        size=tuple(bred.shape)).astype(np.float32)).to(cuda_device)
    first = fused_pool_train_bwd(x, m, w, sc, bred, gp_b)
    again = fused_pool_train_bwd(x, m, w, sc, bred, gp_b)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, b)
    assert first[0].abs().max() > 0 and first[1].abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci", [8, 72, 128])
def test_plain_backward_finds_a_winner_in_every_positive_block(ci, dtype):
    x, m, w, sc = _inputs(torch.device("cpu"), 512, ci, seed=ci)
    x = x.to(dtype)
    bred = folded_mlp_block_max_plain(x, m, w, sc)
    ones = torch.ones(bred.shape)
    _, _, usum, _ = fused_pool_train_bwd_plain(x, m, w, sc, bred, ones)
    positive = (bred.float() > 0).sum(dim=0).float()
    assert positive.sum() > 0
    assert (usum >= positive).all()


def test_aligned16_copies_only_an_offset_view():
    base = torch.arange(40, dtype=torch.bfloat16)
    assert _build.aligned16(base) is base
    view = base[1:33]
    assert view.data_ptr() % 16 != 0
    got = _build.aligned16(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_parse", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tensor_core_report_parsers():
    cs = _chip_smoke()
    sass = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_119block_max_tc_kernelEPK13__nv_bfloat16
        /*0100*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;
        /*0110*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;
        /*0120*/                   FFMA R1, R2, R3, R4 ;
\t\tFunction : _ZN12_GLOBAL__N_116block_max_kernelIfEEvPKT_
        /*0100*/                   FFMA R1, R2, R3, R4 ;
        /*0110*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""
    ops = cs.sass_tensor_ops(sass)
    assert ops == {
        "_ZN12_GLOBAL__N_119block_max_tc_kernelEPK13__nv_bfloat16":
            {"HGMMA": 2, "HMMA": 0},
        "_ZN12_GLOBAL__N_116block_max_kernelIfEEvPKT_": {"HGMMA": 0, "HMMA": 1}}
    log = """ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'
ptxas info    : Function properties for _Z1av
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 91 registers, used 1 barriers, 512 bytes smem
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 225 registers, used 1 barriers
"""
    assert cs.ptxas_props(log) == {
        "_Z1av": dict(registers=91, spill_stores=8, spill_loads=4, smem=512),
        "_Z1bv": dict(registers=225, spill_stores=0, spill_loads=0, smem=0)}


def test_pool_head_decomp_variants_apply_to_the_sources():
    from yolat_tpu_torch.scripts import pool_head_decomp, source_edits

    src = source_edits.variant_sources(pool_head_decomp.EDITS)
    assert set(src) == {e[0] for e in pool_head_decomp.EDITS}
    for name, (fn, files) in src.items():
        base = src["bm_base" if fn == "block_max.cu" else "k11_base"][1][fn]
        assert (files[fn] == base) == name.endswith("_base"), name
