"""Kernels 9 and 10 (`csrc/edge_window_train.cu`) and their plain versions
against an ordered emulation of the plan's summation order.

The four functions of the window train layout (x [N, C], the plan's E real
edges in dst order):
  pair forward   g[e] = [x[dst e] || round(x[src e] - x[dst e])]
  pair backward  dx[v] = round(sum over v's in-edges in dptr order of
                 round(dg0 - dg1), then over its out-edges in sperm order of
                 dg1), added left to right in float32
  sum forward    out[v] = sum over v's in-edges in dptr order of h, float32
  sum backward   dh[e] = round(g[dst e])
where round is to the working type (bf16 or float32). `_emulate` computes
them with numpy, adding in float32 one term at a time in that order, and
rounding to bf16 (nearest even) where the header of the CUDA source says.

The graph (`_hub_graph`): N = 1009 nodes (a multiple of no window or block
size), about one edge per node from a source within 40 rows, a hub node
with over 300 in-edges and over 300 out-edges, and nodes [200, 260) without
any edge.

Unmarked, on the CPU:
  * the port's plain versions against the emulation at C 1, 5, 8, 64, 72,
    float32 and bf16: the gathers exact; the sums within the tolerances of
    tests/test_torch_kernels_cuda.py (float32 rtol/atol 1e-5; the bf16
    pair backward rtol 2^-7 over atol 1e-5, one output ulp);
  * the same graph (padded with edge-free nodes to N = 1024, four windows of
    256) against the JAX functions, their Pallas kernels in interpret mode
    as tests/test_torch_window_dense.py runs them: the gathers exact; a
    float32 sum of k terms within 2 (k - 1) 2^-24 sum|terms| (each side
    within (k - 1) 2^-24 sum|terms| of the exact sum; the hub adds over
    300 terms); the bf16 sums to one ulp of the float64 sum, and within
    2^-7 of sum|terms| of the Pallas kernel's (its interpreter rounds
    partial sums of bf16 inputs to bf16);
  * the wrappers at the kernels' route boundaries (rows of 1 and 1.5
    16-byte pieces, of 32 and 33, and inputs off a 16-byte boundary)
    against the emulation, and phase 2's match of the kernel names to their
    instantiations.
jax is imported inside those tests, so the file imports on the card.

Marked `cuda` (each skips through the `cuda_device` fixture where no CUDA
device is present):

  python -m pytest --noconftest -q -m cuda tests/test_torch_window_train_tc.py

  * each kernel bit-identical to the emulation at the same C values and
    types (the 16-byte route at C 8, 64, 72; the narrow route at C 1, 5),
    two runs bit-identical;
  * the route boundaries above, bit for bit;
  * E = 0;
  * inputs that are views with a storage offset (not 16-byte aligned) take
    the narrow route and give the same bits.
The kernels choose their route themselves (`csrc/edge_window_train.cu`,
`launch`): the 16-byte route where a row is 1-32 whole pieces and every
value array starts on a 16-byte boundary, else the narrow route.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops import edge_window_train as ewt
from yolat_tpu_torch.ops.plans import EW_TRAIN_KEYS, edge_window_plan

N = 1009
HUB = 600
CS = (1, 5, 8, 64, 72)
DTYPES = ("float32", "bfloat16")
# (C, type) at the route's boundaries: rows of 1 and 32 whole 16-byte pieces
# (the 16-byte route), of 1.5 and 33 (the narrow route)
ROUTE_CASES = ((4, "float32"), (6, "float32"), (12, "bfloat16"),
               (256, "bfloat16"), (264, "bfloat16"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed) and the ordered emulation
# ---------------------------------------------------------------------------


def _hub_graph(seed, n=N, hub=HUB, star=320, empty=(200, 260)):
    """(edge [E, 2] i32 sorted by dst, mask [E] bool): about one edge per
    node from a source within 40 rows, `star` more into `hub` from sources
    within 150 rows and `star` more out of it to destinations within 150
    rows; no edge touches the nodes `empty`; 15% of the others masked out."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, n)
    src = np.clip(dst + rng.integers(-40, 41, n), 0, n - 1)
    near = np.clip(hub + rng.integers(-150, 151, (2, star)), 0, n - 1)
    src = np.concatenate([src, near[0], np.full(star, hub)])
    dst = np.concatenate([dst, np.full(star, hub), near[1]])
    keep = ~(((src >= empty[0]) & (src < empty[1]))
             | ((dst >= empty[0]) & (dst < empty[1])))
    src, dst = src[keep], dst[keep]
    mask = rng.random(len(dst)) < 0.85
    mask[(src == hub) | (dst == hub)] = True
    order = np.argsort(dst, kind="stable")
    edge = np.stack([src[order], dst[order]], axis=1).astype(np.int32)
    return edge, mask[order]


def _plan(seed=0, n=N):
    """The port's plan (src, dst, dptr, sperm, sptr) of the hub graph, as
    int32 numpy arrays, with the graph itself."""
    edge, mask = _hub_graph(seed, n)
    p = edge_window_plan(edge, mask, np.zeros((len(edge), 4), np.float32), n,
                         transpose=True)
    plan = tuple(p[k] for k in ("ew_src", "ew_dst") + EW_TRAIN_KEYS)
    din, dout = np.diff(plan[2]), np.diff(plan[4])
    assert din[HUB] > 300 and dout[HUB] > 300
    assert not (din[200:260].any() or dout[200:260].any())
    return plan, (edge, mask)


def _bf16(a):
    """float32 -> the nearest bf16 (ties to even), kept as float32."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(np.float32)


def _runs(acc, ptr, terms, rows=None):
    """acc[v] += terms[rows[ptr[v] + k]] for k = 0, 1, ... in turn: each
    node's run added left to right in float32."""
    deg = np.diff(ptr)
    for k in range(int(deg.max(initial=0))):
        v = np.nonzero(deg > k)[0]
        r = ptr[v] + k
        acc[v] += terms[r if rows is None else rows[r]]
    return acc


def _emulate(plan, n, x, dg, h, g, bf16):
    """The four functions in the plan's order (see the module docstring);
    x, dg and h hold values of the working type."""
    src, dst, dptr, sperm, sptr = plan
    rnd = _bf16 if bf16 else (lambda a: a)
    c = x.shape[1]
    gf = np.concatenate([x[dst], rnd(x[src] - x[dst])], axis=1)
    dx = np.zeros((n, c), np.float32)
    _runs(dx, dptr, rnd(dg[:, :c] - dg[:, c:]))
    _runs(dx, sptr, dg[:, c:], sperm)
    out = _runs(np.zeros((n, h.shape[1]), np.float32), dptr, h)
    return gf, rnd(dx), out, rnd(g[dst])


def _inputs(seed, plan, n, c, bf16):
    """x [n, c], dg [E, 2c], h [E, c] in the working type's values, and the
    float32 cotangent g [n, c]."""
    rng = np.random.default_rng(seed)
    e = len(plan[0])
    rnd = _bf16 if bf16 else (lambda a: a)
    x, dg, h, g = (rng.normal(size=s).astype(np.float32)
                   for s in ((n, c), (e, 2 * c), (e, c), (n, c)))
    return rnd(x), rnd(dg), rnd(h), g


def _shifted(a, dt, dev):
    """a on `dev` as a view one element into a flat buffer: its data off a
    16-byte boundary, which .contiguous() keeps."""
    buf = torch.zeros(a.size + 1, dtype=dt, device=dev)
    buf[1:] = torch.from_numpy(a.reshape(-1)).to(dev, dt)
    v = buf[1:].view(a.shape)
    assert v.contiguous().data_ptr() % 16 != 0
    return v


def _port(plan, n, x, dg, h, g, tdt, dev, shift=False):
    """The four wrappers on `dev` (kernels on the card, plain versions on
    the CPU) -> float32 numpy arrays; `shift`: every value input a view off
    a 16-byte boundary."""
    src, dst, dptr, sperm, sptr = (torch.from_numpy(a).to(dev) for a in plan)
    t = lambda a, dt=tdt: (_shifted(a, dt, dev) if shift
                           else torch.from_numpy(a).to(dev, dt))
    outs = (ewt.pair_fwd(t(x), src, dst),
            ewt.pair_bwd(t(dg), src, dst, dptr, sperm, sptr, n),
            ewt.wsum_fwd(t(h), dst, dptr, n),
            ewt.wsum_bwd(t(g, torch.float32), dst, tdt))
    assert [o.dtype for o in outs] == [tdt, tdt, torch.float32, tdt]
    return [o.float().cpu().numpy() for o in outs]


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", CS)
def test_plain_versions_match_the_ordered_emulation(c, dtype):
    plan, _ = _plan(c)
    bf16 = dtype == "bfloat16"
    ins = _inputs(c + 1, plan, N, c, bf16)
    want = _emulate(plan, N, *ins, bf16)
    got = _port(plan, N, *ins, getattr(torch, dtype), "cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[3], want[3])
    rtol = 2.0 ** -7 if bf16 else 1e-5
    np.testing.assert_allclose(got[1], want[1], rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)
    assert np.abs(want[1][HUB]).max() > 1.0
    assert not want[1][200:260].any() and not want[2][200:260].any()


def _window_rows(rows, real):
    """Real edge rows [E, C] -> the JAX window layout [NW * EB, C]."""
    out = np.zeros((len(real), rows.shape[1]), np.float32)
    out[real] = rows
    return out


def _assert_sums_close(got, want, dtype, terms):
    """A summed output [N, C] against the Pallas kernel's, both against the
    float64 sum of the same terms ([(index [T], values [T, C])], in the
    order the port adds them)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    exact, mag = np.zeros(got.shape), np.zeros(got.shape)
    k = np.zeros(got.shape[0])
    for idx, vals in terms:
        np.add.at(exact, idx, vals.astype(np.float64))
        np.add.at(mag, idx, np.abs(vals.astype(np.float64)))
        np.add.at(k, idx, 1.0)
    if dtype == "float32":
        lim = np.maximum(k - 1, 0)[:, None] * 2.0 ** -24 * mag + 1e-30
        assert (np.abs(got - exact) <= lim).all()
        assert (np.abs(got - want) <= 2 * lim).all()
        return
    np.testing.assert_allclose(got, exact, rtol=2.0 ** -7, atol=1e-6)
    assert (np.abs(got - want) <= 2.0 ** -7 * mag + 1e-6).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [5, 64])
def test_plain_versions_match_pallas_on_the_hub_graph(c, dtype):
    """The hub graph padded with 15 edge-free nodes to four windows of 256
    (the JAX plan wants N a multiple of its window; its per-window capacity
    is raised to hold the hub's edges)."""
    import jax
    import jax.numpy as jnp

    from yolat_tpu.ops.edge_window import edge_window_plan as jax_plan
    from yolat_tpu.ops.edge_window_train import ew_pair_features as jax_pair
    from yolat_tpu.ops.edge_window_train import \
        ew_window_segment_sum_n as jax_wsum

    nj = 1024
    plan, (edge, mask) = _plan(c)
    jp = jax_plan(edge, mask, np.zeros((len(edge), 4), np.float32), nj,
                  wn=256, eb=1024)
    assert jp is not None
    jew = tuple(jnp.asarray(jp[k]) for k in
                ("ew_src_rel", "ew_dst_loc", "ew_attr", "ew_maskf"))
    real = np.asarray(jp["ew_maskf"]).reshape(-1) > 0
    assert real.sum() == len(plan[0])
    bf16 = dtype == "bfloat16"
    x, dg, h, g = _inputs(c + 2, plan, N, c, bf16)
    pad = lambda a: np.concatenate([a, np.zeros((nj - N, c), np.float32)])
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    g_j, vjp = jax.vjp(lambda v: jax_pair(v, jew, interpret=True),
                       jnp.asarray(pad(x), jdt))
    (dx_j,) = vjp(jnp.asarray(_window_rows(dg, real), jdt))
    out_j, vjp = jax.vjp(lambda v: jax_wsum(v, jew, nj, interpret=True),
                         jnp.asarray(_window_rows(h, real), jdt))
    (dh_j,) = vjp(jnp.asarray(pad(g)))
    g_p, dx_p, out_p, dh_p = _port(plan, N, x, dg, h, g, tdt, "cpu")

    src, dst = plan[0], plan[1]
    np.testing.assert_array_equal(g_p, np.asarray(g_j, np.float32)[real])
    np.testing.assert_array_equal(dh_p, np.asarray(dh_j, np.float32)[real])
    dx_j, out_j = np.asarray(dx_j, np.float32), np.asarray(out_j, np.float32)
    assert not dx_j[N:].any() and not out_j[N:].any()
    rnd = _bf16 if bf16 else (lambda a: a)
    _assert_sums_close(dx_p, dx_j[:N], dtype,
                       [(dst, rnd(dg[:, :c] - dg[:, c:])), (src, dg[:, c:])])
    _assert_sums_close(out_p, out_j[:N], dtype, [(dst, h)])


def _route_case(c, dtype, dev, shift=False):
    """(the wrappers' outputs on `dev`, the emulation's) on the hub graph."""
    plan, _ = _plan(c)
    bf16 = dtype == "bfloat16"
    ins = _inputs(c + 2, plan, N, c, bf16)
    want = _emulate(plan, N, *ins, bf16)
    return _port(plan, N, *ins, getattr(torch, dtype), dev, shift), want


def test_vector_route_needs_whole_aligned_pieces():
    """The wrappers on the CPU at the kernels' route boundaries (rows of
    1 / 1.5 / 32 / 33 16-byte pieces; inputs off a 16-byte boundary, which
    .contiguous() keeps): the gathers exact, the sums within the plain
    versions' tolerances. The card twin below holds the kernels to the same
    cases bit for bit."""
    cases = [(c, dt, False) for c, dt in ROUTE_CASES]
    cases += [(64, dt, True) for dt in DTYPES]
    for c, dtype, shift in cases:
        got, want = _route_case(c, dtype, "cpu", shift)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[3], want[3])
        rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
        np.testing.assert_allclose(got[1], want[1], rtol=rtol, atol=1e-5)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)


def test_profiled_calls_name_the_smoke_calls(tmp_path):
    """`scripts/profiled_calls` (phases 7 and 14 read the profiler through
    it in a process of its own): its library calls compute what the
    smoke's library lambdas did, a "module:name" resolves to the wrapper,
    and a spec file round-trips through torch.save with its dtypes."""
    from yolat_tpu_torch.scripts import profiled_calls as pc

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(50, 6)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(30, 6)).astype(np.float32))
    i = torch.from_numpy(rng.integers(0, 50, 30))
    j = torch.from_numpy(rng.integers(0, 50, 30))
    assert torch.equal(pc.gather(x, i), x.index_select(0, i))
    assert all(torch.equal(u, v) for u, v in zip(
        pc.gather2(x, i, j), (x.index_select(0, i), x.index_select(0, j))))
    want = torch.zeros(50, 6).index_add_(0, i, a)
    assert torch.equal(pc.index_add(50, 6, i, a), want)
    assert torch.equal(pc.index_add2(50, 6, i, a, j, 2 * a),
                       want.index_add_(0, j, 2 * a))
    assert pc._function("yolat_tpu_torch.ops.edge_window_train:pair_fwd") \
        is ewt.pair_fwd
    assert pc._function("gather2") is pc.gather2
    spec = {"k": ("yolat_tpu_torch.ops.edge_window_train:wsum_bwd",
                  (x, i.int(), torch.bfloat16))}
    torch.save(spec, tmp_path / "s.pt")
    back = torch.load(tmp_path / "s.pt", weights_only=False)
    name, args = back["k"]
    assert pc._function(name)(*args).dtype == torch.bfloat16


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_wt", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase2_finds_each_row_kernel_instantiation():
    """Each row kernel's four instantiations, in the anonymous namespace of
    the source that defines it (the two sources include row_kernels.cuh,
    each in its own namespace): kernels 9 and 10 in edge_window_train.cu,
    7b in banded_train.cu."""
    cs = _chip_smoke()
    ns = "_ZN52_GLOBAL__N__0a1b2c3d_20_edge_window_train_cu_9e8f7a6b"
    fns = [f"{ns}15{k[0]}_kernelI{t}Lb{v}EEEvPKT_PKiS6_PS1_iiii"
           for k in (("pair_fwd",), ("pair_bwd",), ("wsum_fwd",), ("wsum_bwd",))
           for t in ("f", "13__nv_bfloat16") for v in (0, 1)]
    ns = "_ZN50_GLOBAL__N__0a1b2c3d_15_banded_train_cu_9e8f7a6b"
    fns += [f"{ns}17gather_bwd_kernelI{t}Lb{v}EEEvPKT_S4_PKiS6_S6_PS2_iiii"
            for t in ("f", "13__nv_bfloat16") for v in (0, 1)]
    for name in cs.ROW_KERNELS:
        got = cs.functions_of(name, fns)
        assert len(got) == 4 and all(name in f for f in got), (name, got)
    assert set(cs.ROW_KERNELS).isdisjoint(cs.TC_KERNELS + cs.F32_KERNELS)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", CS)
def test_kernels_are_the_ordered_emulation_bit_for_bit(cuda_device, c, dtype):
    plan, _ = _plan(c)
    bf16, tdt = dtype == "bfloat16", getattr(torch, dtype)
    ins = _inputs(c + 1, plan, N, c, bf16)
    want = _emulate(plan, N, *ins, bf16)
    _build.reset_launch_counts()
    got = _port(plan, N, *ins, tdt, cuda_device)
    again = _port(plan, N, *ins, tdt, cuda_device)
    torch.cuda.synchronize()
    assert all(v == 2 for k, v in _build.launch_counts.items()
               if k.startswith("ew_")), _build.launch_counts
    for a, b, w in zip(got, again, want):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b, a)


@pytest.mark.cuda
@pytest.mark.parametrize("c,dtype", ROUTE_CASES)
def test_route_boundaries_are_the_ordered_emulation_bit_for_bit(
        cuda_device, c, dtype):
    _build.reset_launch_counts()
    got, want = _route_case(c, dtype, cuda_device)
    torch.cuda.synchronize()
    assert all(v == 1 for k, v in _build.launch_counts.items()
               if k.startswith("ew_")), _build.launch_counts
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_without_edges(cuda_device, dtype):
    n, c, tdt = 300, 64, getattr(torch, dtype)
    none = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    ptr = torch.zeros(n + 1, dtype=torch.int32, device=cuda_device)
    x = torch.randn(n, c, device=cuda_device).to(tdt)
    assert ewt.pair_fwd(x, none, none).shape == (0, 2 * c)
    dx = ewt.pair_bwd(torch.zeros(0, 2 * c, dtype=tdt, device=cuda_device),
                      none, none, ptr, none, ptr, n)
    out = ewt.wsum_fwd(torch.zeros(0, c, dtype=tdt, device=cuda_device),
                       none, ptr, n)
    dh = ewt.wsum_bwd(x.float(), none, tdt)
    torch.cuda.synchronize()
    assert dx.shape == (n, c) and dx.dtype == tdt and not dx.any()
    assert out.shape == (n, c) and not out.any()
    assert dh.shape == (0, c) and dh.dtype == tdt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_views_with_an_offset_take_the_narrow_route(cuda_device, dtype):
    """C = 64 (the 16-byte route's rows) with every value input a view off a
    16-byte boundary: the kernels take the narrow route (a 16-byte load
    there would fault) and give the emulation's bits."""
    got, want = _route_case(64, dtype, cuda_device, shift=True)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)
