"""Kernels 7, 7b, 8 and 8b (the banded training route: 7 and 7b in
`csrc/banded_train.cu`, 8 and 8b on kernel 10's bodies in
`csrc/edge_window_train.cu`) and their plain versions against an ordered
emulation of the plan's summation order.

The four functions over the plan of `ops.plans.banded_plan(transpose=True)`
(x [N, C]; the family's E real edges sorted by the endpoint `own`, with
offsets nptr; tperm the rows stably sorted by the other endpoint, with
offsets tptr):
  7   x_own[r] = x[own r], x_oth[r] = x[oth r]
  7b  dx[v] = round(a + b), a the float32 sum of g_own over v's own run in
      nptr order, b that of g_oth over its other run in tperm order, each
      from 0
  8   out[v] = the float32 sum of rows over v's own run in nptr order
  8b  d_rows[r] = round(g[own r])
where round is to the working type (bf16 or float32). `_emulate` computes
them with numpy, adding in float32 one term at a time in that order, and
rounding to bf16 (nearest even) where the header of the CUDA sources says.

The graph (`_clique_graph`): N = 1009 nodes, lower-triangular cliques of 2
to 17 nodes over contiguous node runs (the super-edge family's shape), a
hub node outside them that is the own endpoint of 300 rows and the other
endpoint of 300 more, and nodes [200, 260) without any row; 15% of the
buffer's rows masked out.

Unmarked, on the CPU:
  * the port's plain versions against the emulation at C 1, 5, 8, 64, 72,
    float32 and bf16: the gathers exact; the sums within float32 rtol/atol
    1e-5, 7b at bf16 one output ulp (rtol 2^-7 over atol 1e-5);
  * the same graph (padded with edge-free nodes to N = 1024, two windows of
    512) against the JAX functions at C 5 and 64, their Pallas kernels in
    interpret mode as tests/test_torch_pp_train_ops.py runs them: the
    gathers exact; a float32 sum of k terms within 2 (k - 1) 2^-24
    sum|terms| (each side within (k - 1) 2^-24 sum|terms| of the exact
    sum; the hub adds 300 terms a side); the bf16 sums to one ulp of the
    float64 sum, and within 2^-7 of sum|terms| of the Pallas kernel's (its
    interpreter rounds partial sums of bf16 inputs to bf16);
  * the wrappers at the kernels' route boundaries (rows of 1 and 1.5
    16-byte pieces, of 32 and 33, and inputs off a 16-byte boundary)
    against the emulation; the 32-bit guard of 7b, 8 and 8b; phase 2's
    match of the kernel names to 7b's instantiations.
jax is imported inside those tests, so the file imports on the card.

Marked `cuda` (each skips through the `cuda_device` fixture where no CUDA
device is present):

  python -m pytest --noconftest -q -m cuda tests/test_torch_banded_train_tc.py

  * each kernel bit-identical to the emulation at the same C values and
    types (the 16-byte route at C 8, 64, 72; the narrow route at C 1, 5),
    two runs bit-identical;
  * the route boundaries above, bit for bit;
  * E = 0 through all four;
  * inputs that are views with a storage offset (not 16-byte aligned) take
    the narrow route and give the same bits.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.ops import banded_train as bt
from yolat_tpu_torch.ops.banded_message import plan_tensors
from yolat_tpu_torch.ops.plans import banded_plan

N = 1009
HUB = 600
STAR = 300
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


def _clique_graph(seed, n=N, hub=HUB, star=STAR, empty=(200, 260),
                  pad_e=8192):
    """(edge [pad_e, 2] i32 as (src, dst), mask [pad_e] bool): lower-
    triangular cliques (src < dst) over contiguous runs of 2-17 nodes that
    skip `empty` and the hub; the hub is the destination of `star` rows from
    distinct sources within 160 rows and the source of `star` more; 15% of
    the other real rows and the buffer's tail masked out."""
    rng = np.random.default_rng(seed)
    edges, lo = [], 0
    while True:
        m = int(rng.integers(2, 18))
        lo += int(rng.integers(0, 6))
        if empty[0] - m < lo < empty[1]:
            lo = empty[1]
        if lo <= hub < lo + m:
            lo = hub + 1
        if lo + m > n:
            break
        ids = np.arange(lo, lo + m)
        src, dst = np.meshgrid(ids, ids)
        low = src < dst
        edges.append(np.stack([src[low], dst[low]], axis=1))
        lo += m
    near = np.concatenate([np.arange(hub - 160, hub),
                           np.arange(hub + 1, hub + 161)])
    ins = rng.choice(near, star, replace=False)
    outs = rng.choice(near, star, replace=False)
    edges.append(np.stack([ins, np.full(star, hub)], axis=1))
    edges.append(np.stack([np.full(star, hub), outs], axis=1))
    e = np.concatenate(edges).astype(np.int32)
    e = e[rng.permutation(len(e))]  # the plan sorts; the buffer need not be
    mask = rng.random(len(e)) < 0.85
    mask[(e[:, 0] == hub) | (e[:, 1] == hub)] = True
    edge = np.zeros((pad_e, 2), np.int32)
    full = np.zeros(pad_e, bool)
    edge[:len(e)], full[:len(e)] = e, mask
    return edge, full


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


def _shifted(a, dt, dev):
    """a on `dev` as a view one element into a flat buffer: its data off a
    16-byte boundary, which .contiguous() keeps."""
    buf = torch.zeros(a.size + 1, dtype=dt, device=dev)
    buf[1:] = torch.from_numpy(a.reshape(-1)).to(dev, dt)
    v = buf[1:].view(a.shape)
    assert v.contiguous().data_ptr() % 16 != 0
    return v


def _plan(seed=0, n=N):
    """The port's plan of the clique graph (numpy dict), with the graph."""
    edge, mask = _clique_graph(seed, n)
    p = banded_plan(edge, mask, np.zeros((len(edge), 4), np.float32), n,
                    transpose=True)
    din, dout = np.diff(p["nptr"]), np.diff(p["tptr"])
    assert din[HUB] == STAR and dout[HUB] == STAR
    assert not (din[200:260].any() or dout[200:260].any())
    assert din.max(initial=0) == STAR and np.median(din[din > 0]) < 10
    return p, (edge, mask)


def _emulate(p, n, x, g_own, g_oth, rows, g, bf16):
    """The four functions in the plan's order (see the module docstring);
    x, g_own, g_oth and rows hold values of the working type."""
    rnd = _bf16 if bf16 else (lambda a: a)
    own, oth, nptr, tperm, tptr = (p[k] for k in
                                   ("own", "oth", "nptr", "tperm", "tptr"))
    c = x.shape[1]
    a = _runs(np.zeros((n, c), np.float32), nptr, g_own)
    b = _runs(np.zeros((n, c), np.float32), tptr, g_oth, tperm)
    out = _runs(np.zeros((n, c), np.float32), nptr, rows)
    return x[own], x[oth], rnd(a + b), out, rnd(g[own])


def _inputs(seed, e, n, c, bf16):
    """x [n, c], g_own, g_oth, rows [E, c] in the working type's values, and
    the float32 cotangent g [n, c]."""
    rng = np.random.default_rng(seed)
    rnd = _bf16 if bf16 else (lambda a: a)
    x, g_own, g_oth, rows, g = (rng.normal(size=s).astype(np.float32)
                                for s in ((n, c), (e, c), (e, c), (e, c),
                                          (n, c)))
    return rnd(x), rnd(g_own), rnd(g_oth), rnd(rows), g


def _port(p, n, x, g_own, g_oth, rows, g, tdt, dev, shift=False):
    """The four wrappers on `dev` (kernels on the card, plain versions on
    the CPU) -> float32 numpy arrays (x_own, x_oth, dx, out, d_rows);
    `shift`: every value input a view off a 16-byte boundary."""
    bm = plan_tensors(p, dev)
    t = lambda a, dt=tdt: (_shifted(a, dt, dev) if shift
                           else torch.from_numpy(a).to(dev, dt))
    x_own, x_oth = bt.gather_fwd(t(x), bm.own, bm.oth)
    outs = (x_own, x_oth,
            bt.gather_bwd(t(g_own), t(g_oth), bm.own, bm.oth, bm.nptr,
                          bm.tperm, bm.tptr, n),
            bt.scatter_own_fwd(t(rows), bm.own, bm.nptr, n),
            bt.scatter_own_bwd(t(g, torch.float32), bm.own, tdt))
    assert [o.dtype for o in outs] == [tdt] * 3 + [torch.float32, tdt]
    return [o.float().cpu().numpy() for o in outs]


def _case(c, dtype, dev, shift=False, seed_shift=1):
    """(the wrappers' outputs on `dev`, the emulation's) on the clique
    graph."""
    p, _ = _plan(c)
    bf16 = dtype == "bfloat16"
    ins = _inputs(c + seed_shift, len(p["own"]), N, c, bf16)
    want = _emulate(p, N, *ins, bf16)
    return _port(p, N, *ins, getattr(torch, dtype), dev, shift), want


def _assert_plain_close(got, want, dtype):
    for i in (0, 1, 4):  # the gathers: copies
        np.testing.assert_array_equal(got[i], want[i])
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got[2], want[2], rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", CS)
def test_plain_versions_match_the_ordered_emulation(c, dtype):
    got, want = _case(c, dtype, "cpu")
    _assert_plain_close(got, want, dtype)
    assert np.abs(want[2][HUB]).max() > 1.0
    assert not want[2][200:260].any() and not want[3][200:260].any()


def _assert_sums_close(got, want, dtype, terms):
    """A summed output [N, C] against the Pallas kernel's, both against the
    float64 sum of the same terms ([(index [T], values [T, C])])."""
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
def test_plain_versions_match_pallas_on_the_clique_graph(c, dtype):
    """The clique graph padded with 15 edge-free nodes to two windows of 512
    (the JAX plan wants N a multiple of its window; every other endpoint
    lies within 128 rows of its window). The clique graph repeats no
    (own, other) pair, so per-edge rows are matched through that pair."""
    import jax
    import jax.numpy as jnp

    from yolat_tpu.ops.banded_message import banded_plan as jax_plan
    from yolat_tpu.ops.banded_message import bm_of as jax_bm_of
    from yolat_tpu.ops.banded_train import _plan_indices
    from yolat_tpu.ops.banded_train import banded_gather as jax_gather
    from yolat_tpu.ops.banded_train import banded_scatter_own as jax_scatter

    nj = 1024
    p, (edge, mask) = _plan(c)
    jp = jax_plan(edge, mask, np.zeros((len(edge), 4), np.float32), nj,
                  sortby=1, wn=512, pad=128, eblk=256)
    assert jp is not None
    jbm = jax_bm_of({**{k: jnp.asarray(v) for k, v in jp.items()},
                     "pos": jnp.zeros((nj, 2))}, "")
    j_own, j_oth, j_m = (np.asarray(a) for a in _plan_indices(jbm, nj))
    real = j_m > 0
    key = p["own"].astype(np.int64) * nj + p["oth"]
    order = np.argsort(key)
    assert len(np.unique(key)) == len(key) == int(real.sum())
    jkey = j_own[real].astype(np.int64) * nj + j_oth[real]
    to_port = order[np.searchsorted(key[order], jkey)]  # per real JAX row
    assert np.array_equal(key[to_port], jkey)

    def jrows(a):
        out = np.zeros((real.shape[0], a.shape[1]), np.float32)
        out[real] = a[to_port]
        return out

    bf16 = dtype == "bfloat16"
    x, g_own, g_oth, rows, g = _inputs(c + 2, len(key), N, c, bf16)
    pad = lambda a: np.concatenate([a, np.zeros((nj - N, c), np.float32)])
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    (xo_j, xt_j), vjp = jax.vjp(lambda v: jax_gather(v, jbm, True),
                                jnp.asarray(pad(x), jdt))
    (dx_j,) = vjp((jnp.asarray(jrows(g_own)), jnp.asarray(jrows(g_oth))))
    out_j, vjp = jax.vjp(lambda r: jax_scatter(r, jbm, nj, True),
                         jnp.asarray(jrows(rows), jdt))
    (dr_j,) = vjp(jnp.asarray(pad(g)))
    got = _port(p, N, x, g_own, g_oth, rows, g, tdt, "cpu")

    for port, jax_rows in ((got[0], xo_j), (got[1], xt_j), (got[4], dr_j)):
        np.testing.assert_array_equal(jrows(port),
                                      np.asarray(jax_rows, np.float32))
    dx_j, out_j = np.asarray(dx_j, np.float32), np.asarray(out_j, np.float32)
    assert not dx_j[N:].any() and not out_j[N:].any()
    own, oth = p["own"], p["oth"]
    _assert_sums_close(got[2], dx_j[:N], dtype, [(own, g_own), (oth, g_oth)])
    _assert_sums_close(got[3], out_j[:N], dtype, [(own, rows)])


def test_vector_route_needs_whole_aligned_pieces():
    """The wrappers on the CPU at the kernels' route boundaries (rows of
    1 / 1.5 / 32 / 33 16-byte pieces; inputs off a 16-byte boundary, which
    .contiguous() keeps): the gathers exact, the sums within the plain
    versions' tolerances. The card twin below holds the kernels to the same
    cases bit for bit."""
    cases = [(c, dt, False) for c, dt in ROUTE_CASES]
    cases += [(64, dt, True) for dt in DTYPES]
    for c, dtype, shift in cases:
        got, want = _case(c, dtype, "cpu", shift, seed_shift=2)
        _assert_plain_close(got, want, dtype)


def test_kernels_refuse_sizes_past_32_bit_indices(monkeypatch):
    """7b, 8 and 8b index in 32-bit int: the wrappers raise where e * c or
    n * c reaches 2^31 before they allocate or launch anything (the
    operands here are broadcast views; the route is forced, since a CPU
    tensor takes the plain version)."""
    monkeypatch.setattr(bt, "_route", lambda t, name: True)
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("launched"))
    e, c, n = 2 ** 16, 2 ** 15 + 1, 8
    wide = torch.zeros(1, 1).expand(e, c)
    idx = torch.zeros(1, dtype=torch.int32).expand(e)
    ptr = torch.zeros(n + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="32-bit"):
        bt.gather_bwd(wide, wide, idx, idx, ptr, idx, ptr, n)
    with pytest.raises(ValueError, match="32-bit"):
        bt.scatter_own_fwd(wide, idx, ptr, n)
    with pytest.raises(ValueError, match="32-bit"):
        bt.scatter_own_bwd(torch.zeros(1, 1).expand(n, c), idx,
                           torch.float32)
    tall = torch.zeros(1, 1).expand(2 ** 31 // 4, 4)  # n * c = 2^31
    with pytest.raises(ValueError, match="32-bit"):
        bt.scatter_own_bwd(tall, idx[:4], torch.float32)


def test_banded_train_times_reads_phase_14s_calls():
    """`scripts/banded_train_times` (the same-call timing of 7-8b on two
    trees): its calls are phase 14's, each resolves to the wrapper or
    library call that computes the function, and its ptxas reader keeps
    the banded route's kernels only."""
    from yolat_tpu_torch.scripts import banded_train_times as btt
    from yolat_tpu_torch.scripts import profiled_calls as pc

    p, _ = _plan(5)
    bm = plan_tensors(p)
    specs, bounds = btt.specs_and_bounds(bm, N, torch.device("cpu"))
    names = ("banded_gather", "banded_gather_bwd", "banded_scatter_own",
             "banded_scatter_own_bwd")
    keys = [f"{k} {t} C=64" for t in ("f32", "bf16") for k in names]
    assert sorted(bounds) == sorted(keys)
    assert sorted(specs) == sorted(keys + [k + " library" for k in keys])
    for k in keys:
        (kname, kargs), (lname, largs) = specs[k], specs[k + " library"]
        got, lib = pc._function(kname)(*kargs), pc._function(lname)(*largs)
        got, lib = (got if isinstance(got, tuple) else (got,),
                    lib if isinstance(lib, tuple) else (lib,))
        for a, b in zip(got, lib):  # 7b at bf16 rounds its f32 sum
            rtol = 2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-5
            torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                       atol=1e-5)
        assert bounds[k] > 0
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{f}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {f}\n"
        f"    0 bytes stack frame, {s} bytes spill stores, {s} bytes spill "
        f"loads\nptxas info    : Used {r} registers, used 1 barriers"
        for f, r, s in (("_ZN1a17gather_bwd_kernelIfLb1EEEvPKT_", 40, 0),
                        ("_ZN1a15wsum_fwd_kernelIfLb1EEEvPKT_", 32, 4),
                        ("_ZN1a16banded_tc_kernelILb0EEEvPKT_", 128, 0)))
    assert btt.ptxas_report(log) == {
        "_ZN1a17gather_bwd_kernelIfLb1EEEvPKT_": dict(
            registers=40, spill_stores=0, spill_loads=0),
        "_ZN1a15wsum_fwd_kernelIfLb1EEEvPKT_": dict(
            registers=32, spill_stores=4, spill_loads=4)}


def test_banded_train_decomp_variants_apply_to_the_sources():
    """The 7b probe's edits (`scripts/banded_train_decomp`): each applies
    once to the source as it is, each variant differs from the base, and
    no edit reaches another kernel of the file or a header."""
    from yolat_tpu_torch.scripts import banded_train_decomp as bd
    from yolat_tpu_torch.scripts import source_edits

    src = source_edits.variant_sources(bd.EDITS)
    assert set(src) == {v[0] for v in bd.EDITS}
    base = src["b7_base"][1]
    for name, (source, files) in src.items():
        assert source == "banded_train.cu"
        assert (files == base) == (name == "b7_base"), name
        for fn in _build.HEADERS:
            assert files[fn] == base[fn], (name, fn)
        k7 = lambda t: t[t.index("gather_pair_kernel("):t.index("// Kernel 7b")]
        assert k7(files["banded_train.cu"]) == k7(base["banded_train.cu"])
    assert "constexpr int STEP = 2;" in src["b7_step2"][1]["banded_train.cu"]
    assert "q1 = q;" in src["b7_own"][1]["banded_train.cu"]
    assert "tperm" not in src["b7_notperm"][1]["banded_train.cu"].split(
        "uint4 ga[STEP], gb[STEP];")[1].split("// the next rows")[0]


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_bt", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase2_finds_each_7b_instantiation():
    """Kernel 7b's four instantiations (f32 and bf16, each route) in
    banded_train.cu's own anonymous namespace; the names of kernel 7 and of
    the row kernels of edge_window_train.cu do not match it."""
    cs = _chip_smoke()
    assert "gather_bwd_kernel" in cs.ROW_KERNELS
    ns = "_ZN50_GLOBAL__N__0a1b2c3d_15_banded_train_cu_9e8f7a6b"
    fns = [f"{ns}17gather_bwd_kernelI{t}Lb{v}EEEvPKT_S4_PKiS6_S6_PS2_iiii"
           for t in ("f", "13__nv_bfloat16") for v in (0, 1)]
    others = [f"{ns}18gather_pair_kernelI5uint4EEvPKT_PKiS6_PS1_S7_iii",
              "_ZN53_GLOBAL__N__32312558_20_edge_window_train_cu_7247669415"
              "pair_bwd_kernelIfLb1EEEvPKT_PKiS5_S5_PS1_iiii"]
    got = cs.functions_of("gather_bwd_kernel", fns + others)
    assert got == fns


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


_COUNTED = ("banded_gather", "banded_gather_bwd", "banded_scatter_own",
            "banded_scatter_own_bwd")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", CS)
def test_kernels_are_the_ordered_emulation_bit_for_bit(cuda_device, c, dtype):
    _build.reset_launch_counts()
    got, want = _case(c, dtype, cuda_device)
    again, _ = _case(c, dtype, cuda_device)
    torch.cuda.synchronize()
    assert all(_build.launch_counts[k] == 2 for k in _COUNTED), \
        _build.launch_counts
    for a, b, w in zip(got, again, want):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b, a)


@pytest.mark.cuda
@pytest.mark.parametrize("c,dtype", ROUTE_CASES)
def test_route_boundaries_are_the_ordered_emulation_bit_for_bit(
        cuda_device, c, dtype):
    _build.reset_launch_counts()
    got, want = _case(c, dtype, cuda_device, seed_shift=2)
    torch.cuda.synchronize()
    assert all(_build.launch_counts[k] == 1 for k in _COUNTED), \
        _build.launch_counts
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_without_edges(cuda_device, dtype):
    n, c, tdt = 300, 64, getattr(torch, dtype)
    dev = cuda_device
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    ptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    x = torch.randn(n, c, device=dev).to(tdt)
    rows = torch.zeros(0, c, dtype=tdt, device=dev)
    _build.reset_launch_counts()
    x_own, x_oth = bt.gather_fwd(x, none, none)
    dx = bt.gather_bwd(rows, rows, none, none, ptr, none, ptr, n)
    out = bt.scatter_own_fwd(rows, none, ptr, n)
    d_rows = bt.scatter_own_bwd(x.float(), none, tdt)
    torch.cuda.synchronize()
    assert x_own.shape == x_oth.shape == (0, c) and x_own.dtype == tdt
    assert dx.shape == (n, c) and dx.dtype == tdt and not dx.any()
    assert out.shape == (n, c) and out.dtype == torch.float32
    assert not out.any()
    assert d_rows.shape == (0, c) and d_rows.dtype == tdt
    assert not any(_build.launch_counts[k] for k in _COUNTED)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_views_with_an_offset_take_the_narrow_route(cuda_device, dtype):
    """C = 64 (the 16-byte route's rows) with every value input a view off a
    16-byte boundary: the kernels take the narrow route (a 16-byte load
    there would fault) and give the emulation's bits."""
    got, want = _case(64, dtype, cuda_device, shift=True, seed_shift=2)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)
