"""The port's kNN graph ops (`ops/knn.py`, `nn/dense_graph.dense_knn`) and
the small pieces that complete `ops/` and `nn/` (`nn/losses`,
`nn/layers.SumEmbedding`, `ops/iou.box_iou_pairwise` / `box_iou_plus1`)
against yolat_tpu's, on the CPU.

`knn_graph`, `dilated` (strided) and `dense_knn` must equal JAX's arrays
element for element, in order: `lax.top_k` ranks equal scores lower index
first, and the inputs plant exact ties (duplicated rows, masked columns,
segments smaller than k). The stochastic branch of `dilated` draws from a
torch generator (JAX's key stream is not reproduced), so it is held by
its structure: one k-subset of the k * dilation positions shared by every
centre, drawn at a rate within a binomial bound, reproducible from the
generator. The rest: rtol 1e-6 (the same f32 arithmetic, up to
summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.nn.dense_graph import dense_knn as jax_dense_knn
from yolat_tpu.nn.dense_graph import pairwise_neg_sqdist as jax_pairwise
from yolat_tpu.nn.layers import SumEmbedding as JaxSumEmbedding
from yolat_tpu.nn.losses import smooth_cross_entropy as jax_smooth_ce
from yolat_tpu.ops.iou import box_iou_pairwise as jax_iou_pairwise
from yolat_tpu.ops.iou import box_iou_plus1 as jax_iou_plus1
from yolat_tpu.ops.knn import dilated as jax_dilated
from yolat_tpu.ops.knn import knn_graph as jax_knn_graph
from yolat_tpu_torch.nn.dense_graph import dense_knn, pairwise_neg_sqdist
from yolat_tpu_torch.nn.layers import SumEmbedding
from yolat_tpu_torch.nn.losses import smooth_cross_entropy
from yolat_tpu_torch.nn.state_dict import load_flax_module
from yolat_tpu_torch.ops.iou import box_iou_pairwise, box_iou_plus1
from yolat_tpu_torch.ops.knn import dilated, knn_graph

N, C, K = 48, 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed=0):
    """N points with planted duplicates (exact score ties), a node mask
    and segments, one of them (3 rows) smaller than k."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, C)).astype(np.float32)
    x[[10, 11, 40]] = x[3]
    x[30:34] = x[5]
    x[21] = x[20]
    mask = rng.random(N) < 0.8
    mask[[3, 10, 11, 20, 21]] = True
    seg = np.repeat(np.arange(5), [12, 9, 3, 14, 10]).astype(np.int32)
    return x, mask, seg


CASES = {"plain": (False, False), "mask": (True, False),
         "segments": (False, True), "mask+segments": (True, True)}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("chunk_rows", [None, 7])
def test_knn_graph_equals_jax(case, chunk_rows):
    x, mask, seg = _points()
    use_mask, use_seg = CASES[case]
    m = mask if use_mask else None
    s = seg if use_seg else None
    want = jax_knn_graph(jnp.asarray(x), K,
                         mask=None if m is None else jnp.asarray(m),
                         segment_ids=None if s is None else jnp.asarray(s))
    got = knn_graph(torch.from_numpy(x), K,
                    mask=None if m is None else torch.from_numpy(m),
                    segment_ids=None if s is None else torch.from_numpy(s),
                    chunk_rows=chunk_rows)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    src, dst = got[0].numpy()
    np.testing.assert_array_equal(dst, np.repeat(np.arange(N), K))
    if use_seg:
        # the 3-row segment forces picks from other segments: masked out
        small = np.isin(dst, np.arange(21, 24))
        assert not got[1].numpy()[small & (seg[src] != seg[dst])].any()
        assert (small & (seg[src] != seg[dst])).any()


def test_knn_graph_tie_order_is_lower_index_first():
    """Row 3 has four exact copies (10, 11, 40 and itself): its first
    three neighbours are 10, 11, 40 in that order."""
    x, _, _ = _points()
    src = knn_graph(torch.from_numpy(x), K)[0].numpy()[0].reshape(N, K)
    assert list(src[3, :3]) == [10, 11, 40]
    assert list(src[31, :3]) == [5, 30, 32]


@pytest.mark.parametrize("dilation", [1, 2, 3])
def test_dilated_strided_equals_jax(dilation):
    x, mask, _ = _points(1)
    ei, em = jax_knn_graph(jnp.asarray(x), K * dilation,
                           mask=jnp.asarray(mask))
    want = jax_dilated(ei, em, K, dilation)
    got = dilated(torch.from_numpy(np.array(ei)),
                  torch.from_numpy(np.array(em)), K, dilation,
                  stochastic=True, epsilon=1.0)  # no generator: strided
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_dilated_stochastic_structure():
    """Edges that carry their position: src = centre * k * d + position.
    Every draw keeps one k-subset of the positions for every centre; the
    random branch (epsilon 0.3) is taken at a rate within 4 standard
    deviations of 200 draws; one seed gives one draw."""
    k, d, n_center, eps, draws = 4, 3, 10, 0.3, 200
    kd = k * d
    src = torch.arange(n_center * kd, dtype=torch.int32)
    ei = torch.stack([src, src // kd])
    em = torch.ones(n_center * kd, dtype=torch.bool)
    strided = list(range(0, kd, d))
    gen = torch.Generator().manual_seed(0)
    n_random = 0
    for _ in range(draws):
        out, m = dilated(ei, em, k, d, stochastic=True, epsilon=eps,
                         generator=gen)
        pos = (out[0] % kd).reshape(n_center, k)
        np.testing.assert_array_equal(out[1].numpy(),
                                      np.arange(n_center).repeat(k))
        assert (pos == pos[0]).all() and len(set(pos[0].tolist())) == k
        assert m.all() and len(m) == n_center * k
        n_random += pos[0].tolist() != strided
    sd = (draws * eps * (1 - eps)) ** 0.5
    assert abs(n_random - draws * eps) <= 4 * sd, n_random
    a = dilated(ei, em, k, d, True, 1.0, torch.Generator().manual_seed(7))
    b = dilated(ei, em, k, d, True, 1.0, torch.Generator().manual_seed(7))
    assert torch.equal(a[0], b[0])


def test_dense_knn_equals_jax():
    """Two sets of 12 with planted duplicates; the second has 3 valid
    points, fewer than k: the self column ties with the masked ones at
    -1e30 and the lower index wins, as in JAX."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, C)).astype(np.float32)
    x[0, [4, 7]] = x[0, 1]
    mask = np.ones((2, 12), bool)
    mask[0, 9:] = False
    mask[1, 3:] = False
    np.testing.assert_allclose(
        pairwise_neg_sqdist(torch.from_numpy(x)).numpy(),
        np.asarray(jax_pairwise(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    for m in (None, mask):
        want = jax_dense_knn(jnp.asarray(x), K,
                             mask=None if m is None else jnp.asarray(m))
        for rows in (None, 5):
            got = dense_knn(torch.from_numpy(x), K,
                            mask=None if m is None else torch.from_numpy(m),
                            chunk_rows=rows)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("smoothing", [0.0, 0.2])
@pytest.mark.parametrize("masked", [False, True])
def test_smooth_cross_entropy_matches_jax(smoothing, masked):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(20, 6)) * 3).astype(np.float32)
    labels = rng.integers(0, 6, 20).astype(np.int32)
    mask = rng.random(20) < 0.6 if masked else None

    def f(lg):
        return jax_smooth_ce(lg, jnp.asarray(labels), smoothing,
                             None if mask is None else jnp.asarray(mask))

    want, want_g = jax.value_and_grad(f)(jnp.asarray(logits))
    lg = torch.tensor(logits, requires_grad=True)
    got = smooth_cross_entropy(lg, torch.from_numpy(labels), smoothing,
                               None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-7)


def test_smooth_cross_entropy_empty_mask_is_zero():
    logits = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    got = smooth_cross_entropy(logits, torch.zeros(4, dtype=torch.int64),
                               mask=torch.zeros(4, dtype=torch.bool))
    assert got.item() == 0.0


def test_sum_embedding_through_converted_weights():
    dims, width = (5, 7, 3), 8
    rng = np.random.default_rng(4)
    x = np.stack([rng.integers(0, d, 30) for d in dims], 1).astype(np.int32)
    jm = JaxSumEmbedding(dims, width)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(0),
                                                 jnp.asarray(x)))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    pm = load_flax_module(SumEmbedding(dims, width), variables)
    assert list(pm.state_dict()) == [f"emb_{i}.weight" for i in range(3)]
    got = pm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # xavier-uniform from the generator: bound sqrt(6 / (dim + width))
    a = SumEmbedding(dims, width, generator=torch.Generator().manual_seed(1))
    b = SumEmbedding(dims, width, generator=torch.Generator().manual_seed(1))
    for i, d in enumerate(dims):
        w = getattr(a, f"emb_{i}").weight.detach()
        assert torch.equal(w, getattr(b, f"emb_{i}").weight)
        assert float(w.abs().max()) <= (6.0 / (d + width)) ** 0.5


def _boxes(rng, n):
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(0, 30, (n, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    b[0] = [5, 5, 5, 20]     # zero width
    b[1] = [10, 10, 10, 10]  # a point
    b[2] = [30, 30, 20, 40]  # x1 < x0
    return b


def test_box_ious_match_jax():
    rng = np.random.default_rng(5)
    a, b = _boxes(rng, 12), _boxes(rng, 9)
    b2 = _boxes(rng, 12)
    b2[3] = a[3]  # identical boxes
    for plus1 in (False, True):
        want = np.asarray(jax_iou_pairwise(jnp.asarray(a), jnp.asarray(b2),
                                           plus1))
        got = box_iou_pairwise(torch.from_numpy(a), torch.from_numpy(b2),
                               plus1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[3] == pytest.approx(1.0)
    want = np.asarray(jax_iou_plus1(jnp.asarray(a), jnp.asarray(b)))
    got = box_iou_plus1(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (12, 9)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
