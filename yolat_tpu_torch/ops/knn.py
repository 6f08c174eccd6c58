"""kNN graphs over feature rows, and dilated edge subsampling.

Counterpart of `yolat_tpu/ops/knn.py` (`knn_graph` :20-56, `dilated`
:59-77; the reference's gcn_lib/sparse/torch_edge.py:6-113). The scores
are JAX's, bit for bit in form: the negative squared distance
2 x_i.x_j - |x_i|^2 - |x_j|^2 (one f32 product, IEEE: TF32 off), the self
column lowered by 2e30, masked and cross-segment columns set to -1e30.

The selection is `lax.top_k`'s: per row the k largest scores in
descending order, the lower column first among equal scores. Exact ties
are common (repeated symbols give equal feature rows; every masked or
cross-segment column scores -1e30), and `torch.topk` orders ties as it
likes, so each score is made a unique int64 key, its f32 bits mapped to
an order-preserving int32 in the high word and (N - 1 - column) in the
low word, and one `torch.topk` over the keys gives that order. -0.0 is
read as 0.0 first, as a float compare does. Cost: 12 bytes a score while
a chunk's keys are built (its f32 scores and the int64 keys) and a topk
over 64-bit keys.

The [N, N] matrix is never built: rows go in chunks of `chunk_rows`
(default: as many as keep a chunk's scores and keys within CHUNK_BYTES),
and every row's selection depends on its own scores alone, so any chunk
size gives the same arrays.
"""

from __future__ import annotations

import contextlib

import torch

# a chunk's f32 scores and int64 keys: 12 bytes per score
CHUNK_BYTES = 2 << 30
_BYTES_PER_SCORE = 12


@contextlib.contextmanager
def ieee_f32():
    """f32 products on IEEE arithmetic (TF32 off) inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def default_chunk_rows(n: int) -> int:
    return max(1, min(n, CHUNK_BYTES // (_BYTES_PER_SCORE * max(n, 1))))


def ordered_topk(scores, k: int):
    """Column indices [..., k] of the k largest scores along the last axis,
    in descending order, the lower column first among equal scores
    (`lax.top_k`'s order). `scores` (f32) is overwritten."""
    n = scores.shape[-1]
    scores.add_(0.0)  # -0.0 -> 0.0
    bits = scores.view(torch.int32)
    # negative floats: flip the magnitude bits so the int32 order is the
    # float order
    flip = bits >> 31
    flip &= 0x7FFFFFFF
    bits ^= flip
    del flip
    key = bits.to(torch.int64)
    del scores, bits
    key.mul_(1 << 32).add_(torch.arange(n - 1, -1, -1, device=key.device))
    return torch.topk(key, k, dim=-1).indices


def knn_indices(x, k: int, mask=None, segment_ids=None,
                self_penalty: float = 2e30, chunk_rows: int | None = None):
    """Neighbour columns [N, k] (int64) of every row of x [N, C], in
    `lax.top_k`'s order over JAX's scores with the self column lowered by
    `self_penalty`, scored in f32 whatever x's type."""
    n = x.shape[0]
    rows = chunk_rows or default_chunk_rows(n)
    idx = torch.empty(n, k, dtype=torch.int64, device=x.device)
    with torch.no_grad(), ieee_f32():
        x = x.detach().float()
        x2 = (x * x).sum(dim=1)
        for r0 in range(0, n, rows):
            r1 = min(n, r0 + rows)
            # 2 x_i.x_j - |x_i|^2 - |x_j|^2 in JAX's order of operations
            d = torch.mm(x[r0:r1], x.t())
            d.mul_(2.0)
            d.sub_(x2[r0:r1, None])
            d.sub_(x2[None, :])
            d.diagonal(offset=r0).sub_(self_penalty)
            if mask is not None:
                d.masked_fill_(~mask[None, :], -1e30)
            if segment_ids is not None:
                d.masked_fill_(segment_ids[r0:r1, None]
                               != segment_ids[None, :], -1e30)
            idx[r0:r1] = ordered_topk(d, k)
            del d
    return idx


def knn_graph(x, k: int, mask=None, segment_ids=None,
              chunk_rows: int | None = None):
    """k nearest neighbours of every row of x [N, C] (self excluded),
    `mask` [N] bool: padded rows are never neighbours; `segment_ids` [N]:
    neighbours within one segment (picks a small segment forces across
    are emitted masked out). -> (edge_index [2, N * k] int32 (src =
    neighbour j, dst = centre i, dst = repeat(arange(N), k)), edge_mask
    [N * k] bool)."""
    n = x.shape[0]
    src = knn_indices(x, k, mask, segment_ids,
                      chunk_rows=chunk_rows).reshape(-1)
    dst = torch.arange(n, device=x.device).repeat_interleave(k)
    edge_mask = src != dst
    if mask is not None:
        edge_mask &= mask[dst] & mask[src]
    if segment_ids is not None:
        edge_mask &= segment_ids[dst] == segment_ids[src]
    return torch.stack([src, dst]).to(torch.int32), edge_mask


def dilated(edge_index, edge_mask, k: int, dilation: int = 1,
            stochastic: bool = False, epsilon: float = 0.0,
            generator: torch.Generator | None = None):
    """Keep every `dilation`-th of each centre's k * dilation neighbours or,
    when `stochastic` with a generator, with probability epsilon one random
    k-subset of the positions shared by every centre (torch_edge.py
    Dilated:6-29). The draw (one uniform, one permutation, on the
    generator's device) is the generator's: JAX's key stream is not
    reproduced."""
    if dilation <= 1:
        return edge_index, edge_mask
    kd = k * dilation
    n_center = edge_index.shape[1] // kd
    ei = edge_index.reshape(2, n_center, kd)
    em = edge_mask.reshape(n_center, kd)
    sel = torch.arange(0, kd, dilation, device=edge_index.device)
    if stochastic and generator is not None:
        gdev = generator.device
        use_random = torch.rand((), generator=generator, device=gdev) < epsilon
        perm = torch.randperm(kd, generator=generator, device=gdev)[:k]
        sel = torch.where(use_random.to(sel.device), perm.to(sel.device), sel)
    return ei[:, :, sel].reshape(2, -1), em[:, sel].reshape(-1)
