"""Graph partitioning and edge-sharded segment reductions.

Counterpart of `yolat_tpu/parallel/partition.py`: the reference's
(unused) DeepGCN partition helpers `random_partition_graph` /
`generate_sub_graphs` (numpy, as there), and the scaling primitive for a
giant SVG: each rank reduces its own shard of the edge set and the partial
sums (and counts, for the mean) are summed over the ranks of `group`, as
the JAX functions psum them over the mesh axis. Plain torch, as the JAX
functions are plain jnp; the sums over ranks are differentiable
(`distributed.all_reduce_sum`).
"""

from __future__ import annotations

import numpy as np
import torch

from yolat_tpu_torch.ops.segment import segment_sum
from yolat_tpu_torch.parallel.distributed import all_reduce_sum


def random_partition_graph(num_nodes: int, cluster_number: int = 10,
                           rng: np.random.Generator | None = None
                           ) -> np.ndarray:
    """Uniform random node -> cluster assignment (data_util.py:43-47)."""
    rng = rng or np.random.default_rng()
    return rng.integers(0, cluster_number, size=num_nodes)


def generate_sub_graphs(edge: np.ndarray, parts: np.ndarray,
                        cluster_number: int = 10, batch_size: int = 1):
    """Per batch of clusters (data_util.py:50-61): (node_ids, the edges
    whose both endpoints fall in the batch's clusters, reindexed
    locally)."""
    num_batches = (cluster_number + batch_size - 1) // batch_size
    out = []
    for b in range(num_batches):
        sel = range(b * batch_size, min((b + 1) * batch_size, cluster_number))
        node_mask = np.isin(parts, list(sel))
        node_ids = np.where(node_mask)[0]
        local = -np.ones(len(parts), dtype=np.int64)
        local[node_ids] = np.arange(len(node_ids))
        keep = node_mask[edge[:, 0]] & node_mask[edge[:, 1]]
        out.append((node_ids, local[edge[keep]]))
    return out


def sharded_segment_sum(data, segment_ids, num_segments: int, group=None,
                        mask=None):
    """Segment sum of this rank's edge shard, summed over the ranks of
    `group` (segment ids global): every rank gets the whole sum."""
    local = segment_sum(data, segment_ids, num_segments, mask=mask)
    return all_reduce_sum(local, group)


def sharded_segment_mean(data, segment_ids, num_segments: int, group=None,
                         mask=None):
    """Masked segment mean over the union of the ranks' shards: partial
    sums and partial counts summed over ranks, then divided (an empty
    segment gives 0)."""
    local = segment_sum(data, segment_ids, num_segments, mask=mask)
    ones = (mask.to(data.dtype) if mask is not None
            else torch.ones(data.shape[0], dtype=data.dtype,
                            device=data.device))
    cnt = segment_sum(ones, segment_ids, num_segments)
    total = all_reduce_sum(local, group)
    count = all_reduce_sum(cnt, group)
    return total / torch.clamp(count, min=1.0).reshape(
        (-1,) + (1,) * (total.dim() - 1))


def edge_sharded_gp2_layer(conv: dict, x, edge, e_attr, edge_mask,
                           group=None):
    """The eval-mode canonical conv (AttrRelativeEdgeConvGlobalPool2's
    message path) with the edge set sharded over the ranks of `group`.

    x [N, Ci] is every rank's (replicated); edge [E_r, 2], e_attr [E_r, A]
    and edge_mask [E_r] are this rank's shard; conv holds folded weights
    w1, sc1 ([2, C]: scale, shift), w2, sc2, wr, br. Each rank runs the
    message MLP on its own edges; the masked mean is two sums over ranks.
    Returns the [N, Co] layer output on every rank."""
    n = x.shape[0]
    x_i = x[edge[:, 1].long()]
    x_j = x[edge[:, 0].long()]
    f = torch.cat([x_i, x_j - x_i, e_attr], dim=1)
    h = torch.relu(f @ conv["w1"] * conv["sc1"][0] + conv["sc1"][1])
    h = torch.relu(h @ conv["w2"] * conv["sc2"][0] + conv["sc2"][1])
    agg = sharded_segment_mean(h, edge[:, 1], n, group, mask=edge_mask)
    return agg + x @ conv["wr"] + conv["br"].reshape(1, -1)
