"""Data parallelism: ranks, the sync group, the launcher, graph partitions
and edge-sharded segment sums (`yolat_tpu/parallel/`)."""

from yolat_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                           set_sync_group,
                                           shard_leading_axis)
from yolat_tpu_torch.parallel.partition import (generate_sub_graphs,
                                                random_partition_graph,
                                                sharded_segment_sum)
