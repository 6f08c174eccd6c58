"""Serving configuration of the canonical detector.

Counterpart of `yolat_tpu/train/config.py:16-168` (`Config`), restricted
to the fields the serving path reads, with the same names and defaults
(the canonical README command: centernet3cc_rpn_gp_iter2, 5 input
channels, 64 filters, 2 blocks, 17 floorplan classes).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # dataset
    data_dir: str = "data/FloorPlansGraph5_iter"
    batch_size: int = 4
    in_channels: int = 5
    bbox_sampling_step: int = 10

    # model
    arch: str = "centernet3cc_rpn_gp_iter2"
    conv: str = "attr_edge_gp2"
    n_filters: int = 64
    n_blocks: int = 2
    n_blocks_out: int = 2
    classifier: str = "softmax"
    n_classes: int = 17

    # detection
    max_det: int = 300
    nms_iou: float = 0.5
    nms_conf: float = 0.0
    nms_algorithm: str = "fixpoint"  # or 'loop', the sequential oracle
    nms_topk: int = 1024             # fixpoint-NMS candidate cap
