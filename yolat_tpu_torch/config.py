"""Serving and training configuration of the canonical detector.

Counterpart of `yolat_tpu/train/config.py:16-168` (`Config`), restricted
to the fields the port's serving and training paths read, with the same
names and defaults (the canonical README command: centernet3cc_rpn_gp_iter2,
5 input channels, 64 filters, 2 blocks, 17 floorplan classes).

One default differs: `dense_layout` is False here and True in the JAX
package. There the dense neighbour table is the serving layout; the port
serves over the edge-window plan, which exists for every batch, and packs
the table only when asked (`cli/test --dense_layout true`, or
`train_layout='dense'`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # base
    phase: str = "train"
    exp_name: str = "yolat_tpu"
    root_dir: str = "log"

    # dataset
    data_dir: str = "data/FloorPlansGraph5_iter"
    batch_size: int = 4
    in_channels: int = 5
    bbox_sampling_step: int = 10
    data_aug: bool = True
    drop_edge: float = 0.0

    # train
    total_epochs: int = 200
    lr: float = 2.5e-4
    lr_adjust_freq: int = 10 ** 9   # StepLR effectively off (canonical)
    lr_decay_rate: float = 0.5
    weight_decay: float = 1e-5
    seed: int = 0
    print_freq: int = 5
    optimizer: str = "adam"         # adam | adamw | radam

    # model
    arch: str = "centernet3cc_rpn_gp_iter2"
    conv: str = "attr_edge_gp2"
    n_filters: int = 64
    n_blocks: int = 2
    n_blocks_out: int = 2
    dropout: float = 0.0
    classifier: str = "softmax"
    n_classes: int = 17

    # eval
    eval_start: int = 20            # eval every epoch from here
    map_step: int = 10
    max_det: int = 300
    nms_iou: float = 0.5
    nms_conf: float = 0.0
    nms_algorithm: str = "fixpoint"  # 'loop': the sequential oracle;
                                     # 'classfix': per class, all candidates
    nms_topk: int = 1024             # fixpoint-NMS candidate cap

    # execution
    dtype: str = "float32"          # or bfloat16: bf16 compute, f32 master
    dense_layout: bool = False      # pack the dense neighbour table for
                                    # serving (the engine then takes kernel 4)
    train_layout: str = "sparse"    # conv layout in training: 'sparse' (padded
                                    # dst-sorted edge list), 'window' (kernels
                                    # 9 and 10 over the edge-window plan) or
                                    # 'dense' (the neighbour table)
    fused_head_train: bool = False  # the fused pool head (kernels 3 and 11)
    iou_aware_loss: bool = False    # soft {class: q, background: 1-q} targets
    iou_aware_mode: str = "abs"     # q = IoU ('abs') or IoU / best sibling
    pos_class_weight: float = 1.0   # positive rows' loss weight
    pretrained_model: str = ""

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
