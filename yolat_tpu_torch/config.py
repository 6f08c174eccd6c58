"""Serving and training configuration of the detectors.

Counterpart of `yolat_tpu/train/config.py:16-168` (`Config`), restricted
to the fields the port's serving and training paths read, with the same
names and defaults (the canonical README command: centernet3cc_rpn_gp_iter2,
5 input channels, 64 filters, 2 blocks, 17 floorplan classes), and of the
named flag bundles of `yolat_tpu/cli/common.py:23-80` (`PROFILES`,
`apply_profile`). `arch` is the canonical detector or one of `PP_ARCHS`
(YOLaT++, `yolat_tpu/eval/fast_forward.py:245`, with `PP_GATES` :246).

`act`, `norm` and `conv` choose the detector's MLPs and conv
(`nn.conv.CONV_NAMES`). `graph` is checked by the trainer (only
'bezier_cc_bb_iter' trains, as in `yolat_tpu/train/trainer.py:42-49`).
`bias`, `k`, `epsilon`, `stochastic` and `pos_edge_th` are parsed and
carried, and nothing in the port reads them, as nothing in the JAX
package does (`k`, `epsilon` and `stochastic` belong to the kNN blocks,
`DynConv`, which are not ported yet).

`check_serve_mode` refuses the folded engine (serve modes fast and
fast_bf16) for any model but the attr_edge_gp2 conv with ReLU and
BatchNorm, which is all it folds (the JAX package's `fold_params` fails
with a KeyError there, or folds another function).

One default differs: `dense_layout` is False here and True in the JAX
package. There the dense neighbour table is the serving layout; the port
serves over the edge-window plan, which exists for every batch, and packs
the table only when asked (`cli/test --dense_layout true`, or
`train_layout='dense'`).
"""

from __future__ import annotations

import dataclasses
import os

CANONICAL_ARCH = "centernet3cc_rpn_gp_iter2"
PP_ARCHS = ("yolat_pp", "yolat++", "hierarchical")
# YOLaT++'s four 0-d gates, in the order the hierarchy levels inject
PP_GATES = ("gate_point", "gate_curve", "gate_prim", "gate_super")

# Named flag bundles: Config fields by when they apply. "unless_chart" /
# "when_chart" key on the data directory's NAME, the reference's own
# convention for class dictionaries (graph_dict3.py:57).
PROFILES = {
    "yolat_pp_fast": {
        "always": {"arch": "yolat_pp", "pp_factored_prim": True},
        "unless_chart": {"iou_aware_loss": True, "iou_aware_mode": "rel"},
        "when_chart": {"pos_class_weight": 16.0, "iou_aware_loss": True,
                       "iou_aware_mode": "rel"},
    },
}


def apply_profile(kw: dict, profile: str, explicit: set) -> dict:
    """Overlay a PROFILES bundle onto Config keyword arguments; the fields
    named in `explicit` (flags the user typed) keep their values."""
    bundle = PROFILES[profile]
    base = os.path.basename(os.path.normpath(str(kw.get("data_dir", ""))))
    is_chart = "chart" in base.lower()
    if is_chart and bundle.get("when_chart"):
        print(f"--profile {profile}: chart dataset detected ({base!r}): "
              f"applying the chart recipe {bundle['when_chart']}")
    overrides = dict(bundle["always"])
    overrides.update(bundle.get("when_chart" if is_chart else "unless_chart",
                                {}))
    for field, value in overrides.items():
        if field not in explicit:
            kw[field] = value
    return kw


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
    graph: str = "bezier_cc_bb_iter"
    bbox_sampling_step: int = 10
    data_aug: bool = True
    do_mixup: float = 0.0           # > 0: training-time mixup of CCs
    drop_edge: float = 0.0
    pos_edge_th: float = 5e-3       # carried, unread (as in JAX)

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
    arch: str = CANONICAL_ARCH      # or one of PP_ARCHS (YOLaT++)
    conv: str = "attr_edge_gp2"
    act: str = "relu"
    norm: str = "batch"
    bias: bool = True               # carried, unread (as in JAX)
    n_filters: int = 64
    n_blocks: int = 2
    n_blocks_out: int = 2
    dropout: float = 0.0
    classifier: str = "softmax"
    n_classes: int = 17
    k: int = 16                     # kNN blocks (not ported): carried, unread
    epsilon: float = 0.2
    stochastic: bool = True

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
    scan_steps: int = 1             # train steps per dispatch: one transfer
                                    # of that many batches, their steps
                                    # replayed back to back (JAX: lax.scan)
    buckets: int = 1                # size-bucketed padding of the train
                                    # loader: one graph per bucket's shape
    iou_aware_loss: bool = False    # soft {class: q, background: 1-q} targets
    iou_aware_mode: str = "abs"     # q = IoU ('abs') or IoU / best sibling
    pos_class_weight: float = 1.0   # positive rows' loss weight
    pp_factored_prim: bool = False  # YOLaT++ primitive level as a prefix
                                    # sum per proposal (super_fact_mlp)
                                    # instead of the per-edge clique level
    pp_banded_super: bool = False   # YOLaT++ training: the per-edge clique
                                    # level over the sew_ plan (kernels 7
                                    # and 8) instead of the padded buffer
    profile: str = ""               # named flag bundle applied at parse time
    pretrained_model: str = ""
    # data parallel: one process per device; n_devices counts GLOBAL
    # devices over n_processes nodes (parallel/distributed.py)
    n_devices: int = 1
    coordinator: str = ""           # host:port of the store (rank 0's node)
    process_id: int = 0             # this node's index
    n_processes: int = 0            # nodes; 0 / 1 = one node

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def check_serve_mode(cfg, serve_mode: str) -> None:
    """Refuse the folded engine for a model it does not fold."""
    if serve_mode not in ("fast", "fast_bf16"):
        return
    if (cfg.conv, str(cfg.act).lower(), str(cfg.norm).lower()) != (
            "attr_edge_gp2", "relu", "batch"):
        raise ValueError(
            f"--serve_mode {serve_mode} with --conv {cfg.conv} --act "
            f"{cfg.act} --norm {cfg.norm}: the folded engine serves the "
            "attr_edge_gp2 conv with ReLU and BatchNorm; serve this model "
            "with --serve_mode flax (cli.infer: --serve_mode module)")
