"""Training CLI on one device.

Counterpart of `yolat_tpu/cli/train.py` with the training flags of
`yolat_tpu/cli/common.build_parser` (:83-191) that the port runs, under
the same names:

  python -m yolat_tpu_torch.cli.train --data_dir DIR [--batch_size 4]
      [--total_epochs 200] [--lr 2.5e-4] [--dtype float32|bfloat16]
      [--fused_head_train true] [--train_layout sparse|window|dense]
      [--eval_start 20] [--root_dir log]
      [--pretrained_model ckpt_dir|ckpt_dir/ckpt_<tag>|ref.pth]
      [--max_steps N] [--device cuda]

`--device` defaults to cuda and raises when CUDA is absent; the CLI never
moves to the CPU on its own. `--max_steps` ends the run after N train
steps (evaluating and checkpointing that epoch). The last line prints the
train rate (steps/s and images/s over the synchronised train-step wall
time) and the launch counts of the fused pool head's kernels and of the
window layout's kernels 9 and 10, forward and backward apart (they count
the evaluation's forward passes too).
"""

from __future__ import annotations

import argparse

import torch

from yolat_tpu_torch.config import PROFILES, Config, apply_profile
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.train.trainer import run_training


def _bool(v) -> bool:
    """The JAX CLI's boolean spelling: 1/true/yes/y are true."""
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "y")


def build_parser() -> argparse.ArgumentParser:
    d = Config()
    p = argparse.ArgumentParser(description="yolat_tpu_torch training")
    add = p.add_argument
    add("--phase", default=d.phase, type=str)
    add("--exp_name", default=d.exp_name, type=str)
    add("--root_dir", default=d.root_dir, type=str)
    add("--data_dir", default=d.data_dir, type=str)
    add("--batch_size", default=d.batch_size, type=int)
    add("--in_channels", default=d.in_channels, type=int)
    add("--bbox_sampling_step", default=d.bbox_sampling_step, type=int)
    add("--data_aug", default=d.data_aug, type=_bool)
    add("--drop_edge", default=d.drop_edge, type=float)
    add("--total_epochs", default=d.total_epochs, type=int)
    add("--lr", default=d.lr, type=float)
    add("--lr_adjust_freq", default=d.lr_adjust_freq, type=float)
    add("--lr_decay_rate", default=d.lr_decay_rate, type=float)
    add("--weight_decay", default=d.weight_decay, type=float)
    add("--seed", default=d.seed, type=int)
    add("--print_freq", default=d.print_freq, type=int)
    add("--optimizer", default=d.optimizer, type=str,
        choices=("adam", "adamw", "radam"))
    add("--arch", default=d.arch, type=str)
    add("--conv", default=d.conv, type=str)
    add("--n_filters", default=d.n_filters, type=int)
    add("--n_blocks", default=d.n_blocks, type=int)
    add("--n_blocks_out", default=d.n_blocks_out, type=int)
    add("--dropout", default=d.dropout, type=float)
    add("--classifier", default=d.classifier, type=str)
    add("--pretrained_model", default="", type=str)
    add("--eval_start", default=d.eval_start, type=int)
    add("--map_step", default=d.map_step, type=int)
    add("--nms_algorithm", default=d.nms_algorithm, type=str,
        choices=("fixpoint", "loop", "classfix"))
    add("--nms_topk", default=d.nms_topk, type=int)
    add("--dtype", default=d.dtype, type=str,
        choices=("float32", "bfloat16", "bf16"),
        help="compute dtype; bfloat16 = bf16 forward over f32 master "
             "weights, f32 BN statistics")
    add("--fused_head_train", default=d.fused_head_train, type=_bool,
        help="train-mode fused pool head (kernels 3 and 11)")
    add("--train_layout", default=d.train_layout, type=str,
        choices=("sparse", "window", "dense"),
        help="conv layout: the padded edge list, the edge-window plan "
             "(kernels 9 and 10) or the dense neighbour table")
    add("--iou_aware_loss", default=d.iou_aware_loss, type=_bool)
    add("--pos_class_weight", default=d.pos_class_weight, type=float)
    add("--iou_aware_mode", default=d.iou_aware_mode, type=str,
        choices=("abs", "rel"))
    add("--pp_factored_prim", default=d.pp_factored_prim, type=_bool,
        help="YOLaT++ primitive level as a prefix sum per proposal "
             "(a super_fact_mlp checkpoint) instead of per super edge")
    add("--profile", default=d.profile, type=str,
        choices=("",) + tuple(PROFILES),
        help="named flag bundle; flags typed beside it keep their values")
    add("--max_steps", default=0, type=int,
        help="stop after this many train steps (0: run every epoch)")
    add("--device", default="cuda", type=str)
    return p


def explicit_flags(parser: argparse.ArgumentParser, argv=None) -> set:
    """The dests of the flags the user typed: `argv` parsed again by a
    fresh `parser` whose defaults are suppressed, so that only given flags
    land in the namespace (`yolat_tpu/cli/common.py:47-54`)."""
    for a in parser._actions:
        a.default = argparse.SUPPRESS
    ns, _ = parser.parse_known_args(argv)
    return set(vars(ns))


def config_from_args(args, argv=None) -> Config:
    """The Config of parsed flags; a `--profile` bundle is laid over it,
    except for the flags typed in `argv` (None: the process's own)."""
    fields = set(Config.__dataclass_fields__)
    kw = {k: v for k, v in vars(args).items() if k in fields}
    kw["lr_adjust_freq"] = int(min(args.lr_adjust_freq, 10 ** 9))
    if kw.get("profile"):
        kw = apply_profile(kw, kw["profile"],
                           explicit_flags(build_parser(), argv))
    return Config(**kw)


def device_from_arg(name: str) -> torch.device:
    """The asked device; cuda without CUDA raises instead of moving on."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available "
                           "(pass --device cpu to run on the CPU)")
    return device


def device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = device_from_arg(args.device)
    cfg = config_from_args(args, argv).replace(phase="train")
    launched = dict(_build.launch_counts)  # this run's launches are the rise
    _, results = run_training(cfg, device, max_steps=args.max_steps or None)
    counts = {k: v - launched[k] for k, v in _build.launch_counts.items()}
    results["launches"] = counts
    secs = max(results["train_seconds"], 1e-9)
    print(f"best test_value={results.get('best_value', 0):.4f} "
          f"MAP@0.5={results.get('map_50', 0):.4f} "
          f"exp_dir={results.get('exp_dir')}")
    print(f"{results['steps']} steps, {results['images']} images in "
          f"{secs:.3f} s: {results['steps'] / secs:.3f} steps/s, "
          f"{results['images'] / secs:.3f} images/s on "
          f"{device_name(device)}; kernel launches: "
          + ", ".join(f"{k}={counts[k]}" for k in (
              "folded_mlp_block_max", "fused_pool_train_bwd",
              "ew_pair_features", "ew_pair_features_bwd",
              "ew_window_segment_sum", "ew_window_segment_sum_bwd")))
    return results


if __name__ == "__main__":
    main()
