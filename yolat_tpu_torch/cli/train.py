"""Training CLI, on one device or data parallel.

Counterpart of `yolat_tpu/cli/train.py` with the training flags of
`yolat_tpu/cli/common.build_parser` (:83-191) that the port runs, under
the same names:

  python -m yolat_tpu_torch.cli.train --data_dir DIR [--batch_size 4]
      [--total_epochs 200] [--lr 2.5e-4] [--dtype float32|bfloat16]
      [--fused_head_train true] [--train_layout sparse|window|dense]
      [--remat true]
      [--conv attr_edge_gp2|edge|gat|...] [--act relu|leakyrelu|gelu|none]
      [--norm batch|layer|none]
      [--arch yolat_pp [--pp_banded_super true | --pp_factored_prim true]]
      [--profile yolat_pp_fast] [--eval_start 20] [--root_dir log]
      [--pretrained_model ckpt_dir|ckpt_dir/ckpt_<tag>|ref.pth]
      [--scan_steps K] [--max_steps N] [--device cuda]
      [--buckets B] [--do_mixup 1] [--dense_layout true] [--postname S]
      [--n_devices D [--coordinator host:port --process_id I
                      --n_processes P]]

`--device` defaults to cuda and raises when CUDA is absent; the CLI never
moves to the CPU on its own. `--max_steps` ends the run after N train
steps (evaluating and checkpointing that epoch). On the card every train
step is a CUDA graph replay (`train/loop.make_scan_train_step`);
`--scan_steps K` (default 1) stages K batches in one transfer and replays
their steps back to back, fetching their losses once. The last line prints the
train rate (steps/s and images/s over the synchronised train-step wall
time) and the launch counts of the fused pool head's kernels and of the
window layout's kernels 9 and 10 and of the banded YOLaT++ route's
kernels 7 and 8, forward and backward apart (they count the evaluation's
forward passes too), the CUDA graphs captured, replayed and freed, the
bytes the live graphs hold, the batch signatures met and the pad growths.
On the card the graphs captured equal the signatures met: one per bucket,
and one more per pad that mixup grows.

`--buckets B` packs the train split in B size buckets, each with its own
pads; `--do_mixup 1` mixes every CC with a random CC of its file on each
training load (seeded with `--seed`; the pads grow to fit; refused over
several nodes); `--dense_layout true` packs the dense neighbour table for
the evaluation (the module's dense branch; `cli.test`'s engine takes
kernel 4 with it). `--postname` is accepted and unused, as in the JAX CLI.

`--n_devices D` trains data parallel over D devices
(`train/trainer.run_training(ranks=)`): the CLI starts one process per
local rank (`parallel/launch.spawn_ranks`), rank r on `cuda:r` over NCCL
with `--device cuda` (fewer cards than local ranks raise), or on the CPU
over gloo with `--device cpu`. Over several nodes, D counts the devices
of all of them, each node runs the CLI with its `--process_id` of
`--n_processes`, and `--coordinator host:port` names the store that rank
0 serves (`yolat_tpu/cli/common.py:132, 177-183`). Rank 0 prints the
summary; every rank logs its LossMean.

`--conv NAME` trains the detector with any conv of `nn.conv.CONV_NAMES`
and `--act` / `--norm` set its MLPs (`yolat_tpu/cli/common.py:112-115`).
The window layout is attr_edge_gp2's; the dense layout (and
`--dense_layout true`) takes gp2 and the six convs of `nn.conv.DENSE_CONVS`;
`--fused_head_train true` needs `--act relu --norm batch`; each other
combination is refused (`nn.model.check_model_config`). `--graph` other
than bezier_cc_bb_iter is refused; `--bias`, `--k`, `--epsilon`,
`--stochastic` and `--pos_edge_th` are accepted and unused, as in the JAX
CLI.

`--remat true` checkpoints, in training, attr_edge_gp2's message MLP on
every layout and the fusion MLPs (`fusion_block` off the fused head,
`fusion_block_super` always), as the JAX package's `maybe_remat_mlp`
does: their activations are recomputed in the backward, which holds
less device memory and takes longer. The losses, gradients, running
statistics and checkpoints are those of remat off, so a checkpoint moves
freely between the two. The other convs take it on the fusion MLPs
only; YOLaT++ reads it nowhere, as in JAX. The parser is shared, so
`cli.test`, `cli.detect`, `cli.detect_badcase` and `cli.export_ckpt`
take the flag too and do nothing with it (evaluation never checkpoints).

`--arch yolat_pp` trains YOLaT++ (`nn/yolat_pp.py`) on one of three routes
through its primitive level: per super edge over the padded buffer (the
default), the same level over the clique family's plan with
`--pp_banded_super true` (kernels 7 and 8 with their backward kernels), or
factored with `--pp_factored_prim true` (`--profile yolat_pp_fast` sets it
with the IoU-aware loss). Each also takes `--fused_head_train true`.
"""

from __future__ import annotations

import argparse

import torch

from yolat_tpu_torch.config import PROFILES, Config, apply_profile
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.parallel.distributed import (initialize_from_config,
                                                  local_device_count,
                                                  shutdown)
from yolat_tpu_torch.parallel.launch import spawn_ranks
from yolat_tpu_torch.parallel.mesh import rank_device
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
    add("--graph", default=d.graph, type=str,
        help="graph family; only bezier_cc_bb_iter trains")
    add("--bbox_sampling_step", default=d.bbox_sampling_step, type=int)
    add("--data_aug", default=d.data_aug, type=_bool)
    add("--do_mixup", default=d.do_mixup, type=float,
        help="> 0: mix every CC with a random CC of its file on each "
             "training load (the pads grow to fit)")
    add("--drop_edge", default=d.drop_edge, type=float)
    add("--pos_edge_th", default=d.pos_edge_th, type=float,
        help="accepted and unused, as in the JAX CLI")
    add("--total_epochs", default=d.total_epochs, type=int)
    add("--lr", default=d.lr, type=float)
    add("--lr_adjust_freq", default=d.lr_adjust_freq, type=float)
    add("--lr_decay_rate", default=d.lr_decay_rate, type=float)
    add("--weight_decay", default=d.weight_decay, type=float)
    add("--seed", default=d.seed, type=int)
    add("--print_freq", default=d.print_freq, type=int)
    add("--optimizer", default=d.optimizer, type=str,
        choices=("adam", "adamw", "radam"))
    add("--postname", default="", type=str,
        help="accepted and unused, as in the JAX CLI")
    add("--arch", default=d.arch, type=str)
    add("--conv", default=d.conv, type=str,
        help="graph conv: attr_edge_gp2 (canonical), attr_edge, "
             "multilayer_edge, attr_edge_gp, attr_edge_cf, edge, mr, gcn, "
             "gin, sage, rsage, gat or gen")
    add("--act", default=d.act, type=str,
        help="MLP activation: relu, leakyrelu, gelu or none")
    add("--norm", default=d.norm, type=str,
        help="MLP norm: batch, layer or none")
    add("--bias", default=d.bias, type=_bool,
        help="accepted and unused, as in the JAX CLI")
    add("--n_filters", default=d.n_filters, type=int)
    add("--n_blocks", default=d.n_blocks, type=int)
    add("--n_blocks_out", default=d.n_blocks_out, type=int)
    add("--dropout", default=d.dropout, type=float)
    add("--classifier", default=d.classifier, type=str)
    add("--k", default=d.k, type=int,
        help="kNN blocks (not ported): accepted and unused")
    add("--epsilon", default=d.epsilon, type=float,
        help="kNN blocks (not ported): accepted and unused")
    add("--stochastic", default=d.stochastic, type=_bool,
        help="kNN blocks (not ported): accepted and unused")
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
    add("--remat", default=d.remat, type=_bool,
        help="rematerialise gp2's message MLP and the fusion MLPs in "
             "training (recomputed in the backward: memory for time)")
    add("--dense_layout", default=d.dense_layout, type=_bool,
        help="pack the dense neighbour table for evaluation (cli.test's "
             "engine then takes kernel 4; the module its dense branch)")
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
    add("--pp_banded_super", default=d.pp_banded_super, type=_bool,
        help="YOLaT++ training: the per-edge primitive level over the "
             "super-edge plan (kernels 7 and 8) instead of the padded buffer")
    add("--profile", default=d.profile, type=str,
        choices=("",) + tuple(PROFILES),
        help="named flag bundle; flags typed beside it keep their values")
    add("--buckets", default=d.buckets, type=int,
        help="size buckets of the train loader, each with its own pads "
             "and, on the card, its own CUDA graph")
    add("--scan_steps", default=d.scan_steps, type=int,
        help="train steps per dispatch: their batches cross in one "
             "transfer and, on the card, replay one CUDA graph back to "
             "back, with one loss fetch per chunk")
    add("--max_steps", default=0, type=int,
        help="stop after this many train steps (0: run every epoch)")
    add("--device", default="cuda", type=str)
    add("--n_devices", default=d.n_devices, type=int,
        help="data-parallel devices over all nodes, one process each")
    add("--coordinator", default=d.coordinator, type=str,
        help="host:port of the store rank 0 serves (several nodes)")
    add("--process_id", default=d.process_id, type=int)
    add("--n_processes", default=d.n_processes, type=int,
        help="nodes; > 1 needs --coordinator")
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


def data_parallel(cfg) -> bool:
    return cfg.n_devices > 1 or cfg.n_processes > 1


def run_ranks(cfg, device, worker, *args) -> dict:
    """worker(local_rank, store_path, cfg, device_type, *args) in one
    process per local rank; rank 0's return value."""
    local = local_device_count(cfg, device.type)
    return spawn_ranks(worker, local, (cfg, device.type) + args)[0]


def _train_rank(local_rank, store_path, cfg, device_type, max_steps):
    device = rank_device(local_rank, device_type)
    ranks = initialize_from_config(cfg, local_rank, device,
                                   store_path=store_path)
    try:
        return _train(cfg, device, max_steps, ranks)
    finally:
        shutdown(ranks)


def _train(cfg, device, max_steps, ranks=None) -> dict:
    launched = dict(_build.launch_counts)  # this run's launches are the rise
    graphs = dict(_build.graph_counts)
    _, results = run_training(cfg, device, max_steps=max_steps, ranks=ranks)
    counts = {k: v - launched[k] for k, v in _build.launch_counts.items()}
    graphed = {k: v - graphs[k] for k, v in _build.graph_counts.items()}
    results["launches"], results["graphs"] = counts, graphed
    if ranks is not None and not ranks.is_main:
        return results
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
              "ew_window_segment_sum", "ew_window_segment_sum_bwd",
              "banded_gather", "banded_gather_bwd", "banded_scatter_own",
              "banded_scatter_own_bwd"))
          + f"; CUDA graphs captured={graphed['captured']}, "
          f"replayed={graphed['replayed']}, released="
          f"{results['graphs_released']}, holding "
          f"{results['graph_bytes']} bytes; batch signatures="
          f"{results['signatures']}, pad growths={results['pad_growths']}"
          + (f" (rank 0 of {ranks.world})" if ranks is not None else ""))
    return results


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = device_from_arg(args.device)
    cfg = config_from_args(args, argv).replace(phase="train")
    max_steps = args.max_steps or None
    if data_parallel(cfg):
        return run_ranks(cfg, device, _train_rank, max_steps)
    return _train(cfg, device, max_steps)


if __name__ == "__main__":
    main()
