"""Test CLI: restore a checkpoint and run the eval protocol on a partition.

Counterpart of `yolat_tpu/cli/test.py` (the reference's
cad_recognition/test.py), on one device, with the flags of the train CLI
plus:

  python -m yolat_tpu_torch.cli.test --data_dir DIR --phase test
      --pretrained_model ckpt_dir|ckpt_dir/ckpt_<tag>|ref.pth
      [--serve_mode flax|fast|fast_bf16] [--dense_layout true|false]
      [--nms_algorithm fixpoint|loop|classfix] [--device cuda]
      [--arch yolat_pp [--pp_factored_prim true] | --profile yolat_pp_fast]

`--serve_mode flax` runs the eval-mode module (the parity route; the name
is the JAX package's), `fast` / `fast_bf16` the folded-BN engine with its
kernels, which folds the attr_edge_gp2 conv with ReLU and BatchNorm only:
a checkpoint of another `--conv`, `--act` or `--norm` (flags as
`cli.train` takes them) serves through `flax`, and the fast modes refuse
it (`config.check_serve_mode`). `--dense_layout true` packs the dense neighbour table and no
edge-window plan, so the engine's convs take the fused dense message
(kernel 4) instead of the edge-window message sum (kernel 1); the module
route then takes the conv's dense branch. The checkpoint's training layout
does not matter: all layouts share their parameters. `--arch yolat_pp`
evaluates a YOLaT++ checkpoint (a `.pth` of the port module's own state
dict, or a checkpoint dir): the loader packs the super-edge family and the
banded plans, and the engine runs kernels 5 and 6 beside 1 and 2
(`--profile yolat_pp_fast`, the factored checkpoint: kernel 6 and no
launch of kernel 5); it has no dense route. `--device` defaults to
cuda and raises when CUDA is absent; the CLI never moves to the CPU on its
own. Prints the AP table, the confusion matrix,
`checkpoint epoch=.. best=..`, and last the launch counts of the serving
kernels. `--n_devices D` (with `--coordinator`, `--process_id`,
`--n_processes` over several nodes, as `cli.train` takes them) evaluates
over D ranks, one process each, each on its windows of the split
(`eval/runner.evaluate(group=)`, `yolat_tpu/cli/test.py:44-60`); rank 0
prints the table, which is the single-device table of the split.
"""

from __future__ import annotations

from yolat_tpu_torch.cli.train import (build_parser, config_from_args,
                                       data_parallel, device_from_arg,
                                       device_name, run_ranks)
from yolat_tpu_torch.config import PP_ARCHS, check_serve_mode
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader, extra_plans_for
from yolat_tpu_torch.eval.metrics import format_confusion
from yolat_tpu_torch.eval.runner import evaluate
from yolat_tpu_torch.nn.model import build_model
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.parallel.distributed import (initialize_from_config,
                                                  local_first, shutdown)
from yolat_tpu_torch.parallel.mesh import rank_device
from yolat_tpu_torch.train.checkpoint import (CheckpointManager,
                                              load_train_state,
                                              split_checkpoint_path,
                                              state_from_pth)


def load_checkpoint(cfg, device):
    """-> (eval-mode model on `device`, epoch, best value) from
    cfg.pretrained_model: a reference `.pth` (epoch 0, best nan), a
    checkpoint dir (tag 'best') or `<dir>/ckpt_<tag>`."""
    if not cfg.pretrained_model:
        raise SystemExit("--pretrained_model is required for evaluation")
    model = build_model(cfg)
    path = cfg.pretrained_model.rstrip("/")
    if path.endswith(".pth"):
        state_from_pth(model, path)
        epoch, best = 0, float("nan")
    else:
        ckpt_dir, tag = split_checkpoint_path(path)
        state, epoch, best = CheckpointManager(ckpt_dir).restore(tag)
        load_train_state(state, model)
    return model.to(device).eval(), epoch, best


def serving_loader(cfg, ds, batch_size: int, serve_mode: str,
                   **kw) -> PackedLoader:
    """The loader of the serving CLIs (test, detect, detect_badcase): the
    edge-window plan, or under cfg.dense_layout the dense neighbour table
    and no plan, with the plans cfg's arch reads (`extra_plans_for`)."""
    check_serve_mode(cfg, serve_mode)
    if cfg.arch in PP_ARCHS and cfg.dense_layout and serve_mode != "flax":
        raise ValueError("--dense_layout true: the YOLaT++ engine has no "
                         "dense route (its convs run the edge-window kernel)")
    return PackedLoader(ds, batch_size=batch_size,
                        edge_window=not cfg.dense_layout,
                        dense=cfg.dense_layout, **extra_plans_for(cfg), **kw)


def add_serving_flags(p) -> None:
    p.add_argument("--serve_mode", default="flax",
                   choices=("flax", "fast", "fast_bf16"),
                   help="flax = the eval-mode module; fast / fast_bf16 = the "
                        "folded-BN serving engine")


def main(argv=None) -> dict:
    p = build_parser()
    p.description = "yolat_tpu_torch evaluation"
    add_serving_flags(p)
    args = p.parse_args(argv)
    device = device_from_arg(args.device)
    cfg = config_from_args(args, argv)
    if data_parallel(cfg):
        return run_ranks(cfg, device, _test_rank, args)
    return _test(cfg, args, device)


def _test_rank(local_rank, store_path, cfg, device_type, args):
    device = rank_device(local_rank, device_type)
    ranks = initialize_from_config(cfg, local_rank, device,
                                   store_path=store_path)
    try:
        return _test(cfg, args, device, ranks)
    finally:
        shutdown(ranks)


def _test(cfg, args, device, ranks=None) -> dict:
    is_main = ranks is None or ranks.is_main
    partition = cfg.phase if cfg.phase in ("train", "test", "val") else "test"
    ds = SESYDDataset(cfg.data_dir, partition,
                      bbox_sampling_step=cfg.bbox_sampling_step)
    # the layout under test is the batch's: the model takes no window branch
    cfg = cfg.replace(n_classes=ds.n_classes, train_layout="sparse")
    is_pp = cfg.arch in PP_ARCHS
    dp = {} if ranks is None else dict(n_devices=ranks.world,
                                       rank=ranks.rank)
    loader = local_first(ranks, "loader", lambda: serving_loader(
        cfg, ds, cfg.batch_size, args.serve_mode, **dp))
    model, epoch, best = load_checkpoint(cfg, device)
    if device.type == "cuda" and args.serve_mode != "flax":
        # build the kernels before the evaluation loop
        local_first(ranks, "kernels", _build.library)
    launched = dict(_build.launch_counts)
    results = evaluate(cfg, model, loader, max_det=cfg.max_det,
                       verbose=is_main, serve=args.serve_mode, device=device,
                       group=None if ranks is None else ranks.host_group)
    counts = {k: v - launched[k] for k, v in _build.launch_counts.items()}
    results["launches"] = counts
    if not is_main:
        return results
    print(format_confusion(results["confusion"], ds.class_dict))
    print(f"checkpoint epoch={epoch} best={best:.4f}")
    print(f"{len(ds)} images in {len(loader)} batches"
          + (f" per rank over {ranks.world} ranks" if ranks else "") + " on "
          f"{device_name(device)} ({args.serve_mode}, "
          f"{'dense table' if cfg.dense_layout else 'edge window'}, "
          f"{cfg.nms_algorithm}); kernel launches: "
          + ", ".join(f"{k}={counts[k]}" for k in (
              "edge_window_message_sum", "folded_mlp_block_max2",
              "fused_dense_message") + (
                  ("banded_message_sum", "banded_message_sum_both")
                  if is_pp else ())))
    return results


if __name__ == "__main__":
    main()
