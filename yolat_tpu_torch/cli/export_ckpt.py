"""Export a trained checkpoint to the reference's torch .pth format.

Counterpart of `yolat_tpu/cli/export_ckpt.py`: a model trained by the
port (`cli.train`'s checkpoint dir) is handed back to the reference's own
drivers (cad_recognition/test.py restores `{postname}_{epoch}.pth` /
`_best.pth` dicts, utils/ckpt_util.py:27-111), and to `cli.infer`:

  python -m yolat_tpu_torch.cli.export_ckpt --pretrained_model <ckpt_dir> \
      [--tag best] [--n_classes 17] --out exported_best.pth

The checkpoint `<ckpt_dir>/ckpt_<tag>.pt` is restored into
`build_model(cfg)` with `--n_classes` and the model flags of `cli.train`
(`--arch yolat_pp` exports a YOLaT++ model under its own keys), and
written through `train.checkpoint.save_reference_checkpoint` with the
checkpoint's epoch. Needs no dataset and no device: the JAX CLI packs a
toy batch only to shape flax's parameters, a torch module has its shapes
from the config. It runs on the host; `--device` is not read.
"""

from __future__ import annotations

import os

from yolat_tpu_torch.cli.train import build_parser, config_from_args
from yolat_tpu_torch.nn.model import build_model
from yolat_tpu_torch.train.checkpoint import (CheckpointManager,
                                              load_train_state,
                                              save_reference_checkpoint)


def main(argv=None) -> None:
    p = build_parser()
    p.description = "export a checkpoint to reference .pth format"
    p.add_argument("--out", required=True, type=str, help="output .pth path")
    p.add_argument("--n_classes", default=17, type=int,
                   help="classes incl. background (17 floorplans / "
                        "22 diagrams)")
    p.add_argument("--tag", default="best", type=str,
                   help="checkpoint tag to restore (best / an epoch number)")
    args = p.parse_args(argv)
    cfg = config_from_args(args, argv).replace(n_classes=args.n_classes,
                                               data_aug=False)
    ckpt_dir = cfg.pretrained_model.rstrip("/")
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"--pretrained_model {ckpt_dir!r}: not a "
                                "checkpoint directory")
    model = build_model(cfg)
    state, epoch, best = CheckpointManager(ckpt_dir).restore(tag=args.tag)
    load_train_state(state, model)
    save_reference_checkpoint(model, args.out, epoch=epoch)
    print(f"exported {cfg.pretrained_model} (tag {args.tag}, epoch {epoch}, "
          f"best {best:.4f}) -> {args.out}")


if __name__ == "__main__":
    main()
