"""Checkpoints with the reference's best-copy semantics, on torch.save.

Counterpart of `yolat_tpu/train/checkpoint.py` (Orbax there; the port
depends on torch alone): each epoch writes
`<dir>/ckpt_<epoch>.pt` (model, optimizer and schedule state, step) and
`meta_<epoch>.json` ({epoch, best_value}); an improving epoch is copied to
`ckpt_best.pt` / `meta_best.json`; epochs older than the last `keep` are
removed; `restore(tag)` loads one back. Also the reference `.pth` side of
`yolat_tpu/train/import_reference.py`: `save_reference_checkpoint`
writes {'state_dict': ...} in the reference's names, and
`state_from_pth` loads a reference `.pth` into a model (the optimizer
stays fresh: torch Adam moments of another run are not carried). All of
it works on the model's own state dict, so a YOLaT++ model
(`nn.yolat_pp.YOLaTPlusPlus`, for which the reference has no format) is
saved and restored the same way, under its own keys; a checkpoint of the
other primitive-level variant fails the strict load.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from yolat_tpu_torch.nn.model import load_reference_checkpoint


def train_state(model, optimizer, scheduler, step: int) -> dict:
    return {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict() if scheduler else None,
            "step": step}


def load_train_state(state: dict, model, optimizer=None, scheduler=None) -> int:
    """Load a `train_state` dict in place; returns its step."""
    model.load_state_dict(state["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    if scheduler is not None and state.get("scheduler") is not None:
        scheduler.load_state_dict(state["scheduler"])
    return int(state["step"])


class CheckpointManager:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.keep = keep

    def _path(self, tag) -> str:
        return os.path.join(self.ckpt_dir, f"ckpt_{tag}.pt")

    def _meta(self, tag) -> str:
        return os.path.join(self.ckpt_dir, f"meta_{tag}.json")

    def save(self, state: dict, epoch: int, best_value: float, is_best: bool):
        path = self._path(epoch)
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save(state, tmp)
        os.replace(tmp, path)
        meta = {"epoch": epoch, "best_value": best_value}
        with open(self._meta(epoch), "w") as f:
            json.dump(meta, f)
        if is_best:
            shutil.copyfile(path, self._path("best"))
            with open(self._meta("best"), "w") as f:
                json.dump(meta, f)
        self._gc(epoch)

    def _gc(self, epoch: int):
        for name in os.listdir(self.ckpt_dir):
            if not (name.startswith("ckpt_") and name.endswith(".pt")):
                continue
            tag = name[len("ckpt_"):-len(".pt")]
            if tag.isdigit() and int(tag) <= epoch - self.keep:
                os.remove(os.path.join(self.ckpt_dir, name))
                if os.path.exists(self._meta(tag)):
                    os.remove(self._meta(tag))

    def restore(self, tag="best", map_location="cpu"):
        """-> (train_state dict, epoch, best_value)."""
        state = torch.load(self._path(tag), map_location=map_location,
                           weights_only=True)
        meta = {"epoch": -1, "best_value": -float("inf")}
        if os.path.exists(self._meta(tag)):
            with open(self._meta(tag)) as f:
                meta = json.load(f)
        return state, meta["epoch"], meta["best_value"]


def split_checkpoint_path(path: str) -> tuple:
    """(checkpoint dir, tag) of a `--pretrained_model` path: the dir itself
    (tag 'best') or `<dir>/ckpt_<tag>[.pt]`."""
    path = path.rstrip("/")
    name = os.path.basename(path)
    if name.startswith("ckpt_"):
        return os.path.dirname(path), name[len("ckpt_"):].removesuffix(".pt")
    return path, "best"


def save_reference_checkpoint(model, path: str, epoch: int = 0) -> None:
    """A reference-format `.pth` ({'state_dict': ...}), which
    `cli.infer --pretrained_model` and the reference's own scripts load."""
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in model.state_dict().items()},
                "epoch": epoch}, path)


def state_from_pth(model, path: str):
    """Load a reference `.pth`'s weights into `model` (strict)."""
    return load_reference_checkpoint(model, path)
