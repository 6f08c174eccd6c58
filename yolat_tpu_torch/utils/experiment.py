"""Experiment directory, logging and the scalar log.

Counterpart of `yolat_tpu/utils/experiment.py` (the reference's
OptInit._generate_exp_directory / _configure_logger,
cad_recognition/config.py:112-172): a timestamped, uuid-named experiment
directory with `checkpoint/`, file + stdout logging, and scalars as JSON
lines (`scalars.jsonl`) and, where `torch.utils.tensorboard` imports, in a
TensorBoard event file beside them (`ScalarWriter`, :51-81).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
import uuid


def make_experiment_dir(root_dir: str, jobname: str) -> dict:
    stamp = time.strftime("%Y%m%d-%H%M%S")
    exp_dir = os.path.join(root_dir, f"{jobname}_{stamp}_{uuid.uuid4()}")
    ckpt_dir = os.path.join(exp_dir, "checkpoint")
    os.makedirs(ckpt_dir, exist_ok=True)
    return {"exp_dir": exp_dir, "ckpt_dir": ckpt_dir}


def configure_logger(exp_dir: str, level: str = "info", tag: str = "") -> None:
    """File + stdout logging; `tag` prefixes every message (a rank's)."""
    logger = logging.getLogger()
    logger.setLevel(getattr(logging, level.upper()))
    fmt = logging.Formatter(f"%(asctime)s {tag}%(message)s")
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
    fh = logging.FileHandler(
        os.path.join(exp_dir, os.path.basename(exp_dir) + ".log"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)


class ScalarWriter:
    """Scalars as JSON lines {tag, value, step} in `scalars.jsonl`, and,
    with `use_tensorboard`, in a TensorBoard event file in `exp_dir`. Where
    `torch.utils.tensorboard` does not import (tensorboard absent), the
    writer keeps to the JSON lines, as the JAX package's does (:59-65);
    `tensorboard` says which sinks it took. The import happens here, not
    at module import: where TensorFlow is installed it pulls that in too.
    `close` flushes both; the trainer closes the writer on every exit."""

    def __init__(self, exp_dir: str, use_tensorboard: bool = True):
        self._jsonl = open(os.path.join(exp_dir, "scalars.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(log_dir=exp_dir)

    @property
    def tensorboard(self) -> bool:
        """Whether the scalars also go to a TensorBoard event file."""
        return self._tb is not None

    def add_scalar(self, tag: str, value, step: int):
        value = float(value)
        self._jsonl.write(json.dumps({"tag": tag, "value": value,
                                      "step": step}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
