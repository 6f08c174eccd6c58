"""Experiment directory, logging and the scalar log.

Counterpart of `yolat_tpu/utils/experiment.py` (the reference's
OptInit._generate_exp_directory / _configure_logger,
cad_recognition/config.py:112-172): a timestamped, uuid-named experiment
directory with `checkpoint/`, file + stdout logging, and scalars as JSON
lines (`scalars.jsonl`; the JAX package's optional TensorBoard writer is
not carried).
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
    """Scalars as JSON lines {tag, value, step} in `scalars.jsonl`."""

    def __init__(self, exp_dir: str):
        self._jsonl = open(os.path.join(exp_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": step}) + "\n")

    def close(self):
        self._jsonl.close()
