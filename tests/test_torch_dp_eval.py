"""The port's data-parallel evaluation, DP predict and the CLIs'
`--n_devices` on the CPU.

  * `eval/runner.evaluate(group=)` over 2 rank processes (gloo,
    `parallel/launch.spawn_ranks`, 60 s group timeout, 120 s join timeout),
    each on its windows of the split at batch 1, gives the single-device
    table of the split: the AP per threshold, top-1 and the confusion
    matrix, exactly (the statistics are reassembled in the single device's
    image order), on the eval-mode module ('flax') and the folded engine
    through make_serving_fn ('fast') of a seeded model, and on a model
    whose logits name each proposal's label ('oracle': true positives with
    exact score ties across images, so the AP depends on the order), on
    the train split (3 files: rank 1's second window is empty);
  * `make_dp_predict_fn`: rank r's detections from the [2, ...] stacked
    batch equal `make_serving_fn` on rank r's own batch, bit for bit;
  * `cli.train --n_devices 2 --device cpu` trains an epoch: both ranks log
    their LossMean, rank 0 prints `best test_value=` and writes the
    checkpoint, rank 1 its log under the experiment directory (the
    counterpart of tests/test_multihost.py:34-90); `cli.test --n_devices 2
    --device cpu` prints the table that `cli.test` prints on one device.
    Each CLI runs in a process group of its own, killed at 120 s.
"""

import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

import torch_dp_ranks
from yolat_tpu_torch.cli import test as test_cli
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.dataset import SESYDDataset
from yolat_tpu_torch.data.loader import PackedLoader, stack_shards
from yolat_tpu_torch.eval.fast_forward import fold_params
from yolat_tpu_torch.eval.predict import make_dp_predict_fn, make_serving_fn
from yolat_tpu_torch.eval.runner import evaluate
from yolat_tpu_torch.nn.model import seeded_model
from yolat_tpu_torch.ops.plans import pad_plans
from yolat_tpu_torch.parallel.launch import spawn_ranks
from yolat_tpu_torch.train.checkpoint import save_reference_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
WIDTH = 8
SERVES = ("flax", "fast", "oracle")
CLI_TIMEOUT_S = 120


def _cli(args, log_path):
    """A CLI in a process group of its own (its ranks with it), output to
    a file; threads capped so the ranks share the test's cores."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    log = open(log_path, "w")
    return subprocess.Popen([sys.executable, "-m"] + args, cwd=REPO, env=env,
                            stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True), log


def _wait(proc, log, log_path) -> str:
    try:
        proc.wait(timeout=CLI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        log.close()
    with open(log_path) as f:
        out = f.read()
    assert proc.returncode == 0, out[-4000:]
    return out


@pytest.fixture(scope="module")
def runs(synthetic_root, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_eval")
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    cfg = Config(n_classes=ds.n_classes, n_filters=WIDTH)
    ckpt = str(tmp / "seeded.pth")
    save_reference_checkpoint(seeded_model(cfg), ckpt)
    common = ["--data_dir", synthetic_root, "--bbox_sampling_step", "10",
              "--batch_size", "1", "--n_filters", str(WIDTH), "--device",
              "cpu", "--n_devices", str(WORLD)]
    # the CLIs run beside the ranks of the evaluation below
    train = _cli(["yolat_tpu_torch.cli.train"] + common + [
        "--total_epochs", "1", "--eval_start", "1", "--print_freq", "1",
        "--root_dir", str(tmp / "log")], tmp / "train.log")
    test = _cli(["yolat_tpu_torch.cli.test"] + common + [
        "--phase", "test", "--pretrained_model", ckpt], tmp / "test.log")
    try:
        ranks = spawn_ranks(torch_dp_ranks.evaluate_ranks, WORLD,
                            (WORLD, synthetic_root, "train", cfg, SERVES),
                            join_timeout_s=120.0)
        loader = PackedLoader(ds, batch_size=1, prefetch=0)
        single = {serve: evaluate(
            cfg, torch_dp_ranks.OracleModel(cfg.n_classes)
            if serve == "oracle" else seeded_model(cfg), loader,
            serve="flax" if serve == "oracle" else serve, device="cpu")
            for serve in SERVES}
        batches = list(loader)
        swapped = evaluate(cfg, torch_dp_ranks.OracleModel(cfg.n_classes),
                           [batches[1], batches[0]] + batches[2:],
                           device="cpu")
    finally:
        outs = {"train": _wait(*train, tmp / "train.log"),
                "test": _wait(*test, tmp / "test.log")}
    return dict(ranks=ranks, single=single, swapped=swapped, outs=outs,
                ckpt=ckpt,
                log=str(tmp / "log"), data_dir=synthetic_root)


@pytest.mark.parametrize("serve", SERVES)
def test_dp_evaluate_equals_one_device(runs, serve):
    want = runs["single"][serve]
    for got in (r[serve] for r in runs["ranks"]):
        assert got["map_per_th"] == want["map_per_th"]
        assert got["top1_acc"] == want["top1_acc"]
        assert got["test_value"] == want["test_value"]
        np.testing.assert_array_equal(got["confusion"], want["confusion"])
    assert want["confusion"].sum() > 0  # proposals were counted
    if serve == "oracle":  # true positives, tied scores across images:
        # the same batches in another order give another AP
        assert 0.0 < want["map_all"] < 1.0
        assert runs["swapped"]["map_all"] != want["map_all"]


def test_dp_predict_fn_serves_the_rank_row(synthetic_root):
    ds = SESYDDataset(synthetic_root, "train", bbox_sampling_step=10)
    cfg = Config(n_classes=ds.n_classes, n_filters=WIDTH)
    folded = fold_params(seeded_model(cfg), "cpu")
    shards = [pad_plans(next(iter(PackedLoader(
        ds, batch_size=1, n_devices=WORLD, rank=r, prefetch=0))))
        for r in range(WORLD)]
    stacked = stack_shards(shards)
    for r in range(WORLD):
        got = make_dp_predict_fn(cfg, stacked, r, device="cpu",
                                 folded=folded)(stacked).numpy()
        want = make_serving_fn(cfg, shards[r], device="cpu",
                               folded=folded)(shards[r]).numpy()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert want["valid"].any()


def test_train_cli_two_ranks(runs):
    out = runs["outs"]["train"]
    for r in range(WORLD):
        assert re.search(rf"\[rank {r}\] Epoch:1 Iter:\d+ LossMean:", out), r
    assert "best test_value=" in out and "(rank 0 of 2)" in out
    exp = os.listdir(runs["log"])
    assert len(exp) == 1
    exp_dir = os.path.join(runs["log"], exp[0])
    assert os.path.exists(os.path.join(exp_dir, "checkpoint",
                                       "ckpt_best.pt"))
    assert os.path.exists(os.path.join(exp_dir, "rank1", "rank1.log"))


def test_test_cli_two_ranks_prints_the_one_device_table(runs, capsys):
    test_cli.main(["--data_dir", runs["data_dir"],
                   "--bbox_sampling_step", "10", "--batch_size", "1",
                   "--n_filters", str(WIDTH), "--device", "cpu", "--phase",
                   "test", "--pretrained_model", runs["ckpt"]])
    single = capsys.readouterr().out
    table = [l for l in single.splitlines() if l.startswith("MAP@")]
    assert table and all(l in runs["outs"]["test"] for l in table)
    assert "per rank over 2 ranks" in runs["outs"]["test"]
