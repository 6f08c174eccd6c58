"""The YOLaT++ train CLI on the CPU, on its three routes with and without
the fused pool head: it trains, evaluates and checkpoints, and the test
CLI restores the checkpoint to the same table. Kept apart from
tests/test_torch_pp_train.py so that two test workers share the work.
"""

import os

import numpy as np
import pytest
import torch

from torch_pp_train_common import ROUTES
from yolat_tpu_torch.cli import test as test_cli
from yolat_tpu_torch.cli import train as train_cli


@pytest.mark.parametrize("fused", ["false", "true"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_train_cli_trains_evaluates_and_the_test_cli_restores(
        tmp_path, synthetic_root, capsys, route, fused):
    flags = {"per_edge": ["--arch", "yolat_pp"],
             "banded": ["--arch", "yolat_pp", "--pp_banded_super", "true"],
             "factored": ["--profile", "yolat_pp_fast"]}[route]
    res = train_cli.main(["--data_dir", synthetic_root, "--device", "cpu",
                          "--n_filters", "8", "--batch_size", "2",
                          "--max_steps", "2", "--fused_head_train", fused,
                          "--root_dir", str(tmp_path), "--print_freq", "1"]
                         + flags)
    assert res["steps"] == 2 and len(res["losses"]) == 2
    assert all(np.isfinite(res["losses"])) and res["eval_batches"] == 1
    for k in ("map_50", "map_all", "top1_acc"):
        assert np.isfinite(res[k]), k
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "2 steps" in line and "banded_gather=0, banded_gather_bwd=0, " \
        "banded_scatter_own=0, banded_scatter_own_bwd=0" in line
    ck = os.path.join(res["exp_dir"], "checkpoint")
    assert os.path.exists(os.path.join(ck, "ckpt_1.pt"))
    table = test_cli.main(["--data_dir", synthetic_root, "--phase", "test",
                           "--device", "cpu", "--n_filters", "8",
                           "--batch_size", "2", "--pretrained_model", ck]
                          + flags)
    assert len(table["map_per_th"]) == 10
    np.testing.assert_allclose(table["map_50"], res["map_50"], atol=1e-6)
    if route == "per_edge" and fused == "false" \
            and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main(["--data_dir", synthetic_root] + flags)
