"""One run end to end on the CPU at a small size (the card's own cells run
on the card), the refusal without a card, and the JAX-free process."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import manifest, run

REPO = manifest.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def traced_line(tiny_root):
    cell = manifest.load_cell("yolat_train", root=tiny_root)
    return run.run_cell(cell, 2 ** 31 + 7, 1.0, True, device="cpu",
                        t_start=time.perf_counter())


def test_the_line_has_its_keys_and_checks_last(traced_line):
    out = traced_line
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "grad_gap_worst",
                                  "last_grad_gap", "last_grad_gap_worst",
                                  "change_gap"}
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 3
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes", "busy_s", "window_s"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out)


def test_a_cpu_run_reports_no_device_metric(traced_line):
    """Nothing read from a device trace comes out of a run on the CPU."""
    m = manifest.load_json(os.path.join(REPO, "BENCHMARK.json"))
    device_names = {x["name"] for x in m["per_layer"]
                    if x["source"] == "device_trace"}
    assert not device_names & set(traced_line["metrics"])
    assert traced_line["device"]["platform"] == "cpu"
    assert "pad_useful_share" in traced_line["metrics"]


def test_untraced_run_reports_the_end_to_end_metrics(tiny_root):
    cell = manifest.load_cell("yolat_train", root=tiny_root)
    out = run.run_cell(cell, 5, 1.0, False, device="cpu",
                       t_start=time.perf_counter())
    assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}
    assert out["metrics"]["setup_s"]["unit"] == "s"
    assert "breakdown" not in out


def _bench(cwd, *extra):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "yolat_train",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = _bench(REPO)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA device" in r.stderr


def test_the_benchmark_alone_exits_nonzero(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's folder alone."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _bench(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_forbidden_names_compare_the_top_level_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "yolat_tpu_torch_like", sys)
    assert "yolat_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "yolat_tpu.geom", sys)
    assert run.forbidden_modules() == ["yolat_tpu"]


def test_harness_and_reference_load_no_jax():
    """Every module a run loads, harness, metrics, reference and port,
    imported in a fresh process: no top-level name is jax's or the JAX
    package's."""
    code = (
        "import sys, glob, os\n"
        "import benchmark.run, benchmark.harness, benchmark.check\n"
        "import benchmark.control, benchmark.trace, benchmark.corpus\n"
        "import benchmark.ref.model, benchmark.ref.data\n"
        "from benchmark.manifest import metric_reader\n"
        "for p in glob.glob('benchmark/metrics/*.py'):\n"
        "    metric_reader(os.path.basename(p)[:-3])\n"
        "import yolat_tpu_torch.train.trainer, yolat_tpu_torch.train.loop\n"
        "import yolat_tpu_torch.data.loader, yolat_tpu_torch.ops.plans\n"
        "import torch.profiler\n"
        "print(benchmark.run.forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
