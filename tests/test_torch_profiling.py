"""The port's `utils/profiling.py` against yolat_tpu's, and the scalar
log's sinks.

`timed` calls fn warmup + iters times, drains each warm-up call and the
timed calls once, together. `cost_analysis` counts JAX's flops exactly on
a pure product and at most JAX's on an MLP (FlopCounterMode counts the
matmul family only; XLA counts every op), and raises when a port kernel's
launch count or the CUDA graph replays move during the call. `trace`
writes a Chrome trace that names the CPU ops it saw. `ScalarWriter` says
which sinks it took: the JSON lines alone when asked, or when
`torch.utils.tensorboard` does not import; the trainer closes it on every
exit. The TensorBoard sink itself is in tests/test_torch_scalar_writer.py.
`scripts/traced_predict.py` (the trace's child process on the card) runs
on the CPU, and counts each wrapper's kernel records by name.
"""

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolat_tpu.utils import profiling as jp
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.toy import toy_batch
from yolat_tpu_torch.ops import _build
from yolat_tpu_torch.scripts import traced_predict
from yolat_tpu_torch.train import trainer
from yolat_tpu_torch.utils import profiling as pp
from yolat_tpu_torch.utils.experiment import ScalarWriter


@pytest.mark.parametrize("iters,warmup", [(10, 1), (3, 0), (1, 4)])
def test_timed_calls_and_drains(iters, warmup, monkeypatch):
    calls, drains = [], []
    monkeypatch.setattr(pp, "_drain", lambda outs: drains.append(outs))

    def fn(x, scale=1.0):
        calls.append(scale)
        return {"y": (x * scale,), "z": [x]}

    x = torch.ones(3)
    t = pp.timed(fn, x, iters=iters, warmup=warmup, scale=2.0)
    assert t > 0 and np.isfinite(t)
    assert calls == [2.0] * (warmup + iters)
    # one drain per warm-up call, then one over all timed outputs
    assert len(drains) == warmup + 1
    assert isinstance(drains[-1], list) and len(drains[-1]) == iters


def test_drain_finds_no_cuda_tensor_on_the_cpu():
    tree = {"a": (torch.ones(2), [torch.zeros(1), {"b": torch.ones(1)}]),
            "n": 3}
    assert pp._cuda_devices(tree, set()) == set()
    assert pp.timed(lambda: tree, iters=2) > 0


def _mlp(x, w1, b1, w2):
    return (x @ w1 + b1).clip(0) @ w2


def test_cost_analysis_against_jax():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(64, 32)), rng.normal(size=(32, 16))
    x, y = x.astype(np.float32), y.astype(np.float32)
    got = pp.cost_analysis(torch.matmul, torch.from_numpy(x),
                           torch.from_numpy(y))
    want = jp.cost_analysis(jnp.matmul, jnp.asarray(x), jnp.asarray(y))
    assert got["flops"] == want["flops"] == 2 * 64 * 32 * 16
    assert got["bytes_accessed"] is None
    assert got["raw"] == {"aten.mm": 2 * 64 * 32 * 16}
    w = [rng.normal(size=s).astype(np.float32)
         for s in ((32, 48), (48,), (48, 8))]
    got = pp.cost_analysis(_mlp, torch.from_numpy(x),
                           *map(torch.from_numpy, w))
    want = jp.cost_analysis(_mlp, jnp.asarray(x), *map(jnp.asarray, w))
    matmuls = 2 * 64 * 32 * 48 + 2 * 64 * 48 * 8
    assert got["flops"] == matmuls < want["flops"]
    # relu(x @ y).sum(): XLA counts the max and the sum, torch does not
    relu = jp.cost_analysis(lambda a, b: jax.nn.relu(a @ b).sum(),
                            jnp.asarray(x), jnp.asarray(y))["flops"]
    assert pp.cost_analysis(lambda a, b: torch.relu(a @ b).sum(),
                            torch.from_numpy(x),
                            torch.from_numpy(y))["flops"] == 65536 < relu


@pytest.mark.parametrize("what", ["launch", "replay"])
def test_cost_analysis_refuses_unseen_work(what):
    before = dict(_build.launch_counts), dict(_build.graph_counts)

    def fn(x):
        if what == "launch":
            _build.launch_counts["edge_window_message_sum"] += 1
        else:
            _build.graph_counts["replayed"] += 1
        return x @ x

    try:
        with pytest.raises(RuntimeError, match="cannot see") as e:
            pp.cost_analysis(fn, torch.ones(4, 4))
        if what == "launch":
            assert "edge_window_message_sum': 1" in str(e.value)
        else:
            assert "replayed 1 CUDA graphs" in str(e.value)
    finally:
        _build.launch_counts.update(before[0])
        _build.graph_counts.update(before[1])
    assert pp.cost_analysis(lambda x: x @ x, torch.ones(4, 4))["flops"] == 128


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(8, 8)
    with pp.trace(str(tmp_path), device="cpu") as prof:
        torch.mm(x, x)
    assert prof is not None
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_throughput_meter():
    m = pp.ThroughputMeter()
    assert m.rate == 0.0
    m.update(3)
    m.update(5)
    assert m.n == 8 and m.rate > 0


def _jsonl(path):
    with open(os.path.join(path, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_scalar_writer_json_lines(tmp_path, monkeypatch):
    (tmp_path / "a").mkdir()
    w = ScalarWriter(str(tmp_path / "a"), use_tensorboard=False)
    assert not w.tensorboard
    w.add_scalar("loss", np.float32(0.5), 1)
    w.flush()
    assert _jsonl(str(tmp_path / "a")) == [
        {"tag": "loss", "value": 0.5, "step": 1}]
    w.close()
    # where torch.utils.tensorboard does not import: the JSON lines alone
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    (tmp_path / "b").mkdir()
    w = ScalarWriter(str(tmp_path / "b"))
    assert not w.tensorboard
    w.add_scalar("x", 2, 3)
    w.close()
    assert _jsonl(str(tmp_path / "b")) == [{"tag": "x", "value": 2.0,
                                            "step": 3}]
    assert os.listdir(str(tmp_path / "b")) == ["scalars.jsonl"]


def test_trainer_closes_the_writer_on_a_raise(synthetic_root, tmp_path,
                                              monkeypatch):
    made = []

    class Recording(ScalarWriter):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.closed = False
            made.append((self, kw))

        def close(self):
            self.closed = True
            super().close()

    def boom(*a, **kw):
        raise RuntimeError("loader failed")

    monkeypatch.setattr(trainer, "ScalarWriter", Recording)
    monkeypatch.setattr(trainer, "PackedLoader", boom)
    with pytest.raises(RuntimeError, match="loader failed"):
        trainer.run_training(Config(data_dir=synthetic_root,
                                    root_dir=str(tmp_path)), "cpu",
                             exp_dir=str(tmp_path))
    ((w, kw),) = made
    assert w.closed and kw == {"use_tensorboard": False}


def test_traced_predict_on_the_cpu(tmp_path):
    """The script that phase 25 runs in a child process: on the CPU the
    wrappers take their plain versions, so nothing launches and the trace
    holds CPU ops only; the toy batch's node rows are a multiple of 512."""
    res = traced_predict.main(["--out", str(tmp_path), "--device", "cpu",
                               "--n_filters", "8"])
    assert res["launches"] == res["records"] == {}
    assert res["cpu_ops"] > 100 and os.path.exists(res["trace"])
    batch, pad = toy_batch()
    assert pad.n_nodes % 512 == 0 == batch["pos"].shape[0] % 512


def test_kernel_records_count_each_wrappers_kernels(tmp_path):
    events = ([{"cat": "kernel", "name": "void edge_window_tc_kernel<64>"
                "(float const*, int)"}] * 2
              + [{"cat": "kernel", "name": "void block_max_kernel<float>()"},
                 {"cat": "kernel", "name": "fixpoint_kernel<true>"},
                 {"cat": "kernel", "name": "void at::native::elementwise"},
                 {"cat": "cpu_op", "name": "aten::mm"}])
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    records, cpu_ops = traced_predict.kernel_records(str(path))
    assert cpu_ops == 1
    assert {k: v for k, v in records.items() if v} == {
        "edge_window_message_sum": 2, "folded_mlp_block_max2": 1,
        "nms_fixpoint": 1}
