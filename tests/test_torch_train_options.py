"""The training CLI with the loader's options on the CPU: a diagram split
of two sizes under `--buckets 2 --do_mixup 1 --scan_steps 2`, with
`--dense_layout true` and `--postname`. Chunks never mix shape signatures
(as `tests/test_cli.py::TestBucketedScanTraining` holds for the JAX
trainer), every bucket and every grown pad is a signature of its own, and
the printed line counts them; the flags reach `Config` and the trainer's
split and loaders as the JAX trainer builds them.
"""

import numpy as np

from yolat_tpu_torch.cli import train as train_cli
from yolat_tpu_torch.config import Config
from yolat_tpu_torch.data.staging import batch_signature
from yolat_tpu_torch.data.synthetic import write_diagram_dataset
from yolat_tpu_torch.train import trainer


def _mixed_diagrams(root):
    """4 train diagrams of 4 symbols and 4 of 12, interleaved, and a test
    diagram: two buckets with their own pads."""
    write_diagram_dataset(str(root / "small"), n_train=4, n_test=1, seed=4,
                          n_symbols=4)
    write_diagram_dataset(str(root / "large"), n_train=4, n_test=0, seed=5,
                          n_symbols=12)
    train = [f"{s}/diagrams-syn/file_train_{i}.svg" for i in range(4)
             for s in ("small", "large")]
    (root / "train_list.txt").write_text("\n".join(train) + "\n")
    (root / "test_list.txt").write_text("small/diagrams-syn/file_test_0.svg\n")
    return str(root)


def test_flags_reach_the_config():
    p = train_cli.build_parser()
    args = ["--buckets", "3", "--do_mixup", "0.5", "--postname", "x",
            "--dense_layout", "true"]
    cfg = train_cli.config_from_args(p.parse_args(args), args)
    assert (cfg.buckets, cfg.do_mixup, cfg.dense_layout) == (3, 0.5, True)
    d = Config()
    assert (d.buckets, d.do_mixup, d.dense_layout) == (1, 0.0, False)


def test_buckets_mixup_and_scan_chunks(tmp_path, capsys, monkeypatch):
    root = _mixed_diagrams(tmp_path / "data")
    chunks, loaders = [], []
    make_scan = trainer.make_scan_train_step
    make_loader = trainer.PackedLoader

    def recording_scan(*a, **kw):
        run = make_scan(*a, **kw)

        def wrapped(batches, generator=None):
            chunks.append([batch_signature(b) for b in batches])
            return run(batches, generator)

        wrapped.release, wrapped.stats = run.release, run.stats
        return wrapped

    def recording_loader(ds, **kw):
        loaders.append((ds, kw))
        return make_loader(ds, **kw)

    monkeypatch.setattr(trainer, "make_scan_train_step", recording_scan)
    monkeypatch.setattr(trainer, "PackedLoader", recording_loader)
    res = train_cli.main([
        "--data_dir", root, "--device", "cpu", "--bbox_sampling_step", "5",
        "--n_filters", "8", "--batch_size", "2", "--total_epochs", "2",
        "--eval_start", "1", "--buckets", "2", "--do_mixup", "1",
        "--scan_steps", "2", "--dense_layout", "true", "--postname", "run1",
        "--seed", "1", "--root_dir", str(tmp_path / "log"),
        "--print_freq", "1"])
    # the train split mixes up from the run's seed; its loader is
    # bucketed, the test loader is not and packs the dense table
    (train_ds, train_kw), (test_ds, test_kw) = loaders
    assert train_ds.do_mixup and not test_ds.do_mixup
    assert train_kw["buckets"] == 2 and train_kw["seed"] == 1
    assert "buckets" not in test_kw and test_kw["dense"]
    # chunks of up to two batches, never of two signatures
    assert all(len(set(c)) == 1 for c in chunks)
    assert max(len(c) for c in chunks) == 2
    assert sum(len(c) for c in chunks) == res["steps"] == 8
    met = {c[0] for c in chunks}
    assert res["signatures"] == len(met) >= 2
    assert res["signatures"] <= 2 + res["pad_growths"]
    # a bucket whose pads grew frees its old signature's entry
    assert 1 <= res["graphs_released"] <= res["pad_growths"]
    assert all(np.isfinite(res["losses"])) and res["eval_batches"] == 2
    assert np.isfinite(res["map_50"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "8 steps" in line and "CUDA graphs captured=0, replayed=0" in line
    assert (f"batch signatures={res['signatures']}, pad growths="
            f"{res['pad_growths']}") in line
