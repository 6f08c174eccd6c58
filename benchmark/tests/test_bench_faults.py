"""The check against faults planted underneath the timed path: a run of a
small cell on the CPU, at float32, sees `correct` true when sound and
false with each fault a training cell can have (one chip: no exchange
between chips to leave out)."""

import time

import pytest
import torch

from benchmark import manifest, run


def _run(root, name="yolat_train"):
    cell = manifest.load_cell(name, root=root)
    return run.run_cell(cell, 2 ** 31 + 11, 0.5, False, device="cpu",
                        t_start=time.perf_counter())


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """The loss's mean over the first half of the batch's images alone."""
    import yolat_tpu_torch.train.loop as tl

    real = tl.prepare_batch

    def prepare(cfg, batch, generator=None, aug=None):
        b = real(cfg, batch, generator, aug)
        keep = b["image_id"] < b["gt_bbox"].shape[0] // 2
        return {**b, "proposal_mask": b["proposal_mask"] & keep}

    monkeypatch.setattr(tl, "prepare_batch", prepare)


def _stale_last_grad(monkeypatch):
    """The third step's update fed the second step's gradients, as a
    replay that reads a stale gradient buffer would; its loss is sound."""
    real = torch.optim.Adam.step
    calls = {"n": 0, "prev": None}

    def step(self, closure=None):
        calls["n"] += 1
        params = [p for g in self.param_groups for p in g["params"]]
        now = [p.grad.clone() for p in params]
        if calls["n"] == 3:
            for p, g in zip(params, calls["prev"]):
                p.grad.copy_(g)
        calls["prev"] = now
        return real(self, closure)

    monkeypatch.setattr(torch.optim.Adam, "step", step)


def _loss_altered(monkeypatch):
    """The step's answer, its loss, altered where it is produced."""
    import yolat_tpu_torch.train.loop as tl

    real = tl.detection_loss

    def loss(*args, **kwargs):
        return {k: v * 1.01 for k, v in real(*args, **kwargs).items()}

    monkeypatch.setattr(tl, "detection_loss", loss)


@pytest.mark.parametrize("name", ["yolat_train", "yolatpp_train"])
def test_sound_run_is_correct(tiny_root, name):
    out = _run(tiny_root, name)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _stale_last_grad, _loss_altered])
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(tiny_root)
    assert out["correct"] is False, out["checks"]


def test_a_file_the_corpus_lacks_is_not_correct(tiny_root, monkeypatch):
    """A checked batch holding a file that is not the corpus's (its ground
    truth matches none) reads as not correct, with a result line."""
    import yolat_tpu_torch.data.loader as dl

    real = dl.pack_files

    def pack(files, gts, whs, pad, **kw):
        gts = [(g[0] + 0.01, g[1]) for g in gts]
        return real(files, gts, whs, pad, **kw)

    monkeypatch.setattr(dl, "pack_files", pack)
    out = _run(tiny_root)
    assert out["correct"] is False
    assert all(v["value"] == float("inf") for v in out["checks"].values())
