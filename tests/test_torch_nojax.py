"""yolat_tpu_torch runs where jax is not installed (the machine with the
card has none) and without the JAX package beside it: in a subprocess
whose import system refuses jax, jaxlib, flax, optax, orbax and yolat_tpu,
import every module of the port, write and pack synthetic files, serve
them on the CPU (predict core, on the edge-window and on the dense route,
and CLI), train one step with the fused pool head on and one in the window
layout through the train CLI, evaluate that checkpoint through the test CLI
on the dense route, serve YOLaT++ (predict core, both CLIs, the per-edge
and the factored checkpoint), and check that none of those modules was loaded. Plus a source check: no import of any of them
anywhere in the package or in chip_smoke.py."""

import os
import re
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys, tempfile, os, json

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yolat_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, __REPO__)

    import torch
    import yolat_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(yolat_tpu_torch.__path__,
                                                  "yolat_tpu_torch.")]
    for m in mods:
        importlib.import_module(m)

    from yolat_tpu_torch.cli import infer
    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.dataset import SESYDDataset
    from yolat_tpu_torch.data.loader import PackedLoader
    from yolat_tpu_torch.data.packing import to_device
    from yolat_tpu_torch.data.synthetic import write_dataset
    from yolat_tpu_torch.eval.fast_forward import fold_params
    from yolat_tpu_torch.eval.predict import make_predict_core
    from yolat_tpu_torch.nn.model import seeded_model

    with tempfile.TemporaryDirectory() as d:
        write_dataset(d, n_train=1, n_test=1, seed=3, width=500.0,
                      height=400.0, n_rooms=2, symbols_per_room=(1, 1))
        ds = SESYDDataset(d, "train", bbox_sampling_step=10)
        batch = next(iter(PackedLoader(ds, batch_size=1)))
        cfg = Config(n_classes=ds.n_classes, n_filters=8)
        model = seeded_model(cfg)
        det = make_predict_core(cfg, folded=fold_params(model),
                                detections_only=True)(to_device(batch, "cpu"))
        assert det["boxes"].shape == (1, 300, 4)
        dense = next(iter(PackedLoader(ds, batch_size=1, edge_window=False,
                                       dense=True)))
        assert "nbr_idx" in dense and "ew_src" not in dense
        det2 = make_predict_core(cfg, folded=fold_params(model),
                                 detections_only=True)(to_device(dense, "cpu"))
        assert (det2["valid"] == det["valid"]).all()
        ckpt = os.path.join(d, "m.pth")
        torch.save({"state_dict": model.state_dict()}, ckpt)
        out = os.path.join(d, "det.jsonl")
        infer.main(["--input_dir", d, "--pretrained_model", ckpt, "--out", out,
                    "--device", "cpu", "--n_filters", "8", "--conf_th", "0"])
        with open(out) as f:
            assert len(f.readlines()) == 2
        from yolat_tpu_torch.cli import train as train_cli
        res = train_cli.main(["--data_dir", d, "--device", "cpu",
                              "--n_filters", "8", "--batch_size", "1",
                              "--max_steps", "1", "--fused_head_train", "true",
                              "--root_dir", os.path.join(d, "log")])
        assert res["steps"] == 1 and res["losses"][0] == res["losses"][0]
        res = train_cli.main(["--data_dir", d, "--device", "cpu",
                              "--n_filters", "8", "--batch_size", "1",
                              "--max_steps", "1", "--train_layout", "window",
                              "--root_dir", os.path.join(d, "log_w")])
        assert res["steps"] == 1 and res["losses"][0] == res["losses"][0]
        from yolat_tpu_torch.cli import test as test_cli
        table = test_cli.main([
            "--data_dir", d, "--phase", "test", "--device", "cpu",
            "--n_filters", "8", "--batch_size", "1", "--pretrained_model",
            os.path.join(res["exp_dir"], "checkpoint"), "--serve_mode",
            "fast", "--dense_layout", "true", "--nms_algorithm", "classfix"])
        assert len(table["map_per_th"]) == 10
        # YOLaT++ serving: the super-edge family, the banded plans, both
        # primitive levels
        from yolat_tpu_torch.data.loader import extra_plans_for
        from yolat_tpu_torch.eval.fast_forward import fold_params_for
        from yolat_tpu_torch.train.checkpoint import save_reference_checkpoint
        for factored in (False, True):
            pcfg = Config(arch="yolat_pp", n_classes=ds.n_classes, n_filters=8,
                          pp_factored_prim=factored)
            pb = next(iter(PackedLoader(ds, batch_size=1,
                                        **extra_plans_for(pcfg))))
            assert "sew_own" in pb and "ew_sperm" in pb and "sup_rank" in pb
            pmodel = seeded_model(pcfg)
            det = make_predict_core(pcfg, folded=fold_params_for(pcfg, pmodel),
                                    detections_only=True)(to_device(pb, "cpu"))
            assert det["boxes"].shape == (1, 300, 4)
            pth = os.path.join(d, f"pp{int(factored)}.pth")
            save_reference_checkpoint(pmodel, pth)
            flags = (["--profile", "yolat_pp_fast"] if factored
                     else ["--arch", "yolat_pp"])
            infer.main(["--input_dir", d, "--pretrained_model", pth, "--out",
                        out, "--device", "cpu", "--n_filters", "8",
                        "--conf_th", "0"] + flags)
            with open(out) as f:
                assert len(f.readlines()) == 2
            table = test_cli.main([
                "--data_dir", d, "--phase", "test", "--device", "cpu",
                "--n_filters", "8", "--batch_size", "1", "--pretrained_model",
                pth, "--serve_mode", "fast_bf16"] + flags)
            assert len(table["map_per_th"]) == 10
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("NOJAX-OK", len(mods))
""")


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", SCRIPT.replace("__REPO__", repr(REPO))],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NOJAX-OK" in r.stdout
    n_mods = int(r.stdout.split("NOJAX-OK")[1].split()[0])
    assert n_mods >= 37


def test_no_jax_import_in_port_sources():
    names = r"(jax|jaxlib|flax|optax|orbax|yolat_tpu)(?![\w])"
    pat = re.compile(rf"^\s*(import\s+{names}|from\s+{names})", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(REPO, "yolat_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 35
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path
