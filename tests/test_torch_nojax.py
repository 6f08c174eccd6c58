"""yolat_tpu_torch runs where jax is not installed (the machine with the
card has none) and without the JAX package beside it: in a subprocess
whose import system refuses jax, jaxlib, flax, optax, orbax and yolat_tpu,
import every module of the port, write and pack synthetic files, serve
them on the CPU (predict core, on the edge-window and on the dense route,
and CLI), train one step with the fused pool head on and one in the window
layout through the train CLI, evaluate that checkpoint through the test CLI
on the dense route, serve YOLaT++ (predict core, both CLIs, the per-edge
and the factored checkpoint), train YOLaT++ through the train CLI (the
per-edge sparse route, the banded route of `ops/banded_train.py` with the
fused head, the factored profile), evaluate one of those checkpoints, run
the edge-window decomposition probe on the plain versions, build the host
library and load through it, run `cli.preprocess --workers 2` and a
`PackedLoader(preproc_workers=2)`, and check that none of those modules
was loaded. The refusal is installed by a `sitecustomize` module on the
subprocess's PYTHONPATH, so the spawned workers refuse the same imports;
each process marks that it started under it and any import it refused.
Plus a source check: no import of any of them anywhere in the package or
in chip_smoke.py."""

import os
import re
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# installed in every process of the run (the spawned workers too)
SITECUSTOMIZE = textwrap.dedent("""
    import os, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yolat_tpu")
    MARKS = os.environ["NOJAX_MARKS"]

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                with open(os.path.join(MARKS, f"refused.{os.getpid()}"),
                          "a") as f:
                    f.write(name + "\\n")
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Refuse())
    open(os.path.join(MARKS, f"started.{os.getpid()}"), "w").close()
""")

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys, tempfile, os, json

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yolat_tpu")
    assert type(sys.meta_path[0]).__name__ == "Refuse"
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
        # YOLaT++ training: the three routes through the primitive level
        import yolat_tpu_torch.ops.banded_train
        for i, flags in enumerate((
                ["--arch", "yolat_pp"],
                ["--arch", "yolat_pp", "--pp_banded_super", "true",
                 "--fused_head_train", "true"],
                ["--profile", "yolat_pp_fast"])):
            res = train_cli.main(["--data_dir", d, "--device", "cpu",
                                  "--n_filters", "8", "--batch_size", "1",
                                  "--max_steps", "1", "--root_dir",
                                  os.path.join(d, f"log_pp{i}")] + flags)
            assert res["steps"] == 1 and res["losses"][0] == res["losses"][0]
            assert res["map_50"] == res["map_50"]
        table = test_cli.main([
            "--data_dir", d, "--phase", "test", "--device", "cpu",
            "--n_filters", "8", "--batch_size", "1", "--pretrained_model",
            os.path.join(res["exp_dir"], "checkpoint"), "--profile",
            "yolat_pp_fast"])
        assert len(table["map_per_th"]) == 10
        # the edge-window decomposition probe (kernel 12), plain versions
        from yolat_tpu_torch.scripts import ew_kernel_decomp
        r = ew_kernel_decomp.main(["--device", "cpu", "--n_svgs", "1",
                                   "--batch_size", "1", "--reps", "1"])
        assert r["N"] > 0 and r["full_us"] > 0 and r["noonehot_us"] > 0
        # the host library, the offline CLI and the loader's worker pool;
        # the caches written above are removed first, so the work is cold
        from yolat_tpu_torch.cli import preprocess
        from yolat_tpu_torch.geom import _native
        assert _native.load_library() is not None
        for base, _, names in os.walk(d):
            for n in names:
                if n.endswith(".pkl"):
                    os.remove(os.path.join(base, n))
        _native.reset_counts()
        assert SESYDDataset(d, "train", cache=False).load(0)[0].n_proposals
        assert _native.native_calls["window_pipeline"] > 0
        stats = preprocess.main(["--data_dir", d, "--workers", "2",
                                 "--hierarchical"])
        assert stats["angles"]["std"] > 0
        assert any(n.endswith(".hier.v4.pkl") for _, _, ns in os.walk(d)
                   for n in ns)
        for n in os.listdir(os.path.join(d, "floorplans-syn")):
            if n.endswith(".pkl"):
                os.remove(os.path.join(d, "floorplans-syn", n))
        pooled = PackedLoader(ds, batch_size=1, preproc_workers=2,
                              cache_files=False)
        try:
            pb = next(iter(pooled))
        finally:
            pooled.close()
        assert pb["node_mask"].any() and pb["edge_mask"].any()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("NOJAX-OK", len(mods))
""")


def test_port_runs_without_jax(tmp_path):
    site = tmp_path / "site"
    marks = tmp_path / "marks"
    site.mkdir()
    marks.mkdir()
    (site / "sitecustomize.py").write_text(SITECUSTOMIZE)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(site), NOJAX_MARKS=str(marks))
    r = subprocess.run([sys.executable, "-c", SCRIPT.replace("__REPO__", repr(REPO))],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=420)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NOJAX-OK" in r.stdout
    n_mods = int(r.stdout.split("NOJAX-OK")[1].split()[0])
    assert n_mods >= 41
    names = os.listdir(marks)
    assert not [n for n in names if n.startswith("refused.")], [
        (marks / n).read_text() for n in names if n.startswith("refused.")]
    # the parent, then two preprocess and two loader workers at least (the
    # CLIs' own pools come on top)
    assert sum(n.startswith("started.") for n in names) >= 5, names


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
