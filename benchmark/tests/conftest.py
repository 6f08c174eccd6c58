"""A small copy of the benchmark's manifest for CPU runs: the repo's cells
and metrics, their configurations at 16 channels and float32, and a mix
of 8 small floorplans in batches of 2. Only what a test run can hold;
the cells themselves run on the card."""

import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_tiny_root(root: str, dtype: str = "float32") -> str:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    os.makedirs(os.path.join(root, "benchmark", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "benchmark", "workloads"), exist_ok=True)
    for c in manifest["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        cfg.update(n_filters=16, dtype=dtype)
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    for w in manifest["workloads"]:
        w["traffic"] = "tiny"
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(REPO, "benchmark", "workloads",
                           "floorplan_train.json")) as f:
        mix = json.load(f)
    mix.update(corpus={"n_files": 8, "seed": 3, "width": 800.0,
                       "height": 600.0, "n_rooms": 2,
                       "symbols_per_room": [1, 2]},
               batch_size=2, trace_steps=4)
    with open(os.path.join(root, "benchmark", "workloads", "tiny.json"),
              "w") as f:
        json.dump(mix, f)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny")))
