"""Find a cell and everything it names, by name, from files.

`BENCHMARK.json` at the root of the checkout lists the cells
(`workloads`), the configurations and the metrics. A cell's configuration
is `benchmark/configs/<config>.json`, its traffic mix
`benchmark/workloads/<traffic>.json`, and each metric, end to end or per
layer, `benchmark/metrics/<name>.py` (a module with `read(record)`); the
configuration names its plain reference, a module under `benchmark/`
(`reference`). Adding a
cell takes new files and a new entry in `BENCHMARK.json`; nothing here
names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of the manifest's `workloads`, with its configuration,
    its mix and the metrics it reports."""

    def __init__(self, name: str, manifest: dict, root: str = ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json: "
                           f"{', '.join(cells)}")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(root,
                                             self.config_entry["file"]))
        self.reference = importlib.import_module(self.config["reference"])
        self.mix = load_json(os.path.join(
            root, "benchmark", "workloads", f"{self.entry['traffic']}.json"))
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]


def load_cell(name: str, root: str = ROOT) -> Cell:
    return Cell(name, load_json(os.path.join(root, "BENCHMARK.json")), root)


def metric_reader(name: str):
    """The `read(record) -> float | None` of benchmark/metrics/<name>.py
    (loaded by path: a metric's name may hold a dot)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
