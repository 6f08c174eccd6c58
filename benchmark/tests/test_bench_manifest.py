"""BENCHMARK.json against its contract, and everything found by name."""

import json
import os
import re
import shutil

import pytest

from benchmark import check, manifest
from benchmark.ref import model as ref_model

REPO = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _manifest():
    return manifest.load_json(os.path.join(REPO, "BENCHMARK.json"))


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    m = _manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(m["command"]) <= 32 and all(_line(w) for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entries():
    m = _manifest()
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in m["paths"]))
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    cells = {w["name"] for w in m["workloads"]}
    assert {w["config"] for w in m["workloads"]} == \
        {c["name"] for c in m["configs"]}
    for metric in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES
        assert set(metric.get("workloads", [])) <= cells
        names.add(metric["name"])
    assert len(names) == len(m["end_to_end"]) + len(m["per_layer"])
    for metric in m["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better",
                                              "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for metric in m["per_layer"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better",
                                              "source", "layer", "moves"}
        assert metric["moves"] in e2e and _line(metric["layer"])
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_every_cell_reports_enough():
    m = _manifest()
    for w in m["workloads"]:
        cell = manifest.Cell(w["name"], m)
        e2e = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_configs_mixes_and_metrics_found_by_name():
    m = _manifest()
    for w in m["workloads"]:
        cell = manifest.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["name"] == w["traffic"]
        ref_model.check_config(cell.config)
        assert set(cell.config["limits"]) == set(check.NUMBERS)
        assert cell.config["reduced"] == []
        for metric in cell.end_to_end + cell.per_layer:
            assert callable(manifest.metric_reader(metric["name"]))


def test_a_new_cell_takes_only_files_and_an_entry(tmp_path):
    """A later cell: a configuration file, a mix file and a metric file of
    its own and a manifest entry; no file of the harness changes."""
    root = tmp_path
    shutil.copytree(os.path.join(REPO, "benchmark", "configs"),
                    root / "benchmark" / "configs")
    shutil.copytree(os.path.join(REPO, "benchmark", "workloads"),
                    root / "benchmark" / "workloads")
    m = _manifest()
    cfg = json.loads((root / "benchmark" / "configs" /
                      "yolat_floorplan.json").read_text())
    cfg.update(name="yolat_window", train_layout="window",
               fused_head_train=False)
    (root / "benchmark" / "configs" / "yolat_window.json").write_text(
        json.dumps(cfg))
    mix = json.loads((root / "benchmark" / "workloads" /
                      "floorplan_train.json").read_text())
    mix.update(name="floorplan_mixed", buckets=3)
    (root / "benchmark" / "workloads" / "floorplan_mixed.json").write_text(
        json.dumps(mix))
    m["configs"].append({"name": "yolat_window", "source": "x",
                         "file": "benchmark/configs/yolat_window.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "yolat_window_mixed",
                           "config": "yolat_window",
                           "traffic": "floorplan_mixed", "chips": 1,
                           "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.load_cell("yolat_window_mixed", root=str(root))
    assert cell.config["train_layout"] == "window"
    assert cell.mix["buckets"] == 3
    assert {x["name"] for x in cell.per_layer} == \
        {x["name"] for x in m["per_layer"] if "workloads" not in x}
    with pytest.raises(KeyError):
        manifest.load_cell("no_such_cell", root=str(root))
