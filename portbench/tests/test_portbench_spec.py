"""BENCHMARK.json against the benchmark's contract, and finding a cell's parts
by name."""

from __future__ import annotations

import json
import math
import re

import pytest

from portbench.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_names(bench):
    assert set(bench) == KEYS["top"]
    assert len(json.dumps(bench)) <= 64 * 1024
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind
        for entry in bench[kind]:
            extra = set(entry) - KEYS[kind]
            assert extra <= ({"workloads"} if kind in ("end_to_end", "per_layer") else set())
            assert KEYS[kind] <= set(entry), (kind, entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            if "better" in entry:
                assert entry["better"] in ("lower", "higher")
            if "source" in entry and kind != "configs":
                assert entry["source"] in SOURCES
            for key in ("why", "layer"):
                if key in entry:
                    assert _line(entry[key]), (entry["name"], key)
    for config in bench["configs"]:
        assert _line(config["source"]) and config["source"].startswith("https://")
        assert len(config["reduced"]) <= 16
        assert all(NAME.match(k) for k in config["reduced"])
    for cell in bench["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4)
    assert len({(c["config"], c["traffic"]) for c in bench["workloads"]}) == len(bench["workloads"])


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for path in bench["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path
        assert not path.endswith("_torch")
    assert len(bench["command"]) <= 32
    assert all(_line(word) for word in bench["command"])
    files = [w for w in bench["command"] if w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in bench["paths"]) for f in files)
    for config in bench["configs"]:
        assert any(config["file"].startswith(p + "/") for p in bench["paths"])
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])


def test_bounds_and_window(bench):
    for metric in bench["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    run = bench["run_seconds"]
    assert isinstance(run, int) and 1 <= run <= 51
    # a full check of 24 cells fits the 43,200 s a check may take
    assert (2 + 14 * 24) * (run + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(c["chips"] == 4 for c in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_every_cell_reports_what_it_must(bench):
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in spec.cell_metrics(bench, cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, cell["name"]
        assert spec.cell_metrics(bench, cell["name"], "per_layer"), cell["name"]
    for config in bench["configs"]:
        assert any(c["config"] == config["name"] for c in bench["workloads"])


def test_per_layer_cells_report_the_metric_they_move(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    layers: dict = {}
    for metric in bench["per_layer"]:
        assert metric["moves"] in e2e
        for cell in metric.get("workloads", []):
            moved = {m["name"] for m in spec.cell_metrics(bench, cell, "end_to_end")}
            assert metric["moves"] in moved, (metric["name"], cell)
        layers.setdefault(metric["layer"].split(":")[0], set()).add(metric["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_part_is_found_by_name(bench):
    for cell in bench["workloads"]:
        mix = spec.mix(cell["traffic"])
        assert spec.config(cell["config"])["name"] == cell["config"]
        assert hasattr(spec.driver(mix["driver"]), "run")
        limits = spec.limits(cell["name"])
        assert limits.get("numbers"), f"{cell['name']} has no limits"
    for metric in bench["per_layer"]:
        assert callable(spec.metric(metric["name"]).read)


def test_config_files_hold_the_published_widths(bench):
    from portbench.reference import unet as ref_unet

    for config in bench["configs"]:
        cfg = spec.config(config["name"])
        assert cfg["reduced"] == config["reduced"] == []
        model = ref_unet.Model.from_config(cfg)
        shapes = ref_unet.param_shapes(model)
        assert sum(math.prod(s) for s in shapes.values()) == cfg["parameters"]
        assert (cfg["image_size"], cfg["image_channels"], cfg["noise_steps"]) == (32, 3, 1000)


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    for folder in ("configs", "mixes", "metrics", "drivers", "limits"):
        (tmp_path / folder).mkdir()
    (tmp_path / "configs" / "new-config.json").write_text(json.dumps({"name": "new-config"}))
    (tmp_path / "mixes" / "new_mix.json").write_text(json.dumps({"driver": "new_driver"}))
    (tmp_path / "drivers" / "new_driver.py").write_text("def run(cell):\n    return 7\n")
    (tmp_path / "metrics" / "new.metric.py").write_text("def read(facts):\n    return 41.5\n")
    (tmp_path / "limits" / "new-cell.json").write_text(json.dumps({"numbers": {"x": {"limit": 1}}}))
    assert spec.config("new-config", tmp_path)["name"] == "new-config"
    mix = spec.mix("new_mix", tmp_path)
    assert spec.driver(mix["driver"], tmp_path).run(None) == 7
    assert spec.metric("new.metric", tmp_path).read(None) == 41.5
    assert spec.limits("new-cell", tmp_path)["numbers"]["x"]["limit"] == 1
    with pytest.raises(FileNotFoundError):
        spec.config("absent", tmp_path)
