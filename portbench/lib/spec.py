"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell by a configuration and a traffic mix; the
rest is found by those names under the benchmark's folder, one file each:

* ``configs/<config>.json``: the model's sizes, precision and recipe;
* ``mixes/<traffic>.json``: the traffic's parameters and its ``driver``;
* ``drivers/<driver>.py``: the code that drives the program under a mix
  (a module with ``run(cell) -> dict``);
* ``metrics/<metric>.py``: a per-layer metric's reader (``read(facts) ->
  float | None``);
* ``limits/<workload>.json``: the limits of the numbers that decide the
  cell's ``correct``, with the readings each was set from.

A later change adds a configuration, a mix, a driver, a metric or a cell by
adding files and entries, never by editing a file that exists.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BASE = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = BASE.parent  # the checkout


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(it has {[w['name'] for w in bench['workloads']]})")


def _json(base: Path, folder: str, name: str) -> dict:
    path = base / folder / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} not found: every {folder[:-1]} named in "
                                "BENCHMARK.json has a file of its own")
    with open(path) as f:
        return json.load(f)


def config(name: str, base: Path = BASE) -> dict:
    return _json(base, "configs", name)


def mix(name: str, base: Path = BASE) -> dict:
    return _json(base, "mixes", name)


def limits(name: str, base: Path = BASE) -> dict:
    path = base / "limits" / f"{name}.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)


def _module(base: Path, folder: str, name: str):
    path = base / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str, base: Path = BASE):
    return _module(base, "drivers", name)


def metric(name: str, base: Path = BASE):
    return _module(base, "metrics", name)


def cell_metrics(bench: dict, workload_name: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those whose ``workloads`` list it; one without the list
    belongs to every cell (a per-layer one: every cell that reports the
    end-to-end metric it moves)."""
    e2e = {m["name"] for m in cell_metrics(bench, workload_name, "end_to_end")} \
        if kind == "per_layer" else set()
    return [m for m in bench[kind]
            if workload_name in m.get("workloads", [workload_name])
            and (kind == "end_to_end" or "workloads" in m or m["moves"] in e2e)]
