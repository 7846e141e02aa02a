"""Everything a cell needs, found by name under the root of a checkout:
``BENCHMARK.json`` for the cell, its configuration's file (``file``),
``benchmark/traffic/<mix>.json``, the generator the mix names
(``benchmark/gen/<generator>.py``) and one reader a per-layer metric
(``benchmark/metrics/<metric>.py``). A new configuration, mix or metric
is new files and new entries; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass


@dataclass
class Cell:
    root: str
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from its file (names may hold dots, as metric names do)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, cell: str, e2e_names: set | None = None) -> bool:
    """Whether ``cell`` reports a metric: the metric's ``workloads`` list
    where it has one; else every cell for an end-to-end metric, and for
    a per-layer one every cell that reports what it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(root: str, name: str) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(root, "benchmark", "traffic",
                                     w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(root, name, w, config, traffic, e2e, per_layer)


def generator(cell: Cell):
    g = cell.traffic["generator"]
    return load_module(os.path.join(cell.root, "benchmark", "gen", g + ".py"),
                       f"benchmark.gen.{g}")


def reader(cell: Cell, metric: str):
    """The ``read(run) -> float | None`` of one per-layer metric."""
    return load_module(os.path.join(cell.root, "benchmark", "metrics",
                                    metric + ".py"),
                       f"benchmark_metric_{metric}").read
