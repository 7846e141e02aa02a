"""BENCHMARK.json against the contract's shape, and each name found by
its file; a configuration, a mix and a metric added as new files and
entries only."""

import json
import os
import re

import pytest

from benchmark.harness import cell_run, mallopt, manifest
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_every_cell_finds_its_files(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = manifest.load_cell(ROOT, w["name"])
        assert cell.config["paired"] == (
            cell.traffic["generator"] == "pairs")
        assert manifest.generator(cell).generate
        limits = cell_run.check_limits(cell)
        assert set(limits) == set(cell_run.CHECKED)
        assert 0 < limits["missed_share"] < 1
        assert {m["name"] for m in cell.end_to_end} == e2e
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert callable(manifest.reader(cell, m["name"]))
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        settings = manifest.load_json(os.path.join(ROOT, c["file"]))[
            "mallopt"]
        assert set(settings) <= set(mallopt.PARAMS)
        assert all(0 <= v < 2**31 for v in settings.values())
        assert c["file"].startswith("benchmark/")


def test_per_layer_metrics_name_their_layer_and_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    """A later change adds a configuration, a mix and a metric as files
    and entries; nothing already there changes."""
    from benchmark.tests.conftest import make_tiny_root

    root = make_tiny_root(tmp_path)
    with open(os.path.join(root, "benchmark", "metrics",
                           "reads_per_batch.py"), "w") as f:
        f.write("def read(run):\n"
                "    v = [m['reads'] for m in run['batches']]\n"
                "    return sum(v) / len(v) if v else None\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["per_layer"].append({"name": "reads_per_batch", "unit": "reads",
                           "better": "higher", "source": "program_counter",
                           "layer": "stream", "moves": "reads_per_s",
                           "workloads": ["tiny_se"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    cell = manifest.load_cell(root, "tiny_se")
    assert cell.config["genome_length"] == 400_000
    assert cell.traffic["params"]["reads"] == 6144
    names = [m["name"] for m in cell.per_layer]
    assert "reads_per_batch" in names
    assert manifest.reader(cell, "reads_per_batch")(
        {"batches": [{"reads": 4}, {"reads": 6}]}) == 5
    assert "reads_per_batch" not in [
        m["name"] for m in manifest.load_cell(root, "tiny_pe").per_layer]
