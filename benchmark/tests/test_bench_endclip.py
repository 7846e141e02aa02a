"""The end-clip cell: ``se150_endclip_adapters`` finds its files and its
configuration is ``chr21_se150`` in end-clip mode; the clip traceback's
device time (``clip_tb_ms_per_batch``) read off a synthetic digest, and
nothing where no ``urmap::clip_tb`` call was traced; a tiny end-clip
cell rehearsed on the CPU comes out correct."""

import json
import os
import shutil
import time

import pytest
import torch

from benchmark.harness import cell_run, manifest
from benchmark.harness.trace import Digest
from benchmark.tests.conftest import ROOT

CELL = "se150_endclip_adapters"


def test_endclip_cell_finds_its_files():
    cell = manifest.load_cell(ROOT, CELL)
    assert cell.workload == {
        "name": CELL, "config": "chr21_se150_endclip",
        "traffic": "short_insert", "chips": 1, "why": cell.workload["why"]}
    base = manifest.load_json(os.path.join(ROOT, "benchmark", "configs",
                                           "chr21_se150.json"))
    assert cell.config["map_overrides"] == {"end_clip": True}
    differ = {k for k in base if base[k] != cell.config[k]}
    assert differ == {"source", "deployment", "map_overrides"}
    assert set(cell.config) == set(base)
    assert {m["name"] for m in cell.end_to_end} == {"reads_per_s",
                                                    "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["clip_tb_ms_per_batch"]
    assert callable(manifest.reader(cell, "clip_tb_ms_per_batch"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    conf = {c["name"]: c for c in bench["configs"]}["chr21_se150_endclip"]
    assert conf["reduced"] == cell.config["reduced"]
    assert len(conf["source"]) <= 200 and conf["source"] == \
        cell.config["source"]


def _digest(ops, batches=4):
    return Digest(window_us=1e6, batches=batches, device_ops=[], ops=ops)


def _op(name, kernels):
    return {"name": name, "shapes": [], "kernels": kernels}


@pytest.mark.parametrize("ops,batches,want", [
    ([_op("urmap::clip_tb", [("clip_tb_kernel", 1000.0)]),
      _op("urmap::clip_tb", [("clip_tb_kernel", 1400.0)]),
      _op("urmap::tb_dops", [("tb_dops_kernel", 900.0)])], 2, 1.2),
    ([_op("urmap::clip_tb", [("clip_tb_kernel", 500.0),
                              ("clip_tb_kernel", 300.0)])], 4, 0.2),
    ([_op("urmap::tb_dops", [("tb_dops_kernel", 900.0)])], 2, None),
    ([_op("urmap::clip_tb", [])], 2, None),
    ([], 2, None),
])
def test_clip_tb_ms_per_batch_reads_the_digest(ops, batches, want):
    cell = manifest.load_cell(ROOT, CELL)
    read = manifest.reader(cell, "clip_tb_ms_per_batch")
    got = read({"trace": _digest(ops, batches)})
    assert got == pytest.approx(want) if want is not None else got is None
    assert read({"trace": None}) is None


def test_tiny_endclip_cell_rehearses_correct(tiny_root, tmp_path):
    """``tiny_se`` in end-clip mode under the tiny short-insert mix, added
    as a new configuration and cell, runs set-up, the window and the
    check on the CPU and comes out correct."""
    root = str(tmp_path / "ec")
    shutil.copytree(tiny_root, root)
    conf = os.path.join(root, "benchmark", "configs")
    with open(os.path.join(conf, "tiny_se.json")) as f:
        cfg = json.load(f)
    cfg["map_overrides"] = {"end_clip": True}
    with open(os.path.join(conf, "tiny_ec.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_ec", "source": "tiny",
                             "file": "benchmark/configs/tiny_ec.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "tiny_ec", "config": "tiny_ec",
                               "traffic": "tiny_adapters", "chips": 1,
                               "why": "tiny"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    res, checks = cell_run.run(root, "tiny_ec", 2**31 + 19, 4.0, False,
                               torch.device("cpu"), time.perf_counter())
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
