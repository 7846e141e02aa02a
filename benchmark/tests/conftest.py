"""Test settings of the benchmark's own tests (python -m pytest
benchmark/tests): the repository root on the path, torch on few
threads, the ``cuda`` marker (tests that need a card skip without one,
decided inside the ``cuda_device`` fixture), and the tiny cells the
rehearsals run."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TINY = {"genome_length": 400_000, "leading_n": 5_000, "interior_n_runs": 2,
        "interior_n_len": [100, 1_000], "slot_bits": 17, "batch": 1024}


def make_tiny_root(tmp_path, reads: int = 6144) -> str:
    """A checkout-like root: this benchmark's files and BENCHMARK.json,
    plus tiny configurations (genome 400 kbp, batch 1,024), mixes and
    cells ``tiny_se``, ``tiny_pe``, ``tiny_ad`` added as new files and
    entries only."""
    root = str(tmp_path / "root")
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, src in (("tiny_se", "chr21_se150"), ("tiny_pe", "chr21_pe150")):
        with open(os.path.join(root, "benchmark", "configs",
                               src + ".json")) as f:
            cfg = json.load(f)
        cfg.update(TINY)
        cfg["check"]["records"] = 256
        with open(os.path.join(root, "benchmark", "configs",
                               name + ".json"), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": "tiny",
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": [], "why": "tiny"})
    for mix, src, key in (("tiny_wgs", "wgs_div1", "reads"),
                          ("tiny_pairs", "pairs_div1", "pairs"),
                          ("tiny_adapters", "short_insert", "reads")):
        with open(os.path.join(root, "benchmark", "traffic",
                               src + ".json")) as f:
            t = json.load(f)
        t["params"][key] = reads if key == "reads" else reads // 2
        with open(os.path.join(root, "benchmark", "traffic",
                               mix + ".json"), "w") as f:
            json.dump(t, f)
    for cell, conf, mix in (("tiny_se", "tiny_se", "tiny_wgs"),
                            ("tiny_pe", "tiny_pe", "tiny_pairs"),
                            ("tiny_ad", "tiny_se", "tiny_adapters")):
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": mix, "chips": 1,
                                   "why": "tiny"})
        for m in bench["per_layer"]:
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("bench"))
