"""The stage loop rehearsed on the CPU at a tiny size (genome 400 kbp,
batch 1,024): every cell kind runs through set-up, the window and the
check and comes out correct; the control (reads cut to 96 bases) and
faults planted under the timed path (an answer altered where it is
made, every 8th read left out) come out not correct. ``cell_run.run``
is called with the CPU device in place of the card, which the command
line insists on."""

import math
import time

import pytest
import torch

from benchmark.harness import cell_run, faults


def run(root, cell, seed, seconds=4.0, trace=False):
    return cell_run.run(root, cell, seed, seconds, trace,
                        torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny_se", "tiny_pe", "tiny_ad"])
def test_cells_rehearse_correct(tiny_root, cell):
    res, checks = run(tiny_root, cell, 2**31 + 17)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
    assert all(v > 0 for v in (m["value"] for m in res["metrics"].values()))
    assert [c[0] for c in checks] == ["bad_records", "mapq_off", "score_gap",
                                      "missed_share"]


def test_traced_run_reports_span_metrics(tiny_root):
    # the profile starts 2 s into the window: the batches before it
    # give the spans
    res, _ = run(tiny_root, "tiny_se", 5, seconds=8.0, trace=True)
    m = res["metrics"]
    assert "reads_per_s" not in m
    for name in ("batch_p90_ms", "input_ms_per_batch",
                 "dispatch_ms_per_batch", "format_ms_per_batch",
                 "clip_rows_per_batch"):
        assert name in m and not math.isnan(m[name]["value"])
    # no card: the device readers find nothing and say nothing
    assert "device_idle_share" not in m and "launches_per_batch" not in m


def control_root(tiny_root, tmp_path):
    import json
    import os
    import shutil

    root = str(tmp_path / "control")
    shutil.copytree(tiny_root, root)
    for name in ("tiny_se", "tiny_pe"):
        p = os.path.join(root, "benchmark", "configs", name + ".json")
        with open(p) as f:
            cfg = json.load(f)
        cfg["map_overrides"].update(cfg["check"]["control"]["map_overrides"])
        with open(p, "w") as f:
            json.dump(cfg, f)
    return root


@pytest.mark.parametrize("cell", ["tiny_se", "tiny_pe"])
def test_control_is_not_correct(tiny_root, tmp_path, cell):
    res, checks = run(control_root(tiny_root, tmp_path), cell, 7)
    got = {n: v for n, v, _ in checks}
    assert not res["correct"]
    assert got["score_gap"] >= 40


@pytest.mark.parametrize("cell", ["tiny_se", "tiny_pe"])
def test_altered_answer_is_not_correct(tiny_root, cell):
    """An answer altered where it is produced: every 8th read's POS one
    base on, as the device results reach the host (ungapped rows only:
    on a gapped row the program's own traceback check stops the run,
    which fails it too)."""
    with faults.planted("shift"):
        res, checks = run(tiny_root, cell, 9)
    assert not res["correct"]
    assert dict((n, v) for n, v, _ in checks)["bad_records"] > 0


@pytest.mark.parametrize("cell", ["tiny_se", "tiny_pe"])
def test_reads_left_out_are_not_correct(tiny_root, cell):
    """Part of each batch left out: every 8th read (both mates of every
    8th pair) emitted unmapped, as the device results reach the host.
    Every record keeps the SAM rules; ``missed_share`` catches it."""
    with faults.planted("eighth"):
        res, checks = run(tiny_root, cell, 13)
    got = {n: (v, lim) for n, v, lim in checks}
    assert not res["correct"]
    assert got["bad_records"][0] == 0
    assert got["missed_share"][0] > got["missed_share"][1]


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tiny_root, cuda_device):
    # the profile starts 2 s into the window
    res, checks = cell_run.run(tiny_root, "tiny_se", 11, 6.0, True,
                               cuda_device, time.perf_counter())
    assert res["correct"], checks
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["launches_per_batch"]["value"] > 0
    assert 0 < res["metrics"]["banded_dp_roofline"]["value"] <= 105
