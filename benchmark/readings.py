"""The readings the check's limits are set from (not run by the
benchmark's own runs): the program over a dozen seeds or more, and the
control over three or more, each at the cell's own size and load, in one
process so that a configuration's set-up serves all its cells of a seed.

    python3 benchmark/readings.py --workloads se150_wgs,se150_clean
        --seeds 11,12,13 [--control 11,12] [--seconds se150_wgs=5,...]
        [--variants program,eighth,no_rescue,control]

The control is the program with the configuration's ``check.control``
overrides: reads cut to fewer bases than they have (``max_read_len``),
which breaks the guarantee that a read is aligned whole. The seeds of
``--control`` also read the faults of harness/faults.py: every 8th read
left out (``eighth``) and, for pairs, the mate-rescue scan left out
(``no_rescue``). One JSON line a (cell, seed, variant) on standard
output: the numbers compared, the numbers printed beside them, reads/s
and the batches of the window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from contextlib import nullcontext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reading(world, program, cell, pool, data, seed, variant, over,
            seconds, device) -> dict:
    """One window of ``cell`` under ``variant`` and the check's numbers."""
    from benchmark.harness import cell_run, faults
    from benchmark.harness.window import in_window, run_window
    from urmap_tpu_torch.config import MapConfig
    from urmap_tpu_torch.map import Mapper
    from urmap_tpu_torch.map.pair import PairedMapper

    cfg = cell.config
    if over:
        mc = MapConfig(batch_size=int(cfg["batch"]),
                       **{**cfg["map_overrides"], **over})
        world.mapper = Mapper(world.index, mc, device=device)
        world.pmapper = PairedMapper(world.mapper) if cfg["paired"] else None
    else:
        world.mapper, world.pmapper = program
    fault = (faults.planted(variant) if variant in ("eighth", "no_rescue")
             else nullcontext())
    with fault:
        out = run_window(world, pool, seconds=seconds,
                         warmup=int(cfg["warmup_batches"]),
                         inflight=int(cfg["inflight"]),
                         threads=int(cfg["threads"]),
                         rows=int(cfg["check"]["rows_per_batch"]), seed=seed)
    win = in_window(out)
    t = time.perf_counter()
    got = cell_run.judge_sample(cell, world, data, out, seed, device)
    got.update(cell=cell.name, seed=seed, variant=variant, batches=len(win),
               reads_per_s=sum(m["reads"] for m in win) / seconds,
               check_s=time.perf_counter() - t)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", default="",
                    help="cell=seconds,... (default 5)")
    ap.add_argument("--variants", default="",
                    help="read only these of program,eighth,no_rescue,"
                         "control (default all)")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import cell_run, mallopt, manifest

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cells = [manifest.load_cell(ROOT, w) for w in a.workloads.split(",")]
    mallopt.apply(cells[0].config.get("mallopt", {}))
    secs = {k: float(v) for k, v in
            (kv.split("=") for kv in a.seconds.split(",") if kv)}
    control = {int(s) for s in a.control.split(",") if s}
    for seed in (int(s) for s in a.seeds.split(",")):
        for conf in dict.fromkeys(c.workload["config"] for c in cells):
            mine = [c for c in cells if c.workload["config"] == conf]
            cfg = mine[0].config
            with tempfile.TemporaryDirectory(prefix="urmap_read_") as work:
                times: dict = {}
                world = cell_run.build_world(cfg, seed, device, work, times)
                program = (world.mapper, world.pmapper)
                variants = [("program", None)]
                if seed in control:
                    variants += [("eighth", None)] + (
                        [("no_rescue", None)] if cfg["paired"] else []) + [
                        ("control", cfg["check"]["control"]["map_overrides"])]
                if a.variants:
                    variants = [v for v in variants
                                if v[0] in a.variants.split(",")]
                for cell in mine:
                    pool, data = cell_run.make_pool(cell, world, seed, work,
                                                    times)
                    for variant, over in variants:
                        print(json.dumps(reading(world, program, cell, pool,
                                                 data, seed, variant, over,
                                                 secs.get(cell.name, 5.0),
                                                 device)), flush=True)
                world.mapper = world.pmapper = program = None
                if device.type == "cuda":
                    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
