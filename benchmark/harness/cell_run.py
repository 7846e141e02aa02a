"""One run of one cell: set-up, the window, the check, the result line.

Set-up is what a pipeline pays once a genome and once a process: the
genome from the seed and its FASTA, ``urmap_tpu_torch.cli.main
-make_ufi`` (the index and its prepared tables), ``UfiIndex.load``, the
Mapper (the tables go to the card), the read pool from the seed and its
FASTQ, and the warm-up batches of the stream. All files go to one
temporary directory under TMPDIR, removed at the end; the kernels build
into the port's own directory inside the checkout (build/), once.
"""

from __future__ import annotations

import gc
import math
import os
import resource
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from benchmark.gen.fastq import read_index, write_fastq
from benchmark.gen.genome import Layout, genome_from_config, write_fasta
from benchmark.harness import manifest
from benchmark.harness.trace import Tracer, breakdown, busy_us
from benchmark.harness.window import (Pool, in_window, run_window,
                                      sample_records)

TRACE_AFTER_S = 2.0    # seconds into the window before the traced batches
TRACE_BATCHES = 8      # batches traced, or
TRACE_MAX_S = 2.0      # seconds, whichever comes first


CHECKED = ("bad_records", "mapq_off", "score_gap", "missed_share")


def check_limits(cell) -> dict:
    """The check's limits: the configuration's, with the traffic's own
    (``missed_share`` depends on the mix's share of reads hard to
    place)."""
    return {**cell.config["check"]["limits"],
            **cell.traffic.get("check", {}).get("limits", {})}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class World:
    """One configuration's genome, index and mapper."""

    genome: np.ndarray        # the benchmark's own codes (0-3, N = 4)
    layout: Layout            # its contigs
    index: object
    mapper: object
    pmapper: object


def build_world(cfg: dict, seed: int, device, work: str,
                times: dict) -> World:
    """The genome from the seed, -make_ufi, the index loaded, the
    Mapper built on ``device``."""
    for k, v in cfg.get("env", {}).items():
        os.environ[k] = str(v)
    t = time.perf_counter()
    g = genome_from_config(seed, cfg)
    layout = Layout.from_config(cfg)
    fa = os.path.join(work, "genome.fa")
    write_fasta(fa, g, layout)
    times["genome_s"] = time.perf_counter() - t

    from urmap_tpu_torch import cli
    from urmap_tpu_torch.config import MapConfig
    from urmap_tpu_torch.index import UfiIndex
    from urmap_tpu_torch.map import Mapper
    from urmap_tpu_torch.map.pair import PairedMapper

    t = time.perf_counter()
    ufi = os.path.join(work, "genome.ufi")
    rc = cli.main(["-make_ufi", fa, "-output", ufi, "-wordlength",
                   str(cfg["k"]), "-slot_bits", str(cfg["slot_bits"])])
    if rc != 0:
        raise RuntimeError(f"-make_ufi exited {rc}")
    times["make_ufi_s"] = time.perf_counter() - t
    t = time.perf_counter()
    index = UfiIndex.load(ufi)
    mcfg = MapConfig(batch_size=int(cfg["batch"]), **cfg["map_overrides"])
    mapper = Mapper(index, mcfg, device=device)
    pmapper = PairedMapper(mapper) if cfg["paired"] else None
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    times["load_upload_s"] = time.perf_counter() - t
    log(f"index {index.num_positions} positions over 2^{index.config.slot_bits}"
        f" slots ({index.num_positions / 2**index.config.slot_bits:.4f} a "
        f"slot); tables row128={mapper.row128} "
        f"packed_offsets={mapper.off_bits is not None}")
    return World(g, layout, index, mapper, pmapper)


def make_pool(cell, world: World, seed: int, work: str, times: dict):
    """The traffic's read pool from the seed, written as FASTQ."""
    t = time.perf_counter()
    data = manifest.generator(cell).generate(seed, world.genome,
                                             cell.traffic["params"])
    paired = "codes2" in data
    if paired != bool(cell.config["paired"]):
        raise ValueError(f"traffic {cell.workload['traffic']} and config "
                         f"{cell.workload['config']} disagree on pairs")
    prefix = b"p" if paired else b"r"
    fq1 = os.path.join(work, "reads_1.fq")
    nbytes = write_fastq(fq1, data["codes"], prefix)
    fq2 = None
    if paired:
        fq2 = os.path.join(work, "reads_2.fq")
        nbytes += write_fastq(fq2, data["codes2"], prefix)
    times["pool_s"] = time.perf_counter() - t
    times["pool_bytes"] = nbytes
    return Pool(fq1, fq2), data


def judge_sample(cell, world: World, data: dict, out, seed: int, device):
    """The reference's numbers over the records sampled from the window."""
    from benchmark.reference.judge import judge

    cfg = cell.config
    paired = "codes2" in data
    picked = sample_records(out, int(cfg["check"]["records"]), paired, seed)
    prefix = b"p" if paired else b"r"
    rows, lines, truth = [], [], []
    for recs in picked:
        idx = read_index(recs[0].split(b"\t", 1)[0], prefix)
        if paired:
            rows += [data["codes"][idx], data["codes2"][idx]]
            truth += [data["truth"]["pos"][idx], data["truth"]["pos2"][idx]]
        else:
            rows.append(data["codes"][idx])
            truth.append(data["truth"]["pos"][idx])
        lines += recs
    if not lines:
        return {"sampled": 0, "bad_records": 0, "mapq_off": 0,
                "score_gap": 0, "missed": 0, "missed_share": 0.0,
                "truth_share": math.nan,
                "why": ["no record committed in the window"]}
    return judge(world.genome, world.layout, np.stack(rows),
                 lines, cfg, paired, np.asarray(truth), device=device)


def host_sample() -> tuple:
    """This process's CPU seconds so far in user and system mode (its
    load around the window, printed on stderr)."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime, r.ru_stime


def host_line(a: tuple, b: tuple, seconds: float, reads: int) -> str:
    user, system = b[0] - a[0], b[1] - a[1]
    return (f"host over the window: this process {(user + system) / seconds:.3f}"
            f" CPUs (user {user / seconds:.3f}, system {system / seconds:.3f});"
            f" {(user + system) * 1e6 / max(reads, 1):.4f} CPU us a read")


def sync_files(work: str) -> None:
    """Set-up's files on disk before the window, so that their write-back
    does not run inside it."""
    for d, _, fs in os.walk(work):
        for f in fs:
            fd = os.open(os.path.join(d, f), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        device, t_proc0: float) -> tuple[dict, list]:
    """→ (the result line's object without ``check``, the check's
    [(name, value, limit)])."""
    import torch

    cell = manifest.load_cell(root, workload)
    cfg = cell.config
    times: dict = {"start_s": time.perf_counter() - t_proc0}
    with tempfile.TemporaryDirectory(prefix="urmap_bench_") as work:
        world = build_world(cfg, seed, device, work, times)
        pool, data = make_pool(cell, world, seed, work, times)
        t = time.perf_counter()
        sync_files(work)
        times["sync_s"] = time.perf_counter() - t
        tracer = (Tracer(TRACE_AFTER_S, TRACE_BATCHES, TRACE_MAX_S)
                  if trace else None)
        t_setup0 = time.perf_counter()
        out = run_window(world, pool, seconds=seconds,
                         warmup=int(cfg["warmup_batches"]),
                         inflight=int(cfg["inflight"]),
                         threads=int(cfg["threads"]),
                         rows=int(cfg["check"]["rows_per_batch"]),
                         seed=seed, tracer=tracer, sample=host_sample)
        times["warmup_s"] = out.t_open - t_setup0
        times["disk_bytes"] = sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, fs in os.walk(work) for f in fs)
    setup_s = out.t_open - t_proc0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    win = in_window(out)
    reads = sum(m["reads"] for m in win)
    t0 = out.batches[0]["t_leave"] if out.batches else 0.0
    for m in sorted(out.batches, key=lambda m: m["seq"])[:4]:
        log(f"batch {m['seq']}: left the reader at {m['t_leave'] - t0:.3f} s,"
            f" committed at {m['t_commit'] - t0:.3f} s; dispatch "
            f"{m['dispatch_ms']:.1f}, sync {m['sync_ms']:.1f}, format "
            f"{m['format_ms']:.1f} ms")
    log(f"window opened {out.t_open - t0:.3f} s after the first batch left"
        f" the reader; {sum(m['seq'] > max(x['seq'] for x in win) for m in out.batches) if win else 0}"
        f" batches committed after the close")
    log("setup " + " ".join(f"{k}={v:.6g}" for k, v in times.items()))
    log(f"window {seconds} s: {len(win)} batches, {reads} reads, "
        f"{out.sam_bytes} SAM bytes in all")
    if out.host:
        log(host_line(*out.host, seconds, reads))
    metrics = {}
    if not trace:
        vals = {"reads_per_s": reads / seconds, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    result = {"correct": False, "attempted": reads, "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        d = tracer.digest
        run_data = {"batches": [m for m in win if not tracer.overlaps(
                        m["t_leave"] - m["input_ms"] / 1e3, m["t_commit"])],
                    "window": win, "trace": d, "config": cfg,
                    "traffic": cell.traffic}
        for m in cell.per_layer:
            v = manifest.reader(cell, m["name"])(run_data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if d is not None:
            result["device"]["busy_s"] = busy_us(d) / 1e6
            result["device"]["window_s"] = d.window_us / 1e6
            result["breakdown"] = breakdown(d)
    # the program's state goes before the reference runs on the card
    mapper_dev = world.mapper.device
    world.mapper = world.pmapper = None
    gc.collect()
    if mapper_dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    got = judge_sample(cell, world, data, out, seed, device)
    log(f"check {time.perf_counter() - t:.3f} s: sampled {got['sampled']}, "
        f"missed {got['missed']}, truth_share {got['truth_share']:.6f}")
    for w in got["why"]:
        log(f"check: {w}")
    limits = check_limits(cell)
    checks = [(k, got[k], limits[k]) for k in CHECKED]
    result["correct"] = got["sampled"] > 0 and all(v <= lim
                                                   for _, v, lim in checks)
    return result, checks
