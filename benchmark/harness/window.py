"""The timed path: urmap_tpu_torch's streaming map loop, wired as its
``cli.cmd_map`` wires it, over a read pool on disk, pass after pass.

  FastqReader + PrefetchIterator, prepack on the prefetch thread
  → start_batch (the dispatch thread) → finish_batch
  → second_pass, cigars_nm_blob, format_single_end / format_paired
    (the worker pool) → commit (the writer thread)

all driven by ``urmap_tpu_torch.utils.stream.run_stream``. The stage
callables are this file's thin glue (``cmd_map``'s are closures); every
heavy stage is the program's. The commit counts the SAM bytes and keeps
the batches the check samples; it writes no SAM file.

The loop is closed: a batch leaves the reader only while fewer than
``OUTSTANDING`` batches are dispatched and not yet formatted.
``run_stream`` itself gives its worker pool work without bound, so
where the host output is the slower stage the dispatch thread would run
ever further ahead of it (``cmd_map`` over a large input queues every
batch's results in host memory), and the rate, the latency and the
memory would depend on how long the run had been going. The bound is
above ``inflight``, so the dispatch thread always has batches to sync,
and leaves every worker a batch queued behind the one it formats.
``cmd_map`` has no such bound: the closed loop is flow control the
program lacks, kept here only until ``run_stream`` bounds its own queue.

The first ``warmup`` batches are set-up. The window opens when the last
of them is committed and lasts ``seconds``. No batch is fed after it
closes; the batches still queued then are drained without their host
output. Each committed batch of the window gives the check
``rows`` records (pairs), drawn from the seed and the batch's number.
Spans are taken on every batch with the host clock; a traced run also
profiles a few batches of the window (harness/trace.py).
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np

# Batches between the reader and the formatted SAM. A stopgap: remove it
# once run_stream holds its workers' queue to a bound of its own.
OUTSTANDING = 6


@dataclass
class Pool:
    """The read pool's FASTQ files (mate 2's for pairs)."""

    fq1: str
    fq2: str | None


@dataclass
class Outcome:
    batches: list = field(default_factory=list)   # metas, commit order
    t_open: float = 0.0
    t_close: float = 0.0
    picked: list = field(default_factory=list)    # (seq, [record lines])
    sam_bytes: int = 0
    host: tuple = ()                              # (sample at open, at close)


def run_window(world, pool: Pool, *, seconds: float, warmup: int,
               inflight: int, threads: int, rows: int, seed: int,
               tracer=None, sample=None) -> Outcome:
    """Stream the pool through the mapper until the window closes."""
    from urmap_tpu_torch.io import FastqReader, sam_native
    from urmap_tpu_torch.io.fastq import PrefetchIterator
    from urmap_tpu_torch.map.cigar import cigars_nm_blob
    from urmap_tpu_torch.utils.stream import run_stream

    if not sam_native.available():
        raise RuntimeError("the native SAM codec did not build")
    if OUTSTANDING <= inflight:
        raise ValueError("OUTSTANDING must exceed inflight, or the "
                         "dispatch thread waits on batches it holds")
    mapper, pmapper = world.mapper, world.pmapper
    mcfg = mapper.mcfg
    genome = world.index.seqdb.codes
    seqdb = world.index.seqdb
    paired = pmapper is not None
    stop = threading.Event()
    out = Outcome()
    state = {"t_end": None, "formatted": 0}
    lock = threading.Lock()
    formatted = threading.Condition(lock)

    def source():
        """Batches of the pool, pass after pass, each with its parse time."""
        while not stop.is_set():
            reader = FastqReader(pool.fq1, pool.fq2,
                                 batch_size=(mcfg.batch_size // 2 if paired
                                             else mcfg.batch_size),
                                 max_read_len=mcfg.max_read_len)
            it = iter(reader)
            try:
                while not stop.is_set():
                    t = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    yield item, time.perf_counter() - t
            finally:
                it.close()

    def prepack(entry):
        item, t_parse = entry
        t = time.perf_counter()
        if paired:
            fwd, rev = item
            pk = pmapper.prepack(fwd.codes, fwd.lengths, rev.codes,
                                 rev.lengths)
        else:
            pk = mapper.prepack(item.codes, item.lengths)
        return item, pk, t_parse + time.perf_counter() - t

    prefetch = PrefetchIterator(source(), transform=prepack)

    def feed():
        seq = 0
        it = iter(prefetch)
        while True:
            with (tracer.span("bench.wait_format") if tracer
                  else nullcontext()):
                with formatted:
                    while seq - state["formatted"] >= OUTSTANDING:
                        formatted.wait()
            with (tracer.span("bench.wait_input") if tracer
                  else nullcontext()):
                entry = next(it, None)
            if entry is None:
                return
            now = time.perf_counter()
            if state["t_end"] is not None and now >= state["t_end"]:
                return
            item, pk, t_in = entry
            if tracer is not None:
                tracer.at_batch(seq, now, out.t_open or None)
            meta = {"seq": seq, "t_leave": now, "input_ms": t_in * 1e3}
            seq += 1
            yield item, pk, meta

    def start_one(entry):
        item, pk, meta = entry
        t = time.perf_counter()
        with tracer.span("bench.start_batch") if tracer else nullcontext():
            if paired:
                fwd, rev = item
                h = pmapper.start_batch(fwd.codes, fwd.lengths, rev.codes,
                                        rev.lengths, prepacked=pk)
            else:
                h = mapper.start_batch(item.codes, item.lengths,
                                       prepacked=pk)
        meta["dispatch_ms"] = (time.perf_counter() - t) * 1e3
        return h

    def sync_one(entry, handle):
        item, _, meta = entry
        t = time.perf_counter()
        with tracer.span("bench.finish_batch") if tracer else nullcontext():
            if paired:
                res = pmapper.finish_batch(handle, item[0].lengths,
                                           item[1].lengths)
            else:
                res = mapper.finish_batch(handle, item.lengths)
        meta["sync_ms"] = (time.perf_counter() - t) * 1e3
        return res

    def format_one(entry, res):
        try:
            return format_batch(entry, res)
        finally:
            with formatted:
                state["formatted"] += 1
                formatted.notify()

    def format_batch(entry, res):
        item, _, meta = entry
        t = time.perf_counter()
        if stop.is_set():           # queued past the close: not counted
            meta["reads"] = meta["clip_rows"] = 0
            meta["format_ms"] = 0.0
            return b"", meta
        if paired:
            fwd, rev = item
            res = pmapper.second_pass(fwd.codes, fwd.lengths, rev.codes,
                                      rev.lengths, res)
            c1 = cigars_nm_blob(genome, fwd.codes, res.m1, mapper.sc,
                                raw_lengths=fwd.seq_len,
                                clip_rows=res.m1.clipped)
            c2 = cigars_nm_blob(genome, rev.codes, res.m2, mapper.sc,
                                raw_lengths=rev.seq_len,
                                clip_rows=res.m2.clipped)
            data = sam_native.format_paired(
                fwd, rev, res, c1[:2], c1[2], c1[3], c2[:2], c2[2], c2[3],
                seqdb)
            meta["reads"] = 2 * len(fwd)
            meta["clip_rows"] = int(res.m1.clipped.sum()
                                    + res.m2.clipped.sum())
        else:
            res = mapper.second_pass(item.codes, item.lengths, res)
            c = cigars_nm_blob(genome, item.codes, res, mapper.sc,
                               raw_lengths=item.seq_len,
                               clip_rows=res.clipped)
            data = sam_native.format_single_end(item, res, c[:2], c[2],
                                                seqdb)
            meta["reads"] = len(item)
            meta["clip_rows"] = int(res.clipped.sum())
        meta["format_ms"] = (time.perf_counter() - t) * 1e3
        return data, meta

    def commit(result):
        data, meta = result
        now = time.perf_counter()
        meta["t_commit"] = now
        with lock:
            out.batches.append(meta)
            out.sam_bytes += len(data)
            if meta["seq"] == warmup - 1:
                out.t_open = now
                state["t_end"] = now + seconds
                if sample is not None:
                    state["host0"] = sample()
                return
            in_win = state["t_end"] is not None and now <= state["t_end"]
        if in_win and data:
            out.picked.append((meta["seq"], pick_lines(
                data, paired, rows, np.random.default_rng(
                    [seed, 7, meta["seq"]]))))

    def until_close():
        yield from feed()
        stop.set()
        if sample is not None and "host0" in state:
            out.host = (state["host0"], sample())

    try:
        run_stream(until_close(), start_one, sync_one, format_one, commit,
                   inflight=inflight, workers=threads)
    finally:
        stop.set()
        for _ in prefetch:       # let the prefetch thread see the stop
            pass
        if tracer is not None:
            tracer.close()
    out.t_close = state["t_end"] if state["t_end"] is not None else 0.0
    return out


def in_window(out: Outcome) -> list:
    """The metas of the batches committed inside the window."""
    return [m for m in out.batches
            if out.t_open < m["t_commit"] <= out.t_close]


def pick_lines(data: bytes, paired: bool, rows: int, rng) -> list:
    """``rows`` records (pairs: both mates' lines) of one batch's SAM
    bytes (a pair batch is mate 1's block, then mate 2's)."""
    ends = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)
    starts = np.concatenate([[0], ends[:-1] + 1])
    n = ends.size // 2 if paired else ends.size
    out = []
    for r in np.sort(rng.choice(n, size=min(rows, n), replace=False)):
        idx = (r, n + r) if paired else (r,)
        out.append([data[starts[i] : ends[i] + 1] for i in idx])
    return out


def sample_records(out: Outcome, n_records: int, paired: bool,
                   seed: int) -> list:
    """``n_records`` records (pairs count both mates) drawn from the
    seed out of those the window's batches gave → list of [line, ...]."""
    every = [recs for _, batch in sorted(out.picked) for recs in batch]
    want = min(len(every), -(-n_records // (2 if paired else 1)))
    rng = np.random.default_rng([seed, 8])
    return [every[i] for i in np.sort(rng.choice(len(every), size=want,
                                                 replace=False))]
