"""Spans and counters of the port's map loop (urmap_tpu_torch/utils/trace.py).

Off, a span is one shared no-op object and nothing is recorded. On,
batches mapped on the CPU through start_batch, finish_batch,
second_pass, cigars_nm_blob and the native SAM formatter give spans
that carry their batch's id and nest inside their parents, one
``host_syncs`` a ``urmap.sync`` span, the rounds ``kernels.Rounds``
counted and a row counter for every gapped row; the SAM bytes are those
of the run with tracing off.
"""

import threading

import numpy as np
import pytest
import torch

from tests.utils import make_seqdb, plant_pair, plant_read, write_fastq
from urmap_tpu_torch import kernels
from urmap_tpu_torch.config import IndexConfig, MapConfig
from urmap_tpu_torch.index import build_index
from urmap_tpu_torch.io import sam_native
from urmap_tpu_torch.io.fastq import FastqReader
from urmap_tpu_torch.map.cigar import cigars_nm_blob
from urmap_tpu_torch.map.pair import PairedMapper
from urmap_tpu_torch.map.pipeline import Mapper
from urmap_tpu_torch.utils import trace

L = 150
ROUNDS = {"verify": kernels.verify_rounds, "dp": kernels.dp_rounds,
          "clip": kernels.clip_rounds, "rescue": kernels.rescue_rounds,
          "tier": kernels.tier_rounds}
ROW_COUNTERS = ("rows.replay", "rows.clip_replay", "rows.host_dp",
                "rows.clip_dp")


@pytest.fixture
def off():
    """Tracing off and nothing held, before and after."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 300 kb genome, 96 single-end reads (SNPs, indels, 70-base
    adapter tails for the clip-rescue lane, junk) and 48 FR pairs (every
    fourth with a mate only the rescue scan places, every fourth with a
    deletion in mate 1), as FASTQ."""
    d = tmp_path_factory.mktemp("trace")
    rng = np.random.default_rng(16)
    db = make_seqdb(rng, [300_000])
    reads = []
    for i in range(96):
        kind = i % 6
        r = plant_read(rng, db, n_snps=2 if kind == 0 else 0,
                       dels=3 if kind == 1 else 0, ins=2 if kind == 2 else 0)
        if kind == 3:
            r.codes = r.codes.copy()
            r.codes[80:] = rng.integers(0, 4, L - 80)
        if kind == 4:
            r.codes = rng.integers(0, 4, L).astype(np.uint8)
        reads.append(r)
    write_fastq(str(d / "se.fq"), reads)
    pairs = [plant_pair(rng, db, length=L, frag=int(rng.integers(250, 600)),
                        n_snps=1, snp_every=15 if i % 4 == 0 else None)
             for i in range(48)]
    for r1, _, _ in pairs[1::4]:      # a 3-base deletion in mate 1
        g = db.codes[r1.gpos : r1.gpos + L + 3]
        c = np.concatenate([g[:60], g[63:]])
        r1.codes = ((3 - c)[::-1] if r1.strand else c).astype(np.uint8)
    write_fastq(str(d / "r1.fq"), [p[0] for p in pairs])
    write_fastq(str(d / "r2.fq"), [p[1] for p in pairs])
    idx = build_index(db, IndexConfig(slot_bits=16), backend="host")
    return d, db, idx


def run(world, paired: bool, tb_bits: bool = True):
    """Every batch through start_batch → finish_batch → second_pass →
    cigars_nm_blob → the native SAM formatter → (SAM bytes, results)."""
    d, db, idx = world
    mapper = Mapper(idx, MapConfig(max_read_len=L, batch_size=32,
                                   tb_bits=tb_bits), device="cpu")
    g = db.codes
    out, results = b"", []
    if paired:
        pm = PairedMapper(mapper)
        for fwd, rev in FastqReader(str(d / "r1.fq"), str(d / "r2.fq"),
                                    batch_size=16, max_read_len=L):
            h = pm.start_batch(fwd.codes, fwd.lengths, rev.codes,
                               rev.lengths)
            res = pm.finish_batch(h, fwd.lengths, rev.lengths)
            res = pm.second_pass(fwd.codes, fwd.lengths, rev.codes,
                                 rev.lengths, res)
            c1 = cigars_nm_blob(g, fwd.codes, res.m1, mapper.sc,
                                raw_lengths=fwd.seq_len,
                                clip_rows=res.m1.clipped)
            c2 = cigars_nm_blob(g, rev.codes, res.m2, mapper.sc,
                                raw_lengths=rev.seq_len,
                                clip_rows=res.m2.clipped)
            out += sam_native.format_paired(fwd, rev, res, c1[:2], c1[2],
                                            c1[3], c2[:2], c2[2], c2[3], db)
            results.append(res)
        return out, results
    for b in FastqReader(str(d / "se.fq"), batch_size=32, max_read_len=L):
        res = mapper.finish_batch(mapper.start_batch(b.codes, b.lengths),
                                  b.lengths)
        res = mapper.second_pass(b.codes, b.lengths, res)
        c = cigars_nm_blob(g, b.codes, res, mapper.sc, raw_lengths=b.seq_len,
                           clip_rows=res.clipped)
        out += sam_native.format_single_end(b, res, c[:2], c[2], db)
        results.append(res)
    return out, results


def test_off_spans_are_one_shared_object_and_record_nothing(world, off):
    assert not trace.enabled()
    assert trace.span("urmap.a") is trace.span("urmap.b", 7) \
        is trace.sync("upload") is trace.NO_SPAN
    with trace.span("urmap.a") as s:
        assert s is trace.NO_SPAN
        trace.count("rows.replay", 3)
    assert trace.new_batch() is None
    _, results = run(world, paired=False)
    assert [r.batch for r in results] == [None] * len(results)
    assert trace.drain() == []


@pytest.mark.parametrize("paired,tb_bits", [(False, True), (False, False),
                                            (True, True)])
def test_traced_batches(world, off, paired, tb_bits):
    before = {k: r.rounds for k, r in ROUNDS.items()}
    trace.enable()
    try:
        sam_on, results = run(world, paired, tb_bits)
    finally:
        trace.disable()
    added = {k: r.rounds - before[k] for k, r in ROUNDS.items()}
    recs = trace.drain()
    sam_off, _ = run(world, paired, tb_bits)
    assert sam_on == sam_off

    spans = [r for r in recs if isinstance(r, trace.Span)]
    counts = [r for r in recs if isinstance(r, trace.Count)]
    batches = [trace.batch_of(r) for r in results]
    assert None not in batches and len(set(batches)) == len(results) == 3
    if paired:
        assert all(r.m1.batch == r.m2.batch for r in results)
    # every span and count belongs to one of the batches
    assert {r.batch for r in recs} == set(batches)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.thread == s.thread and p.batch == s.batch
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    names = {s.label for s in spans}
    assert {"urmap.start_batch", "urmap.finish_batch", "urmap.unpack",
            "urmap.sync[upload]", "urmap.sync[download]",
            "urmap.sync[nonzero]", "urmap.sync[dp]", "urmap.sync[const]",
            "urmap.second_pass", "urmap.cigars", "urmap.cigars.compose",
            "urmap.sam"} <= names
    assert all(s.parent is None for s in spans
               if s.name in ("urmap.start_batch", "urmap.finish_batch",
                             "urmap.second_pass", "urmap.cigars",
                             "urmap.sam"))
    for b in batches:
        t = trace.totals([r for r in recs if r.batch == b])
        n_sync = sum(1 for s in spans if s.batch == b
                     and s.name == "urmap.sync")
        assert t["counts"]["host_syncs"] == n_sync > 0
    # the rounds kernels.Rounds counted, by loop
    for k in ROUNDS:
        got = sum(c.n for c in counts if c.name == f"rounds.{k}")
        assert got == added[k]
    # every gapped row went one way: replayed (B6's records or the clip
    # traceback's), host DP or host clip DP
    mates = [m for r in results for m in ((r.m1, r.m2) if paired else (r,))]
    gapped = sum(int((m.mapped & m.gapped).sum()) for m in mates)
    rows = {k: sum(c.n for c in counts if c.name == k) for k in ROW_COUNTERS}
    assert sum(rows.values()) == gapped > 0
    clipped = sum(int(m.clipped.sum()) for m in mates)
    assert rows["rows.clip_dp"] + rows["rows.clip_replay"] == clipped
    assert sum(c.n for c in counts if c.name == "rows.clip_replay_failed") \
        == 0
    if tb_bits:
        assert rows["rows.replay"] > 0
    else:
        assert rows["rows.replay"] == 0 and rows["rows.host_dp"] > 0
    if not paired:
        assert clipped > 0
        # single-end: the clip traceback's records serve every clip row
        # (the pass runs with the traceback on); the pair path keeps the
        # host clip DP
        if tb_bits:
            assert rows["rows.clip_replay"] == clipped
            assert "urmap.cigars.clip_replay" in names
        else:
            assert rows["rows.clip_dp"] == clipped
    else:
        assert sum(c.n for c in counts if c.name == "rounds.rescue") > 0


def test_threads_keep_their_own_stacks(off):
    trace.enable()
    inside = threading.Barrier(2, timeout=30)
    done = threading.Barrier(2, timeout=30)

    def work(batch):
        with trace.span("urmap.outer", batch):
            inside.wait()
            with trace.span("urmap.inner"):
                trace.count("n", batch)
            done.wait()

    threads = [threading.Thread(target=work, args=(b,)) for b in (1, 2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        trace.disable()
    recs = trace.drain()
    spans = {(s.name, s.batch): s for s in recs
             if isinstance(s, trace.Span)}
    assert len(spans) == 4
    for b in (1, 2):
        outer, inner = spans["urmap.outer", b], spans["urmap.inner", b]
        assert outer.parent is None and inner.parent == outer.id
        assert inner.thread == outer.thread
    assert spans["urmap.outer", 1].thread != spans["urmap.outer", 2].thread
    assert sorted((c.batch, c.n) for c in recs
                  if isinstance(c, trace.Count)) == [(1, 1), (2, 2)]


def test_spans_enter_a_running_profiler(off):
    """While a torch profiler runs, a span is a record_function of its
    label on the profiler's timeline; outside one, it is not entered."""
    from torch.profiler import ProfilerActivity, profile

    trace.enable()
    try:
        with trace.span("urmap.before"):
            pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("urmap.outer", 5):
                with trace.sync("download"):
                    torch.ones(4).sum()
    finally:
        trace.disable()
    names = [e.name for e in prof.events()]
    assert "urmap.outer" in names and "urmap.sync[download]" in names
    assert "urmap.before" not in names
    got = trace.totals(trace.drain())
    assert got["counts"] == {"host_syncs": 1}
    assert set(got["span_ms"]) == {"urmap.before", "urmap.outer",
                                   "urmap.sync[download]"}
