"""The clip traceback (map/clip_tb.py, the plain version of
csrc/clip_tb.cu) and its host replay (io/native/replay.cpp) against the
host clip-mode DP, ``traceback_batch_native(..., clip_open=...)``.

Everything is an integer: every comparison is exact. Each planted case
is checked to give the CIGAR shape it names, so that the case covers
what it says; then the records, decoded, must give the host DP's CIGAR,
NM, span and score byte for byte, or be marked so the host DP serves
the row.
"""

import re

import numpy as np
import pytest
import torch

from tests.utils import make_seqdb, plant_read, write_fastq
from urmap_tpu_torch.config import IndexConfig, MapConfig, ScoreConfig
from urmap_tpu_torch.index import build_index
from urmap_tpu_torch.io import sam_native
from urmap_tpu_torch.io.fastq import FastqReader
from urmap_tpu_torch.io.native import replay
from urmap_tpu_torch.kernels import clip_tb as kclip
from urmap_tpu_torch.map.cigar import cigars_nm_blob, traceback_batch_native
from urmap_tpu_torch.map.clip_tb import PAD, clip_tb_from_windows
from urmap_tpu_torch.map.pipeline import Mapper
from urmap_tpu_torch.utils import trace

SC = ScoreConfig()
# a larger mismatch and a cheaper gap make a deletion run right after the
# soft-clipped prefix the best path (through the start-clip entry, and
# through a leading insertion rewritten to S)
SC_DEL = ScoreConfig(mismatch=-6, gap_open=-3, gap_extend=-1, clip_open=-4)
G = 4000
L = 150


def _genome():
    rng = np.random.default_rng(17)
    g = rng.integers(0, 4, G).astype(np.uint8)
    g[2000:2012] = 4                      # a run of genome N
    return g


def _junk(rng, n):
    return rng.integers(0, 4, n).astype(np.uint8)


# name → (scores, a function of (genome, rng) → (read, pos), the shape
# the host DP's CIGAR must have, whether the records serve the row)
CASES = {
    "start_clip": (SC, lambda g, rng: (np.concatenate(
        [_junk(rng, 40), g[500:610]]), 500), r"^\d+S\d+M$", True),
    "end_clip": (SC, lambda g, rng: (np.concatenate(
        [g[700:800], _junk(rng, 50)]), 700), r"^\d+M\d+S$", True),
    "both_clips": (SC, lambda g, rng: (np.concatenate(
        [_junk(rng, 30), g[900:980], _junk(rng, 40)]), 900),
        r"^\d+S\d+M\d+S$", True),
    "deletion_after_start_clip": (SC_DEL, lambda g, rng: (np.concatenate(
        [_junk(rng, 2), g[503:651]]), 500), r"^\d+S\d+D\d+M$", True),
    "deletion_after_leading_insertion": (SC_DEL, lambda g, rng: (
        np.concatenate([_junk(rng, 1), g[1103:1252]]), 1100),
        r"^1S\d+D\d+M$", True),
    "leading_insertion_to_S": (SC, lambda g, rng: (np.concatenate(
        [_junk(rng, 1), g[1300:1449]]), 1300), r"^1S149M$", True),
    # the window stops at the genome's end: the last base is an
    # insertion, rewritten to S
    "clamped_window_trailing_insertion": (SC, lambda g, rng: (
        np.concatenate([g[G - 149 :], _junk(rng, 1)]), G - 149),
        r"^\d+M1S$", True),
    "indels_and_end_clip": (SC, lambda g, rng: (np.concatenate(
        [g[1500:1560], g[1563:1600], _junk(rng, 3), g[1600:1630],
         _junk(rng, 20)]), 1500), r"^\d+M3D\d+M\d+I\d+M\d+S$", True),
    "genome_n_and_read_n": (SC, lambda g, rng: (np.concatenate(
        [g[1960:2030], np.full(4, 5, np.uint8), g[2034:2066],
         _junk(rng, 44)]), 1960), r"^\d+M\d+S$", True),
    # 66 deletions: past the 6 bits of a record, so the host DP serves it
    "deletion_run_too_long": (SC, lambda g, rng: (np.concatenate(
        [g[2500:2520], g[2586:2698], _junk(rng, 18)]), 2500),
        r"^\d+M6\dD\d+M\d+S$", False),
}


def _clip_pass(genome, reads, lens, poss, sc):
    """The pass's inputs as map.pipeline.clip_tb_pass_device builds them
    (windows of L + 48 from POS, widths cut at the genome's end), the
    plain clip traceback, then the host replay."""
    n, Lr = reads.shape
    win = np.zeros((n, Lr + PAD), np.uint8)
    wid = np.zeros(n, np.int32)
    for i, p in enumerate(poss):
        w = min(int(lens[i]) + PAD, G - int(p))
        wid[i] = w
        win[i, :w] = genome[p : p + w]
    score, recs, ok = clip_tb_from_windows(
        *(torch.from_numpy(a) for a in (win, reads, lens, wid)), sc=sc,
        clip_open=sc.clip_open)
    # the kernel's dtypes (csrc/ops.cpp clip_tb)
    assert (score.dtype, recs.dtype, ok.dtype) == (torch.int32, torch.int32,
                                                   torch.bool)
    dec = replay.clip_replay_batch(recs.numpy(), np.arange(n, dtype=np.int32),
                                   lens, genome, poss, reads)
    return score.numpy(), ok.numpy(), dec


@pytest.mark.parametrize("name", list(CASES))
def test_replayed_records_equal_the_host_clip_dp(name):
    sc, make, shape, served = CASES[name]
    genome = _genome()
    rng = np.random.default_rng(len(name))
    read, pos = make(genome, rng)
    assert read.size == L
    # beside the planted row, under the default scores, 23 random
    # clip-mode rows of mixed lengths (random prefixes and tails, indels,
    # N) in the same call (SC_DEL's cheap gaps give some of them paths
    # the host walk itself cannot finish)
    n = 24 if sc is SC else 1
    reads = np.full((n, L), 5, np.uint8)
    lens = np.full(n, L, np.int32)
    poss = np.zeros(n, np.int64)
    reads[0], poss[0] = read, pos
    for i in range(1, n):
        ln = int(rng.integers(60, L + 1))
        p = int(rng.integers(0, G - 120))
        seg = list(genome[p : p + ln + 40])
        if i % 3 == 0:
            k = int(rng.integers(1, 12))
            seg = seg[:20] + seg[20 + k :] if i % 2 else \
                seg[:30] + list(_junk(rng, k % 5 + 1)) + seg[30:]
        r = np.asarray(seg[:ln], np.uint8)
        if r.size < ln:                 # near the genome's end
            r = np.concatenate([r, _junk(rng, ln - r.size)])
        t = int(rng.integers(0, ln // 2))
        if i % 2:
            r[ln - t :] = _junk(rng, t)
        else:
            r[:t] = _junk(rng, t)
        r[rng.random(ln) < 0.02] = 5
        reads[i, :ln], lens[i], poss[i] = r, ln, p
    hblob, hoff, hnm, hscore, hspan = traceback_batch_native(
        genome, poss, reads, lens, sc, raw=True, clip_open=sc.clip_open)
    assert re.match(shape, hblob[hoff[0] : hoff[1]].decode()), \
        hblob[hoff[0] : hoff[1]]
    score, ok, ((blob, off), nm, span, okd) = _clip_pass(genome, reads, lens,
                                                         poss, sc)
    np.testing.assert_array_equal(score, hscore)
    assert bool(ok[0]) == served
    for i in np.nonzero(ok)[0]:
        assert okd[i]
        assert blob[off[i] : off[i + 1]] == hblob[hoff[i] : hoff[i + 1]], i
        assert (nm[i], span[i]) == (hnm[i], hspan[i]), i
    assert ok[1:].all()


@pytest.fixture(scope="module")
def short_insert(tmp_path_factory):
    """A 200 kb genome and 128 single-end reads of 150 bases: a third
    with a 65-75 base adapter tail (the clip-rescue lane rescues them),
    some with an indel besides, the rest SNPs and indels."""
    d = tmp_path_factory.mktemp("clip_tb")
    rng = np.random.default_rng(9)
    db = make_seqdb(rng, [200_000])
    reads = []
    for i in range(128):
        r = plant_read(rng, db, length=L, n_snps=1,
                       dels=2 if i % 4 == 1 else 0,
                       ins=2 if i % 4 == 2 else 0)
        if i % 3 == 0:
            t = int(rng.integers(65, 76))
            r.codes = r.codes.copy()
            r.codes[L - t :] = rng.integers(0, 4, t)
        reads.append(r)
    write_fastq(str(d / "se.fq"), reads)
    idx = build_index(db, IndexConfig(slot_bits=16), backend="host")
    return d, db, idx


def test_mapper_sam_bytes_equal_the_host_clip_dp(short_insert):
    """A CPU Mapper with the pass writes the SAM bytes the host clip DP
    writes for the same results (the records dropped), and the records
    serve every clip-rescued gapped row."""
    d, db, idx = short_insert
    mapper = Mapper(idx, MapConfig(max_read_len=L, batch_size=128),
                    device="cpu")
    before = kclip.counter.plain_calls
    (b,) = list(FastqReader(str(d / "se.fq"), batch_size=128,
                            max_read_len=L))
    handle = mapper.start_batch(b.codes, b.lengths)
    assert handle[0].dtype == torch.int32       # one int32 copy to the host
    res = mapper.finish_batch(handle, b.lengths)
    assert kclip.counter.plain_calls == before + 1
    crow = res.clipped & res.gapped & res.mapped
    assert crow.sum() >= 20
    assert set(res.clip_tb["rows"]) == set(np.nonzero(crow)[0])

    def sam():
        c = cigars_nm_blob(db.codes, b.codes, res, mapper.sc,
                           raw_lengths=b.seq_len, clip_rows=res.clipped)
        return sam_native.format_single_end(b, res, c[:2], c[2], db)

    trace.enable()
    try:
        with_pass = sam()
    finally:
        trace.disable()
    counts = {}
    for r in trace.drain():
        if isinstance(r, trace.Count):
            counts[r.name] = counts.get(r.name, 0) + r.n
    assert counts.get("rows.clip_replay") == int(crow.sum())
    assert counts.get("rows.clip_replay_failed", 0) == 0
    assert counts.get("rows.clip_dp", 0) == 0
    res.clip_tb = None
    assert sam() == with_pass


@pytest.mark.parametrize("n,C,density", [(300, 128, 0.1), (300, 128, 0.9),
                                         (300, 128, 0.0), (5, 5, 1.0)])
def test_compact_equals_nonzero_padded(n, C, density):
    """The pass's sync-free compaction (pipeline._compact) gives the
    lanes _nonzero_padded gives, and the live count, past capacity
    too."""
    from urmap_tpu_torch.map.pipeline import _compact, _nonzero_padded

    sel = torch.from_numpy(np.random.default_rng(n).random(n) < density)
    idx, do = _compact(sel, C)
    assert torch.equal(idx, _nonzero_padded(sel, C))
    assert int(do.sum()) == min(int(sel.sum()), C)
    assert torch.equal(do, torch.arange(C) < int(sel.sum()))
