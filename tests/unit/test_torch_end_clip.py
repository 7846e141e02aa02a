"""End-clip mode (MapConfig.end_clip) of the port against urmap_tpu.

The port's Mapper and PairedMapper on the CPU (plain versions) and
urmap_tpu's on the same planted reads with ``end_clip=True``: every
field of MapResult / PairResult equal, and the SAM bytes of the
clip-mode host traceback (cigars_nm_blob with clip_open) identical.
The cases are urmap_tpu's own: reads with a garbage tail map soft-clipped
at the truth (tests/unit/test_end_clip.py), the clip-rescue lane is
off under end_clip (tests/integration/test_clip_rescue.py), and the
device traceback (kernel B6) is not run. In its place the clip
traceback writes every single-end gapped winner's CIGAR: its records,
replayed, give the host clip DP's bytes, and score at each record's
POS what the benchmark's plain clip-mode Gotoh gives there.
"""

import numpy as np
import pytest

from tests.utils import make_seqdb, plant_pair, plant_read
from urmap_tpu.config import IndexConfig, MapConfig
from urmap_tpu.index.build import build_index as jbuild
from urmap_tpu.io import sam_native
from urmap_tpu.map.cigar import cigars_nm_blob as jcigars
from urmap_tpu.map.pair import PairedMapper as JPaired
from urmap_tpu.map.pipeline import Mapper as JMapper
from urmap_tpu_torch.index import build_index as tbuild
from urmap_tpu_torch.map import Mapper as TMapper
from urmap_tpu_torch.map import PairedMapper as TPaired
from urmap_tpu_torch.map.cigar import cigars_nm_blob as tcigars

FIELDS = ("mapped", "pos", "strand", "score", "second", "mapq", "gapped",
          "ungapped", "clipped", "suspect", "lengths")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    db = make_seqdb(rng, [300_000])
    cfg = IndexConfig(slot_bits=16)
    return (rng, db, jbuild(db, cfg, backend="host"),
            tbuild(db, cfg, backend="host"))


def _same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def _batch(tmp_path, codes, name):
    """The native ReadBatch of ``codes`` through a FASTQ file."""
    from urmap_tpu import alphabet
    from urmap_tpu.io.fastq import FastqReader

    fq = str(tmp_path / f"{name}.fq")
    with open(fq, "w") as f:
        for i, c in enumerate(codes):
            f.write(f"@r{i}\n{alphabet.decode(c)}\n+\n{'I' * len(c)}\n")
    return next(iter(FastqReader(fq, batch_size=len(codes))))


def _sam_se(cigars_fn, mapper, db, batch, res):
    blob, off, nm, _ = cigars_fn(db.codes, batch.codes, res, mapper.sc,
                                 raw_lengths=batch.seq_len,
                                 clip_open=mapper.sc.clip_open,
                                 clip_rows=res.clipped)
    return sam_native.format_single_end(batch, res, (blob, off), nm, db)


def _tailed(rng, db, n, L, tail):
    """Reads whose last ``tail`` bases are replaced by garbage; truth."""
    codes = np.empty((n, L), np.uint8)
    truth = np.empty(n, np.int64)
    for i in range(n):
        r = plant_read(rng, db, length=L, strand=0)
        c = r.codes.copy()
        c[L - tail:] = (c[L - tail:] + 1 + rng.integers(0, 3, size=tail)) % 4
        codes[i], truth[i] = c, r.gpos
    return codes, truth


def test_end_clip_maps_adapter_tails_as_urmap_tpu(world, tmp_path):
    """urmap_tpu/tests/unit/test_end_clip.py's case: 40-base garbage
    tails on 100-base reads, plus clean, SNP and indel reads."""
    rng, db, jidx, tidx = world
    L, n = 100, 48
    codes, truth = _tailed(rng, db, n // 2, L, 40)
    other = [plant_read(rng, db, length=L, n_snps=i % 3,
                        dels=2 if i % 4 == 0 else 0) for i in range(n // 2)]
    codes = np.concatenate([codes, np.stack([r.codes for r in other])])
    lengths = np.full(n, L, np.int32)
    mcfg = MapConfig(max_read_len=L, batch_size=32, min_score_frac=0.4,
                     end_clip=True)
    jm, tm = JMapper(jidx, mcfg), TMapper(tidx, mcfg, device="cpu")
    assert not tm.tb and not jm.tb
    want = jm.map_codes(codes, lengths)
    got = tm.map_codes(codes, lengths)
    _same(want, got)
    assert got.tb is None
    assert int(((got.pos[: n // 2] == truth) & got.mapped[: n // 2]).sum()) \
        >= n // 2 - 2
    batch = _batch(tmp_path, codes, "se")
    sam_t = _sam_se(tcigars, tm, db, batch, got)
    assert sam_t == _sam_se(jcigars, jm, db, batch, want)
    cig = [ln.split(b"\t")[5] for ln in sam_t.splitlines()]
    assert sum(c.endswith(b"S") for c in cig[: n // 2]) >= n // 2 - 4


def test_end_clip_turns_the_rescue_lane_and_traceback_off(world):
    """urmap_tpu/tests/integration/test_clip_rescue.py's case: under
    end_clip no row is flagged clipped (every DP is already clip-mode),
    the port launches no B6 traceback (its counter stays 0), and the clip
    traceback runs in its place over every mapped gapped winner."""
    from urmap_tpu_torch.kernels import banded_dp, clip_tb, tb_dp

    rng, db, jidx, tidx = world
    L, n = 150, 32
    codes, truth = _tailed(rng, db, n, L, 60)
    lengths = np.full(n, L, np.int32)
    mcfg = MapConfig(max_read_len=L, batch_size=32, end_clip=True)
    tb_dp.counter.reset()
    banded_dp.clip_counter.reset()
    banded_dp.counter.reset()
    clip_tb.counter.reset()
    tm = TMapper(tidx, mcfg, device="cpu")
    assert tm.clip_tb and not tm.tb
    got = tm.map_codes(codes, lengths)
    want = JMapper(jidx, mcfg).map_codes(codes, lengths)
    _same(want, got)
    assert not got.clipped.any()
    assert int(((got.pos == truth) & got.mapped).sum()) >= n - 2
    assert tb_dp.counter.plain_calls == 0 and tb_dp.counter.launches == 0
    assert got.tb is None
    # the main DP ran in clip mode only
    assert banded_dp.clip_counter.plain_calls > 0
    assert banded_dp.counter.plain_calls == 0
    # one clip traceback a batch, a lane for every mapped gapped winner
    assert clip_tb.counter.plain_calls == 1
    gapped = np.nonzero(got.mapped & got.gapped)[0]
    assert gapped.size >= n - 2
    assert set(got.clip_tb["rows"]) == set(gapped)
    assert got.clip_open == tm.sc.clip_open


def _library(rng, db, n, L):
    """Single-end reads as a short-insert library mapped in local mode
    gives them, in turn: a 1-8 bp deletion, a 1-8 bp insertion, a 30-75
    bp adapter tail, a tail and an indel, and one SNP alone or (every
    tenth read) junk; one SNP in each planted read."""
    codes = np.empty((n, L), np.uint8)
    for i in range(n):
        kind, d = i % 5, int(rng.integers(1, 9))
        r = plant_read(rng, db, length=L, n_snps=1,
                       dels=d if kind == 0 or (kind == 3 and i % 2) else 0,
                       ins=d if kind == 1 or (kind == 3 and not i % 2)
                       else 0)
        c = r.codes.copy()
        if kind in (2, 3):
            t = int(rng.integers(30, 76))
            c[L - t :] = rng.integers(0, 4, t)
        if i % 10 == 9:
            c = rng.integers(0, 4, L).astype(np.uint8)
        codes[i] = c
    return codes


def _traced_cigars(tm, db, batch):
    """Map ``batch`` in one call and write its CIGARs, tracing on →
    (result, cigars_nm_blob's tuple, the counts by name)."""
    from urmap_tpu_torch.utils import trace

    trace.enable()
    try:
        res = tm.finish_batch(tm.start_batch(batch.codes, batch.lengths),
                              batch.lengths)
        cig = tcigars(db.codes, batch.codes, res, tm.sc,
                      raw_lengths=batch.seq_len, clip_rows=res.clipped)
    finally:
        trace.disable()
    counts = {}
    for r in trace.drain():
        if isinstance(r, trace.Count):
            counts[r.name] = counts.get(r.name, 0) + r.n
    return res, cig, counts


def _same_cigars(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("frac", [8, 20])
def test_end_clip_records_give_the_host_clip_dp_cigars(world, tmp_path,
                                                       frac):
    """Under end_clip the clip traceback's records, replayed, give the
    host clip DP's CIGAR, NM and span for every mapped gapped winner
    (indels, adapter tails, both); at ``tb_capacity_frac`` 20 the
    winners outnumber the clip lanes (twice B6's 128) and those past
    them take the host clip DP, with the same bytes."""
    rng, db, _, tidx = world
    L, n = 150, 640
    codes = _library(np.random.default_rng(frac), db, n, L)
    mcfg = MapConfig(batch_size=n, end_clip=True, tb_capacity_frac=frac)
    tm = TMapper(tidx, mcfg, device="cpu")
    batch = _batch(tmp_path, codes, "lib")
    res, got, counts = _traced_cigars(tm, db, batch)
    gapped = int((res.mapped & res.gapped).sum())
    assert gapped >= n // 2
    lanes = min(2 * max(n // frac, 128), n)
    assert counts["rows.clip_tb"] == min(gapped, lanes)
    assert counts.get("rows.clip_tb_past", 0) == max(gapped - lanes, 0)
    assert counts.get("rows.clip_replay_failed", 0) == 0
    assert counts["rows.clip_replay"] == min(gapped, lanes)
    assert counts.get("rows.clip_dp", 0) == max(gapped - lanes, 0)
    assert "rows.replay" not in counts and "rows.host_dp" not in counts
    if frac == 20:
        assert gapped > lanes
    res.clip_tb = None
    _same_cigars(got, tcigars(db.codes, batch.codes, res, tm.sc,
                              raw_lengths=batch.seq_len,
                              clip_rows=res.clipped))


def test_cigars_nm_blob_formats_in_the_result_clip_mode(world, tmp_path):
    """A result records its clip mode: cigars_nm_blob without clip_open
    gives an end-clip result's bytes with it, and a clip_open that
    disagrees with the result's mode (a plain result's None included)
    raises ValueError."""
    rng, db, _, tidx = world
    L, n = 150, 48
    codes = _library(np.random.default_rng(4), db, n, L)
    batch = _batch(tmp_path, codes, "mode")
    sc = TMapper(tidx, MapConfig(max_read_len=L, batch_size=n),
                 device="cpu").sc
    ends = {}
    for end_clip in (True, False):
        tm = TMapper(tidx, MapConfig(max_read_len=L, batch_size=n,
                                     end_clip=end_clip), device="cpu")
        ends[end_clip] = tm.map_codes(codes, batch.lengths)
    res, plain = ends[True], ends[False]
    assert res.clip_open == sc.clip_open and plain.clip_open is None

    def blob(r, **kw):
        return tcigars(db.codes, codes, r, sc, raw_lengths=batch.seq_len,
                       clip_rows=r.clipped, **kw)

    _same_cigars(blob(res), blob(res, clip_open=sc.clip_open))
    with pytest.raises(ValueError, match="mapped with clip_open"):
        blob(res, clip_open=sc.clip_open - 1)
    with pytest.raises(ValueError, match="mapped with clip_open None"):
        blob(plain, clip_open=sc.clip_open)


@pytest.mark.parametrize("seed", [5, 6])
def test_end_clip_cigar_scores_equal_the_reference_gotoh(seed, tmp_path):
    """On a seeded random genome, each mapped record's CIGAR (the clip
    traceback's records replayed) scores, at its POS, what the
    benchmark's plain clip-mode Gotoh (benchmark/reference/align.py)
    gives for the read against the host's window from that POS."""
    import torch

    from benchmark.reference.align import (best_scores, cigar_score,
                                           parse_cigar)
    from urmap_tpu_torch import alphabet
    from urmap_tpu_torch.config import IndexConfig as TCfg

    rng = np.random.default_rng(seed)
    db = make_seqdb(rng, [150_000])
    tidx = tbuild(db, TCfg(slot_bits=16), backend="host")
    L, n = 150, 96
    codes = _library(rng, db, n, L)
    tm = TMapper(tidx, MapConfig(batch_size=n, end_clip=True),
                 device="cpu")
    batch = _batch(tmp_path, codes, "ref")
    res, cig, counts = _traced_cigars(tm, db, batch)
    assert counts["rows.clip_replay"] == int((res.mapped & res.gapped).sum())
    sam = sam_native.format_single_end(batch, res, cig[:2], cig[2], db)
    sc = {k: getattr(tm.sc, k) for k in ("match", "mismatch", "gap_open",
                                         "gap_extend", "clip_open")}
    g = db.codes
    scored = clipped = 0
    for line in sam.splitlines():
        f = line.split(b"\t")
        if int(f[1]) & 4:
            continue
        read = alphabet.encode(f[9], is_genome=False)
        pos = int(db.starts[0]) + int(f[3]) - 1     # one contig
        ops = parse_cigar(f[5])
        got = cigar_score(ops, read, g, pos, sc)
        win = np.full(L + 48, 4, np.uint8)
        seg = g[pos : pos + L + 48]
        win[: seg.size] = seg
        want = best_scores(torch.from_numpy(read[None]),
                           torch.from_numpy(win[None]),
                           torch.tensor([True]), sc)
        assert got[0] == int(want[0]), (f[0], f[5])
        scored += 1
        clipped += got[3] > 0
    assert scored >= n * 3 // 4 and clipped >= n // 5


def test_paired_end_clip_as_urmap_tpu(world, tmp_path):
    """FR pairs with a garbage tail on some mates and one mate mutated
    every 15th base (the rescue scan, in clip mode): PairResult and the
    paired SAM bytes equal urmap_tpu's."""
    rng, db, jidx, tidx = world
    L, n = 120, 40
    pairs = [plant_pair(rng, db, length=L, frag=int(rng.integers(250, 500)),
                        snp_every=15 if i % 5 == 0 else None)
             for i in range(n)]
    c1 = np.stack([p[0].codes for p in pairs])
    c2 = np.stack([p[1].codes for p in pairs])
    c1[1::4, L - 45:] = rng.integers(0, 4, size=(len(c1[1::4]), 45))
    ln = np.full(n, L, np.int32)
    mcfg = MapConfig(max_read_len=L, batch_size=32, end_clip=True)
    jp = JPaired(JMapper(jidx, mcfg))
    tp = TPaired(TMapper(tidx, mcfg, device="cpu"))
    want = jp.map_pair_codes(c1, ln, c2, ln)
    got = tp.map_pair_codes(c1, ln, c2, ln)
    for a, b in ((want.m1, got.m1), (want.m2, got.m2)):
        _same(a, b)
    np.testing.assert_array_equal(want.proper, got.proper)
    assert got.proper.mean() > 0.8

    b1, b2 = _batch(tmp_path, c1, "r1"), _batch(tmp_path, c2, "r2")

    def sam(cigars_fn, pm, res):
        clip = pm.sc.clip_open
        x1 = cigars_fn(db.codes, c1, res.m1, pm.sc, raw_lengths=b1.seq_len,
                       clip_open=clip, clip_rows=res.m1.clipped)
        x2 = cigars_fn(db.codes, c2, res.m2, pm.sc, raw_lengths=b2.seq_len,
                       clip_open=clip, clip_rows=res.m2.clipped)
        return sam_native.format_paired(
            b1, b2, res, (x1[0], x1[1]), x1[2], x1[3], (x2[0], x2[1]),
            x2[2], x2[3], db)

    assert sam(tcigars, tp, got) == sam(jcigars, jp, want)
