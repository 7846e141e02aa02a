"""The port's device-traceback path on the CPU against urmap_tpu's.

On an 80,000-base index and indel reads from both strands: the port's
tb_pass_device matrix equals the reference's WHOLE matrix (fill lanes
included), the default Mapper (tb_bits on) equals urmap_tpu.map.Mapper
in MapResult, tb dict, cigars_nm_blob output and SAM bytes, and equals
itself with tb_bits off. Integers and bytes throughout: tolerance 0.

Fill lanes of the traceback matrix take the biased position 0, far past
the genome's end, so their window comes from the gather's clamp. The
reference has two gathers: the row gather of its accelerator path, which
the port copies (start clamped to the last element, rows to the last
row), and on the CPU a slice gather that pins the start to M - width.
They agree on every in-range start. The tests run the reference's row
gather (``GATHER_MODE = "row"``, as its own test_genome_pack.py sets it)
and compare every cell; one case keeps the CPU default and compares all
but the fill lanes' never-read records.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from tests.utils import make_seqdb, plant_read, write_fastq
from urmap_tpu import genome_pack as jgpk
from urmap_tpu.config import IndexConfig, MapConfig
from urmap_tpu.index.build import build_index as jbuild
from urmap_tpu.io import sam_native
from urmap_tpu.io.fastq import FastqReader
from urmap_tpu.map import pipeline as jpipe
from urmap_tpu.map.cigar import cigars_nm_blob as jcigars
from urmap_tpu.map.seed import POS_BIAS
from urmap_tpu.utils.stream import run_stream
from urmap_tpu_torch import genome_pack as tgpk
from urmap_tpu_torch.index import build_index as tbuild
from urmap_tpu_torch.io import sam_native as tsam_native
from urmap_tpu_torch.kernels import tb_dp as ktb
from urmap_tpu_torch.map import pipeline as tpipe
from urmap_tpu_torch.map.cigar import _tb_select, cigars_nm_blob as tcigars

ICFG = IndexConfig(k=16, slot_bits=18, max_positions_per_slot=64)
MCFG = MapConfig(max_read_len=128, batch_size=64, seeds_per_read=6,
                 positions_per_seed=32, top_candidates=8, band_halfwidth=12)
FIELDS = ("mapped", "pos", "strand", "score", "second", "mapq", "gapped",
          "ungapped", "clipped", "suspect", "lengths")
TB_KEYS = ("rows", "score", "pos", "strand", "cols", "dops", "hw", "L")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    db = make_seqdb(rng, [80_000])
    return (rng, db, jbuild(db, ICFG, backend="host"),
            tbuild(db, ICFG, backend="host"))


def _indel_reads(rng, db, n, every=1):
    """100-base reads from both strands; every ``every``-th has a 1-5
    base insertion or deletion (the first always has one)."""
    reads = []
    for i in range(n):
        snps = int(rng.integers(0, 3))
        if i % every:
            reads.append(plant_read(rng, db, length=100, n_snps=snps))
        elif rng.random() < 0.5:
            reads.append(plant_read(rng, db, length=100, n_snps=snps,
                                    ins=int(rng.integers(1, 6))))
        else:
            reads.append(plant_read(rng, db, length=100, n_snps=snps,
                                    dels=int(rng.integers(1, 6))))
    return reads


def _pad_batch(reads, L=128):
    codes = np.full((len(reads), L), 5, np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r.codes)] = r.codes
        lens[i] = len(r.codes)
    return codes, lens


@pytest.fixture(autouse=True)
def row_gather(monkeypatch):
    monkeypatch.setattr(jgpk, "GATHER_MODE", "row")


def _assert_same_result(want, got, live_only=False):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)
    assert (want.tb is None) == (got.tb is None)
    if want.tb is not None:
        assert set(want.tb) == set(got.tb) == set(TB_KEYS)
        for k in TB_KEYS:
            a, b = want.tb[k], got.tb[k]
            if k == "dops" and live_only:
                a, b = a[:, want.tb["cols"]], b[:, got.tb["cols"]]
            np.testing.assert_array_equal(a, b, err_msg=k)
            assert np.asarray(a).dtype == np.asarray(b).dtype


def _assert_same_blob(a, b):
    for x, y in zip(a, b):
        if isinstance(x, bytes):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("nrows,overflow", [(64, False), (256, True)])
def test_tb_pass_device_whole_matrix(world, nrows, overflow):
    """Row 0 is a gapped winner, so the fill lanes (which alias row 0)
    must be masked by count; with 256 rows C = 128 lanes and more gapped
    winners than lanes. Every cell of the matrix is compared: meta rows
    and the records of fill lanes, whose window is the gather's clamp."""
    rng, db, jidx, tidx = world
    mcfg = dataclasses.replace(MCFG, batch_size=nrows)
    jm = jpipe.Mapper(jidx, mcfg)
    tm = tpipe.Mapper(tidx, mcfg, device="cpu")
    reads = _indel_reads(np.random.default_rng(nrows), db, nrows,
                         every=1 if overflow else 3)
    codes, lens = _pad_batch(reads)
    res = jm.map_codes(codes, lens)
    gsel = res.mapped & res.gapped & ~res.clipped
    C = jpipe.tb_cols(nrows, mcfg)
    assert tpipe.tb_cols(nrows, mcfg) == C == min(nrows, 128)
    assert tpipe.tb_rows(mcfg) == jpipe.tb_rows(mcfg)
    assert gsel[0]
    assert (gsel.sum() > C) == overflow and (overflow or gsel.sum() < C)
    assert {0, 1} <= set(res.strand[gsel])
    pos = (res.pos - POS_BIAS).astype(np.int32)
    L = mcfg.max_read_len
    nw = -(-L // jgpk.BASES_PER_WORD)
    jrp, jrn = jgpk.pack_reads(jnp.asarray(codes), jnp.asarray(lens), nw)
    want = np.asarray(jpipe.tb_pass_device(
        jm.tables, jnp.asarray(pos), jnp.asarray(res.strand),
        jnp.asarray(lens), jnp.asarray(gsel), jrp, jrn, L=L, mcfg=mcfg,
        sc=jm.sc))
    trp, trn = tgpk.pack_reads(torch.from_numpy(codes),
                               torch.from_numpy(lens), nw)
    # both strands' words, stacked as the seed front gives them
    rrp, rrn = tgpk.revcomp_words(trp, trn, torch.from_numpy(lens), L)
    ktb.counter.reset()
    got = tpipe.tb_pass_device(
        tm.tables, torch.from_numpy(pos), torch.from_numpy(res.strand),
        torch.from_numpy(lens), torch.from_numpy(gsel),
        torch.cat([trp, rrp]), torch.cat([trn, rrn]), L=L, mcfg=mcfg,
        sc=tm.sc).numpy()
    assert ktb.counter.plain_calls == 1
    assert got.shape == want.shape == (tpipe.tb_rows(mcfg), C)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # live lanes by count: exactly min(winners, C), in row order
    do = (got[1] >> 16) & 1
    assert do.sum() == min(int(gsel.sum()), C)
    np.testing.assert_array_equal(got[0][do == 1],
                                  np.nonzero(gsel)[0][:C])
    # the strand bit rides at bit 18 of meta row 1
    np.testing.assert_array_equal(((got[1] >> 18) & 1)[do == 1],
                                  res.strand[got[0][do == 1]])
    jt = jpipe.unpack_tb(want, mcfg.band_halfwidth, L)
    tt = tpipe.unpack_tb(got, mcfg.band_halfwidth, L)
    for k in TB_KEYS:
        np.testing.assert_array_equal(jt[k], tt[k], err_msg=k)


def _sam(mapper, cigars_fn, native_mod, reader_cls, db, fq):
    out = []

    def fmt(b, res):
        blob, off, nm, _ = cigars_fn(db.codes, b.codes, res, mapper.sc,
                                     raw_lengths=b.seq_len,
                                     clip_rows=res.clipped)
        return native_mod.format_single_end(b, res, (blob, off), nm, db)

    run_stream(reader_cls(fq, batch_size=mapper.mcfg.batch_size,
                          max_read_len=mapper.mcfg.max_read_len),
               lambda b: mapper.start_batch(b.codes, b.lengths),
               lambda b, h: mapper.finish_batch(h, b.lengths), fmt,
               out.append, inflight=1, workers=2)
    return b"".join(out)


@pytest.mark.parametrize("gather_mode", ["row", "auto"])
def test_default_mapper_matches_urmap_tpu(world, tmp_path, monkeypatch,
                                          gather_mode):
    """tb_bits on (the default) in both packages: MapResult, tb dict,
    the cigars_nm_blob tuple and the SAM bytes; then the port with
    tb_bits off gives the same result and bytes; and at least 0.9 of
    the gapped winners decode from the device records."""
    from urmap_tpu_torch.io.fastq import FastqReader as TFastqReader

    monkeypatch.setattr(jgpk, "GATHER_MODE", gather_mode)
    rng, db, jidx, tidx = world
    jm = jpipe.Mapper(jidx, MCFG)
    tm = tpipe.Mapper(tidx, MCFG, device="cpu")
    assert jm.tb and tm.tb
    reads = _indel_reads(np.random.default_rng(11), db, 48)
    codes, lens = _pad_batch(reads)
    want = jm.map_codes(codes, lens)
    got = tm.map_codes(codes, lens)
    assert got.tb is not None and got.tb["rows"].size > 0
    _assert_same_result(want, got, live_only=gather_mode == "auto")
    rows = np.nonzero(got.mapped & got.gapped)[0]
    use, _ti = _tb_select(got, rows, got.clipped)
    assert use.size >= int(0.9 * rows.size), (use.size, rows.size)
    with_j = jcigars(db.codes, codes, want, jm.sc, clip_rows=want.clipped)
    with_t = tcigars(db.codes, codes, got, tm.sc, clip_rows=got.clipped)
    _assert_same_blob(with_j, with_t)
    # the records change nothing: the host DP gives the same tuple
    _assert_same_blob(with_t, tcigars(db.codes, codes,
                                      dataclasses.replace(got, tb=None),
                                      tm.sc, clip_rows=got.clipped))
    # the port with the traceback off
    tm_off = tpipe.Mapper(tidx, dataclasses.replace(MCFG, tb_bits=False),
                          device="cpu")
    assert not tm_off.tb
    off = tm_off.map_codes(codes, lens)
    assert off.tb is None
    _assert_same_result(dataclasses.replace(got, tb=None), off)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, reads)
    sam_j = _sam(jm, jcigars, sam_native, FastqReader, db, fq)
    sam_t = _sam(tm, tcigars, tsam_native, TFastqReader, db, fq)
    sam_off = _sam(tm_off, tcigars, tsam_native, TFastqReader, db, fq)
    assert sam_j.count(b"\n") == len(reads)
    assert b"I" in sam_t and b"D" in sam_t
    assert sam_t == sam_j
    assert sam_off == sam_t


def test_multi_batch_merge_keeps_tb(world):
    """map_codes over three batches (64 + 64 + 22) keeps the device
    records through merge_tb_batches, equal to the reference's merge,
    and the merged blob equals the host-DP blob."""
    rng, db, jidx, tidx = world
    jm = jpipe.Mapper(jidx, MCFG)
    tm = tpipe.Mapper(tidx, MCFG, device="cpu")
    reads = _indel_reads(np.random.default_rng(12), db, 150)
    codes, lens = _pad_batch(reads)
    want = jm.map_codes(codes, lens)
    got = tm.map_codes(codes, lens)
    _assert_same_result(want, got)
    rows = np.nonzero(got.mapped & got.gapped)[0]
    use, _ti = _tb_select(got, rows, got.clipped)
    assert use.size >= int(0.9 * rows.size)
    assert (use >= 128).any() and (use < 64).any()
    assert got.tb["dops"].shape[1] == 3 * tpipe.tb_cols(64, MCFG)
    with_tb = tcigars(db.codes, codes, got, tm.sc, clip_rows=got.clipped)
    without = tcigars(db.codes, codes, dataclasses.replace(got, tb=None),
                      tm.sc, clip_rows=got.clipped)
    _assert_same_blob(with_tb, without)
    assert tpipe.merge_tb_batches([got.tb, None], [0, 64]) is None


def test_tb_select_refuses_stale_records(world):
    """A result whose row was moved, rescored, or flipped in strand at
    an equal pos and score must not replay the device records."""
    rng, db, jidx, tidx = world
    tm = tpipe.Mapper(tidx, MCFG, device="cpu")
    codes, lens = _pad_batch(_indel_reads(np.random.default_rng(13), db, 16))
    res = tm.map_codes(codes, lens)
    rows = np.nonzero(res.mapped & res.gapped)[0]
    use, _ = _tb_select(res, rows, res.clipped)
    assert use.size > 1
    r = int(use[0])
    for field, delta in (("pos", 3), ("score", -1)):
        getattr(res, field)[r] += delta
        assert r not in _tb_select(res, rows, res.clipped)[0]
        getattr(res, field)[r] -= delta
    assert r in _tb_select(res, rows, res.clipped)[0]
    r2 = int(use[1])
    res.strand[r2] = 1 - res.strand[r2]
    kept = _tb_select(res, rows, res.clipped)[0]
    assert r2 not in kept and r in kept
    # clip-rescued rows keep the host clip-mode traceback
    clip = np.zeros(len(res.mapped), bool)
    clip[r] = True
    assert r not in _tb_select(res, rows, clip)[0]


def _blob_or_error(cigars_fn, db, codes, res, sc):
    try:
        return cigars_fn(db.codes, codes, res, sc, clip_rows=res.clipped)
    except AssertionError as e:
        return str(e)


@pytest.mark.parametrize("n,batch,overflow", [(100, 1024, False),
                                              (256, 256, True)])
def test_random_tails_fall_back_alike(n, batch, overflow):
    """Reads with a 30-55 base random tail mostly map without the clip
    lane, as gapped full-read alignments whose banded score the host's
    unbanded traceback can beat. Rows replayed from the device records
    never meet that traceback; rows that fall back to it (here: more
    winners than lanes, or the records dropped) raise "native traceback
    score mismatch" — in both packages alike, message included."""
    rng = np.random.default_rng(5)
    db = make_seqdb(rng, [200_000])
    reads = []
    for _ in range(n):
        t = int(rng.integers(30, 56))
        r = plant_read(rng, db, length=150 - t)
        r.codes = np.concatenate([r.codes,
                                  rng.integers(0, 4, t).astype(np.uint8)])
        reads.append(r)
    codes, lens = _pad_batch(reads, L=160)
    mcfg = MapConfig(batch_size=batch)          # the default: tb_bits on
    jm = jpipe.Mapper(jbuild(db, None, backend="host"), mcfg)
    tm = tpipe.Mapper(tbuild(db, None, backend="host"), mcfg, device="cpu")
    want, got = jm.map_codes(codes, lens), tm.map_codes(codes, lens)
    _assert_same_result(want, got)
    winners = np.nonzero(got.mapped & got.gapped & ~got.clipped)[0]
    use, _ti = _tb_select(got, winners, got.clipped)
    lanes = tpipe.tb_cols(batch, mcfg)
    assert winners.size > 0.8 * n and (winners.size > lanes) == overflow
    assert use.size == min(winners.size, lanes)   # no stale record
    out_j = _blob_or_error(jcigars, db, codes, want, jm.sc)
    out_t = _blob_or_error(tcigars, db, codes, got, tm.sc)
    if overflow:
        assert isinstance(out_t, str) and out_t == out_j
        assert "native traceback score mismatch" in out_t
    else:
        _assert_same_blob(out_j, out_t)
    # without the records every winner meets the host traceback
    no_j = _blob_or_error(jcigars, db, codes,
                          dataclasses.replace(want, tb=None), jm.sc)
    no_t = _blob_or_error(tcigars, db, codes,
                          dataclasses.replace(got, tb=None), tm.sc)
    assert isinstance(no_t, str) and no_t == no_j
    assert "native traceback score mismatch" in no_t
