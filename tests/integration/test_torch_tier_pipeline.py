"""The port's mapping paths with the tiered gather on
(URMAP_TIER_GATHER=1) against urmap_tpu's with the same environment.

A genome of random sequence with a 400 bp unit pasted 30 times: at the
auto slot_bits the aligned layout is chosen and prepare_tables picks a
tier, and the unit's seeds pass it, so overflow rounds run. The
single-end Mapper (device traceback on), the PairedMapper and the wide
second pass on the CPU must equal urmap_tpu's in every field, traceback
record and SAM byte, and the port's own untiered run. Integers and
bytes: tolerance 0.
"""

import dataclasses

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one torch thread)
from tests.utils import plant_pair, plant_read, write_fastq
from urmap_tpu import genome_pack as jgpk
from urmap_tpu.config import MapConfig
from urmap_tpu.index.build import build_index as jbuild
from urmap_tpu.io import sam_native as jsam_native
from urmap_tpu.io.fasta import SeqDB
from urmap_tpu.io.fastq import FastqReader as JFastqReader
from urmap_tpu.map import pair as jpair
from urmap_tpu.map import pipeline as jpipe
from urmap_tpu.map.cigar import cigars_nm_blob as jcigars
from urmap_tpu.utils.stream import run_stream
from urmap_tpu_torch.index import build_index as tbuild
from urmap_tpu_torch.io import sam_native as tsam_native
from urmap_tpu_torch.io.fastq import FastqReader as TFastqReader
from urmap_tpu_torch.kernels import lane_rotate, tier_rounds
from urmap_tpu_torch.map import pair as tpair
from urmap_tpu_torch.map import pipeline as tpipe
from urmap_tpu_torch.map.cigar import cigars_nm_blob as tcigars

L = 120
MCFG = MapConfig(max_read_len=L, batch_size=64, rescue_capacity_frac=16)
FIELDS = ("mapped", "pos", "strand", "score", "second", "mapq", "gapped",
          "ungapped", "clipped", "suspect", "lengths")
TB_KEYS = ("rows", "score", "pos", "strand", "cols", "dops", "hw", "L")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(13)
    unit = rng.integers(0, 4, size=400).astype(np.uint8)
    parts = [rng.integers(0, 4, size=150_000).astype(np.uint8)]
    for _ in range(30):
        parts += [unit, rng.integers(0, 4, size=500).astype(np.uint8)]
    db = SeqDB.from_seqs(["chr1", "chr2"], [
        np.concatenate(parts), rng.integers(0, 4, 60_000).astype(np.uint8)])
    reads = []
    for i in range(160):
        kind = i % 8
        if kind == 0:             # from a copy of the unit: overflow seeds
            gpos = 150_000 + 900 * int(rng.integers(0, 30)) \
                + int(rng.integers(0, 400 - L))
            reads.append(plant_read(rng, db, length=L, gpos=gpos,
                                    n_snps=int(rng.integers(0, 6))))
        elif kind == 1:
            reads.append(plant_read(rng, db, length=L,
                                    ins=int(rng.integers(1, 6))))
        elif kind == 2:
            reads.append(plant_read(rng, db, length=L,
                                    dels=int(rng.integers(1, 6))))
        elif kind == 3:           # junk: unmapped, the second pass's rows
            r = plant_read(rng, db, length=L)
            r.codes = rng.integers(0, 4, L).astype(np.uint8)
            reads.append(r)
        else:
            reads.append(plant_read(rng, db, length=L,
                                    n_snps=int(rng.integers(0, 3))))
    pairs = [plant_pair(rng, db, length=L, frag=int(rng.integers(250, 600)),
                        n_snps=int(rng.integers(0, 3)),
                        snp_every=(15 if i % 4 == 0 else None))[:2]
             for i in range(64)]
    return db, reads, pairs, jbuild(db, None, backend="host"), \
        tbuild(db, None, backend="host")


@pytest.fixture(autouse=True)
def tier_on(monkeypatch):
    monkeypatch.setenv("URMAP_TIER_GATHER", "1")
    # the reference's accelerator gather, whose clamp the port copies
    # (fill lanes' records compare whole)
    monkeypatch.setattr(jgpk, "GATHER_MODE", "row")


def _codes(reads):
    codes = np.stack([r.codes for r in reads])
    return codes, np.full(len(reads), codes.shape[1], np.int32)


def _assert_same(want, got, tb=True):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)
    assert (want.tb is None) == (got.tb is None)
    if tb and want.tb is not None:
        for k in TB_KEYS:
            np.testing.assert_array_equal(want.tb[k], got.tb[k], err_msg=k)


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


def test_mapper_tier_matches_urmap_tpu(world, tmp_path, monkeypatch):
    db, reads, _pairs, jidx, tidx = world
    jm = jpipe.Mapper(jidx, MCFG)
    tm = tpipe.Mapper(tidx, MCFG, device="cpu")
    assert tm.csr_aligned and tm.gather_tier == jm.gather_tier
    assert tm.gather_tier in (4, 8) and tm.tb
    codes, lens = _codes(reads)
    tier_rounds.reset()
    lane_rotate.fetch_counter.reset()
    got = tm.map_codes(codes, lens)
    # three batches (64 + 64 + 32): a tier fetch each, then the rounds
    assert tier_rounds.calls == 3 and tier_rounds.rounds >= 3
    assert lane_rotate.fetch_counter.plain_calls == 3 + tier_rounds.rounds
    want = jm.map_codes(codes, lens)
    _assert_same(want, got)
    assert got.tb["rows"].size > 0 and got.gapped.any()
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, reads)
    sam_t = _sam(tm, tcigars, tsam_native, TFastqReader, db, fq)
    assert sam_t == _sam(jm, jcigars, jsam_native, JFastqReader, db, fq)
    assert sam_t.count(b"\n") == len(reads)
    # the port untiered: the same calls and bytes
    monkeypatch.delenv("URMAP_TIER_GATHER")
    plain = tpipe.Mapper(tidx, MCFG, device="cpu")
    assert plain.gather_tier is None
    _assert_same(got, plain.map_codes(codes, lens))
    assert _sam(plain, tcigars, tsam_native, TFastqReader, db, fq) == sam_t


def _pair_sam(fmt, cigars_fn, db, b1, b2, res, sc):
    def cig3(b, m):
        blob, off, nm, span = cigars_fn(db.codes, b.codes, m, sc,
                                        raw_lengths=b.seq_len,
                                        clip_rows=m.clipped)
        return (blob, off), nm, span

    return fmt.format_paired(b1, b2, res, *cig3(b1, res.m1),
                             *cig3(b2, res.m2), db)


def test_paired_tier_matches_urmap_tpu(world, tmp_path, monkeypatch):
    db, _reads, pairs, jidx, tidx = world
    jp = jpair.PairedMapper(jpipe.Mapper(jidx, MCFG))
    tp = tpair.PairedMapper(tpipe.Mapper(tidx, MCFG, device="cpu"))
    assert tp.mapper.gather_tier in (4, 8)
    f1, f2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    write_fastq(f1, [p[0] for p in pairs], prefix="p")
    write_fastq(f2, [p[1] for p in pairs], prefix="p")
    jb = list(JFastqReader(f1, f2, batch_size=32, max_read_len=L))
    tb = list(TFastqReader(f1, f2, batch_size=32, max_read_len=L))
    assert len(jb) == len(tb) == 2
    tier_rounds.reset()
    sam_j, sam_t, got_all = [], [], []
    for (j1, j2), (t1, t2) in zip(jb, tb):
        want = jp.map_pair_codes(j1.codes, j1.lengths, j2.codes, j2.lengths)
        got = tp.map_pair_codes(t1.codes, t1.lengths, t2.codes, t2.lengths)
        np.testing.assert_array_equal(want.proper, got.proper)
        _assert_same(want.m1, got.m1)
        _assert_same(want.m2, got.m2)
        sam_j.append(_pair_sam(jsam_native, jcigars, db, j1, j2, want,
                               jp.sc))
        sam_t.append(_pair_sam(tsam_native, tcigars, db, t1, t2, got,
                               tp.sc))
        got_all.append((t1, t2, got))
    assert tier_rounds.calls == 2
    assert sam_t == sam_j and b"".join(sam_t).count(b"\n") == 2 * len(pairs)
    assert np.concatenate([g.proper for *_, g in got_all]).mean() > 0.9
    # the port untiered: the same pairs
    monkeypatch.delenv("URMAP_TIER_GATHER")
    tq = tpair.PairedMapper(tpipe.Mapper(tidx, MCFG, device="cpu"))
    assert tq.mapper.gather_tier is None
    for t1, t2, got in got_all:
        res = tq.map_pair_codes(t1.codes, t1.lengths, t2.codes, t2.lengths)
        np.testing.assert_array_equal(res.proper, got.proper)
        _assert_same(res.m1, got.m1)
        _assert_same(res.m2, got.m2)


def test_second_pass_tier_matches_urmap_tpu(world):
    """A first pass at 2 positions a seed (no tier: it is not below P)
    and the wide second pass at 16 with the tier on, over the rows the
    first pass left unmapped or suspect."""
    db, reads, _pairs, jidx, tidx = world
    cfg = dataclasses.replace(MCFG, positions_per_seed=2, second_pass_p=16)
    tm = tpipe.Mapper(tidx, cfg, device="cpu")
    assert tm.gather_tier in (4, 8, None)
    assert tm.second._tables["gather_tier"] in (4, 8)
    codes, lens = _codes(reads)
    tier_rounds.reset()
    got = tm.map_codes(codes, lens)
    assert tier_rounds.calls >= 1     # the second pass ran tiered
    _assert_same(jpipe.Mapper(jidx, cfg).map_codes(codes, lens), got)
    wide = tpipe.Mapper(tidx, dataclasses.replace(cfg, second_pass_p=0,
                                                  positions_per_seed=16),
                        device="cpu").map_codes(codes, lens)
    assert (got.mapped == (got.mapped | wide.mapped)).all()
