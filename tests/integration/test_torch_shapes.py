"""Shapes past the default that the card now takes, on the CPU against
urmap_tpu.

The port's Mapper and PairedMapper (device "cpu", the plain versions)
against the reference's at band half-widths 12 and 24 with the device
traceback on, at max_read_len 704 with reads above 624 bases, and at
Q x P = 256 candidates a read: MapResult (with the traceback dicts) and
the SAM bytes identical. Then ``card_limits``, the pure function the
Mapper asks before it loads any table on a CUDA device: it refuses
exactly the configs past a kernel's stated limit and names that limit.
"""

import dataclasses

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one torch thread)
from tests.utils import make_seqdb, plant_pair, plant_read, write_fastq
from urmap_tpu.config import IndexConfig, MapConfig
from urmap_tpu.index.build import build_index as jbuild
from urmap_tpu.io import sam_native as jsam_native
from urmap_tpu.io.fastq import FastqReader as JFastqReader
from urmap_tpu.map import pair as jpair
from urmap_tpu.map import pipeline as jpipe
from urmap_tpu.map.cigar import cigars_nm_blob as jcigars
from urmap_tpu_torch.index import build_index as tbuild
from urmap_tpu_torch.io import sam_native as tsam_native
from urmap_tpu_torch.io.fastq import FastqReader as TFastqReader
from urmap_tpu_torch.kernels import banded_dp, tb_dp, vote
from urmap_tpu_torch.map import pair as tpair
from urmap_tpu_torch.map import pipeline as tpipe
from urmap_tpu_torch.map.cigar import cigars_nm_blob as tcigars

FIELDS = ("mapped", "pos", "strand", "score", "second", "mapq", "gapped",
          "ungapped", "clipped", "suspect", "lengths")
ICFG = IndexConfig(slot_bits=16)
# (name, MapConfig): hw 12 and 24 with the traceback on, long reads, and
# 8 seeds x 32 positions = 256 candidates a read
SHAPES = {
    "hw12": MapConfig(batch_size=64, band_halfwidth=12),
    "hw24_long": MapConfig(batch_size=64, band_halfwidth=24,
                           max_read_len=704, rescue_window=1800),
    "qp256": MapConfig(batch_size=64, positions_per_seed=32),
}


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    db = make_seqdb(rng, [250_000])
    return (rng, db, jbuild(db, ICFG, backend="host"),
            tbuild(db, ICFG, backend="host"))


def _reads(rng, db, mcfg, n=72):
    """Planted reads: indels up to the band's reach, SNPs, junk, and on
    a 704-base block reads of 630-700 bases beside 150-base ones."""
    hw, Lm = mcfg.band_halfwidth, mcfg.max_read_len
    reads = []
    for i in range(n):
        length = int(rng.integers(630, Lm + 1)) if Lm > 624 and i % 3 == 0 \
            else 150
        kind = i % 6
        if kind == 1:
            r = plant_read(rng, db, length=length, ins=min(hw - 2, 11),
                           n_snps=1)
        elif kind == 2:
            r = plant_read(rng, db, length=length, dels=min(hw - 2, 11))
        elif kind == 3:
            r = plant_read(rng, db, length=length,
                           n_snps=int(rng.integers(2, 8)))
        elif kind == 4:           # junk
            r = plant_read(rng, db, length=length)
            r.codes = rng.integers(0, 4, length).astype(np.uint8)
        else:
            r = plant_read(rng, db, length=length)
        reads.append(r)
    return reads


def _sam(mapper, cigars_fn, reader, db):
    out = []
    for b in reader:
        res = mapper.finish_batch(mapper.start_batch(b.codes, b.lengths),
                                  b.lengths)
        blob, off, nm, _ = cigars_fn(db.codes, b.codes, res, mapper.sc,
                                     raw_lengths=b.seq_len,
                                     clip_rows=res.clipped)
        fmt = tsam_native if cigars_fn is tcigars else jsam_native
        out.append(fmt.format_single_end(b, res, (blob, off), nm, db))
    return b"".join(out)


def _same_tb(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        for k in a:
            x, y = a[k], b[k]
            if k == "dops":       # live lanes: fill lanes are never read
                x, y = x[:, a["cols"]], y[:, b["cols"]]
            np.testing.assert_array_equal(x, y, err_msg=f"tb.{k}")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_mapper_matches_urmap_tpu_at_shape(world, tmp_path, shape):
    rng, db, jidx, tidx = world
    mcfg = SHAPES[shape]
    assert tpipe.card_limits(mcfg) == []
    jm = jpipe.Mapper(jidx, mcfg)
    tm = tpipe.Mapper(tidx, mcfg, device="cpu")
    assert jm.tb and tm.tb
    reads = _reads(np.random.default_rng(len(shape)), db, mcfg)
    Lm = mcfg.max_read_len
    codes = np.full((len(reads), Lm), 5, np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r.codes)] = r.codes
        lens[i] = len(r.codes)
    want = jm.map_codes(codes, lens)
    got = tm.map_codes(codes, lens)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)
    _same_tb(want.tb, got.tb)
    planted = np.arange(len(reads)) % 6 != 4
    ok = got.mapped & (got.pos == [r.gpos for r in reads])
    assert ok[planted].mean() > 0.9 and got.tb["rows"].size > 0
    if Lm > 624:
        assert (lens > 624).sum() >= 20 and ok[lens > 624].mean() > 0.9
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, reads)
    sam_j = _sam(jm, jcigars, JFastqReader(fq, batch_size=64,
                                           max_read_len=Lm), db)
    sam_t = _sam(tm, tcigars, TFastqReader(fq, batch_size=64,
                                           max_read_len=Lm), db)
    assert sam_t == sam_j and sam_t.count(b"\n") == len(reads)


@pytest.mark.parametrize("shape", ["hw12", "hw24_long"])
def test_paired_mapper_matches_urmap_tpu_at_shape(world, shape):
    rng, db, jidx, tidx = world
    mcfg = dataclasses.replace(SHAPES[shape], batch_size=32)
    prng = np.random.default_rng(3 + len(shape))
    pairs = [plant_pair(prng, db, length=150,
                        frag=int(prng.integers(250, 600)),
                        n_snps=int(prng.integers(0, 3)),
                        snp_every=15 if i % 5 == 0 else None)
             for i in range(40)]
    pairs = [(p[0], p[1]) for p in pairs]
    c1 = np.stack([p[0].codes for p in pairs])
    c2 = np.stack([p[1].codes for p in pairs])
    ln = np.full(len(pairs), 150, np.int32)
    jp = jpair.PairedMapper(jpipe.Mapper(jidx, mcfg))
    tp = tpair.PairedMapper(tpipe.Mapper(tidx, mcfg, device="cpu"))
    want = jp.map_pair_codes(c1, ln, c2, ln)
    got = tp.map_pair_codes(c1, ln, c2, ln)
    np.testing.assert_array_equal(want.proper, got.proper)
    for m in ("m1", "m2"):
        a, b = getattr(want, m), getattr(got, m)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{m}.{f}")
        _same_tb(a.tb, b.tb)
    assert got.proper.mean() > 0.9
    # the paired SAM bytes of the first batch, through both packages'
    # readers and formatters
    import tempfile

    from tests.integration.test_torch_paired import _native_sam as native_sam

    with tempfile.TemporaryDirectory() as d:
        f1, f2 = f"{d}/r1.fq", f"{d}/r2.fq"
        write_fastq(f1, [p[0] for p in pairs], prefix="p")
        write_fastq(f2, [p[1] for p in pairs], prefix="p")
        j1, j2 = next(iter(JFastqReader(f1, f2, batch_size=16,
                                        max_read_len=150)))
        t1, t2 = next(iter(TFastqReader(f1, f2, batch_size=16,
                                        max_read_len=150)))
    jr = jp.finish_batch(jp.start_batch(j1.codes, j1.lengths, j2.codes,
                                        j2.lengths), j1.lengths, j2.lengths)
    tr = tp.finish_batch(tp.start_batch(t1.codes, t1.lengths, t2.codes,
                                        t2.lengths), t1.lengths, t2.lengths)
    assert native_sam(tsam_native, tcigars, db, t1, t2, tr, tp.sc) == \
        native_sam(jsam_native, jcigars, db, j1, j2, jr, jp.sc)


@pytest.mark.parametrize("field,ok,bad,limit", [
    ("band_halfwidth", 271, 272, "kernel B1 (banded_dp) takes 1 to 271"),
    ("positions_per_seed", 512, 513,
     "kernel B4 (vote) takes at most 4096 candidates a read"),
])
def test_card_limits_refuse_past_the_limit(field, ok, bad, limit):
    def cfg(v):
        extra = {"rescue_window": 4000} if field == "band_halfwidth" else {}
        return MapConfig(**{field: v}, **extra)

    assert tpipe.card_limits(cfg(ok)) == []
    got = tpipe.card_limits(cfg(bad))
    assert len(got) == 1 and limit in got[0], got


@pytest.mark.parametrize("hw", [8, 16, 24, 31])
def test_card_limits_long_reads(hw):
    """The read block: B6 (the traceback, on by default) stops first, at
    the bytes one winner's shared memory holds; without the traceback the
    seed front and B1 are the limits."""
    lim = tb_dp.max_read_len(hw)
    assert 5_000 < lim < banded_dp.max_read_len(hw)
    mk = dict(band_halfwidth=hw, rescue_window=40_000)
    assert tpipe.card_limits(MapConfig(max_read_len=lim, **mk)) == []
    got = tpipe.card_limits(MapConfig(max_read_len=lim + 1, **mk))
    assert len(got) == 1 and f"kernel B6 (tb_dops) holds at most {lim} " \
        f"bases at band_halfwidth {hw}" in got[0], got
    assert tpipe.card_limits(MapConfig(max_read_len=lim + 1, tb_bits=False,
                                       **mk)) == []
    lim1 = banded_dp.max_read_len(hw)
    got = tpipe.card_limits(MapConfig(max_read_len=lim1 + 1, tb_bits=False,
                                      band_halfwidth=hw,
                                      rescue_window=2 * lim1))
    assert any(f"kernel B1 (banded_dp) holds at most {lim1} bases" in g
               for g in got), got
    # B6's bytes: the codes (8 rows a word per band cell of the variant),
    # the records, the window and read bytes, one winner in 227 KB
    assert tb_dp.smem_bytes(lim, hw) <= 227 * 1024 \
        < tb_dp.smem_bytes(lim + 1, hw)


def test_card_limits_hold_the_defaults_and_refuse_before_tables(world):
    """The default config is inside every limit. Past one, the refusal
    (pipeline.refuse_beyond_card, which Mapper.__init__ calls before the
    tables load, and so for the Mapper a PairedMapper wraps) raises for
    a CUDA device and names the limit; a CPU Mapper takes the shape."""
    import torch

    _rng, _db, _jidx, tidx = world
    assert tpipe.card_limits(MapConfig()) == []
    assert vote.MAX_M >= 8 * 256            # Q x the index's slot cap
    wide = MapConfig(batch_size=64, positions_per_seed=1024)
    with pytest.raises(ValueError, match=r"kernel B4 \(vote\) takes at most "
                                         "4096"):
        tpipe.refuse_beyond_card(wide, torch.device("cuda"))
    tpipe.refuse_beyond_card(wide, torch.device("cpu"))
    assert tpipe.Mapper(tidx, wide, device="cpu").mcfg is wide
