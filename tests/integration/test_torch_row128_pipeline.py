"""The port's Mapper over a row128 table on the CPU against urmap_tpu's.

``URMAP_ROW128_BYTES=1`` (the reference's own override) forces the
dense-row layout on a small index. With the default MapConfig (device
traceback on) the port must equal urmap_tpu.map.Mapper in MapResult, tb
dict, cigars_nm_blob output and SAM bytes, with the packed offsets on
and off; equal itself on the aligned layout; and give the same result on
tables prepared by either package. Integers and bytes: tolerance 0.
"""

import numpy as np
import pytest

from tests.utils import make_seqdb, plant_read, write_fastq
from urmap_tpu.config import MapConfig
from urmap_tpu.index.build import build_index as jbuild
from urmap_tpu.index.store import prepare_tables as jprepare
from urmap_tpu.io import sam_native
from urmap_tpu.io.fastq import FastqReader
from urmap_tpu.map.cigar import cigars_nm_blob as jcigars
from urmap_tpu.map.pipeline import Mapper as JMapper
from urmap_tpu.utils.stream import run_stream
from urmap_tpu_torch.index import build_index as tbuild
from urmap_tpu_torch.index.store import prepare_tables as tprepare
from urmap_tpu_torch.map import Mapper as TMapper
from urmap_tpu_torch.map.cigar import cigars_nm_blob as tcigars

FIELDS = ("mapped", "pos", "strand", "score", "second", "mapq", "gapped",
          "ungapped", "clipped", "suspect", "lengths")
TB_KEYS = ("rows", "score", "pos", "strand", "cols", "dops", "hw", "L")
MCFG = MapConfig(batch_size=128)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(31)
    db = make_seqdb(rng, [150_000, 50_000])
    reads = []
    for i in range(200):
        kind = i % 8
        if kind in (0, 1):
            r = plant_read(rng, db, strand=kind)
        elif kind == 2:
            r = plant_read(rng, db, n_snps=int(rng.integers(1, 8)))
        elif kind == 3:
            r = plant_read(rng, db, ins=int(rng.integers(1, 9)), n_snps=1)
        elif kind == 4:
            r = plant_read(rng, db, dels=int(rng.integers(1, 9)))
        elif kind == 5:           # adapter tail: the clip-rescue lane
            r = plant_read(rng, db, length=150 - 65, strand=0)
            r.codes = np.concatenate(
                [r.codes, rng.integers(0, 4, 65).astype(np.uint8)])
        elif kind == 6:           # junk
            r = plant_read(rng, db)
            r.codes = rng.integers(0, 4, 150).astype(np.uint8)
        else:                     # short reads, one below k
            r = plant_read(rng, db, length=int(rng.choice([20, 60, 100])))
        reads.append(r)
    codes = np.full((len(reads), 160), 5, np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r.codes)] = r.codes
        lengths[i] = len(r.codes)
    return db, reads, codes, lengths, jbuild(db, None, backend="host"), \
        tbuild(db, None, backend="host")


def _assert_same(want, got, live_only=False):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)
    assert set(want.tb) == set(got.tb) == set(TB_KEYS)
    for k in TB_KEYS:
        a, b = want.tb[k], got.tb[k]
        if k == "dops" and live_only:
            # fill lanes hold never-read records of a window past the
            # table's end, where the layouts' fetches clamp differently
            a, b = a[:, want.tb["cols"]], b[:, got.tb["cols"]]
        np.testing.assert_array_equal(a, b, err_msg=k)


def _sam(mapper, cigars_fn, db, fq):
    out = []

    def fmt(b, res):
        blob, off, nm, _ = cigars_fn(db.codes, b.codes, res, mapper.sc,
                                     raw_lengths=b.seq_len,
                                     clip_rows=res.clipped)
        return sam_native.format_single_end(b, res, (blob, off), nm, db)

    run_stream(FastqReader(fq, batch_size=MCFG.batch_size),
               lambda b: mapper.start_batch(b.codes, b.lengths),
               lambda b, h: mapper.finish_batch(h, b.lengths), fmt,
               out.append, inflight=1, workers=2)
    return b"".join(out)


@pytest.mark.parametrize("packed", [True, False])
def test_row128_mapper_matches_urmap_tpu(corpus, tmp_path, monkeypatch,
                                         packed):
    db, reads, codes, lengths, jidx, tidx = corpus
    monkeypatch.setenv("URMAP_ROW128_BYTES", "1")
    if not packed:
        monkeypatch.setenv("URMAP_NO_PACKED_OFFSETS", "1")
    jm = JMapper(jidx, MCFG)
    tm = TMapper(tidx, MCFG, device="cpu")
    assert jm.row128 and tm.row128 and tm.tb
    assert (jm.off_bits is not None) == packed
    assert tm.off_bits == jm.off_bits
    assert tm.tables["positions"].dim() == 2 \
        and tm.tables["ginter"].dim() == 2
    want = jm.map_codes(codes, lengths)
    got = tm.map_codes(codes, lengths)
    _assert_same(want, got)
    assert got.clipped.any() and got.gapped.any() and got.mapped.mean() > 0.7
    assert got.tb["rows"].size > 0
    with_j = jcigars(db.codes, codes, want, jm.sc, clip_rows=want.clipped)
    with_t = tcigars(db.codes, codes, got, tm.sc, clip_rows=got.clipped)
    for x, y in zip(with_j, with_t):
        if isinstance(x, bytes):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)
    if packed:
        fq = str(tmp_path / "r.fq")
        write_fastq(fq, reads)
        sam_t = _sam(tm, tcigars, db, fq)
        assert sam_t.count(b"\n") == len(reads)
        assert sam_t == _sam(jm, jcigars, db, fq)


def test_row128_equals_aligned_layout(corpus, tmp_path, monkeypatch):
    """The port against itself: the layout changes no result field, no
    live traceback record and no SAM byte."""
    db, reads, codes, lengths, _jidx, tidx = corpus
    base = TMapper(tidx, MCFG, device="cpu")
    assert not base.row128 and base.csr_aligned and base.off_bits is None
    monkeypatch.setenv("URMAP_ROW128_BYTES", "1")
    m128 = TMapper(tidx, MCFG, device="cpu")
    assert m128.row128 and not m128.csr_aligned
    want = base.map_codes(codes, lengths)
    got = m128.map_codes(codes, lengths)
    _assert_same(want, got, live_only=True)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, reads)
    assert _sam(base, tcigars, db, fq) == _sam(m128, tcigars, db, fq)


def test_row128_tables_from_either_package(corpus, monkeypatch):
    """tables_from_numpy: row128 tables prepared by the reference's
    prepare_tables and by the port's map alike."""
    _db, _reads, codes, lengths, jidx, tidx = corpus
    monkeypatch.setenv("URMAP_ROW128_BYTES", "1")
    p = MCFG.positions_per_seed
    jprep, tprep = jprepare(jidx, p), tprepare(tidx, p)
    assert jprep[1]["layout"] == tprep[1]["layout"] == "row128"
    assert jprep[0]["opacked"] is not None
    on_j = TMapper(tidx, MCFG, device="cpu", prepared=jprep)
    on_t = TMapper(tidx, MCFG, device="cpu", prepared=tprep)
    assert on_j.row128 and on_j.off_bits == on_t.off_bits != None  # noqa: E711
    _assert_same(on_j.map_codes(codes[:128], lengths[:128]),
                 on_t.map_codes(codes[:128], lengths[:128]))
