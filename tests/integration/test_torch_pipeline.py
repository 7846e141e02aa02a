"""The port's Mapper on the CPU against urmap_tpu.map.Mapper.

Both packages map the same planted corpora — exact, SNP, indel,
reverse-complement, junk, adapter-tailed and short reads — over several
batches with a partial last one, with the device traceback off
(tb_bits=False) on both sides. MapResult must be equal field by field
and the SAM bytes (FastqReader → Mapper → run_stream → cigars_nm_blob →
format_single_end) identical.
"""

import numpy as np
import pytest

from tests.utils import make_seqdb, plant_read, write_fastq
from urmap_tpu.config import IndexConfig, MapConfig
from urmap_tpu.index.build import build_index as jbuild
from urmap_tpu.index.store import prepare_tables as jprepare
from urmap_tpu.io import sam_native
from urmap_tpu.io.fastq import FastqReader
from urmap_tpu.map.cigar import cigars_nm_blob as jcigars
from urmap_tpu.map.pipeline import Mapper as JMapper
from urmap_tpu.utils.stream import run_stream
from urmap_tpu_torch.index import build_index as tbuild
from urmap_tpu_torch.map import Mapper as TMapper
from urmap_tpu_torch.map.cigar import cigars_nm_blob as tcigars

FIELDS = ("mapped", "pos", "strand", "score", "second", "mapq", "gapped",
          "ungapped", "clipped", "suspect", "lengths")
MCFG = MapConfig(batch_size=128, tb_bits=False)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(21)
    db = make_seqdb(rng, [150_000, 50_000])
    reads = []
    for i in range(300):
        kind = i % 10
        if kind == 0:
            r = plant_read(rng, db, strand=0)
        elif kind == 1:
            r = plant_read(rng, db, strand=1)
        elif kind in (2, 3):
            r = plant_read(rng, db, n_snps=int(rng.integers(1, 8)))
        elif kind == 4:
            r = plant_read(rng, db, ins=int(rng.integers(1, 9)), n_snps=1)
        elif kind == 5:
            r = plant_read(rng, db, dels=int(rng.integers(1, 9)))
        elif kind == 6:           # adapter tail: the clip-rescue lane
            r = plant_read(rng, db, length=150 - 65, strand=0)
            r.codes = np.concatenate(
                [r.codes, rng.integers(0, 4, 65).astype(np.uint8)])
        elif kind == 7:           # junk
            r = plant_read(rng, db)
            r.codes = rng.integers(0, 4, 150).astype(np.uint8)
        elif kind == 8:           # short reads, one below k
            r = plant_read(rng, db, length=int(rng.choice([20, 60, 100])))
        else:                     # N bases in the read
            r = plant_read(rng, db, n_snps=2)
            r.codes[rng.integers(0, 150, 3)] = 5
        reads.append(r)
    return db, reads


def _codes(reads, L=160):
    codes = np.full((len(reads), L), 5, np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r.codes)] = r.codes
        lengths[i] = len(r.codes)
    return codes, lengths


def _assert_same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def _sam(mapper, cigars_fn, db, fq):
    """The single-end SAM path, driven by run_stream."""
    out = []

    def start(b):
        return mapper.start_batch(b.codes, b.lengths)

    def sync(b, h):
        return mapper.finish_batch(h, b.lengths)

    def fmt(b, res):
        blob, off, nm, _ = cigars_fn(db.codes, b.codes, res, mapper.sc,
                                     raw_lengths=b.seq_len,
                                     clip_rows=res.clipped)
        return sam_native.format_single_end(b, res, (blob, off), nm, db)

    run_stream(FastqReader(fq, batch_size=MCFG.batch_size), start, sync, fmt,
               out.append, inflight=1, workers=2)
    return b"".join(out)


@pytest.mark.parametrize("slot_bits", [None, 15])   # aligned, classic
def test_mapper_matches_urmap_tpu(corpus, tmp_path, slot_bits):
    db, reads = corpus
    cfg = None if slot_bits is None else IndexConfig(slot_bits=slot_bits)
    jidx = jbuild(db, cfg, backend="host")
    tidx = tbuild(db, cfg, backend="host")
    layout = jprepare(jidx, MCFG.positions_per_seed)[1]["layout"]
    assert layout == ("aligned" if slot_bits is None else "classic")
    jm = JMapper(jidx, MCFG)
    tm = TMapper(tidx, MCFG, device="cpu")
    codes, lengths = _codes(reads)
    want = jm.map_codes(codes, lengths)
    got = tm.map_codes(codes, lengths)
    _assert_same(want, got)
    assert want.mapped[[i for i in range(300) if i % 10 == 7]].sum() == 0
    assert got.clipped.any() and got.gapped.any() and got.mapped.mean() > 0.8
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, reads)
    sam_j = _sam(jm, jcigars, db, fq)
    sam_t = _sam(tm, tcigars, db, fq)
    assert sam_j.count(b"\n") == len(reads)
    assert sam_t == sam_j


def test_mapper_on_urmap_tpu_tables(corpus):
    """tables_from_numpy: the port maps on urmap_tpu's prepared tables;
    a 150-base block leaves lanes of the last word past L."""
    db, reads = corpus
    mcfg = MapConfig(batch_size=128, max_read_len=150, tb_bits=False)
    jidx = jbuild(db, None, backend="host")
    tm = TMapper(jidx, mcfg, device="cpu",
                 prepared=jprepare(jidx, mcfg.positions_per_seed))
    codes, lengths = _codes(reads[:128], L=150)
    _assert_same(JMapper(jidx, mcfg).map_codes(codes, lengths),
                 tm.map_codes(codes, lengths))


def test_mapper_refuses_what_is_not_ported(corpus, monkeypatch):
    db, _ = corpus
    idx = tbuild(db, None, backend="host")
    # the default configuration (device traceback on) is ported
    assert TMapper(idx, MapConfig(batch_size=128), device="cpu").tb
    # so is the tiered gather: the aligned table carries a tier, which
    # URMAP_TIER_GATHER=1 puts into effect (its parity with urmap_tpu:
    # test_torch_tier_pipeline.py)
    prepared = jprepare(jbuild(db, None, backend="host"), 16)
    prepared[1]["gather_tier"] = 4
    assert TMapper(idx, MCFG, device="cpu",
                   prepared=prepared).gather_tier is None
    monkeypatch.setenv("URMAP_TIER_GATHER", "1")
    assert TMapper(idx, MCFG, device="cpu",
                   prepared=prepared).gather_tier == 4
    monkeypatch.delenv("URMAP_TIER_GATHER")
    # the row128 layout is ported: the Mapper takes it
    monkeypatch.setenv("URMAP_ROW128_BYTES", "1")
    m128 = TMapper(idx, MCFG, device="cpu")
    assert m128.row128 and m128.off_bits is not None
