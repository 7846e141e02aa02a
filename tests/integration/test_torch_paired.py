"""Paired-end mapping of the port on the CPU against urmap_tpu's.

``_pair_cross``, ``_rescue_scan`` and ``map_pairs_device`` on the same
numpy inputs as the JAX functions; ``PairedMapper`` against the
reference's in PairResult (every field of both mates, ``proper``, both
traceback dicts), in the pure-Python records and in the native paired
SAM bytes, on the aligned and the row128 layout; a three-batch merge;
the host re-check of pairs. Integers and bytes: tolerance 0.

The pairs (tests/utils.py plant_pair): proper FR pairs, pairs whose
second mate is mutated every 15th base (unseedable: the rescue scan
places it), pairs with a junk mate, and pairs with a small deletion.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.utils import make_seqdb, plant_pair, write_fastq
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
from urmap_tpu_torch.map import pair as tpair
from urmap_tpu_torch.map import pipeline as tpipe
from urmap_tpu_torch.map.cigar import cigars_nm_blob as tcigars

ICFG = IndexConfig(slot_bits=16)
L = 120
# pair batch 32; rescue_capacity_frac 16 leaves Dr = 2 rescue lanes, so
# the rescue loop takes several rounds
MCFG = MapConfig(max_read_len=L, batch_size=64, rescue_capacity_frac=16)
FIELDS = ("mapped", "pos", "strand", "score", "second", "mapq", "gapped",
          "ungapped", "clipped", "suspect", "lengths")
TB_KEYS = ("rows", "score", "pos", "strand", "cols", "dops", "hw", "L")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(5)
    db = make_seqdb(rng, [300_000])
    pairs = []
    for i in range(80):
        r1, r2, _ = plant_pair(rng, db, length=L,
                               frag=int(rng.integers(250, 600)),
                               n_snps=int(rng.integers(0, 3)),
                               snp_every=(15 if i % 4 == 0 else None))
        if i % 16 == 5:           # a junk mate: stays unmapped
            r2.codes = rng.integers(0, 4, L).astype(np.uint8)
        if i % 8 == 3:            # a 3-base deletion in mate 1
            g = db.codes[r1.gpos : r1.gpos + L + 3]
            c = np.concatenate([g[:60], g[63:]])
            if r1.strand:
                c = (3 - c)[::-1]
            r1.codes = c.astype(np.uint8)
        pairs.append((r1, r2))
    c1 = np.stack([p[0].codes for p in pairs])
    c2 = np.stack([p[1].codes for p in pairs])
    ln = np.full(len(pairs), L, np.int32)
    return db, pairs, c1, c2, ln, jbuild(db, ICFG, backend="host"), \
        tbuild(db, ICFG, backend="host")


def _mappers(world, mcfg=MCFG):
    jidx, tidx = world[5], world[6]
    jm = jpipe.Mapper(jidx, mcfg)
    tm = tpipe.Mapper(tidx, mcfg, device="cpu")
    assert jm.row128 == tm.row128 and jm.off_bits == tm.off_bits
    return jm, tm


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_revcomp_batch_matches(rng):
    reads = rng.integers(0, 4, (50, 37)).astype(np.uint8)
    reads[rng.random(reads.shape) < 0.05] = 5
    lens = rng.integers(0, 38, 50).astype(np.int32)
    lens[:3] = [0, 1, 37]
    reads[np.arange(37)[None, :] >= lens[:, None]] = 5
    np.testing.assert_array_equal(
        np.asarray(jpipe.revcomp_batch(_j(reads), _j(lens))),
        tpipe.revcomp_batch(_t(reads), _t(lens)).numpy())


@pytest.mark.parametrize("span", [True, False])
def test_pair_cross_matches(rng, span):
    """Synthetic candidates with tied pair scores (the first maximum
    must win), invalid lanes, both orientations, positions near the top
    of the biased range."""
    B, C = 96, 16
    pos = rng.integers(0, 3000, (2, B, C)).astype(np.int32)
    pos[1] = pos[0] + rng.integers(-200, 900, (B, C))
    pos[:, :8] += np.int32((1 << 31) - 5000)        # near INT32_MAX
    score = rng.integers(60, 121, (2, B, C)).astype(np.int32)
    score[:, 8:40] = 100                             # ties everywhere
    strand = rng.integers(0, 2, (2, B, C)).astype(np.int32)
    valid = rng.random((2, B, C)) < 0.7
    valid[:, 40:44] = False
    sp = rng.integers(L - 6, L + 7, (2, B, C)).astype(np.int32)
    ln = rng.integers(100, L + 1, (2, B)).astype(np.int32)

    def cdict(i, conv):
        d = {"pos": conv(pos[i]), "score": conv(score[i]),
             "strand": conv(strand[i]), "valid": conv(valid[i])}
        if span:
            d["span"] = conv(sp[i])
        return d

    want = jpair._pair_cross(cdict(0, _j), cdict(1, _j), _j(ln[0]),
                             _j(ln[1]), MCFG)
    got = tpair._pair_cross(cdict(0, _t), cdict(1, _t), _t(ln[0]),
                            _t(ln[1]), MCFG)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(),
                                      err_msg=k)
    assert got["has"].any() and not got["has"].all()


def test_rescue_scan_matches(world, rng):
    db, pairs, c1, c2, ln, _ji, _ti = world
    jm, tm = _mappers(world)
    n = 24
    r1 = [p[0] for p in pairs[:n]]
    apos = np.array([r.gpos for r in r1], np.int64)
    apos[:3] = [5, 299_000, 150]                     # both genome ends
    apos = (apos - jpipe.POS_BIAS).astype(np.int32)
    astrand = np.array([r.strand for r in r1], np.int32)
    other = c2[:n].copy()
    rc = np.asarray(jpipe.revcomp_batch(_j(other), _j(ln[:n])))
    other = np.where((astrand == 0)[:, None], rc, other)
    args = (apos, astrand, ln[:n], other, ln[:n])
    want = jpair._rescue_scan(jm.tables, *(_j(a) for a in args), mc=MCFG,
                              sc=jm.sc)
    got = tpair._rescue_scan(tm.tables, *(_t(a) for a in args), mc=MCFG,
                             sc=tm.sc)
    for k in ("pos", "score", "ungapped"):
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(),
                                      err_msg=k)
    placed = got["pos"].numpy().astype(np.int64) + jpipe.POS_BIAS
    truth = np.array([p[1].gpos for p in pairs[:n]])
    assert (placed[3:] == truth[3:]).mean() > 0.8


@pytest.mark.parametrize("row128", [False, True])
def test_map_pairs_device_matches(world, monkeypatch, row128):
    """Every field of both mates, proper and the traceback matrix. Row 0
    is an anchor (its mate needs the rescue) and there are more anchors
    than rescue lanes, so fill lanes alias a live row."""
    db, pairs, c1, c2, ln, _ji, _ti = world
    if row128:
        monkeypatch.setenv("URMAP_ROW128_BYTES", "1")
    jm, tm = _mappers(world)
    assert jm.row128 == row128
    Bp = 32
    a = (c1[:Bp], ln[:Bp], c2[:Bp], ln[:Bp])
    jfn = jax.jit(functools.partial(
        jpair.map_pairs_device, icfg=jm.icfg, mcfg=MCFG, sc=jm.sc,
        csr_aligned=jm.csr_aligned, gather_tier=jm.gather_tier,
        row128=jm.row128, off_bits=jm.off_bits, tb=True))
    want = jfn(jm.tables, *(_j(x) for x in a))
    stats = {}
    got = tpair.map_pairs_device(tm.tables, *(_t(x) for x in a),
                                 icfg=tm.icfg, mcfg=MCFG, sc=tm.sc, tb=True,
                                 stats=stats)
    assert stats["rescue_rounds"] >= 2 and Bp // MCFG.rescue_capacity_frac == 2
    for m in ("m1", "m2"):
        assert set(want[m]) == set(got[m])
        for k in want[m]:
            np.testing.assert_array_equal(np.asarray(want[m][k]),
                                          got[m][k].numpy(), err_msg=m + k)
    np.testing.assert_array_equal(np.asarray(want["proper"]),
                                  got["proper"].numpy())
    wtb, gtb = np.asarray(want["_tb"]), got["_tb"].numpy()
    do = ((wtb[1] >> 16) & 1).astype(bool)
    assert do.any()
    # row index, flags and anchor whole; score and records of the live
    # lanes (a fill lane's window lies past the table's end, where the
    # reference's CPU gather clamps otherwise: never-read values)
    np.testing.assert_array_equal(wtb[[0, 1, 3]], gtb[[0, 1, 3]])
    np.testing.assert_array_equal(wtb[:, do], gtb[:, do])
    if row128:
        np.testing.assert_array_equal(wtb, gtb)
    # row 0: mate 2 unseedable, rescued off mate 1's anchor
    m2 = got["m2"]
    assert bool(m2["mapped"][0]) and bool(got["proper"][0])
    assert int(m2["pos"][0]) + jpipe.POS_BIAS == pairs[0][1].gpos


def _assert_same_pair(want, got, live_only=True):
    np.testing.assert_array_equal(want.proper, got.proper)
    assert want.proper.dtype == got.proper.dtype
    for m in ("m1", "m2"):
        a, b = getattr(want, m), getattr(got, m)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{m}.{f}")
        assert (a.tb is None) == (b.tb is None)
        if a.tb is None:
            continue
        assert set(a.tb) == set(b.tb) == set(TB_KEYS)
        for k in TB_KEYS:
            x, y = a.tb[k], b.tb[k]
            if k == "dops" and live_only:
                x, y = x[:, a.tb["cols"]], y[:, b.tb["cols"]]
            np.testing.assert_array_equal(x, y, err_msg=f"{m}.tb.{k}")


def _native_sam(fmt, cigars_fn, db, b1, b2, res, sc):
    def cig3(r):
        blob, off, nm, span = r
        return (blob, off), nm, span

    c1, e1, s1 = cig3(cigars_fn(db.codes, b1.codes, res.m1, sc,
                                raw_lengths=b1.seq_len,
                                clip_rows=res.m1.clipped))
    c2, e2, s2 = cig3(cigars_fn(db.codes, b2.codes, res.m2, sc,
                                raw_lengths=b2.seq_len,
                                clip_rows=res.m2.clipped))
    return fmt.format_paired(b1, b2, res, c1, e1, s1, c2, e2, s2, db)


@pytest.mark.parametrize("layout", ["aligned", "row128", "tb_off"])
def test_paired_mapper_matches_urmap_tpu(world, tmp_path, monkeypatch,
                                         layout):
    db, pairs, c1, c2, ln, _ji, _ti = world
    if layout == "row128":
        monkeypatch.setenv("URMAP_ROW128_BYTES", "1")
    mcfg = dataclasses.replace(MCFG, tb_bits=layout != "tb_off")
    jm, tm = _mappers(world, mcfg)
    assert tm.row128 == (layout == "row128")
    jp, tp = jpair.PairedMapper(jm), tpair.PairedMapper(tm)
    assert tp.pair_batch == jp.pair_batch == 32 and tp.tb == jp.tb
    f1, f2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    write_fastq(f1, [p[0] for p in pairs], prefix="p")
    write_fastq(f2, [p[1] for p in pairs], prefix="p")
    jb = list(JFastqReader(f1, f2, batch_size=32, max_read_len=L))
    tb = list(TFastqReader(f1, f2, batch_size=32, max_read_len=L))
    assert len(jb) == len(tb) == 3                  # 32 + 32 + 16 pairs
    sam_j, sam_t = [], []
    for (j1, j2), (t1, t2) in zip(jb, tb):
        want = jp.finish_batch(
            jp.start_batch(j1.codes, j1.lengths, j2.codes, j2.lengths),
            j1.lengths, j2.lengths)
        got = tp.finish_batch(
            tp.start_batch(t1.codes, t1.lengths, t2.codes, t2.lengths,
                           prepacked=tp.prepack(t1.codes, t1.lengths,
                                                t2.codes, t2.lengths)),
            t1.lengths, t2.lengths)
        assert tp.second_pass(t1.codes, t1.lengths, t2.codes, t2.lengths,
                              got) is got
        _assert_same_pair(want, got)
        assert (got.m1.tb is not None) == mcfg.tb_bits
        assert jp.format_py(j1, j2, want) == tp.format_py(t1, t2, got)
        sam_j.append(_native_sam(jsam_native, jcigars, db, j1, j2, want,
                                 jm.sc))
        sam_t.append(_native_sam(tsam_native, tcigars, db, t1, t2, got,
                                 tm.sc))
    assert sam_t == sam_j
    assert b"".join(sam_t).count(b"\n") == 2 * len(pairs)
    assert tp.stats["batches"] == 3 and tp.stats["rescue_rounds"] >= 3
    # what the pairs were planted for
    res = tp.map_pair_codes(c1, ln, c2, ln)          # three-batch merge
    _assert_same_pair(jp.map_pair_codes(c1, ln, c2, ln), res)
    rescued = np.arange(len(pairs)) % 4 == 0
    junk = np.arange(len(pairs)) % 16 == 5
    assert res.m2.mapped[rescued & ~junk].mean() > 0.8
    assert res.proper[~junk].mean() > 0.9 and not res.m2.mapped[junk].any()
    assert res.m1.gapped[np.arange(len(pairs)) % 8 == 3].all()
    ok2 = res.m2.mapped & (res.m2.pos == [p[1].gpos for p in pairs])
    assert ok2[~junk].mean() > 0.9
    if mcfg.tb_bits:
        assert res.m1.tb["rows"].size > 0
        assert res.m1.tb["rows"].max() >= 64         # re-based by the merge


def test_recheck_pairs_matches(world):
    """The host re-check of pairs (what a second pass would call): both
    packages on the same PairResult, with proper pairs broken by a moved
    mate, discordant ones touched, and gapped mates (spans from the
    traceback)."""
    db, pairs, c1, c2, ln, _ji, _ti = world
    jm, tm = _mappers(world)
    jp, tp = jpair.PairedMapper(jm), tpair.PairedMapper(tm)
    want = jp.map_pair_codes(c1, ln, c2, ln)
    got = tp.map_pair_codes(c1, ln, c2, ln)
    touched = np.zeros(len(pairs), bool)
    touched[::3] = True
    for res in (want, got):
        res.m2.pos[6] += 5000            # a moved mate breaks the pair
        res.m2.strand[9] = res.m1.strand[9]
        res.proper[12] = False           # concordant but flagged off
    jp._recheck_pairs(c1, c2, want, touched)
    tp._recheck_pairs(c1, c2, got, touched)
    np.testing.assert_array_equal(want.proper, got.proper)
    assert not got.proper[6] and not got.proper[9] and got.proper[12]
    rows = np.nonzero(got.m1.mapped)[0]
    np.testing.assert_array_equal(
        jpair._ref_spans(db.codes, c1, want.m1, rows, jm.sc),
        tpair._ref_spans(db.codes, c1, got.m1, rows, tm.sc))
    assert (tpair._ref_spans(db.codes, c1, got.m1, rows, tm.sc)
            != ln[rows]).any()


def test_pad_block_and_pair_batch_limit(world):
    c1 = world[2]
    for bs, ml in ((40, None), (32, 130), (32, L)):
        a = jpair._pad_block(c1[:32], np.full(32, L, np.int64), bs, ml)
        b = tpair._pad_block(c1[:32], np.full(32, L, np.int64), bs, ml)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[1].dtype == b[1].dtype == np.int32
    tp = tpair.PairedMapper(_mappers(world)[1])
    ln = np.full(33, L, np.int32)
    with pytest.raises(ValueError, match="pair batch 33 > 32"):
        tp.prepack(c1[:33], ln, c1[:33], ln)
