"""The repeat path of the port against urmap_tpu, on the CPU.

Repeat-laden genomes are where the weak and suspect MAPQ gates, the
saturated-seed fallback, the pair caps and the wide second pass decide
the result, and where exact duplicates make real ties. Each test here is
the port's counterpart of one of urmap_tpu's repeat tests: the same
genome function and seed, the same reads, mapped by both packages with
the same MapConfig. The port's MapResult (every field of ``FIELDS``;
both mates and ``proper`` for pairs) and its SAM bytes must equal
urmap_tpu's, and the reference test's own property is asserted on the
port's result:

- tests/integration/test_repeat_mapq.py: tandem reads contained, unique
  reads confident; a weak pair capped, an anchored mate confident;
- tests/integration/test_suspect_gate.py: family reads never
  confidently wrong; the second pass recovers suspects; clip-rescued
  reads are excluded from the gate; paired suspect corroboration;
- tests/integration/test_robustness.py: an exact repeat gets MAPQ 0.

Then a genome with tools/accuracy.py's ``plant_repeat_families`` (25%
repeats: SINE- and LINE-like families, exact segmental duplications,
tandem runs) and its ``simulate`` reads, under the default MapConfig and
under VERYFAST_MAP_OVERRIDES on a -veryfast index, where some reads must
be weak (counted on the port's candidates) and some suspect; and the
last JSON line of tools/accuracy.py equal to the port's tool's
(urmap_tpu_torch.tools.accuracy), with and without --veryfast. Last, a
fault of urmap_tpu the port copies (ROADMAP C.3): a tandem-run read
whose banded DP score the host DP does not reproduce stops both SAM
writers alike. Integers and bytes: tolerance 0.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from tests.integration import test_repeat_mapq as ref_tandem
from tests.integration import test_suspect_gate as ref_family
from tests.utils import plant_read, random_seq
from urmap_tpu import alphabet
from urmap_tpu.config import VERYFAST_MAP_OVERRIDES, IndexConfig, MapConfig
from urmap_tpu.index.build import build_index as jbuild
from urmap_tpu.io import sam_native as jsam
from urmap_tpu.io.fasta import SeqDB
from urmap_tpu.io.fastq import FastqReader as JFastqReader
from urmap_tpu.map.cigar import cigars_nm_blob as jcigars
from urmap_tpu.map.pair import RESCUE_MAPQ_CAP
from urmap_tpu.map.pair import PairedMapper as JPaired
from urmap_tpu.map.pipeline import Mapper as JMapper
from urmap_tpu_torch.index import build_index as tbuild
from urmap_tpu_torch.io import sam_native as tsam
from urmap_tpu_torch.io.fastq import FastqReader as TFastqReader
from urmap_tpu_torch.map import PairedMapper as TPaired
from urmap_tpu_torch.map import pipeline as tpipe
from urmap_tpu_torch.map.cigar import cigars_nm_blob as tcigars
from urmap_tpu_torch.tools import accuracy as taccuracy

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIELDS = ("mapped", "pos", "strand", "score", "second", "mapq", "gapped",
          "ungapped", "clipped", "suspect", "lengths")


def _indexes(db, icfg):
    return jbuild(db, icfg, backend="host"), tbuild(db, icfg, backend="host")


def _same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def _write_fastq(path, codes, lengths):
    with open(path, "w") as f:
        for i, (c, n) in enumerate(zip(codes, lengths)):
            f.write(f"@r{i}\n{alphabet.decode(c[:n])}\n+\n{'I' * n}\n")


def _batch(reader, paths, codes, lengths, L):
    """The reads back from FASTQ as one NativeReadBatch (a pair of them
    for two paths), checked against the codes that were mapped."""
    got = next(iter(reader(*paths, batch_size=len(lengths[0]),
                           max_read_len=L)))
    got = got if len(paths) == 2 else (got,)
    for b, c, n in zip(got, codes, lengths):
        np.testing.assert_array_equal(b.lengths, n)
        w = min(b.codes.shape[1], c.shape[1])
        live = np.arange(w)[None, :] < n[:, None]
        np.testing.assert_array_equal(np.where(live, b.codes[:, :w], 0),
                                      np.where(live, c[:, :w], 0))
    return got


def map_single(tmp_path, db, idx, mcfg, codes, lengths):
    """Both packages map ``codes`` → (urmap_tpu's result, the port's),
    held equal in FIELDS and in the single-end SAM bytes."""
    jidx, tidx = idx
    jm, tm = JMapper(jidx, mcfg), tpipe.Mapper(tidx, mcfg, device="cpu")
    want = jm.map_codes(codes, lengths)
    got = tm.map_codes(codes, lengths)
    _same(want, got)
    fq = str(tmp_path / "r.fq")
    _write_fastq(fq, codes, lengths)
    sam = []
    for reader, cig, fmt, m, res in ((JFastqReader, jcigars, jsam, jm, want),
                                     (TFastqReader, tcigars, tsam, tm, got)):
        b, = _batch(reader, [fq], [codes], [lengths], mcfg.max_read_len)
        blob, off, nm, _ = cig(db.codes, b.codes, res, m.sc,
                               raw_lengths=b.seq_len, clip_rows=res.clipped)
        sam.append(fmt.format_single_end(b, res, (blob, off), nm, db))
    assert sam[1] == sam[0]
    assert sam[1].count(b"\n") == len(lengths)
    return want, got


def map_pairs(tmp_path, db, idx, mcfg, r1, r2, ln):
    """Both packages' PairedMapper → (urmap_tpu's PairResult, the
    port's), held equal in both mates' FIELDS, ``proper`` and the paired
    SAM bytes."""
    jidx, tidx = idx
    jp = JPaired(JMapper(jidx, mcfg))
    tp = TPaired(tpipe.Mapper(tidx, mcfg, device="cpu"))
    want = jp.map_pair_codes(r1, ln, r2, ln)
    got = tp.map_pair_codes(r1, ln, r2, ln)
    _same(want.m1, got.m1)
    _same(want.m2, got.m2)
    np.testing.assert_array_equal(want.proper, got.proper)
    f1, f2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    _write_fastq(f1, r1, ln)
    _write_fastq(f2, r2, ln)
    sam = []
    for reader, cig, fmt, pm, res in ((JFastqReader, jcigars, jsam, jp, want),
                                      (TFastqReader, tcigars, tsam, tp, got)):
        b1, b2 = _batch(reader, [f1, f2], [r1, r2], [ln, ln],
                        mcfg.max_read_len)
        per = []
        for b, m in ((b1, res.m1), (b2, res.m2)):
            blob, off, nm, span = cig(db.codes, b.codes, m, pm.mapper.sc,
                                      raw_lengths=b.seq_len,
                                      clip_rows=m.clipped)
            per += [(blob, off), nm, span]
        sam.append(fmt.format_paired(b1, b2, res, *per, db))
    assert sam[1] == sam[0]
    assert sam[1].count(b"\n") == 2 * len(ln)
    return want, got


# ---- tests/integration/test_repeat_mapq.py ------------------------------

def test_tandem_reads_contained_unique_reads_confident(tmp_path):
    rng = np.random.default_rng(0)
    db, third = ref_tandem._tandem_genome(rng)
    idx = _indexes(db, IndexConfig(slot_bits=16))
    mcfg = MapConfig(max_read_len=120, batch_size=64)
    n, L = 64, 120
    g0 = int(db.starts[0])
    codes = np.empty((n, L), np.uint8)
    for i in range(n):
        if i % 2:   # deep inside the tandem run
            p = int(rng.integers(third + 200, 2 * third - L - 200))
        else:       # unique sequence
            p = int(rng.integers(0, third - L - 1))
        codes[i] = db.codes[g0 + p : g0 + p + L]
    lengths = np.full(n, L, np.int32)
    _, res = map_single(tmp_path, db, idx, mcfg, codes, lengths)
    tandem = np.arange(n) % 2 == 1
    assert res.mapped[tandem].mean() >= 0.9
    assert int(res.mapq[tandem & res.mapped].max()) <= mcfg.weak_mapq_cap
    assert res.mapped[~tandem].all()
    assert (res.mapq[~tandem] >= 20).mean() >= 0.95


def test_weak_pair_capped_anchored_mate_keeps_confidence(tmp_path):
    rng = np.random.default_rng(0)
    db, third = ref_tandem._tandem_genome(rng)
    idx = _indexes(db, IndexConfig(slot_bits=16))
    mcfg = MapConfig(max_read_len=120, batch_size=64)
    n, L, frag = 32, 120, 400
    g0 = int(db.starts[0])
    r1 = np.empty((n, L), np.uint8)
    r2 = np.empty((n, L), np.uint8)
    for i in range(n):
        if i % 2:   # whole fragment inside the tandem run (weak+weak)
            p = int(rng.integers(third + 200, 2 * third - frag - 200))
        else:       # R1 unique, fragment straddles toward unique side
            p = int(rng.integers(0, third - frag - 200))
        r1[i] = db.codes[g0 + p : g0 + p + L]
        r2[i] = alphabet.revcomp(
            db.codes[g0 + p + frag - L : g0 + p + frag])
    ln = np.full(n, L, np.int32)
    _, res = map_pairs(tmp_path, db, idx, mcfg, r1, r2, ln)
    both_weak = np.arange(n) % 2 == 1
    for m in (res.m1, res.m2):
        assert int(m.mapq[both_weak & m.mapped].max()) \
            <= mcfg.weak_mapq_cap
    assert (res.m1.mapq[~both_weak] >= 20).mean() >= 0.9
    assert int(res.m2.mapq[~both_weak].max()) <= max(
        RESCUE_MAPQ_CAP, int(res.m2.mapq[~both_weak].max()))


# ---- tests/integration/test_suspect_gate.py -----------------------------

def test_family_reads_never_confidently_wrong(tmp_path):
    rng = np.random.default_rng(0)
    db, starts = ref_family._family_genome(rng)
    idx = _indexes(db, IndexConfig(slot_bits=20))
    L, n = 150, 256
    mcfg = MapConfig(max_read_len=L, batch_size=n, positions_per_seed=8)
    fam, tpos = ref_family._reads_from(db, rng, starts, n // 2, L)
    g0 = int(db.starts[0])
    glen = db.codes.shape[0] - g0
    upos = g0 + rng.integers(glen // 2, glen - L - 1, size=n // 2)
    uniq = np.stack([db.codes[p : p + L] for p in upos])
    codes = np.concatenate([fam, uniq])
    lengths = np.full(n, L, np.int32)
    _, res = map_single(tmp_path, db, idx, mcfg, codes, lengths)
    h = n // 2
    wrong = res.mapped[:h] & (np.abs(res.pos[:h] - tpos) > 20)
    assert not (wrong & (res.mapq[:h] >= 10)).any()
    assert res.mapped[h:].all()
    assert (np.abs(res.pos[h:] - upos) <= 20).all()
    assert (res.mapq[h:] >= 20).mean() >= 0.95
    assert res.suspect is not None and res.suspect[:h].any()


def test_second_pass_recovers_suspects(tmp_path):
    rng = np.random.default_rng(0)
    db, starts = ref_family._family_genome(rng, copies=60, div=0.04)
    idx = _indexes(db, IndexConfig(slot_bits=20))
    L, n = 150, 512
    fam, tpos = ref_family._reads_from(db, rng, starts, n, L, snp=0.02)
    lengths = np.full(n, L, np.int32)
    narrow = MapConfig(max_read_len=L, batch_size=n, positions_per_seed=8)
    wide = MapConfig(max_read_len=L, batch_size=n, positions_per_seed=8,
                     second_pass_p=64)
    _, res0 = map_single(tmp_path, db, idx, narrow, fam, lengths)
    _, res = map_single(tmp_path, db, idx, wide, fam, lengths)
    correct0 = res0.mapped & (np.abs(res0.pos - tpos) <= 20)
    correct = res.mapped & (np.abs(res.pos - tpos) <= 20)
    assert not (res0.mapped & ~correct0 & (res0.mapq >= 10)).any()
    assert res0.suspect.any()
    assert correct.sum() > correct0.sum()
    assert correct.mean() >= 0.95
    assert not (res.mapped & ~correct & (res.mapq >= 10)).any()
    assert (res.mapq[correct] >= 10).mean() >= 0.9


def test_clip_rescued_reads_excluded_from_gate(tmp_path):
    rng = np.random.default_rng(0)
    db, starts = ref_family._family_genome(rng)
    idx = _indexes(db, IndexConfig(slot_bits=20))
    L, n = 150, 128
    g0 = int(db.starts[0])
    codes = np.empty((n, L), np.uint8)
    tpos = np.empty(n, np.int64)
    for i in range(n):
        p = int(starts[rng.integers(0, len(starts))]) + 300 - 50
        tpos[i] = g0 + p
        codes[i, :90] = db.codes[g0 + p : g0 + p + 90]
        codes[i, 90:] = rng.integers(0, 4, size=L - 90)
    lengths = np.full(n, L, np.int32)
    mcfg = MapConfig(max_read_len=L, batch_size=n, positions_per_seed=8)
    _, res = map_single(tmp_path, db, idx, mcfg, codes, lengths)
    clip = res.clipped & res.mapped
    assert clip.any()
    assert not (clip & res.suspect).any()
    correct = clip & (np.abs(res.pos - tpos) <= 20)
    assert correct.any()
    assert (res.mapq[correct] >= 10).mean() >= 0.8


def test_pe_suspect_corroboration(tmp_path):
    rng = np.random.default_rng(0)
    db, starts = ref_family._family_genome(rng, copies=120, div=0.02)
    idx = _indexes(db, IndexConfig(slot_bits=20))
    L, n, frag = 150, 64, 400
    g0 = int(db.starts[0])
    glen = db.codes.shape[0] - g0
    r1 = np.empty((n, L), np.uint8)
    r2 = np.empty((n, L), np.uint8)
    tpos = np.empty(n, np.int64)
    for i in range(n):
        if i % 2:
            p = int(starts[rng.integers(0, len(starts))])
        else:
            p = int(rng.integers(glen // 2, glen - frag - 1))
        tpos[i] = g0 + p
        r1[i] = db.codes[g0 + p : g0 + p + L]
        r2[i] = alphabet.revcomp(db.codes[g0 + p + frag - L : g0 + p + frag])
        m = rng.random(L) < 0.05
        r1[i, m] = (r1[i, m] + rng.integers(1, 4, int(m.sum()))) % 4
    ln = np.full(n, L, np.int32)
    mcfg = MapConfig(max_read_len=L, batch_size=n, positions_per_seed=8)
    _, res = map_pairs(tmp_path, db, idx, mcfg, r1, r2, ln)
    fam = np.arange(n) % 2 == 1
    uniq = ~fam
    assert (res.m1.mapq[uniq & res.proper] >= 20).mean() >= 0.8
    gated = fam & res.proper & (L - res.m1.score > 18)
    assert gated.any()
    capped = res.m1.mapq[gated] <= RESCUE_MAPQ_CAP
    correct = np.abs(res.m1.pos[gated] - tpos[gated]) <= 20
    assert (capped | correct).all()
    assert capped.any()
    assert not res.m1.suspect[fam & res.proper].any()
    assert (res.m2.mapq[gated] >= 20).mean() >= 0.8


# ---- tests/integration/test_robustness.py -------------------------------

def test_exact_repeat_gets_mapq_zero(tmp_path):
    rng = np.random.default_rng(0)
    unique = random_seq(rng, 40_000)
    repeat = random_seq(rng, 5_000)
    seq = unique[:20_000] + repeat + unique[20_000:] + repeat
    db = SeqDB.from_seqs(["chr1"], [seq])
    idx = _indexes(db, IndexConfig(slot_bits=16))
    start = int(db.starts[0])
    rep1 = start + 20_000
    rep2 = start + 45_000
    reads = []
    for i in range(10):  # reads fully inside the repeat copy 1
        off = int(rng.integers(0, 5_000 - 100))
        reads.append(plant_read(rng, db, length=100, gpos=rep1 + off,
                                strand=0))
    for i in range(10):  # unique-region reads
        off = int(rng.integers(0, 19_000 - 100))
        reads.append(plant_read(rng, db, length=100, gpos=start + off,
                                strand=0))
    max_len = 120
    codes = np.stack([np.pad(r.codes, (0, max_len - len(r.codes)),
                             constant_values=alphabet.READ_N)
                      for r in reads])
    lengths = np.array([len(r.codes) for r in reads], np.int32)
    mcfg = MapConfig(max_read_len=max_len, batch_size=32)
    _, res = map_single(tmp_path, db, idx, mcfg, codes, lengths)
    for i in range(10):
        assert res.mapped[i]
        p = int(res.pos[i])
        assert p == reads[i].gpos or p == reads[i].gpos + (rep2 - rep1)
        assert int(res.mapq[i]) == 0
    for i in range(10, 20):
        assert res.mapped[i] and int(res.pos[i]) == reads[i].gpos
        assert int(res.mapq[i]) >= 20


# ---- tools/accuracy.py's repeat families --------------------------------

# the MapConfig that tools/accuracy.py builds for --read-len 150 --batch
# 256, and with --veryfast (VERYFAST_MAP_OVERRIDES: B4 at 8 x 8 = 64
# candidates a read, B5's row entry at 8 positions a seed)
MODES = {"default": MapConfig(max_read_len=150, batch_size=256),
         "veryfast": MapConfig(max_read_len=150, batch_size=256,
                               **VERYFAST_MAP_OVERRIDES)}


@pytest.mark.parametrize("mode", list(MODES))
def test_repeat_families_match_urmap_tpu(tmp_path, monkeypatch, mode):
    """A 0.4 Mbp genome with 25% repeat families and 1,024 simulated
    reads (1% SNPs, 10% with an indel, both strands): equal results and
    SAM bytes under the default MapConfig and, on a -veryfast index
    (auto slot_bits + 2), under VERYFAST_MAP_OVERRIDES. The gates are
    live: weak reads (read off the port's candidates) map with MAPQ at
    most weak_mapq_cap; winners on saturated evidence whose score trails
    a perfect one by more than the gate's deficit, at most
    suspect_mapq_cap; some reads are suspect; and no call at MAPQ >= 10
    is more than 5 bases off."""
    from urmap_tpu_torch.config import ScoreConfig, resolve_suspect_deficits

    rng = np.random.default_rng(11)
    seq = rng.integers(0, 4, size=400_000).astype(np.uint8)
    taccuracy.plant_repeat_families(rng, seq, 0.25)
    db = SeqDB.from_seqs(["chr1"], [seq])
    vf = mode == "veryfast"
    bits = IndexConfig.auto_slot_bits(db.total_len) + (2 if vf else 0)
    idx = _indexes(db, IndexConfig(slot_bits=bits, veryfast=vf))
    mcfg = MODES[mode]
    codes, tpos, tstrand = taccuracy.simulate(np.random.default_rng(1), db,
                                              1024, 150, 0.01, 0.10)
    lengths = np.full(1024, 150, np.int32)
    seen = {"weak": [], "nsat": []}
    real = tpipe.candidates_batch_device

    def spy(*a, **kw):
        c = real(*a, **kw)
        for k, v in seen.items():
            v.append(c[k].clone())
        return c

    monkeypatch.setattr(tpipe, "candidates_batch_device", spy)
    _, res = map_single(tmp_path, db, idx, mcfg, codes, lengths)
    weak, nsat = (torch.cat(v).numpy() for v in seen.values())
    assert len(weak) == len(nsat) == 1024
    weak &= res.mapped
    assert weak.sum() > 0
    assert (res.mapq[weak] <= mcfg.weak_mapq_cap).all()
    sc = ScoreConfig()
    gate, _ = resolve_suspect_deficits(mcfg, sc)
    capped = res.mapped & (nsat > 0) & ~res.clipped \
        & (lengths * sc.match - res.score > gate)
    assert (res.mapq[capped] <= mcfg.suspect_mapq_cap).all()
    assert res.suspect.sum() > 0
    correct = res.mapped & (np.abs(res.pos - tpos) <= 5) \
        & (res.strand == tstrand)
    assert not (res.mapped & ~correct & (res.mapq >= 10)).any()
    assert correct.mean() >= 0.9


def _last_json(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [[], ["--veryfast"]])
def test_accuracy_tool_matches_urmap_tpus(extra):
    """tools/accuracy.py and python -m urmap_tpu_torch.tools.accuracy
    print the same last JSON line (the ROC by MAPQ threshold) on a
    0.3 Mbp genome with 25% repeats."""
    spec = importlib.util.spec_from_file_location(
        "accuracy_reference", os.path.join(ROOT, "tools", "accuracy.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    argv = ["--cpu", "--genome-mbp", "0.3", "--repeat-frac", "0.25",
            "--reads", "1000", "--batch", "256", *extra]
    want = _last_json(ref.main, argv)
    got = _last_json(taccuracy.main, argv)
    assert got == want
    assert got["metric"] == "accuracy_roc"
    assert [r["mapq"] for r in got["roc"]] == [0, 1, 10, 20, 30, 40, 42]
    assert got["roc"][2]["precision"] >= 0.99


def test_tandem_read_stops_both_sam_writers():
    """ROADMAP C.3, a fault of urmap_tpu that the port copies: a read in
    a tandem run whose banded main-DP score the host DP at its POS does
    not reproduce (the traceback kernel, re-centred there, scores it
    differently, so its records are stale) reaches the host DP of
    cigars_nm_blob, and the SAM writer raises "native traceback score
    mismatch" naming that row, in both packages alike. Here read 1,451
    of the repeat-family corpus (the default MapConfig, a batch of 256
    from read 1,280)."""
    from urmap_tpu_torch.map.cigar import (strand_codes_subset,
                                           traceback_batch_native)

    rng = np.random.default_rng(11)
    seq = rng.integers(0, 4, size=400_000).astype(np.uint8)
    taccuracy.plant_repeat_families(rng, seq, 0.25)
    db = SeqDB.from_seqs(["chr1"], [seq])
    jidx, tidx = _indexes(db, IndexConfig(
        slot_bits=IndexConfig.auto_slot_bits(db.total_len)))
    codes, _tpos, _ts = taccuracy.simulate(np.random.default_rng(1), db,
                                           1536, 150, 0.01, 0.10)
    codes = codes[1280:]
    lengths = np.full(256, 150, np.int32)
    mcfg = MODES["default"]
    jm, tm = JMapper(jidx, mcfg), tpipe.Mapper(tidx, mcfg, device="cpu")
    want, got = jm.map_codes(codes, lengths), tm.map_codes(codes, lengths)
    _same(want, got)
    rows = np.nonzero(got.mapped & got.gapped & ~got.clipped)[0]
    sub = strand_codes_subset(codes[rows], got.strand[rows], lengths[rows])
    host = traceback_batch_native(db.codes, got.pos[rows], sub,
                                  lengths[rows], tm.sc, raw=True)[3]
    assert rows[host != got.score[rows]].tolist() == [171]
    k = int(np.nonzero(got.tb["rows"] == 171)[0][0])
    assert got.tb["score"][k] != got.score[171]          # stale records
    for cig, m, res in ((jcigars, jm, want), (tcigars, tm, got)):
        with pytest.raises(AssertionError,
                           match=r"native traceback score mismatch at "
                                 r"rows \[171\]"):
            cig(db.codes, codes, res, m.sc, clip_rows=res.clipped)
