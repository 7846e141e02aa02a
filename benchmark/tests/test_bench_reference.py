"""The plain reference: its DP against a cell-by-cell loop, CIGAR
scoring by hand, its k-mer index, and the judge on records made by hand
and changed by one field."""

import numpy as np
import pytest
import torch

from benchmark.gen.genome import CHARS, COMP, Layout
from benchmark.reference.align import (NEG, best_scores, cigar_score,
                                       parse_cigar)
from benchmark.reference.judge import judge, mapq_rule
from benchmark.reference.kmers import KmerIndex, clusters
from benchmark.reference.sam import Rec, check_pair

SC = {"match": 1, "mismatch": -2, "gap_open": -4, "gap_extend": -1,
      "clip_open": -5}
CALLS = {"min_score_frac": 0.4, "max_mapq": 42, "mapq_scale": 6.0,
         "distinct": 160, "rescue_mapq_cap": 30, "fragment": [50, 1000]}
CFG = {"scores": SC, "calls": CALLS, "check": {"k": 24}}


def loop_dp(read, win, clip):
    """Gotoh cell by cell (no running maximum), free genome ends."""
    L, W = len(read), len(win)
    go, ge, co = SC["gap_open"], SC["gap_extend"], SC["clip_open"]
    H = [[0] * (W + 1)] + [[NEG] * (W + 1) for _ in range(L)]
    F = [[NEG] * (W + 1) for _ in range(L + 1)]
    best_end = max(H[0]) + co
    for i in range(1, L + 1):
        E = NEG
        for j in range(W + 1):
            F[i][j] = max(H[i - 1][j] + go, F[i - 1][j] + ge)
            h = max(F[i][j], co if clip else NEG)
            if j:
                E = max(H[i][j - 1] + go, E + ge)
                s = SC["match"] if read[i - 1] == win[j - 1] and win[j - 1] < 4 \
                    else SC["mismatch"]
                h = max(h, H[i - 1][j - 1] + s, E)
            H[i][j] = h
        if i < L:
            best_end = max(best_end, max(H[i]) + co)
    e2e = max(H[L])
    return max(e2e, best_end) if clip else e2e


@pytest.mark.parametrize("clip", [False, True])
def test_dp_equals_the_loop(clip):
    rng = np.random.default_rng(3)
    reads, wins = [], []
    for _ in range(12):
        L, W = 20, 34
        g = rng.integers(0, 5, W).astype(np.uint8)
        r = g[7 : 7 + L].copy()
        r[rng.integers(0, L, 2)] = rng.integers(0, 4, 2)
        if rng.random() < 0.5:
            r = np.concatenate([r[:9], r[11:], rng.integers(0, 4, 2)])
        reads.append(r.astype(np.uint8))
        wins.append(g)
    got = best_scores(torch.from_numpy(np.stack(reads)),
                      torch.from_numpy(np.stack(wins)),
                      torch.full((12,), clip), SC).numpy()
    want = [loop_dp(r.tolist(), w.tolist(), clip) for r, w in zip(reads, wins)]
    assert got.tolist() == want


def test_dp_by_hand():
    g = np.random.default_rng(1).integers(0, 4, 80).astype(np.uint8)
    exact = g[20:60]
    one_mm = exact.copy()
    one_mm[10] = (one_mm[10] + 1) % 4
    deletion = np.concatenate([g[20:35], g[37:62]])     # 2 bases skipped
    reads = torch.from_numpy(np.stack([exact, one_mm, deletion]))
    wins = torch.from_numpy(np.stack([g, g, g]))
    got = best_scores(reads, wins, torch.zeros(3, dtype=torch.bool), SC)
    assert got.tolist() == [40, 37, 40 - 5]


def test_cigar_score_by_hand():
    g = np.random.default_rng(2).integers(0, 4, 100).astype(np.uint8)
    read = np.concatenate([g[10:30], g[33:53]])
    assert cigar_score(parse_cigar(b"20M3D20M"), read, g, 10, SC) == (
        40 - 6, 3, 43, 0)
    tail = np.concatenate([g[10:40], (g[40:50] + 1) % 4])
    assert cigar_score(parse_cigar(b"30M10S"), tail, g, 10, SC) == (
        30 - 5, 0, 30, 1)
    assert cigar_score(parse_cigar(b"30M9S"), tail, g, 10, SC) is None
    assert parse_cigar(b"30M 10S") is None


def test_kmer_index_and_clusters():
    g = np.random.default_rng(4).integers(0, 4, 5000).astype(np.uint8)
    read = np.concatenate([g[1000:1060], g[1064:1154]])   # 4 bp deletion
    idx = KmerIndex(g, 24, torch.device("cpu"), torch.from_numpy(read[None]))
    rows, diags = idx.diagonals(torch.from_numpy(read[None]))
    r, lo, hi = clusters(rows, diags, 32)
    assert r.tolist() == [0] and lo[0] == 1000 and hi[0] == 1004


def test_mapq_rule():
    assert mapq_rule(150, NEG, CALLS) == 42
    assert mapq_rule(150, 147, CALLS) == 18
    assert mapq_rule(150, 150, CALLS) == 0


def se_record(name, read, pos0, strand, g, mapq=42, cigar=None):
    seq = COMP[read[::-1]] if strand else read
    cig = cigar or b"%dM" % read.size
    got = cigar_score(parse_cigar(cig), seq, g, pos0, SC)
    return b"\t".join([name, b"16" if strand else b"0", b"chr21",
                       b"%d" % (pos0 + 1), b"%d" % mapq, cig, b"*", b"0",
                       b"0", CHARS[seq].tobytes(), b"I" * read.size,
                       b"AS:i:%d" % got[0], b"NM:i:%d" % got[1]]) + b"\n"


def test_judge_holds_records_to_the_reference():
    rng = np.random.default_rng(6)
    g = rng.integers(0, 4, 20000).astype(np.uint8)
    reads, lines = [], []
    for i in range(6):
        p, strand = 1000 + 2000 * i, i % 2
        fwd = g[p : p + 150].copy()
        fwd[40] = (fwd[40] + 1) % 4
        read = COMP[fwd[::-1]] if strand else fwd
        reads.append(read)
        lines.append(se_record(b"r%09d" % i, read, p, strand, g))
    reads = np.stack(reads)
    one = Layout.of([("chr21", g.size)])
    ok = judge(g, one, reads, lines, CFG, paired=False)
    assert (ok["bad_records"], ok["mapq_off"], ok["score_gap"]) == (0, 0, 0)
    # one answer altered where it was made: POS one base off
    f = lines[2].split(b"\t")
    f[3] = b"%d" % (int(f[3]) + 1)
    bad = judge(g, one, reads, lines[:2] + [b"\t".join(f)] + lines[3:],
                CFG, paired=False)
    assert bad["bad_records"] == 1
    # a worse alignment written consistently: an all-M CIGAR shifted by
    # one base scores far below the read's best (and below the floor)
    shifted = se_record(b"r%09d" % 4, reads[4], 1000 + 2000 * 4 + 1, 0, g)
    worse = judge(g, one, reads, lines[:4] + [shifted] + lines[5:],
                  CFG, paired=False)
    assert worse["score_gap"] > 100
    # an overconfident MAPQ
    low = lines[:1] + [se_record(b"r%09d" % 1, reads[1], 3000, 1, g,
                                 mapq=7)] + lines[2:]
    assert judge(g, one, reads, low, CFG, paired=False)["mapq_off"] == 1
    # a read left out: written unmapped though the reference places it
    f = [b"r%09d" % 3, b"4", b"*", b"0", b"0", b"*", b"*", b"0", b"0",
         CHARS[reads[3]].tobytes(), b"I" * 150]
    out = judge(g, one, reads, lines[:3] + [b"\t".join(f) + b"\n"]
                + lines[4:], CFG, paired=False)
    assert (out["bad_records"], out["missed"]) == (0, 1)
    assert out["missed_share"] == 1 / 6


def mate_pair(pos_rev: int, flags: tuple) -> tuple:
    """Two mapped unclipped 150 bp mates, forward at 1,001 and reverse
    at ``pos_rev`` + 1, with the given flags and their own TLEN."""
    tl = pos_rev + 150 - 1000
    recs = []
    for flag, pos, mpos, t, strand in ((flags[0], 1000, pos_rev, tl, 0),
                                       (flags[1], pos_rev, 1000, -tl, 1)):
        r = Rec(read=np.zeros(150, np.uint8), fields=[
            b"p0", b"%d" % flag, b"chr21", b"%d" % (pos + 1), b"42", b"150M",
            b"=", b"%d" % (mpos + 1), b"%d" % t])
        r.flag, r.mapped, r.strand, r.pos0 = flag, True, strand, pos
        r.span, r.fits = 150, True
        recs.append(r)
    return tuple(recs)


@pytest.mark.parametrize("pos_rev,flags,why", [
    (1300, (99, 147), ""),
    (1300, (97, 145), "no 0x2"),
    (2200, (99, 147), "0x2 on mates outside"),
    (2200, (97, 145), ""),
])
def test_proper_pair_flag_follows_the_fragment_range(pos_rev, flags, why):
    r1, r2 = mate_pair(pos_rev, flags)
    check_pair(r1, r2, CALLS["fragment"])
    assert r1.why.startswith(why) and r2.why.startswith(why)
