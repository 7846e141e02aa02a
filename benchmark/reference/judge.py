"""The comparison that decides ``correct``: a sample of the records the
timed window committed, judged by the plain reference.

For each sampled read (each mate of a sampled pair) the reference
  1. holds the record to the SAM rules and to the read (reference/sam.py);
  2. finds the read's loci itself: every exact k-mer hit in its own index
     of the genome's k-mers that the sampled reads hold
     (reference/kmers.py), on both strands, the record's
     own locus, and for a mate that finds none of its own, the window
     where its mate's best locus puts it (the fragment range);
  3. aligns the read at each locus (reference/align.py), end to end and
     in clip mode.
Numbers compared (each with its limit in the configuration's ``check``):
  ``bad_records``  records that break a rule of step 1 (exact: 0);
  ``mapq_off``     mapped records whose MAPQ is not the one the
                   reference's loci give: the configuration's MAPQ rule
                   over the best and second-best locus (a locus more
                   than ``distinct`` bases away), for a mate also the
                   rescue cap (exact: 0);
  ``score_gap``    the widest amount by which the reference's best
                   alignment of a mapped read (clip mode where the
                   record is clipped) beats the record's own (its
                   CIGAR's score at its POS, wherever the CIGAR fits);
  ``missed_share`` the share of the sampled records left unmapped whose
                   read the reference aligns at or above the mapping
                   floor (for a mate also in its mate's fragment
                   window): reads the timed path left out. Its limit
                   is in the traffic's file, as the mix sets how many
                   reads are hard to place.
Positions are offsets in the benchmark's genome array (gen/genome.py
``Layout``: the contigs one after the other, N between them); a record's
(RNAME, POS) is turned into one.
Printed beside them, not compared: ``missed`` (the same as a count),
``truth_share`` (mapped records at their planted start,
tools/check_sam_truth.py's measure) and ``sampled``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.gen.genome import COMP, GENOME_N, SEPARATOR, Layout
from benchmark.reference.align import NEG, best_scores
from benchmark.reference.kmers import KmerIndex, clusters
from benchmark.reference.sam import Rec, check_own, check_pair, min_score

MARGIN = 32        # bases of genome beyond a locus on each side
BLOCK = 4096       # windows aligned at a time


def windows_of(genome: np.ndarray, starts: np.ndarray, width: int):
    """uint8[n, width] genome slices from ``starts``; N off the ends."""
    idx = starts[:, None] + np.arange(width)[None, :]
    ok = (idx >= 0) & (idx < genome.size)
    return np.where(ok, genome[np.clip(idx, 0, genome.size - 1)],
                    GENOME_N).astype(np.uint8)


class Jobs:
    """Loci to align: read number, strand, diagonal, window start and
    width; aligned in blocks, end to end and in clip mode."""

    def __init__(self):
        self.cols = {k: [] for k in ("read", "strand", "diag", "start",
                                     "width")}

    def add(self, read, strand, diag, start, width):
        for k, v in (("read", read), ("strand", strand), ("diag", diag),
                     ("start", start), ("width", width)):
            self.cols[k].append(np.atleast_1d(np.asarray(v, np.int64)))

    def run(self, genome, oriented, sc, device):
        """oriented: uint8[n_reads, 2, L] (forward, reverse complement)
        → dict of arrays, one entry a job, with ``e2e`` and ``clip``."""
        c = {k: (np.concatenate(v) if v else np.zeros(0, np.int64))
             for k, v in self.cols.items()}
        n = c["read"].size
        c["e2e"] = np.full(n, NEG, np.int64)
        c["clip"] = np.full(n, NEG, np.int64)
        order = np.argsort(c["width"], kind="stable")
        for s in range(0, n, BLOCK):
            sel = order[s : s + BLOCK]
            W = int(c["width"][sel].max())
            win = torch.from_numpy(windows_of(genome, c["start"][sel], W))
            rd = torch.from_numpy(oriented[c["read"][sel], c["strand"][sel]])
            win, rd = win.to(device), rd.to(device)
            for mode in ("e2e", "clip"):
                flag = torch.full((sel.size,), mode == "clip",
                                  dtype=torch.bool, device=device)
                c[mode][sel] = best_scores(rd, win, flag, sc).cpu().numpy()
        return c


def mapq_rule(best: int, second: int, calls: dict) -> int:
    """The configuration's MAPQ: round(scale x (best - second)) to even,
    clamped to [0, max]; max where no second locus scores."""
    if second <= NEG // 2:
        return calls["max_mapq"]
    q = np.float32(calls["mapq_scale"]) * np.float32(best - second)
    return int(min(max(np.round(q), 0), calls["max_mapq"]))


def judge(genome, layout: Layout, reads: np.ndarray, lines: list[bytes],
          cfg: dict, paired: bool, truth_pos: np.ndarray | None = None,
          device="cpu") -> dict:
    """reads: uint8[n, L] as sequenced, one row per record (for pairs
    mate 1 and mate 2 of a pair next to each other: rows 2p, 2p + 1);
    lines: the records, in the same order; truth_pos: offsets in the
    array. → the numbers."""
    sc, calls = cfg["scores"], cfg["calls"]
    n, L = reads.shape
    if (paired and len(layout.names) > 1
            and calls["fragment"][1] + 2 * MARGIN > SEPARATOR):
        raise ValueError("a mate's fragment window would reach past the "
                         "N between two contigs")
    recs = [Rec(read=reads[i], fields=ln.rstrip(b"\n").split(b"\t"))
            for i, ln in enumerate(lines)]
    for r in recs:
        check_own(r, genome, layout, sc, calls, paired)
    if paired:
        for p in range(0, n, 2):
            check_pair(recs[p], recs[p + 1], calls["fragment"])
    oriented = np.stack([reads, COMP[reads[:, ::-1]]], axis=1)
    k = cfg["check"]["k"]
    dev = torch.device(device)
    index = KmerIndex(genome, k, dev, torch.from_numpy(oriented))
    jobs = Jobs()
    for strand in (0, 1):
        rows, diags = index.diagonals(torch.from_numpy(oriented[:, strand]))
        r, lo, hi = clusters(rows, diags, MARGIN)
        jobs.add(r, np.full(r.size, strand), lo, lo - MARGIN,
                 L + 2 * MARGIN + (hi - lo))
    del index
    # each mapped record's own locus
    own = [i for i, r in enumerate(recs) if r.mapped and r.fits]
    jobs.add(own, [recs[i].strand for i in own],
             [recs[i].diag for i in own],
             [recs[i].diag - MARGIN for i in own],
             [L + 2 * MARGIN] * len(own))
    res = jobs.run(genome, oriented, sc, dev)
    floor = min_score(calls, L)
    best_e2e = np.full(n, NEG, np.int64)
    np.maximum.at(best_e2e, res["read"], res["e2e"])
    if paired:
        # mates that align nowhere on their own: the window where the
        # mate's best locus puts them (FR, the fragment range)
        resc = Jobs()
        lo_f, hi_f = calls["fragment"]
        for i in np.flatnonzero(best_e2e < floor):
            j = i ^ 1
            if best_e2e[j] < floor:
                continue
            m = np.flatnonzero((res["read"] == j) & (res["e2e"] == best_e2e[j]))
            a, s = int(res["diag"][m[0]]), int(res["strand"][m[0]])
            start = a - MARGIN if s == 0 else a + L - hi_f - MARGIN
            resc.add(i, 1 - s, start + MARGIN, start, hi_f + 2 * MARGIN)
        extra = resc.run(genome, oriented, sc, dev)
        res = {key: np.concatenate([res[key], extra[key]]) for key in res}
        best_e2e = np.full(n, NEG, np.int64)
        np.maximum.at(best_e2e, res["read"], res["e2e"])
    best_clip = np.full(n, NEG, np.int64)
    np.maximum.at(best_clip, res["read"], res["clip"])
    by_read = np.argsort(res["read"], kind="stable")
    bounds = np.searchsorted(res["read"][by_read], np.arange(n + 1))
    out = {"bad_records": 0, "mapq_off": 0, "score_gap": 0, "missed": 0,
           "sampled": n}
    why = []
    on_truth = mapped_n = 0
    for i, r in enumerate(recs):
        if r.why:
            out["bad_records"] += 1
            why.append(f"record {i}: {r.why}")
        ref_maps = max(best_e2e[i], best_clip[i]) >= floor
        if not r.mapped:
            out["missed"] += int(ref_maps and not r.why)
            continue
        if not r.fits:
            continue
        mapped_n += 1
        if truth_pos is not None and truth_pos[i] >= 0:
            on_truth += int(abs(r.pos0 - int(truth_pos[i])) <= 8)
        best = best_clip[i] if r.clips else best_e2e[i]
        out["score_gap"] = max(out["score_gap"], int(best - r.score))
        js = by_read[bounds[i] : bounds[i + 1]]
        key = res["e2e"][js] if best_e2e[i] >= floor else res["clip"][js]
        top = js[np.argmax(key)]
        far = np.abs(res["diag"][js] - res["diag"][top]) > calls["distinct"]
        second = int(key[np.flatnonzero(far)].max()) if far.any() else NEG
        want = mapq_rule(int(key.max()), second, calls)
        ok = {want, min(want, calls["rescue_mapq_cap"])} if paired else {want}
        if r.mapq not in ok:
            out["mapq_off"] += 1
            why.append(f"record {i}: MAPQ {r.mapq}, the reference's loci "
                       f"give {sorted(ok)}")
    out["missed_share"] = out["missed"] / n
    out["truth_share"] = on_truth / mapped_n if mapped_n else math.nan
    out["why"] = why[:8]
    return out
