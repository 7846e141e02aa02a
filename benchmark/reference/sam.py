"""The record checks of the reference: each SAM record the timed path
wrote, held to the SAM rules and to the read it was given.

Everything a record states about itself must agree: its flags, its
coordinates (RNAME a contig of the configuration, POS within it), its
SEQ and QUAL against the read the benchmark made, its CIGAR against the
contig (the read consumed whole inside it, NM recounted, AS
equal to the CIGAR's score, or at most it where the ends are
clipped), AS at or above the mapping floor, MAPQ in range; for a pair
also the mate fields against the mate's record (flags 0x8 and 0x20,
RNEXT ``=`` where the mates share a contig and the mate's RNAME
otherwise, PNEXT, TLEN from the two alignments' spans on one contig and
0 across two, 0x2 only on two
mapped mates, and on two unclipped mates exactly where they lie in FR
orientation inside the configuration's fragment range). NumPy only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from benchmark.gen.genome import CHARS, COMP, Layout
from benchmark.reference.align import cigar_score, parse_cigar

PAIRED, PROPER, UNMAPPED, MATE_UNMAPPED = 0x1, 0x2, 0x4, 0x8
REVERSE, MATE_REVERSE, FIRST, SECOND = 0x10, 0x20, 0x40, 0x80


@dataclass
class Rec:
    """One parsed record and what the checks derived from it."""

    read: np.ndarray          # codes as sequenced
    fields: list
    flag: int = 0
    mapped: bool = False
    strand: int = 0
    contig: int = -1          # the RNAME's contig in the layout
    pos0: int = -1            # leftmost aligned base, offset in the array
    diag: int = 0             # pos0 less the leading clip
    mapq: int = 0
    score: int = 0            # the CIGAR's own score
    span: int = 0
    clips: int = 0
    fits: bool = False        # the CIGAR fits the read at POS
    why: str = ""             # first rule broken, "" when none

    def oriented(self) -> np.ndarray:
        return COMP[self.read[::-1]] if self.strand else self.read


def min_score(calls: dict, length: int) -> int:
    return math.ceil(calls["min_score_frac"] * length)


def check_own(rec: Rec, genome: np.ndarray, layout: Layout, sc: dict,
              calls: dict, paired: bool) -> None:
    """The rules one record keeps on its own; sets ``rec.why`` on the
    first it breaks and fills the derived fields."""
    f = rec.fields
    if len(f) < 11:
        rec.why = "fewer than 11 fields"
        return
    try:
        flag, pos, mapq = int(f[1]), int(f[3]), int(f[4])
        int(f[7]), int(f[8])
    except ValueError:
        rec.why = "a number field is not a number"
        return
    rec.flag, rec.mapq = flag, mapq
    allowed = 0xFF if paired else (UNMAPPED | REVERSE)
    if flag & ~allowed:
        rec.why = f"flag {flag} has bits outside {allowed}"
        return
    rec.mapped = not flag & UNMAPPED
    rec.strand = int(bool(flag & REVERSE))
    L = rec.read.size
    seq = CHARS[rec.oriented()] if rec.mapped else CHARS[rec.read]
    if f[9] != seq.tobytes():
        rec.why = "SEQ is not the read"
        return
    qual = b"I" * L
    if f[10] != qual:
        rec.why = "QUAL is not the read's"
        return
    if not rec.mapped:
        if rec.strand:
            rec.why = "0x10 on an unmapped record"
        elif f[5] != b"*" or mapq != 0:
            rec.why = "CIGAR or MAPQ on an unmapped record"
        elif not paired and (f[2] != b"*" or pos != 0):
            rec.why = "RNAME or POS on an unmapped read"
        return
    c = layout.index(f[2])
    if c is None or pos < 1:
        rec.why = "RNAME or POS off the genome"
        return
    rec.contig = c
    if not 0 <= mapq <= calls["max_mapq"]:
        rec.why = f"MAPQ {mapq} out of range"
        return
    ops = parse_cigar(f[5])
    s, n = int(layout.starts[c]), int(layout.lengths[c])
    got = None if ops is None else cigar_score(ops, rec.oriented(),
                                               genome[s : s + n], pos - 1, sc)
    if got is None:
        rec.why = "CIGAR does not fit the read at POS"
        return
    rec.score, nm, rec.span, rec.clips = got
    rec.fits = True
    rec.pos0 = s + pos - 1
    rec.diag = rec.pos0 - (ops[0][0] if ops[0][1] == b"S" else 0)
    tags = {t[:2]: t[5:] for t in f[11:] if len(t) > 5}
    try:
        AS, NM = int(tags[b"AS"]), int(tags[b"NM"])
    except (KeyError, ValueError):
        rec.why = "AS or NM missing"
        return
    if NM != nm:
        rec.why = f"NM {NM}, the CIGAR at POS gives {nm}"
    elif (AS != rec.score) if rec.clips == 0 else (rec.score < AS):
        rec.why = f"AS {AS}, the CIGAR at POS scores {rec.score}"
    elif AS < min_score(calls, L):
        rec.why = f"AS {AS} below the mapping floor"
    elif not paired and (f[6] != b"*" or int(f[7]) or int(f[8])):
        rec.why = "mate fields on a single-end record"


def fr_proper(r1: Rec, r2: Rec, fragment) -> bool:
    """Two mapped mates in FR orientation inside ``fragment``: opposite
    strands, the forward mate's start at or before the reverse mate's,
    and from the one to the end of the other (the reverse mate's start
    plus its CIGAR's span) within [lo, hi]."""
    if (not (r1.mapped and r2.mapped) or r1.strand == r2.strand
            or r1.contig != r2.contig):
        return False
    fwd, rev = (r1, r2) if r1.strand == 0 else (r2, r1)
    tl = rev.pos0 - fwd.pos0 + rev.span
    return fwd.pos0 <= rev.pos0 and fragment[0] <= tl <= fragment[1]


def check_pair(r1: Rec, r2: Rec, fragment) -> None:
    """The mate fields of two records of one pair, each against the
    other (after check_own). Where both mates are mapped whole (no
    clip), 0x2 is set exactly when they lie in FR orientation inside
    ``fragment`` [lo, hi]."""
    whole = all(r.mapped and r.fits and not r.clips for r in (r1, r2))
    proper = whole and fr_proper(r1, r2, fragment)
    for me, mate, bit in ((r1, r2, FIRST), (r2, r1, SECOND)):
        if me.why:
            continue
        f, mf = me.fields, mate.fields
        if not me.flag & PAIRED or (me.flag & (FIRST | SECOND)) != bit:
            me.why = "0x1, 0x40 or 0x80 wrong"
        elif bool(me.flag & MATE_UNMAPPED) != (not mate.mapped):
            me.why = "0x8 disagrees with the mate"
        elif bool(me.flag & MATE_REVERSE) != (mate.mapped
                                              and mate.strand == 1):
            me.why = "0x20 disagrees with the mate"
        elif me.flag & PROPER and not (me.mapped and mate.mapped):
            me.why = "0x2 without two mapped mates"
        elif whole and bool(me.flag & PROPER) != proper:
            me.why = ("no 0x2 on mates in FR orientation inside the "
                      "fragment range" if proper else
                      "0x2 on mates outside FR orientation or the "
                      "fragment range")
        elif not me.mapped and mate.mapped and (f[2] != mf[2]
                                                or f[3] != mf[3]):
            me.why = "unmapped mate not placed at its mate"
        elif not me.mapped and not mate.mapped and (f[2] != b"*"
                                                    or f[3] != b"0"):
            me.why = "RNAME or POS on an unmapped pair"
        elif f[6] != rnext(me, mate):
            me.why = "RNEXT wrong"
        elif int(f[7]) != (int(mf[3]) if mate.mapped
                           else int(f[3]) if me.mapped else 0):
            me.why = "PNEXT wrong"
        elif int(f[8]) != tlen(me, mate, bit == FIRST):
            me.why = f"TLEN {int(f[8])}, the spans give "\
                     f"{tlen(me, mate, bit == FIRST)}"


def rnext(me: Rec, mate: Rec) -> bytes:
    """RNEXT of ``me`` (SAM v1.6): ``*`` with no mate mapped, the mate's
    RNAME where both are mapped on two contigs, else ``=`` (an unmapped
    mate sits at its mate's place)."""
    if not (me.mapped or mate.mapped):
        return b"*"
    if me.mapped and mate.mapped and me.contig != mate.contig:
        return mate.fields[2]
    return b"="


def tlen(me: Rec, mate: Rec, first: bool) -> int:
    """TLEN of ``me``: the outer span of two mapped mates on one contig,
    positive on the leftmost (R1 on a tie of starts when its end is not
    past the mate's), else 0."""
    if not (me.mapped and mate.mapped) or me.contig != mate.contig:
        return 0
    r1, r2 = (me, mate) if first else (mate, me)
    s1, e1 = r1.pos0, r1.pos0 + r1.span
    s2, e2 = r2.pos0, r2.pos0 + r2.span
    span = max(e1, e2) - min(s1, s2)
    t1 = span if (s1 < s2 or (s1 == s2 and e1 <= e2)) else -span
    return t1 if first else -t1
