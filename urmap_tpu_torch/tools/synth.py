"""Synthetic genomes and planted reads for the port's tools.

Copies, each under a comment line naming its source, with the package
name replaced: bench.py's vectorised read synthesis (indel planting,
single-end reads, FR pairs, FASTQ writing), which tools/a2a_rounds.py
and tools/make_g38_corpus.py take, and tests/utils.py's planted reads
and pairs, which tools/make_verify_corpus.py takes. The tools of this
package cannot import either file, since each of them loads
urmap_tpu.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from urmap_tpu_torch import alphabet
from urmap_tpu_torch.io.fasta import SeqDB


# bench.py:plant_indels
def plant_indels(rng, codes, pos, db, length, frac, max_sz=8):
    """Replace ~``frac`` of rows IN PLACE with reads carrying one 1 to
    ``max_sz`` bp insertion or deletion (tools/accuracy.py's profile),
    so the bench exercises the DP bucket + gapped-CIGAR path under load
    (round-3 verdict weak item 5: SNP-only reads never left the
    ungapped lane). The truth coordinate — the LEFTMOST aligned genome
    base — is unchanged by construction: reads keep genome bases
    [pos, pos+m) before the event, then either skip ``s`` genome bases
    (deletion) or carry ``s`` random inserted bases."""
    n, start = codes.shape[0], int(db.starts[0])
    ref_end = start + int(db.lengths[0])
    ok = pos <= ref_end - length - max_sz - 1   # deletion tail in range
    sel = np.nonzero((rng.random(n) < frac) & ok)[0]
    if sel.size == 0:
        return
    k = sel.size
    m = rng.integers(24, length - 24 - max_sz, size=k)[:, None]
    s = rng.integers(1, max_sz + 1, size=k)[:, None]
    isdel = rng.random(k)[:, None] < 0.5
    j = np.arange(length)[None, :]
    p = pos[sel, None]
    didx = p + j + np.where(j >= m, s, 0)          # skip s genome bases
    iidx = p + j - np.clip(j - m, 0, s)            # repeat frame after m
    new = db.codes[np.where(isdel, didx, iidx)]
    insmask = ~isdel & (j >= m) & (j < m + s)
    rnd = rng.integers(0, 4, size=new.shape).astype(new.dtype)
    codes[sel] = np.where(insmask, rnd, new)


# bench.py:synth_reads
def synth_reads(rng, db, n, length, snp_rate=0.01, indel_frac=0.0):
    """Vectorized planted reads: codes uint8[n, length], truth positions."""
    from urmap_tpu_torch import alphabet

    ref_len = int(db.lengths[0])
    start = int(db.starts[0])
    pos = rng.integers(0, ref_len - length, size=n).astype(np.int64) + start
    idx = pos[:, None] + np.arange(length)[None, :]
    codes = db.codes[idx].copy()
    if indel_frac > 0:
        plant_indels(rng, codes, pos, db, length, indel_frac)
    # SNPs
    mask = rng.random(codes.shape) < snp_rate
    codes[mask] = (codes[mask] + rng.integers(1, 4, size=int(mask.sum()))) % 4
    # strands
    strand = rng.integers(0, 2, size=n).astype(np.int8)
    rc = alphabet.COMP_CODE[codes[:, ::-1]]
    codes = np.where(strand[:, None] == 1, rc, codes)
    return codes.astype(np.uint8), pos, strand


# bench.py:synth_pairs
def synth_pairs(rng, db, n_pairs, length, snp_rate=0.01,
                frag_lo=200, frag_hi=800, indel_frac=0.0):
    """Vectorized FR pairs: (r1 codes, r2 codes, truth pos per mate)."""
    from urmap_tpu_torch import alphabet

    ref_len = int(db.lengths[0])
    start = int(db.starts[0])
    frag = rng.integers(frag_lo, frag_hi, size=n_pairs).astype(np.int64)
    p = rng.integers(0, ref_len - frag_hi - 8, size=n_pairs).astype(np.int64) \
        + start
    li = p[:, None] + np.arange(length)[None, :]
    ri = (p + frag - length)[:, None] + np.arange(length)[None, :]
    left = db.codes[li].copy()
    right = db.codes[ri].copy()
    if indel_frac > 0:
        plant_indels(rng, left, p, db, length, indel_frac)
        plant_indels(rng, right, p + frag - length, db, length, indel_frac)
    for c in (left, right):
        mask = rng.random(c.shape) < snp_rate
        c[mask] = (c[mask] + rng.integers(1, 4, size=int(mask.sum()))) % 4
    # R1 = fwd fragment start, R2 = rc of fragment end (FR), half swapped
    r1_fwd = rng.integers(0, 2, size=n_pairs).astype(bool)
    right_rc = alphabet.COMP_CODE[right[:, ::-1]]
    r1 = np.where(r1_fwd[:, None], left, right_rc).astype(np.uint8)
    r2 = np.where(r1_fwd[:, None], right_rc, left).astype(np.uint8)
    t1 = np.where(r1_fwd, p, p + frag - length)
    t2 = np.where(r1_fwd, p + frag - length, p)
    return r1, r2, t1, t2


# bench.py:write_fastq
def write_fastq(path, codes, read_len, name_prefix=b"r"):
    code_to_char = np.frombuffer(b"ACGTNN", np.uint8)
    qual_row = b"I" * read_len
    with open(path, "wb") as f:
        chunk = []
        for i in range(len(codes)):
            chunk.append(b"@%s%d\n%s\n+\n%s\n"
                         % (name_prefix, i, code_to_char[codes[i]].tobytes(),
                            qual_row))
            if len(chunk) == 50000:
                f.write(b"".join(chunk)); chunk = []
        f.write(b"".join(chunk))


# tests/utils.py:random_seq
def random_seq(rng, n: int) -> str:
    return alphabet.decode(rng.integers(0, 4, size=n).astype(np.uint8))


# tests/utils.py:make_seqdb
def make_seqdb(rng, lengths: list[int]) -> SeqDB:
    labels = [f"chr{i + 1}" for i in range(len(lengths))]
    return SeqDB.from_seqs(labels, [random_seq(rng, n) for n in lengths])


# tests/utils.py:PlantedRead
@dataclass
class PlantedRead:
    codes: np.ndarray          # read codes as sequenced (strand applied)
    gpos: int                  # global genome pos of alignment start (truth)
    strand: int                # 0 fwd, 1 rc
    n_snps: int = 0
    indels: list[tuple[int, int]] = field(default_factory=list)  # (read_off, +ins/-del)

    @property
    def seq(self) -> str:
        return alphabet.decode(self.codes)


# tests/utils.py:plant_read
def plant_read(rng, db: SeqDB, *, length: int = 150, strand: int | None = None,
               n_snps: int = 0, ins: int = 0, dels: int = 0,
               gpos: int | None = None) -> PlantedRead:
    """Sample a read from the genome with optional SNPs and one indel each
    way, then optionally reverse-complement it (strand=1)."""
    if strand is None:
        strand = int(rng.integers(0, 2))
    # choose a position fully inside one sequence, leaving indel slack
    slack = length + dels + 8
    if gpos is None:
        ref = int(rng.integers(0, db.num_seqs))
        local = int(rng.integers(0, int(db.lengths[ref]) - slack))
        gpos = int(db.starts[ref]) + local
    frag = db.codes[gpos : gpos + length + dels].copy()

    indels: list[tuple[int, int]] = []
    if dels:
        off = int(rng.integers(8, length - 8))
        frag = np.concatenate([frag[:off], frag[off + dels:]])
        indels.append((off, -dels))
    frag = frag[:length - ins] if ins else frag[:length]
    if ins:
        off = int(rng.integers(8, len(frag) - 8))
        insert = rng.integers(0, 4, size=ins).astype(np.uint8)
        frag = np.concatenate([frag[:off], insert, frag[off:]])
        indels.append((off, ins))
    frag = frag[:length]

    n_planted = 0
    if n_snps:
        offs = rng.choice(len(frag), size=n_snps, replace=False)
        for o in offs:
            frag[o] = (frag[o] + int(rng.integers(1, 4))) % 4
            n_planted += 1
    if strand == 1:
        frag = alphabet.revcomp(frag)
    return PlantedRead(codes=frag.astype(np.uint8), gpos=gpos, strand=strand,
                       n_snps=n_planted, indels=indels)


# tests/utils.py:plant_pair
def plant_pair(rng, db: SeqDB, *, length: int = 100, frag: int = 300,
               n_snps: int = 0, r1_fwd: bool | None = None,
               snp_every: int | None = None):
    """Plant an FR pair: fragment of ``frag`` bases; R1/R2 from its two
    ends. Returns (r1, r2, frag_start) with reads as sequenced (R1 fwd +
    R2 rc of the fragment ends when r1_fwd, else swapped).
    ``snp_every``: mutate every Nth base of R2 (to defeat seeding and
    exercise mate rescue)."""
    ref = int(rng.integers(0, db.num_seqs))
    local = int(rng.integers(0, int(db.lengths[ref]) - frag - 8))
    gpos = int(db.starts[ref]) + local
    left = db.codes[gpos : gpos + length].copy()
    right = db.codes[gpos + frag - length : gpos + frag].copy()

    def snp(codes, n):
        for o in rng.choice(len(codes), size=n, replace=False):
            codes[o] = (codes[o] + int(rng.integers(1, 4))) % 4
        return codes

    left = snp(left, n_snps) if n_snps else left
    right = snp(right, n_snps) if n_snps else right
    if r1_fwd is None:
        r1_fwd = bool(rng.integers(0, 2))
    if r1_fwd:
        r1c, r1p, r1s = left, gpos, 0
        r2c, r2p, r2s = alphabet.revcomp(right), gpos + frag - length, 1
    else:
        r1c, r1p, r1s = alphabet.revcomp(right), gpos + frag - length, 1
        r2c, r2p, r2s = left, gpos, 0
    if snp_every:
        # mutate the as-sequenced R2 at a regular grid
        for o in range(snp_every // 2, len(r2c), snp_every):
            r2c[o] = (r2c[o] + int(rng.integers(1, 4))) % 4
    r1 = PlantedRead(codes=r1c.astype(np.uint8), gpos=r1p, strand=r1s)
    r2 = PlantedRead(codes=r2c.astype(np.uint8), gpos=r2p, strand=r2s)
    return r1, r2, gpos
