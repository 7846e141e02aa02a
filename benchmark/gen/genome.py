"""The synthetic reference genome of a configuration, from the seed.

NumPy only: the yardstick does not change with the program, so nothing
here imports the mapper.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# the DNA alphabet the FASTA and FASTQ files use (codes 0-3, N = 4)
CHARS = np.frombuffer(b"ACGTN", np.uint8)
GENOME_N = 4
# complement of codes A C G T N
COMP = np.array([3, 2, 1, 0, 4], np.uint8)
# N between two contigs in the benchmark's own array: more than any
# window the reference aligns (a locus with its margins, a mate's
# fragment window), so none reaches from one contig into the next
SEPARATOR = 10_000
FASTA_CHUNK = 80 << 20      # bases a FASTA write takes at a time
RUN_CHUNK = 1 << 26         # bases the N-free stretches are found in at a time


# chip_smoke.py:make_genome (lengths and run counts from the config)
def make_genome(rng, n: int, leading_n: int, interior_runs: int,
                interior_len: tuple[int, int]) -> np.ndarray:
    """Random ACGT codes with a few N runs (a long leading one, as on
    chr21, and short interior ones)."""
    g = rng.integers(0, 4, size=n, dtype=np.uint8)
    g[:leading_n] = GENOME_N
    lo, hi = interior_len
    margin = min(1_000_000, n // 4)
    for s in rng.integers(margin, n - margin, size=interior_runs):
        g[s : s + int(rng.integers(lo, hi))] = GENOME_N
    return g


# chip_smoke.py:write_fasta, one record a contig, written in chunks
def write_fasta(path: str, codes: np.ndarray, layout: "Layout",
                chunk: int = FASTA_CHUNK) -> None:
    """One record a contig, 80 bases a line; the host holds one chunk's
    copy of the sequence at a time (``chunk`` a multiple of 80)."""
    width = 80
    with open(path, "wb") as f:
        for name, s, n in zip(layout.names, layout.starts, layout.lengths):
            f.write(f">{name}\n".encode())
            full = n // width * width
            for a in range(0, full, chunk):
                b = min(a + chunk, full)
                lines = np.empty(((b - a) // width, width + 1), np.uint8)
                lines[:, :width] = CHARS[codes[s + a : s + b]].reshape(
                    -1, width)
                lines[:, width] = ord("\n")
                f.write(lines.tobytes())
            f.write(CHARS[codes[s + full : s + n]].tobytes() + b"\n")


@dataclass(frozen=True)
class Layout:
    """The contigs of a configuration in the benchmark's own genome array:
    each contig's name, length and start, one after the other with
    ``SEPARATOR`` bases of N between two."""

    names: tuple
    lengths: np.ndarray       # int64
    starts: np.ndarray        # int64, offsets in the array

    @classmethod
    def of(cls, contigs) -> "Layout":
        """From [(name, length), ...]."""
        names = tuple(str(c[0]) for c in contigs)
        lengths = np.array([int(c[1]) for c in contigs], np.int64)
        starts = np.concatenate([[0], np.cumsum(lengths[:-1] + SEPARATOR)])
        return cls(names, lengths, starts.astype(np.int64))

    @classmethod
    def from_config(cls, cfg: dict) -> "Layout":
        """``contigs`` [[name, length], ...], or one sequence named
        ``genome_label`` of ``genome_length`` bases."""
        return cls.of(cfg.get("contigs")
                      or [(cfg["genome_label"], cfg["genome_length"])])

    @property
    def size(self) -> int:
        return int(self.starts[-1] + self.lengths[-1])

    def index(self, name: bytes) -> int | None:
        """The contig named ``name`` (a SAM RNAME), None if none is."""
        try:
            return self.names.index(name.decode())
        except (ValueError, UnicodeDecodeError):
            return None

    def offset(self, name: bytes, pos1: int) -> int:
        """(RNAME, 1-based POS) → offset in the array."""
        return int(self.starts[self.names.index(name.decode())]) + pos1 - 1

    def locate(self, offset: int) -> tuple[str, int]:
        """Offset in the array → (contig name, 1-based POS)."""
        i = int(np.searchsorted(self.starts, offset, side="right")) - 1
        return self.names[i], offset - int(self.starts[i]) + 1


def genome_from_config(seed: int, cfg: dict) -> np.ndarray:
    """The genome a configuration asks for, from streams of the seed of
    its own, so the reads do not shift it: one sequence
    (``genome_length``) from ``[seed, 1]``, or with ``contigs`` each
    contig from ``[seed, 1, i]``, so one contig's length does not shift
    another's bases. ``leading_n``, ``interior_n_runs`` and
    ``interior_n_len`` apply to each contig."""
    runs_of_n = (int(cfg["leading_n"]), int(cfg["interior_n_runs"]),
                tuple(cfg["interior_n_len"]))
    if "contigs" not in cfg:
        rng = np.random.default_rng([seed, 1])
        return make_genome(rng, int(cfg["genome_length"]), *runs_of_n)
    layout = Layout.from_config(cfg)
    g = np.full(layout.size, GENOME_N, np.uint8)
    for i, (s, n) in enumerate(zip(layout.starts, layout.lengths)):
        rng = np.random.default_rng([seed, 1, i])
        g[s : s + n] = make_genome(rng, int(n), *runs_of_n)
    return g


def free_runs(g: np.ndarray, chunk: int = RUN_CHUNK):
    """(starts, ends) int64 of the maximal N-free stretches of ``g``,
    ascending, found ``chunk`` bases at a time."""
    cuts = []
    prev = True                     # before the genome: N
    for c0 in range(0, g.size, chunk):
        isn = g[c0 : c0 + chunk] >= GENOME_N
        if isn[0] != prev:
            cuts.append(np.array([c0]))
        cuts.append(np.flatnonzero(isn[1:] != isn[:-1]) + (c0 + 1))
        prev = bool(isn[-1])
    if not prev:
        cuts.append(np.array([g.size]))
    b = np.concatenate(cuts or [np.zeros(0)]).astype(np.int64)
    return b[0::2], b[1::2]


def draw_starts(rng, g: np.ndarray, span: int, n: int,
                chunk: int = RUN_CHUNK) -> np.ndarray:
    """``n`` starts p drawn uniformly among those whose ``g[p : p +
    span]`` holds no N: the r-th such start, in ascending order, for
    each of ``rng.integers(0, count, size=n)``. Counted over the N-free
    stretches, never a whole-genome array: a start never reaches across
    an N, so never from one contig into the next."""
    s, e = free_runs(g, chunk)
    per = np.maximum(e - s - span + 1, 0)
    before = np.cumsum(per)
    total = int(before[-1]) if before.size else 0
    if total == 0:
        raise ValueError("no N-free window of the asked span in the genome")
    r = rng.integers(0, total, size=n)
    i = np.searchsorted(before, r, side="right")
    return (s[i] + r - (before[i] - per[i])).astype(np.int64)
