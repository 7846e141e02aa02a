"""The synthetic reference genome of a configuration, from the seed.

NumPy only: the yardstick does not change with the program, so nothing
here imports the mapper.
"""

from __future__ import annotations

import numpy as np

# the DNA alphabet the FASTA and FASTQ files use (codes 0-3, N = 4)
CHARS = np.frombuffer(b"ACGTN", np.uint8)
GENOME_N = 4
# complement of codes A C G T N
COMP = np.array([3, 2, 1, 0, 4], np.uint8)


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


# chip_smoke.py:write_fasta
def write_fasta(path: str, codes: np.ndarray, label: str) -> None:
    chars = CHARS[codes]
    width = 80
    full = len(chars) // width * width
    lines = chars[:full].reshape(-1, width)
    nl = np.full((len(lines), 1), ord("\n"), np.uint8)
    with open(path, "wb") as f:
        f.write(f">{label}\n".encode())
        f.write(np.hstack([lines, nl]).tobytes())
        f.write(chars[full:].tobytes() + b"\n")


def genome_from_config(seed: int, cfg: dict) -> np.ndarray:
    """The genome a configuration asks for (``genome_length``,
    ``leading_n``, ``interior_n_runs``, ``interior_n_len``), from a
    stream of the seed of its own, so the reads do not shift it."""
    rng = np.random.default_rng([seed, 1])
    return make_genome(rng, int(cfg["genome_length"]), int(cfg["leading_n"]),
                       int(cfg["interior_n_runs"]),
                       tuple(cfg["interior_n_len"]))


def valid_starts(g: np.ndarray, span: int) -> np.ndarray:
    """bool per start p: genome[p : p + span] holds no N (False where
    the span runs past the end)."""
    isn = np.concatenate([[0], np.cumsum(g >= GENOME_N)])
    ok = np.zeros(len(g), bool)
    m = len(g) - span + 1
    if m > 0:
        ok[:m] = isn[span : span + m] - isn[:m] == 0
    return ok


def draw_starts(rng, ok: np.ndarray, n: int) -> np.ndarray:
    """``n`` starts drawn uniformly among the True entries of ``ok``."""
    where = np.flatnonzero(ok)
    if where.size == 0:
        raise ValueError("no N-free window of the asked span in the genome")
    return where[rng.integers(0, where.size, size=n)].astype(np.int64)
