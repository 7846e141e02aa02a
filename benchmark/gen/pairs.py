"""FR read pairs: the generator that ``traffic/*.json`` files with
``"generator": "pairs"`` name.

A copy, in NumPy only, of chip_smoke.py:plant_pairs with the indel
planting of gen/reads.py (bench.py's, vectorised), changed in one way:
every share is an exact count, so each seed gives the same number of
pairs of each kind, in another order and at other places.

Parameters (the traffic file's ``params``): ``pairs``, ``read_len``,
``fragment`` [lo, hi] (inclusive), ``snp_rate`` (per base),
``indel_share`` (pairs with one 1-8 bp indel in one mate),
``rescue_share`` (pairs with one mate changed at every 15th base, so no
24-mer of it survives and only the mate rescue places it),
``junk_share`` (both mates random).
"""

from __future__ import annotations

import numpy as np

from benchmark.gen.genome import COMP, draw_starts
from benchmark.gen.reads import CHUNK, exact_kinds, plant_indels, substitute

NORMAL, INDEL, RESCUE, JUNK = 0, 1, 2, 3


def generate(seed: int, g: np.ndarray, params: dict) -> dict:
    """→ {"codes": uint8[n, L] mate 1, "codes2": mate 2 (as sequenced),
    "truth": {"pos", "pos2" int64 (-1 for junk), "strand", "strand2",
    "kind", "mutated" (1 or 2: the mate changed)}}."""
    rng = np.random.default_rng([seed, 3])
    n, L = int(params["pairs"]), int(params["read_len"])
    flo, fhi = params["fragment"]
    kind = exact_kinds(rng, n, [params.get("indel_share", 0.0),
                                params.get("rescue_share", 0.0),
                                params.get("junk_share", 0.0)])
    frag = rng.integers(flo, fhi + 1, size=n)
    fs = draw_starts(rng, g, fhi + 32, n)
    pos = np.stack([fs, fs + frag - L])          # left, right mate
    which = rng.integers(0, 2, size=n)           # the altered mate
    r1_left = rng.integers(0, 2, size=n).astype(bool)
    c1 = np.empty((n, L), np.uint8)
    c2 = np.empty((n, L), np.uint8)
    for s in range(0, n, CHUNK):
        sl = slice(s, min(s + CHUNK, n))
        c1[sl], c2[sl] = make_rows(rng, g, pos[:, sl], kind[sl], which[sl],
                                   r1_left[sl], L, params)
    junk = kind == JUNK
    return {"codes": c1, "codes2": c2, "truth": {
        "pos": np.where(junk, -1, np.where(r1_left, pos[0], pos[1])),
        "pos2": np.where(junk, -1, np.where(r1_left, pos[1], pos[0])),
        "strand": (~r1_left).astype(np.int8),
        "strand2": r1_left.astype(np.int8),
        "kind": kind,
        "mutated": np.where((which == 0) == r1_left, 1, 2).astype(np.int8)}}


def make_rows(rng, g, pos, kind, which, r1_left, L: int, params: dict):
    """One chunk of pairs → (mate 1, mate 2) as sequenced."""
    mates = [g[pp[:, None] + np.arange(L)[None, :]] for pp in pos]
    junk = kind == JUNK
    for m in (0, 1):
        ind = np.flatnonzero((kind == INDEL) & (which == m))
        if ind.size:
            sizes = rng.integers(1, 9, size=ind.size)
            mates[m][ind] = plant_indels(rng, g, pos[m][ind], L, sizes)
    grid = np.arange(7, L, 15)
    for m in (0, 1):
        c = mates[m]
        substitute(rng, c, float(params.get("snp_rate", 0.0)), ~junk)
        mut = np.flatnonzero((kind == RESCUE) & (which == m))
        c[np.ix_(mut, grid)] = (c[np.ix_(mut, grid)] + rng.integers(
            1, 4, (mut.size, grid.size))) % 4
        c[junk] = rng.integers(0, 4, (int(junk.sum()), L))
    left, right = mates[0], COMP[mates[1][:, ::-1]]
    c1 = np.where(r1_left[:, None], left, right).astype(np.uint8)
    c2 = np.where(r1_left[:, None], right, left).astype(np.uint8)
    return c1, c2
