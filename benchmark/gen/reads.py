"""Single-end planted reads: the generator that ``traffic/*.json`` files
with ``"generator": "reads"`` name.

A copy, in NumPy only, of chip_smoke.py:plant_reads with bench.py's
vectorised indel planting (urmap_tpu_torch/tools/synth.py:plant_indels,
itself bench.py's), changed in one way: every share is an exact count,
so each seed gives the same number of reads of each kind, in another
order and at other places.

Parameters (the traffic file's ``params``): ``reads``, ``read_len``,
``snp_rate`` (per base), ``indel_share`` (reads with one indel of
``indel_len`` [lo, hi] bases, deletion or insertion), ``adapter_share``
(reads whose last ``adapter_len`` [lo, hi] bases are random),
``junk_share`` (random reads).
"""

from __future__ import annotations

import numpy as np

from benchmark.gen.genome import COMP, draw_starts

NORMAL, INDEL, ADAPTER, JUNK = 0, 1, 2, 3


def exact_kinds(rng, n: int, shares: list[float]) -> np.ndarray:
    """Kind per read with exactly round(n * share) of each kind > 0,
    the rest kind 0, in an order drawn from ``rng``."""
    kind = np.zeros(n, np.int8)
    at = 0
    for k, share in enumerate(shares, start=1):
        c = int(round(n * share))
        kind[at : at + c] = k
        at += c
    if at > n:
        raise ValueError(f"shares {shares} add up to more than 1")
    return rng.permutation(kind)


# urmap_tpu_torch/tools/synth.py:plant_indels (bench.py's), offsets as
# chip_smoke.py:plant_reads draws them
def plant_indels(rng, g, pos, length, sizes, margin=8):
    """Rows of reads at genome starts ``pos`` with one indel of
    ``sizes`` bases each, at an offset in [margin, length - margin):
    a deletion skips that many genome bases, an insertion carries that
    many random bases. The leftmost aligned base stays ``pos``."""
    k = pos.size
    m = rng.integers(margin, length - margin, size=k)[:, None]
    s = sizes[:, None]
    isdel = rng.random(k)[:, None] < 0.5
    j = np.arange(length)[None, :]
    p = pos[:, None]
    didx = p + j + np.where(j >= m, s, 0)
    iidx = p + j - np.clip(j - m, 0, s)
    new = g[np.where(isdel, didx, iidx)]
    insmask = ~isdel & (j >= m) & (j < m + s)
    rnd = rng.integers(0, 4, size=new.shape).astype(new.dtype)
    return np.where(insmask, rnd, new)


def substitute(rng, codes: np.ndarray, rate: float, rows: np.ndarray):
    """Per-base substitutions at ``rate`` in the rows ``rows`` (bool)."""
    snp = (rng.random(codes.shape, dtype=np.float32) < rate) & rows[:, None]
    codes[snp] = (codes[snp] + rng.integers(1, 4, int(snp.sum()))) % 4


CHUNK = 1 << 16   # rows built at a time (bounds the host memory)


def generate(seed: int, g: np.ndarray, params: dict) -> dict:
    """→ {"codes": uint8[n, L] as sequenced, "truth": {"pos": int64
    (-1 for junk), "strand": int8, "kind": int8}}."""
    rng = np.random.default_rng([seed, 2])
    n, L = int(params["reads"]), int(params["read_len"])
    lo_i, hi_i = params.get("indel_len", [1, 8])
    kind = exact_kinds(rng, n, [params.get("indel_share", 0.0),
                                params.get("adapter_share", 0.0),
                                params.get("junk_share", 0.0)])
    pos = draw_starts(rng, g, L + hi_i + 8, n)
    strand = rng.integers(0, 2, size=n).astype(np.int8)
    codes = np.empty((n, L), np.uint8)
    for s in range(0, n, CHUNK):
        sl = slice(s, min(s + CHUNK, n))
        codes[sl] = make_rows(rng, g, pos[sl], kind[sl], strand[sl], L,
                              params)
    return {"codes": codes,
            "truth": {"pos": np.where(kind == JUNK, -1, pos),
                      "strand": strand, "kind": kind}}


def make_rows(rng, g, pos, kind, strand, L: int, params: dict):
    """One chunk of reads as sequenced."""
    lo_i, hi_i = params.get("indel_len", [1, 8])
    codes = g[pos[:, None] + np.arange(L)[None, :]]
    ind = np.flatnonzero(kind == INDEL)
    if ind.size:
        sizes = rng.integers(lo_i, hi_i + 1, size=ind.size)
        codes[ind] = plant_indels(rng, g, pos[ind], L, sizes)
    ad = np.flatnonzero(kind == ADAPTER)
    if ad.size:
        lo_a, hi_a = params["adapter_len"]
        t = rng.integers(lo_a, hi_a + 1, size=ad.size)[:, None]
        tail = np.arange(L)[None, :] >= L - t
        codes[ad] = np.where(tail, rng.integers(0, 4, (ad.size, L)),
                             codes[ad])
    substitute(rng, codes, float(params.get("snp_rate", 0.0)), kind != JUNK)
    junk = kind == JUNK
    codes[junk] = rng.integers(0, 4, (int(junk.sum()), L))
    rc = COMP[codes[:, ::-1]]
    return np.where(strand[:, None] == 1, rc, codes).astype(np.uint8)
