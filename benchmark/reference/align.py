"""Plain alignment arithmetic of the reference: the best score of a read
against a genome window, and the score and edit distance of a CIGAR.

The scoring is the configuration's (``scores`` in its file): ``match``
and ``mismatch`` a base, a gap of n bases ``gap_open + gap_extend * (n -
1)``, ``clip_open`` for each soft-clipped end. A read is aligned whole
(end to end) and the genome ends are free; in clip mode each end of the
read may be left out instead, for ``clip_open`` an end.

Plain PyTorch (CPU or CUDA); no kernel, nothing of the program.
"""

from __future__ import annotations

import re

import numpy as np
import torch

NEG = -(1 << 40)
_CIGAR = re.compile(rb"(\d+)([MIDNSHP=X])")


def best_scores(reads: torch.Tensor, windows: torch.Tensor,
                clip: torch.Tensor, sc: dict) -> torch.Tensor:
    """Best score of each read against its window: reads uint8[n, L]
    (strand applied, codes 0-3, anything else never matches), windows
    uint8[n, W] (genome codes, 4 = N or off the genome, never matching),
    clip bool[n] (clip mode). Gotoh's recurrence row by row; within a
    row the deletions are a running maximum (a gap that opens from a
    deletion never beats extending it, since gap_open <= gap_extend).
    → int64[n]."""
    n, L = reads.shape
    W = windows.shape[1]
    dev = reads.device
    ma, mi = sc["match"], sc["mismatch"]
    go, ge, co = sc["gap_open"], sc["gap_extend"], sc["clip_open"]
    if go > ge:
        raise ValueError("gap_open above gap_extend: deletions chain")
    cols = torch.arange(W + 1, device=dev, dtype=torch.int64)
    win = windows.to(torch.int64)
    rd = reads.to(torch.int64)
    rd = torch.where(rd > 3, -1, rd)
    win = torch.where(win > 3, -2, win)
    H = torch.zeros((n, W + 1), dtype=torch.int64, device=dev)
    F = torch.full((n, W + 1), NEG, dtype=torch.int64, device=dev)
    start = torch.where(clip, co, NEG).to(torch.int64)[:, None]
    # ending early: every row above the last, plus one clip
    cend = H.amax(dim=1) + co
    for i in range(1, L + 1):
        s = torch.where(win == rd[:, i - 1 : i], ma, mi)
        F = torch.maximum(H + go, F + ge)
        Hp = F.clone()
        Hp[:, 1:] = torch.maximum(Hp[:, 1:], H[:, :-1] + s)
        Hp = torch.maximum(Hp, start)
        A = Hp + go - ge * (cols + 1)
        cm = torch.cummax(A, dim=1).values
        E = torch.full_like(Hp, NEG)
        E[:, 1:] = ge * cols[1:] + cm[:, :-1]
        H = torch.maximum(Hp, E)
        if i < L:
            cend = torch.maximum(cend, H.amax(dim=1) + co)
    e2e = H.amax(dim=1)
    return torch.where(clip, torch.maximum(e2e, cend), e2e)


def parse_cigar(cigar: bytes) -> list[tuple[int, bytes]] | None:
    """[(length, op), ...] or None when the string is not a CIGAR."""
    ops = [(int(n), op) for n, op in _CIGAR.findall(cigar)]
    if not ops or b"".join(b"%d%s" % o for o in ops) != cigar:
        return None
    return ops


def cigar_score(ops, read: np.ndarray, genome: np.ndarray, pos: int,
                sc: dict):
    """Score, NM, genome span and soft-clipped ends of the alignment a
    CIGAR states for ``read`` (strand applied) at 0-based ``pos``;
    None where it does not fit (ops other than M/I/D/S, clips inside,
    the read not consumed whole, the genome left)."""
    ma, mi = sc["match"], sc["mismatch"]
    go, ge = sc["gap_open"], sc["gap_extend"]
    i, j, score, nm, clips = 0, pos, 0, 0, 0
    for k, (n, op) in enumerate(ops):
        if n <= 0:
            return None
        if op == b"M":
            if j < 0 or j + n > genome.size:
                return None
            mm = int(np.count_nonzero(genome[j : j + n] != read[i : i + n]))
            score += (n - mm) * ma + mm * mi
            nm += mm
            i += n
            j += n
        elif op in (b"I", b"D"):
            score += go + ge * (n - 1)
            nm += n
            if op == b"I":
                i += n
            else:
                j += n
        elif op == b"S" and k in (0, len(ops) - 1):
            clips += 1
            i += n
        else:
            return None
    if i != read.size:
        return None
    return score + clips * sc["clip_open"], nm, j - pos, clips
