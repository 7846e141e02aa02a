"""The reference's own index: every genome position of each N-free
k-mer that the sampled reads hold (on either strand), exactly, sorted by
its 2-bit code and then by position. It is worked out again from the
genome the benchmark made, and shares nothing with the program's hashed
index. The genome is scanned a chunk at a time, so the card holds one
chunk's codes, not the whole genome's.

One departure from an index sorted by code alone: where a k-mer has
more than ``cap`` hits, ``diagonals`` takes the ``cap`` lowest
positions (before, whichever the sort put first; on the benchmark's
random genomes no 24-mer has that many copies).

Plain PyTorch (CPU or CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 27     # genome bases scanned at a time


def kmer_codes(codes: torch.Tensor, k: int):
    """codes uint8[..., n] → (int64[..., n - k + 1] 2-bit codes, bool
    valid: no base outside 0-3 in the k-mer)."""
    m = codes.shape[-1] - k + 1
    out = torch.zeros(codes.shape[:-1] + (m,), dtype=torch.int64,
                      device=codes.device)
    bad = torch.zeros(out.shape, dtype=torch.bool, device=codes.device)
    for t in range(k):
        c = codes[..., t : t + m]
        out.mul_(4).add_(c & 3)
        bad |= c > 3
    return out, ~bad


class KmerIndex:
    """Exact positions of the N-free k-mers of ``genome`` that ``reads``
    (uint8[..., L], each strand as it will be looked up) hold."""

    def __init__(self, genome: np.ndarray, k: int, device,
                 reads: torch.Tensor, chunk: int = CHUNK):
        code, ok = kmer_codes(reads.to(device), k)
        want = torch.unique(code[ok])            # sorted
        codes, pos = [], []
        for c0 in range(0, genome.size - k + 1 if want.numel() else 0,
                        chunk):
            piece = torch.from_numpy(genome[c0 : c0 + chunk + k - 1])
            code, ok = kmer_codes(piece.to(device), k)
            at = torch.searchsorted(want, code).clamp_(max=want.numel() - 1)
            p = torch.nonzero(ok & (want[at] == code))[:, 0]
            codes.append(code[p])
            pos.append(p + c0)
            del piece, code, ok, at     # before the next chunk's
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        code = torch.cat(codes) if codes else empty
        # positions ascend chunk after chunk: a stable sort by code
        # leaves each code's positions ascending
        self.codes, order = torch.sort(code, stable=True)
        self.pos = (torch.cat(pos) if pos else empty)[order]
        self.k = k
        self.device = device

    def diagonals(self, reads: torch.Tensor, cap: int = 8):
        """reads uint8[n, L] (strand applied) → (row, diagonal) int64
        arrays of every exact k-mer hit, ``cap`` at most per k-mer
        (diagonal = genome position - offset in the read)."""
        code, ok = kmer_codes(reads.to(self.device), self.k)
        lo = torch.searchsorted(self.codes, code, right=False)
        hi = torch.searchsorted(self.codes, code, right=True)
        n, m = code.shape
        off = torch.arange(m, device=self.device)[None, :]
        rows, diags = [], []
        for c in range(cap):
            at = lo + c
            hit = ok & (at < hi)
            r, o = torch.nonzero(hit, as_tuple=True)
            if r.numel() == 0:
                break
            rows.append(r)
            diags.append(self.pos[at[r, o]] - off[0, o])
        if not rows:
            empty = np.zeros(0, np.int64)
            return empty, empty
        return (torch.cat(rows).cpu().numpy(),
                torch.cat(diags).cpu().numpy())


def clusters(rows: np.ndarray, diags: np.ndarray, gap: int):
    """Diagonals of one read strand that lie within ``gap`` of the next
    form one locus → (row, lowest diagonal, highest diagonal) arrays."""
    if rows.size == 0:
        e = np.zeros(0, np.int64)
        return e, e, e
    o = np.lexsort((diags, rows))
    r, d = rows[o], diags[o]
    new = np.ones(r.size, bool)
    new[1:] = (r[1:] != r[:-1]) | (d[1:] - d[:-1] > gap)
    first = np.flatnonzero(new)
    last = np.concatenate([first[1:], [r.size]]) - 1
    return r[first], d[first], d[last]
