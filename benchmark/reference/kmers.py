"""The reference's own index: every N-free k-mer of the genome, exactly,
sorted by its 2-bit code. It is worked out again from the genome the
benchmark made, and shares nothing with the program's hashed index.

Plain PyTorch (CPU or CUDA).
"""

from __future__ import annotations

import numpy as np
import torch


def kmer_codes(codes: torch.Tensor, k: int):
    """codes uint8[..., n] → (int64[..., n - k + 1] 2-bit codes, bool
    valid: no base outside 0-3 in the k-mer)."""
    m = codes.shape[-1] - k + 1
    out = torch.zeros(codes.shape[:-1] + (m,), dtype=torch.int64,
                      device=codes.device)
    bad = torch.zeros(out.shape, dtype=torch.bool, device=codes.device)
    for t in range(k):
        c = codes[..., t : t + m]
        out = out * 4 + (c & 3).to(torch.int64)
        bad |= c > 3
    return out, ~bad


class KmerIndex:
    """Exact positions of every N-free k-mer of ``genome``."""

    def __init__(self, genome: np.ndarray, k: int, device):
        g = torch.from_numpy(np.ascontiguousarray(genome)).to(device)
        code, ok = kmer_codes(g, k)
        pos = torch.nonzero(ok)[:, 0]
        self.codes, order = torch.sort(code[pos])
        self.pos = pos[order]
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
