"""Banded semi-global affine-gap DP, batched over candidates.

``banded_from_windows`` is the plain PyTorch version of kernel B1
(kernels/banded_dp.py): rows advance in a Python loop, the band of
W = 2*hw+1 diagonals lives on the last axis. Semantics are those of
urmap_tpu/map/dp.py and its Pallas kernel:

  - the read aligns in full; gaps are affine (open = first base,
    extend = each further base);
  - the alignment may start at any offset d0 in [-hw, +hw] from the
    candidate start and ends freely;
  - the start rides through the DP packed with the score,
    packed = score * S + (d0 + hw), so every max tie-breaks toward the
    larger d0, deterministically;
  - ``clip_open``: the alignment may also enter and exit at any read
    row, each clipped side charged ``clip_open`` once.
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.config import ScoreConfig

NEG = -(1 << 20)


def _exclusive_runmax(x: torch.Tensor, fill: int) -> torch.Tensor:
    """y[..., b] = max(x[..., :b]) (fill for b=0), in log2 steps."""
    def shift_right(a, s):
        return torch.nn.functional.pad(a[..., :-s], (s, 0), value=fill)

    y = shift_right(x, 1)
    s = 1
    while s < x.shape[-1]:
        y = torch.maximum(y, shift_right(y, s))
        s <<= 1
    return y


def banded_from_windows(windows: torch.Tensor, reads: torch.Tensor,
                        lengths: torch.Tensor, *, hw: int, sc: ScoreConfig,
                        clip_open: int | None = None):
    """windows uint8[N, L + 2*hw] (row n = genome[cand_n - hw : ...],
    genome N as code 4), reads uint8[N, L], lengths int32[N] →
    (scores, d0, d1, ungapped), each int32[N].

    d1 is the end diagonal: the first band cell holding the last-row
    maximum, minus hw. ungapped is the straight-diagonal score at d0
    (match/mismatch over the first ``lengths`` bases at band cell
    d0 + hw), as kernel B1 computes it; under ``clip_open`` the start
    cell may lie outside the band, and it is then 0 (callers re-gather).
    """
    N, L = reads.shape
    dev = reads.device
    W = 2 * hw + 1
    S = (L + 2 * hw + 1) if clip_open is not None else (W + 1)
    NEGP = NEG * S
    open_s, ext_s = sc.gap_open * S, sc.gap_extend * S
    match_s, mis_s = sc.match * S, sc.mismatch * S

    b_idx = torch.arange(W, dtype=torch.int32, device=dev)
    f_pre = (b_idx + 1) * ext_s
    f_post = open_s + b_idx * ext_s
    H0 = b_idx.expand(N, W).clone()                 # score 0, d0 = b - hw
    H, E, final = H0, torch.full((N, W), NEGP, dtype=torch.int32,
                                 device=dev), H0
    early = torch.full((N,), NEGP, dtype=torch.int32, device=dev)
    lens = lengths.to(torch.int32)[:, None]
    win = windows.to(torch.int32)
    rd = reads.to(torch.int32)
    fill_e = torch.full((N, 1), NEGP, dtype=torch.int32, device=dev)
    for i in range(L):
        if clip_open is not None:
            fresh = H0 if i == 0 else clip_open * S + b_idx[None, :] + i
            H = torch.maximum(H, torch.where(i < lens, fresh, NEGP))
        sub = torch.where(win[:, i : i + W] == rd[:, i : i + 1],
                          match_s, mis_s)
        diag = H + sub
        E = torch.maximum(torch.cat([H[:, 1:], fill_e], 1) + open_s,
                          torch.cat([E[:, 1:], fill_e], 1) + ext_s)
        T = torch.maximum(diag, E)
        H = torch.maximum(T, _exclusive_runmax(T - f_pre, NEGP) + f_post)
        final = torch.where(i + 1 == lens, H, final)
        if clip_open is not None:
            row_best = torch.where(i + 1 < lens, H, NEGP).amax(dim=-1)
            early = torch.maximum(early, row_best + clip_open * S)

    packed = final.amax(dim=-1)
    d1 = final.argmax(dim=-1).to(torch.int32) - hw   # first max cell
    if clip_open is not None:
        packed = torch.maximum(packed, early)
    # packed scores go negative: floor division, so b0 lands in [0, S)
    scores = torch.div(packed, S, rounding_mode="floor")
    b0 = packed - scores * S
    # straight-diagonal score at the start cell b0 (0 when b0 >= W)
    rows = torch.arange(L, device=dev)[None, :]
    g = torch.gather(win, 1, (rows + b0.clamp(max=W - 1)[:, None].long()))
    per = torch.where(g == rd, sc.match, sc.mismatch)
    ung = torch.where(rows < lens, per, 0).sum(dim=1, dtype=torch.int32)
    ung = torch.where(b0 < W, ung, 0)
    return scores.to(torch.int32), (b0 - hw).to(torch.int32), d1, \
        ung.to(torch.int32)


def banded_packed(ginter: torch.Tensor, base_off: int,
                  cand_starts: torch.Tensor, reads: torch.Tensor,
                  lengths: torch.Tensor, rpacked: torch.Tensor,
                  rnplane: torch.Tensor, *, hw: int, sc: ScoreConfig,
                  clip_open: int | None = None):
    """Banded DP fed from the bit-packed genome planes →
    (scores, d0, ungapped, span). Windows are gathered as packed words
    and unpacked; kernel B1 runs on a CUDA tensor, its plain version on
    a CPU tensor (kernels/banded_dp.py). Without ``clip_open`` the
    ungapped score is B1's straight-diagonal sum at d0; with it, the
    winner may start outside the band and ungapped is re-gathered with
    mismatch_counts at POS = cand + d0."""
    from urmap_tpu_torch import genome_pack as gpk
    from urmap_tpu_torch.kernels import banded_dp

    N, L = reads.shape
    windows = gpk.gather_codes(ginter, base_off, cand_starts - hw,
                               L + 2 * hw)
    scores, d0, d1, ung = banded_dp.banded_from_windows(
        windows, reads, lengths, hw=hw, sc=sc, clip_open=clip_open)
    if clip_open is not None:
        mm = gpk.mismatch_counts(ginter, base_off, cand_starts + d0,
                                 rpacked, rnplane, lengths)
        ung = (lengths - mm) * sc.match + mm * sc.mismatch
    return scores, d0, ung.to(torch.int32), lengths + d1 - d0


def banded_semiglobal(genome: torch.Tensor, cand_starts: torch.Tensor,
                      reads: torch.Tensor, lengths: torch.Tensor, *,
                      hw: int, sc: ScoreConfig,
                      clip_open: int | None = None):
    """Banded DP over the byte genome, the plain version of kernel B1'
    (kernels/banded_dp.py banded_semiglobal): genome uint8[G] codes,
    cand_starts int32[N] (where read base 0 is expected; any value),
    reads uint8[N, L] strand-applied, lengths int32[N] →
    (scores, d0, ungapped, span).

    The window of candidate n is genome[cand - hw : cand + L + hw] with
    every index clamped to [0, G-1] on its own (cells outside repeat the
    boundary code); ungapped is the match/mismatch sum over the read at
    POS = cand + d0, re-gathered from the genome with the same clamp,
    not B1's in-band diagonal sum: under ``clip_open`` POS may lie
    outside the band. span = lengths + d1 - d0 (meaningless under
    ``clip_open``)."""
    N, L = reads.shape
    G = genome.shape[0]
    dev = reads.device
    cand = cand_starts.to(torch.int64)
    widx = cand[:, None] - hw + torch.arange(L + 2 * hw, device=dev)[None, :]
    windows = genome[widx.clamp(0, G - 1)]
    scores, d0, d1, _ = banded_from_windows(windows, reads, lengths, hw=hw,
                                            sc=sc, clip_open=clip_open)
    col = torch.arange(L, device=dev)[None, :]
    gidx = (cand + d0)[:, None] + col
    per = torch.where(genome[gidx.clamp(0, G - 1)] == reads, sc.match,
                      sc.mismatch)
    ung = torch.where(col < lengths[:, None], per, 0) \
        .sum(dim=1, dtype=torch.int32)
    return scores, d0, ung, lengths + d1 - d0


def banded_dispatch(genome: torch.Tensor, cand_starts: torch.Tensor,
                    reads: torch.Tensor, lengths: torch.Tensor, *, hw: int,
                    sc: ScoreConfig, clip_open: int | None = None):
    """banded_semiglobal by kernel B1' on a CUDA tensor, by the plain
    version above on a CPU tensor."""
    from urmap_tpu_torch.kernels import banded_dp

    return banded_dp.banded_semiglobal(genome, cand_starts, reads, lengths,
                                       hw=hw, sc=sc, clip_open=clip_open)
