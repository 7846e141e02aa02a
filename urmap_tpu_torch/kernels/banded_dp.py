"""Kernels B1 and B1' wrappers: banded semi-global DP.

``banded_from_windows`` (B1, over pre-gathered windows): CUDA tensors
launch ``csrc/banded_dp.cu`` (replaces
urmap_tpu/kernels/banded_dp.py:pallas_from_windows), in plain or
clip_open mode (a template parameter of the kernel, counted
separately); CPU tensors run the plain version,
map.dp.banded_from_windows. The two are bit-equal for every length,
those outside [0, L] included (below 0 counts as 0; above L the last
row is never reached and the initial row stands).

``banded_semiglobal`` (B1', over the byte genome): the same kernel body
with its window bytes read per cell from the genome (replaces
urmap_tpu/kernels/banded_dp.py:banded_semiglobal_pallas); CPU tensors
run map.dp.banded_semiglobal. Bit-equal for every length too.

Kernels are compiled for band half-widths 8, 16 and 32; for another the
operators raise ValueError.
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.config import ScoreConfig
from urmap_tpu_torch.kernels import Counter
from urmap_tpu_torch.kernels import _build
from urmap_tpu_torch.map.dp import banded_from_windows as _plain
from urmap_tpu_torch.map.dp import banded_semiglobal as _plain_semiglobal

counter = Counter("banded_dp")
clip_counter = Counter("banded_dp_clip")
semiglobal_counter = Counter("banded_semiglobal")
semiglobal_clip_counter = Counter("banded_semiglobal_clip")


def banded_from_windows(windows: torch.Tensor, reads: torch.Tensor,
                        lengths: torch.Tensor, *, hw: int, sc: ScoreConfig,
                        clip_open: int | None = None):
    """→ (scores, d0, d1, ungapped), each int32[N]; see map.dp."""
    cnt = counter if clip_open is None else clip_counter
    if not windows.is_cuda:
        cnt.plain_calls += 1
        return _plain(windows, reads, lengths, hw=hw, sc=sc,
                      clip_open=clip_open)
    _build.load()
    outs = torch.ops.urmap.banded_dp(windows, reads, lengths, hw, sc.match,
                                     sc.mismatch, sc.gap_open, sc.gap_extend,
                                     clip_open)
    cnt.launched()
    return outs


def banded_semiglobal(genome: torch.Tensor, cand_starts: torch.Tensor,
                      reads: torch.Tensor, lengths: torch.Tensor, *, hw: int,
                      sc: ScoreConfig, clip_open: int | None = None):
    """→ (scores, d0, ungapped, span), each int32[N]; see map.dp."""
    cnt = semiglobal_counter if clip_open is None else semiglobal_clip_counter
    if not genome.is_cuda:
        cnt.plain_calls += 1
        return _plain_semiglobal(genome, cand_starts, reads, lengths, hw=hw,
                                 sc=sc, clip_open=clip_open)
    _build.load()
    outs = torch.ops.urmap.banded_semiglobal(
        genome, cand_starts, reads, lengths, hw, sc.match, sc.mismatch,
        sc.gap_open, sc.gap_extend, clip_open)
    cnt.launched()
    return outs
