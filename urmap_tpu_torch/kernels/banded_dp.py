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

Every band half-width from 1 to 271 runs a kernel: 8, 16 and 32 their
compiled bodies, the others the body compiled for 16, 32 or 271 with the
half-width at run time (csrc/banded_dp.cu); outside that range the
operators raise ValueError. Long reads take that runtime body with fewer
candidates a block; a read block of up to ``max_read_len(hw)`` bases
fits one candidate's shared memory, and above it the launch is refused.
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.config import ScoreConfig
from urmap_tpu_torch.kernels import Counter
from urmap_tpu_torch.kernels import _build
from urmap_tpu_torch.map.dp import banded_from_windows as _plain
from urmap_tpu_torch.map.dp import banded_semiglobal as _plain_semiglobal

MAX_HALF_WIDTH = 271   # the runtime body's largest: 32 lanes x 17 cells
SMEM_BYTES = 227 * 1024  # the most shared memory an H100 block holds


def _cells(hw: int) -> int:
    """Band cells of the body that takes one candidate a block at ``hw``
    (csrc/banded_dp.cu: the runtime body compiled for HW' = 16, 32 or
    271, K lanes x CPL cells)."""
    for top, cells in ((16, 4 * 9), (32, 4 * 17), (MAX_HALF_WIDTH, 32 * 17)):
        if hw <= top:
            return cells
    raise ValueError(f"band_halfwidth {hw} > {MAX_HALF_WIDTH}")


def smem_bytes(L: int, hw: int) -> int:
    """Shared memory of one candidate (csrc/banded_dp.cu Smem): six bit
    planes of the window (to a 16-byte boundary), the window bytes and
    the read bytes."""
    nwb = (L + _cells(hw)) // 32 + 2
    pw = (6 * nwb) | 1
    return -(-4 * pw // 16) * 16 + (32 * nwb + 16) + ((-(-L // 4)) | 1) * 4


def max_read_len(hw: int) -> int:
    """The longest read block (L) whose one candidate fits a block."""
    lo, hi = 0, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if smem_bytes(mid, hw) <= SMEM_BYTES \
            else (lo, mid - 1)
    return lo


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
        cnt.plain()
        return _plain(windows, reads, lengths, hw=hw, sc=sc,
                      clip_open=clip_open)
    _build.load()
    outs = torch.ops.urmap.banded_dp(windows, reads, lengths, hw, sc.match,
                                     sc.mismatch, sc.gap_open, sc.gap_extend,
                                     clip_open)
    cnt.launched(windows.shape[0])
    return outs


def banded_semiglobal(genome: torch.Tensor, cand_starts: torch.Tensor,
                      reads: torch.Tensor, lengths: torch.Tensor, *, hw: int,
                      sc: ScoreConfig, clip_open: int | None = None):
    """→ (scores, d0, ungapped, span), each int32[N]; see map.dp."""
    cnt = semiglobal_counter if clip_open is None else semiglobal_clip_counter
    if not genome.is_cuda:
        cnt.plain()
        return _plain_semiglobal(genome, cand_starts, reads, lengths, hw=hw,
                                 sc=sc, clip_open=clip_open)
    _build.load()
    outs = torch.ops.urmap.banded_semiglobal(
        genome, cand_starts, reads, lengths, hw, sc.match, sc.mismatch,
        sc.gap_open, sc.gap_extend, clip_open)
    cnt.launched()
    return outs
