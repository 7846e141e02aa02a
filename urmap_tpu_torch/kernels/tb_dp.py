"""Kernels B6 and B7 wrappers: the traceback DP of the gapped winners.

CUDA tensors launch ``csrc/tb_dp.cu`` (replaces
urmap_tpu/kernels/tb_dp.py:tb_dops_from_windows_pallas and
tb_from_windows_pallas; two kernels of one source, counted separately);
CPU tensors run the plain versions of map/tb.py. Kernel and plain
version are bit-equal on every output. Unlike the reference's dispatch
there is no environment switch: a CUDA tensor launches the kernel or
raises. B6 takes band half-widths 1 to 31 (a record holds the deletion
run in 6 bits), B7 1 to 271; outside them the operators raise
ValueError. A read block of up to ``max_read_len(hw)`` bases fits one
winner's shared memory; above it the launch is refused.
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.config import ScoreConfig
from urmap_tpu_torch.kernels import Counter
from urmap_tpu_torch.kernels import _build
from urmap_tpu_torch.map import tb as _plain

counter = Counter("tb_dops")
bits_counter = Counter("tb_bits")
# half-widths compiled with their band's cells; any other runs the body
# with the half-width at run time
HALF_WIDTHS = (8, 16)
SMEM_BYTES = 227 * 1024    # the most shared memory an H100 block holds


def _cells(hw: int, dops: bool) -> int:
    """Band cells of the variant that runs ``hw`` (csrc/tb_dp.cu
    dispatch)."""
    W = 2 * hw + 1
    for cells in (24, 40, 72) + (() if dops else (544,)):
        if W <= cells:
            return cells
    raise ValueError(f"band_halfwidth {hw}: no traceback kernel")


def smem_bytes(L: int, hw: int, dops: bool = True) -> int:
    """Shared memory of one winner (csrc/tb_dp.cu TbSmem): B6's codes and
    records, the window and read bytes."""
    ws = _cells(hw, dops)
    words = (-(-(L + ws - 1) // 4)) + (-(-L // 4))
    if dops:
        words += -(-L // 8) * ws + -(-(-(-L // 4)) // 8) * 8
    return 4 * words


def max_read_len(hw: int, dops: bool = True) -> int:
    """The longest read block (L) whose one winner fits a block."""
    lo, hi = 0, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if smem_bytes(mid, hw, dops) <= SMEM_BYTES \
            else (lo, mid - 1)
    return lo


def tb_dops_from_windows(windows: torch.Tensor, reads: torch.Tensor,
                         lengths: torch.Tensor, *, hw: int, sc: ScoreConfig):
    """B6 → (score int32[N], dops int32[DWp, N], walk_ok bool[N]); see
    map.tb."""
    if not windows.is_cuda:
        counter.plain()
        return _plain.tb_dops_from_windows(windows, reads, lengths, hw=hw,
                                           sc=sc)
    _build.load()
    outs = torch.ops.urmap.tb_dops(windows, reads, lengths, hw, sc.match,
                                   sc.mismatch, sc.gap_open, sc.gap_extend)
    counter.launched()
    return outs


def tb_from_windows(windows: torch.Tensor, reads: torch.Tensor,
                    lengths: torch.Tensor, *, hw: int, sc: ScoreConfig):
    """B7 → (score int32[N], bend int32[N], bits int32[NWORDS, N]); see
    map.tb."""
    if not windows.is_cuda:
        bits_counter.plain()
        return _plain.tb_from_windows(windows, reads, lengths, hw=hw, sc=sc)
    _build.load()
    outs = torch.ops.urmap.tb_bits(windows, reads, lengths, hw, sc.match,
                                   sc.mismatch, sc.gap_open, sc.gap_extend)
    bits_counter.launched()
    return outs
