"""Kernels B6 and B7 wrappers: the traceback DP of the gapped winners.

CUDA tensors launch ``csrc/tb_dp.cu`` (replaces
urmap_tpu/kernels/tb_dp.py:tb_dops_from_windows_pallas and
tb_from_windows_pallas; two kernels of one source, counted separately);
CPU tensors run the plain versions of map/tb.py. Kernel and plain
version are bit-equal on every output. Unlike the reference's dispatch
there is no environment switch: a CUDA tensor launches the kernel or
raises (ValueError for a band half-width outside ``HALF_WIDTHS``).
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.config import ScoreConfig
from urmap_tpu_torch.kernels import Counter
from urmap_tpu_torch.kernels import _build
from urmap_tpu_torch.map import tb as _plain

counter = Counter("tb_dops")
bits_counter = Counter("tb_bits")
HALF_WIDTHS = (8, 16)  # band half-widths with a compiled kernel


def tb_dops_from_windows(windows: torch.Tensor, reads: torch.Tensor,
                         lengths: torch.Tensor, *, hw: int, sc: ScoreConfig):
    """B6 → (score int32[N], dops int32[DWp, N], walk_ok bool[N]); see
    map.tb."""
    if not windows.is_cuda:
        counter.plain_calls += 1
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
        bits_counter.plain_calls += 1
        return _plain.tb_from_windows(windows, reads, lengths, hw=hw, sc=sc)
    _build.load()
    outs = torch.ops.urmap.tb_bits(windows, reads, lengths, hw, sc.match,
                                   sc.mismatch, sc.gap_open, sc.gap_extend)
    bits_counter.launched()
    return outs
