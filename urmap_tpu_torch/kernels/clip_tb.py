"""The clip traceback's wrapper: the clip-mode traceback of the
clip-rescued gapped winners over the host's whole window.

CUDA tensors launch ``csrc/clip_tb.cu`` (no TPU counterpart: the
reference runs this DP on the host, codecs.cpp urmap_traceback_batch);
CPU tensors run the plain version of map/clip_tb.py. Kernel and plain
version are bit-equal on every output. The kernel holds reads of 1 to
``MAX_READ_LEN`` bases (a warp covers 256 window columns, L + 49) and
scores with gap_open <= gap_extend; outside them the operator raises
ValueError. ``enabled`` is the one predicate the mapping path asks.
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.config import ScoreConfig
from urmap_tpu_torch.kernels import Counter
from urmap_tpu_torch.kernels import _build
from urmap_tpu_torch.map import clip_tb as _plain

counter = Counter("clip_tb")
MAX_READ_LEN = 256 - _plain.PAD - 1


def enabled(L: int, sc: ScoreConfig) -> bool:
    """Whether the mapping path runs the clip traceback for read blocks
    of ``L`` bases under ``sc`` (on every device alike, so the card and
    the CPU take the same path)."""
    return 1 <= L <= MAX_READ_LEN and sc.gap_open <= sc.gap_extend


def clip_tb(windows: torch.Tensor, reads: torch.Tensor,
            lengths: torch.Tensor, widths: torch.Tensor, *,
            sc: ScoreConfig, clip_open: int):
    """→ (score int32[N], recs int32[DWp, N], ok bool[N]); see
    map.clip_tb."""
    if not windows.is_cuda:
        counter.plain()
        return _plain.clip_tb_from_windows(windows, reads, lengths, widths,
                                           sc=sc, clip_open=clip_open)
    _build.load()
    outs = torch.ops.urmap.clip_tb(windows, reads, lengths, widths, sc.match,
                                   sc.mismatch, sc.gap_open, sc.gap_extend,
                                   clip_open)
    counter.launched()
    return outs
