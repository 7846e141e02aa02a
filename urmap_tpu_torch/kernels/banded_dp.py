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
HALF_WIDTHS = (8, 16, 32)  # band half-widths with a compiled kernel


def banded_from_windows(windows: torch.Tensor, reads: torch.Tensor,
                        lengths: torch.Tensor, *, hw: int, sc: ScoreConfig,
                        clip_open: int | None = None):
    """→ (scores, d0, d1, ungapped), each int32[N]; see map.dp."""
    cnt = counter if clip_open is None else clip_counter
    if not windows.is_cuda:
        cnt.plain_calls += 1
        return _plain(windows, reads, lengths, hw=hw, sc=sc,
                      clip_open=clip_open)
    if hw not in HALF_WIDTHS:
        raise ValueError(f"banded_dp: no kernel for hw={hw} "
                         f"(compiled: {HALF_WIDTHS})")
    n, L = reads.shape
    _build.require_cuda(windows, "windows", torch.uint8, 2)
    _build.require_cuda(reads, "reads", torch.uint8, 2)
    _build.require_cuda(lengths, "lengths", torch.int32, 1)
    if windows.shape != (n, L + 2 * hw) or lengths.shape[0] != n:
        raise ValueError(f"banded_dp: windows {tuple(windows.shape)}, "
                         f"reads {(n, L)}, lengths {tuple(lengths.shape)}")
    dev = windows.device
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4)]
    err = _build.lib().urmap_banded_dp(
        windows.data_ptr(), reads.data_ptr(), lengths.data_ptr(),
        *(o.data_ptr() for o in outs), n, L, hw, sc.match, sc.mismatch,
        sc.gap_open, sc.gap_extend, int(clip_open is not None),
        int(clip_open or 0), _build.stream_ptr(dev))
    _build.check(err, "urmap_banded_dp")
    cnt.launched()
    return tuple(outs)


def banded_semiglobal(genome: torch.Tensor, cand_starts: torch.Tensor,
                      reads: torch.Tensor, lengths: torch.Tensor, *, hw: int,
                      sc: ScoreConfig, clip_open: int | None = None):
    """→ (scores, d0, ungapped, span), each int32[N]; see map.dp."""
    cnt = semiglobal_counter if clip_open is None else semiglobal_clip_counter
    if not genome.is_cuda:
        cnt.plain_calls += 1
        return _plain_semiglobal(genome, cand_starts, reads, lengths, hw=hw,
                                 sc=sc, clip_open=clip_open)
    if hw not in HALF_WIDTHS:
        raise ValueError(f"banded_semiglobal: no kernel for hw={hw} "
                         f"(compiled: {HALF_WIDTHS})")
    n, L = reads.shape
    _build.require_cuda(genome, "genome", torch.uint8, 1)
    _build.require_cuda(cand_starts, "cand_starts", torch.int32, 1)
    _build.require_cuda(reads, "reads", torch.uint8, 2)
    _build.require_cuda(lengths, "lengths", torch.int32, 1)
    if cand_starts.shape[0] != n or lengths.shape[0] != n \
            or genome.shape[0] < 1:
        raise ValueError(f"banded_semiglobal: genome {tuple(genome.shape)}, "
                         f"cand {tuple(cand_starts.shape)}, reads {(n, L)}, "
                         f"lengths {tuple(lengths.shape)}")
    dev = genome.device
    scores, d0, ung, span = (torch.empty(n, dtype=torch.int32, device=dev)
                             for _ in range(4))
    err = _build.lib().urmap_banded_semiglobal(
        genome.data_ptr(), genome.shape[0], cand_starts.data_ptr(),
        reads.data_ptr(), lengths.data_ptr(), scores.data_ptr(),
        d0.data_ptr(), ung.data_ptr(), span.data_ptr(), n, L, hw, sc.match,
        sc.mismatch, sc.gap_open, sc.gap_extend, int(clip_open is not None),
        int(clip_open or 0), _build.stream_ptr(dev))
    _build.check(err, "urmap_banded_semiglobal")
    cnt.launched()
    return scores, d0, ung, span
