"""Kernels B6 and B7 wrappers: the traceback DP of the gapped winners.

CUDA tensors launch ``csrc/tb_dp.cu`` (replaces
urmap_tpu/kernels/tb_dp.py:tb_dops_from_windows_pallas and
tb_from_windows_pallas, two modes of one kernel, counted separately);
CPU tensors run the plain versions of map/tb.py. Kernel and plain
version are bit-equal on every output. Unlike the reference's dispatch
there is no environment switch: a CUDA tensor launches the kernel or
raises.
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


def _launch(windows, reads, lengths, hw: int, sc: ScoreConfig, dops: bool):
    """→ (score, aux, bits, dops): aux is walk_ok (0/1) in dops mode,
    else bend; the dops matrix is None in bits mode."""
    name = "tb_dops" if dops else "tb_bits"
    if hw not in HALF_WIDTHS:
        raise ValueError(f"{name}: no kernel for hw={hw} "
                         f"(compiled: {HALF_WIDTHS})")
    n, L = reads.shape
    _build.require_cuda(windows, "windows", torch.uint8, 2)
    _build.require_cuda(reads, "reads", torch.uint8, 2)
    _build.require_cuda(lengths, "lengths", torch.int32, 1)
    if windows.shape != (n, L + 2 * hw) or lengths.shape[0] != n:
        raise ValueError(f"{name}: windows {tuple(windows.shape)}, "
                         f"reads {(n, L)}, lengths {tuple(lengths.shape)}")
    dev = windows.device
    score = torch.empty(n, dtype=torch.int32, device=dev)
    aux = torch.empty(n, dtype=torch.int32, device=dev)
    # the per-cell codes: B7's output, B6's scratch
    bits = torch.empty((_plain.tb_words(L, hw), n), dtype=torch.int32,
                       device=dev)
    recs = (torch.empty((_plain.dops_words(L), n), dtype=torch.int32,
                        device=dev) if dops else None)
    err = _build.lib().urmap_tb_dp(
        windows.data_ptr(), reads.data_ptr(), lengths.data_ptr(),
        score.data_ptr(), aux.data_ptr(), bits.data_ptr(),
        recs.data_ptr() if dops else None, n, L, hw, sc.match, sc.mismatch,
        sc.gap_open, sc.gap_extend, int(dops), _build.stream_ptr(dev))
    _build.check(err, "urmap_tb_dp")
    return score, aux, bits, recs


def tb_dops_from_windows(windows: torch.Tensor, reads: torch.Tensor,
                         lengths: torch.Tensor, *, hw: int, sc: ScoreConfig):
    """B6 → (score int32[N], dops int32[DWp, N], walk_ok bool[N]); see
    map.tb."""
    if not windows.is_cuda:
        counter.plain_calls += 1
        return _plain.tb_dops_from_windows(windows, reads, lengths, hw=hw,
                                           sc=sc)
    score, ok, _bits, dops = _launch(windows, reads, lengths, hw, sc, True)
    counter.launched()
    return score, dops, ok.to(torch.bool)


def tb_from_windows(windows: torch.Tensor, reads: torch.Tensor,
                    lengths: torch.Tensor, *, hw: int, sc: ScoreConfig):
    """B7 → (score int32[N], bend int32[N], bits int32[NWORDS, N]); see
    map.tb."""
    if not windows.is_cuda:
        bits_counter.plain_calls += 1
        return _plain.tb_from_windows(windows, reads, lengths, hw=hw, sc=sc)
    score, bend, bits, _ = _launch(windows, reads, lengths, hw, sc, False)
    bits_counter.launched()
    return score, bend, bits
