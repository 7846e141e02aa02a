"""Kernel B8 wrapper: the micro-benchmark's rounds of integer mixing.

CUDA tensors launch ``csrc/micro_passes.cu`` (replaces the Pallas kernel
of tools/bench_microvpu.py, ``f_pallas``); CPU tensors run the plain
version, ``plain_passes``. The two are bit-equal. Words are uint32 bits
in int32 tensors (``_bits.py``). No mapping path launches it: its one
caller is ``tools/bench_microvpu.py`` of the port.
"""

from __future__ import annotations

import torch

from urmap_tpu_torch import _bits
from urmap_tpu_torch.kernels import Counter
from urmap_tpu_torch.kernels import _build

counter = Counter("micro_passes")

# tools/bench_microvpu.py:PASSES
PASSES = 24


def plain_passes(x: torch.Tensor, passes: int = PASSES) -> torch.Tensor:
    """The source's ``body`` on int32 words: round i multiplies by
    0x9E3779B1 + 2i + 1, xors in the word shifted right by 15 (logical)
    and adds 0x85EBCA6B, each modulo 2^32 (torch's int32 ops wrap)."""
    h = x
    for i in range(passes):
        h = h * _bits.i32(0x9E3779B1 + 2 * i + 1)
        h = h ^ _bits.srl(h, 15)
        h = h + _bits.i32(0x85EBCA6B)
    return h


def passes(x: torch.Tensor) -> torch.Tensor:
    """int32 [N, W] → int32 [N, W]: ``PASSES`` rounds on every word."""
    if not x.is_cuda:
        counter.plain()
        return plain_passes(x)
    _build.load()
    out = torch.ops.urmap.micro_passes(x, PASSES)
    counter.launched()
    return out


def u32_sum(h: torch.Tensor) -> torch.Tensor:
    """The uint32 sum of int32 words modulo 2^32, as an int64 scalar (the
    source's ``jnp.sum(..., dtype=jnp.uint32)``)."""
    return h.sum(dtype=torch.int64) & 0xFFFF_FFFF
