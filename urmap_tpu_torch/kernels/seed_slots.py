"""Kernel B3 wrapper: seed slots from the read word planes.

CUDA tensors launch ``csrc/seed_slots.cu`` (replaces
urmap_tpu/kernels/seed_slots.py:seed_slots_words_pallas); CPU tensors
run the plain version, map.seed.extract_seed_slots_words. The two are
bit-equal: chip_smoke.py holds them to exact equality on the card.
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.kernels import Counter
from urmap_tpu_torch.kernels import _build
from urmap_tpu_torch.map.seed import extract_seed_slots_words

counter = Counter("seed_slots")


def seed_slots_words(rpacked: torch.Tensor, rnplane: torch.Tensor,
                     lengths: torch.Tensor, L: int, *, k: int, q: int,
                     slot_bits: int):
    """(slots int32[N, Q], offs int32[N, Q], valid bool[N, Q]) from the
    word planes int32[N, nw] and lengths int32[N]."""
    if not rpacked.is_cuda:
        counter.plain_calls += 1
        return extract_seed_slots_words(rpacked, rnplane, lengths, L, k=k,
                                        q=q, slot_bits=slot_bits)
    _build.load()
    slots, offs, valid = torch.ops.urmap.seed_slots(rpacked, rnplane, lengths,
                                                    L, k, q, slot_bits)
    counter.launched()
    return slots, offs, valid
