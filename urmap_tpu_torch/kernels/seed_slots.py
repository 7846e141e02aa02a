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
    n, nw = rpacked.shape
    if L < k or not 1 <= k <= 32 or L > 16 * nw or not 1 <= slot_bits <= 32:
        raise ValueError(f"seed_slots: unsupported L={L} k={k} nw={nw} "
                         f"slot_bits={slot_bits}")
    for t, name in ((rpacked, "rpacked"), (rnplane, "rnplane")):
        _build.require_cuda(t, name, torch.int32, 2)
        if t.shape != (n, nw):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {(n, nw)}")
    _build.require_cuda(lengths, "lengths", torch.int32, 1)
    if lengths.shape[0] != n:
        raise ValueError("lengths: one per read")
    dev = rpacked.device
    slots = torch.empty((n, q), dtype=torch.int32, device=dev)
    offs = torch.empty((n, q), dtype=torch.int32, device=dev)
    valid = torch.empty((n, q), dtype=torch.bool, device=dev)
    err = _build.lib().urmap_seed_slots(
        rpacked.data_ptr(), rnplane.data_ptr(), lengths.data_ptr(),
        slots.data_ptr(), offs.data_ptr(), valid.data_ptr(), n, nw, L, k, q,
        slot_bits, _build.stream_ptr(dev))
    _build.check(err, "urmap_seed_slots")
    counter.launched()
    return slots, offs, valid
