"""Kernel B3 wrapper: the seed front.

CUDA tensors launch ``csrc/seed_slots.cu seed_front_kernel`` (B3
redesigned for the card: replaces
urmap_tpu/kernels/seed_slots.py:seed_slots_words_pallas and the array ops
around it, from the read upload to each seed's CSR run); CPU tensors run
its plain version, map.seed.seed_front_plain. The two are bit-equal:
chip_smoke.py holds them to exact equality on the card.

Two modes of the one kernel, counted apart: the front proper (each
seed's CSR run from the whole offsets table) and the slots mode
(``offsets=None``: each seed's slot, what the TPU kernel itself gives),
which the sharded routes run (dist/sharded.py: a rank holds one slot
range of the table, so the run is decoded where the slot is owned).
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.kernels import Counter
from urmap_tpu_torch.kernels import _build
from urmap_tpu_torch.map.seed import seed_front_plain

counter = Counter("seed_front")
slots_counter = Counter("seed_front_slots")
SMEM_BYTES = 227 * 1024  # the most shared memory an H100 block holds


def front_max_read_len() -> int:
    """The longest read block the seed front takes: 4 reads a block,
    each with four planes of nw + 2 words in shared memory."""
    return (SMEM_BYTES // (4 * 4 * 4) - 2) * 16


def seed_front(a: torch.Tensor, b: torch.Tensor, lengths: torch.Tensor,
               L: int, *, k: int, q: int, slot_bits: int,
               offsets: torch.Tensor | None,
               obase: torch.Tensor | None = None, cnt_bits: int = 0,
               block_bits: int = 0):
    """The forward reads (``a``, ``b``: the upload blocks uint8 of
    genome_pack.pack_read_codes_host, or the word planes int32[B, nw])
    → (rpacked2, rnplane2 int32[2B, nw]: forward rows, then the reverse
    complements; offs int32[2B, Q], valid bool[2B, Q]; start int64[2B,
    Q] and cnt int32[2B, Q], each seed's CSR run in ``offsets``, packed
    with ``obase`` when given). ``offsets`` None: the slots mode, →
    (rpacked2, rnplane2, offs, valid, slots int32[2B, Q]). See
    map.seed.seed_front_plain."""
    slots_mode = offsets is None
    c = slots_counter if slots_mode else counter
    if not a.is_cuda:
        c.plain()
        return seed_front_plain(a, b, lengths, L, k=k, q=q,
                                slot_bits=slot_bits, offsets=offsets,
                                obase=obase, cnt_bits=cnt_bits,
                                block_bits=block_bits)
    _build.load()
    outs = torch.ops.urmap.seed_front(a, b, lengths, L, k, q, slot_bits,
                                      offsets, obase, cnt_bits, block_bits)
    c.launched()
    # slots mode: the kernel writes each slot in place of cnt
    return outs[:4] + (outs[5],) if slots_mode else outs
