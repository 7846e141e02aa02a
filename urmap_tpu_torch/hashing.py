"""K-mer word hashing, shared by the index build and the seed stage.

The torch functions take and return int32 tensors holding uint32 bit
patterns (``_bits``); the numpy twins serve the host index build.
Every function is bit-equal to its counterpart in ``urmap_tpu/hashing.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from urmap_tpu_torch._bits import i32, srl

MAX_K = 32


# urmap_tpu/hashing.py:extract_words
def extract_words(codes: torch.Tensor, k: int):
    """Slide a k-window over a uint8 code tensor → (lo, hi, valid): lo
    the last min(k, 16) bases (2 bits each, first base most
    significant), hi the earlier bases, valid true iff all k bases are
    ACGT (codes < 4; genome N is 4). lo and hi are int32 words holding
    uint32 bits, one per window start, on the codes' device.

    For k % 4 == 0 it packs 4-base bytes first and combines k/4 byte
    groups, as extract_words_np does: bit-identical, fewer passes."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    n = codes.shape[0] - k + 1
    if n <= 0:
        raise ValueError(f"sequence shorter than k={k}")
    lo_bases = min(k, 16)
    c3 = (codes & 3).to(torch.int32)
    lo = torch.zeros(n, dtype=torch.int32, device=codes.device)
    hi = torch.zeros_like(lo)
    valid = torch.ones(n, dtype=torch.bool, device=codes.device)
    if k % 4 == 0:
        m = codes.shape[0] - 3            # 4-base groups start count
        b4 = ((c3[0:m] << 6) | (c3[1 : m + 1] << 4)
              | (c3[2 : m + 2] << 2) | c3[3 : m + 3])
        v4 = (codes[0:m] | codes[1 : m + 1]
              | codes[2 : m + 2] | codes[3 : m + 3]) < 4
        ng_hi = (k - lo_bases) // 4
        for g in range(k // 4):
            grp = b4[4 * g : 4 * g + n]
            valid &= v4[4 * g : 4 * g + n]
            if g < ng_hi:
                hi = (hi << 8) | grp
            else:
                lo = (lo << 8) | grp
        return lo, hi, valid
    for i in range(k):
        valid &= codes[i : i + n] < 4
        if i < k - lo_bases:
            hi = (hi << 2) | c3[i : i + n]
        else:
            lo = (lo << 2) | c3[i : i + n]
    return lo, hi, valid


def hash_words(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Avalanche a (hi, lo) word pair to a well-mixed 32-bit word
    (murmur3 fmix32-style, int32 wraparound multiplies)."""
    h = lo * i32(0x9E3779B1)
    h = h ^ (hi * i32(0x85EBCA6B))
    h = h ^ srl(h, 16)
    h = h * i32(0x7FEB352D)
    h = h ^ srl(h, 15)
    h = h * i32(0x846CA68B)
    return h ^ srl(h, 16)


def words_to_slots(lo: torch.Tensor, hi: torch.Tensor,
                   slot_bits: int) -> torch.Tensor:
    """Hash words and reduce to [0, 2**slot_bits) slot ids."""
    return hash_words(lo, hi) & i32((1 << slot_bits) - 1)


# urmap_tpu/hashing.py:extract_words_np
def extract_words_np(codes: np.ndarray, k: int):
    """Host (numpy) k-mer words at every offset → (lo, hi, valid)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    n = codes.shape[0] - k + 1
    if n <= 0:
        raise ValueError(f"sequence shorter than k={k}")
    lo_bases = min(k, 16)
    if k % 4 == 0 and (k - lo_bases) % 4 == 0 and k >= 4:
        m = codes.shape[0] - 3            # 4-base groups start count
        c3 = (codes & np.uint8(3)).astype(np.uint32)
        b4 = c3[0:m] << np.uint32(6)
        b4 |= c3[1 : m + 1] << np.uint32(4)
        b4 |= c3[2 : m + 2] << np.uint32(2)
        b4 |= c3[3 : m + 3]
        v4 = ((codes[0:m] | codes[1 : m + 1]
               | codes[2 : m + 2] | codes[3 : m + 3]) < 4)
        hi = np.zeros(n, np.uint32)
        lo = np.zeros(n, np.uint32)
        valid = np.ones(n, np.bool_)
        ng_hi = (k - lo_bases) // 4
        for g in range(k // 4):
            grp = b4[4 * g : 4 * g + n]
            valid &= v4[4 * g : 4 * g + n]
            if g < ng_hi:
                hi = (hi << np.uint32(8)) | grp
            else:
                lo = (lo << np.uint32(8)) | grp
        return lo, hi, valid
    lo = np.zeros(n, np.uint32)
    hi = np.zeros(n, np.uint32)
    valid = np.ones(n, np.bool_)
    for i in range(k):
        c = codes[i : i + n]
        valid &= c < 4
        c32 = (c & 3).astype(np.uint32)
        if i < k - lo_bases:
            hi = (hi << np.uint32(2)) | c32
        else:
            lo = (lo << np.uint32(2)) | c32
    return lo, hi, valid


# urmap_tpu/hashing.py:hash_words_np
def hash_words_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Host twin of hash_words (uint32 arrays)."""
    lo = lo.astype(np.uint32)
    hi = hi.astype(np.uint32)
    with np.errstate(over="ignore"):
        h = lo * np.uint32(0x9E3779B1)
        h ^= hi * np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x7FEB352D)
        h ^= h >> np.uint32(15)
        h *= np.uint32(0x846CA68B)
        h ^= h >> np.uint32(16)
    return h


# urmap_tpu/hashing.py:words_to_slots_np
def words_to_slots_np(lo, hi, slot_bits: int) -> np.ndarray:
    return hash_words_np(lo, hi) & np.uint32((1 << slot_bits) - 1)
