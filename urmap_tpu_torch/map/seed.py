"""Seed extraction, index gather and diagonal voting (plain PyTorch).

The reference's per-read loop (word extract → hash → fetch position
list → vote diagonals) as three batched stages, each bit-equal to its
counterpart in urmap_tpu/map/seed.py:

  1. extract_seed_slots_words: Q seed k-mers per read at evenly spaced
     offsets, from the 2-bit word planes, hashed to index slots (the
     plain version of kernel B3, kernels/seed_slots.py);
     seed_front_plain composes it with the read words of both strands
     and the CSR offset decode (the plain version of the seed front,
     B3 redesigned);
  2. gather_candidates: CSR gather of up to P positions per seed →
     candidate alignment starts (pos − seed offset): decode_offsets,
     then gather_runs;
  3. vote_top_candidates: per read, the top-V distinct candidate starts
     by seed votes (the plain version of kernel B4, kernels/vote.py).

Invalid seeds and candidates carry SENTINEL and lose every comparison.
"""

from __future__ import annotations

import torch

from urmap_tpu_torch._bits import EVEN, funnel, i32, rev2bit, srl
from urmap_tpu_torch.hashing import words_to_slots

SENTINEL = 0x7FFFFFF0  # invalid candidate start (sorts last)

# Device genome positions are BIASED int32: b = p - POS_BIAS. Order-
# preserving, SENTINEL stays the maximum, and 2^16 of headroom below
# INT32_MIN absorbs small subtractions near genome position 0. POS_BIAS
# is a multiple of 16, so the packed-genome gathers unbias through
# their static word offset (store: base_off).
POS_BIAS = (1 << 31) - (1 << 16)


def seed_offsets(lengths: torch.Tensor, k: int, q: int) -> torch.Tensor:
    """int32[N, Q] seed start offsets: floor(i*(len-k)/(Q-1)), 0 if len<k."""
    if q == 1:
        return torch.zeros((lengths.shape[0], 1), dtype=torch.int32,
                           device=lengths.device)
    span = (lengths.to(torch.int32) - k).clamp(min=0)
    qi = torch.arange(q, dtype=torch.int32, device=lengths.device)
    return (qi[None, :] * span[:, None]) // (q - 1)


def extract_seed_slots_words(rpacked: torch.Tensor, rnplane: torch.Tensor,
                             lengths: torch.Tensor, L: int, *, k: int,
                             q: int, slot_bits: int):
    """Word planes int32[N, nw] → (slots int32[N, Q], offs int32[N, Q],
    valid bool[N, Q]).

    The k-mer at each seed offset o is read straight from the words:
    A = bases o..o+15 and B = o+16..o+31 (two funnels over words o//16,
    +1, +2, the planes padded with two guard words — code 0, N plane
    all-N), each 2-bit-lane reversed to the first-base-most-significant
    order the hash expects. Valid = N-free and len >= k. k <= 32."""
    n, nw = rpacked.shape
    if L < k:
        raise ValueError(f"read block width {L} < word length {k}")
    m = L - k + 1
    offs = seed_offsets(lengths, k, q)
    offs_c = offs.clamp(0, m - 1)
    dev = rpacked.device
    cw = torch.cat([rpacked, torch.zeros((n, 2), dtype=torch.int32,
                                         device=dev)], dim=1)
    nwp = torch.cat([rnplane, torch.full((n, 2), EVEN, dtype=torch.int32,
                                         device=dev)], dim=1)
    w = (offs_c >> 4).long()
    sh = 2 * (offs_c & 15)

    def kmer_word(a, d):
        return funnel(torch.gather(a, 1, w + d), torch.gather(a, 1, w + d + 1),
                      sh)

    A, nA = kmer_word(cw, 0), kmer_word(nwp, 0)
    if k <= 16:
        lo = srl(rev2bit(A), 32 - 2 * k)
        hi = torch.zeros_like(lo)
        okbits = nA & i32((1 << (2 * k)) - 1)
    else:
        B, nB = kmer_word(cw, 1), kmer_word(nwp, 1)
        if k == 32:
            hi, lo = rev2bit(A), rev2bit(B)
            okbits = nA | nB
        else:
            ra, rb = rev2bit(A), rev2bit(B)
            hb = 2 * (k - 16)
            hi = srl(ra, 32 - hb)
            lo = (ra << hb) | srl(rb, 32 - hb)
            okbits = nA | (nB & ((1 << hb) - 1))
    slots = words_to_slots(lo, hi, slot_bits)
    valid = (okbits == 0) & (lengths >= k)[:, None]
    return slots, offs, valid


def align_row_words(p: int) -> int:
    """Row width of the no-straddle (aligned) positions layout: the
    smallest power of two >= max(GATHER_ROW_WORDS, p)."""
    from urmap_tpu_torch.genome_pack import GATHER_ROW_WORDS

    rw = GATHER_ROW_WORDS
    while rw < p:
        rw *= 2
    return rw


def _aligned_rows_fetch(positions: torch.Tensor, flat_starts: torch.Tensor,
                        width: int, rw: int) -> torch.Tensor:
    """``width`` entries from each (row-contained) CSR offset of a 1-D
    table whose runs never cross a row of ``rw`` words (the aligned
    layout; the row128 layout at rw = 128): one row per start, shifted
    left by the offset within the row with SENTINEL fill. Starts are
    taken as uint32 values (a human-genome table passes 2^31 entries)
    and the row index is clipped to the last full row. The plain
    version of kernel B5's row entry (kernels/lane_rotate.py)."""
    nrows = positions.shape[0] // rw
    s = flat_starts.to(torch.int64) & 0xFFFF_FFFF
    r0 = torch.div(s, rw, rounding_mode="floor").clamp(max=nrows - 1)
    t = (s % rw)[:, None] + torch.arange(
        width, dtype=torch.int64, device=positions.device)[None, :]
    got = positions[r0[:, None] * rw + t.clamp(max=rw - 1)]
    return torch.where(t < rw, got, SENTINEL)


def _row128_fetch(positions2d: torch.Tensor, flat_starts: torch.Tensor,
                  width: int) -> torch.Tensor:
    """Dense-row fetch of the row128 layout: ``positions2d`` is the
    table shaped [R, 128], every run lives inside one row
    (store.align_runs_fixed), so one row per start yields the first
    ``width`` entries at each CSR offset, with SENTINEL in the lanes
    that pass the row's end."""
    return _aligned_rows_fetch(positions2d.reshape(-1), flat_starts, width,
                               128)


def decode_offsets(offsets: torch.Tensor, slots: torch.Tensor, *,
                   obase: torch.Tensor | None = None, cnt_bits: int = 0,
                   block_bits: int = 0):
    """Each seed's CSR run → (start int64, cnt int32), shaped as
    ``slots``. ``offsets`` holds uint32 CSR offsets as int32 bit
    patterns (widened to int64 here). ``obase``: ``offsets`` is the
    packed table of store.pack_offsets_row128: one word carries two
    uint16 slot entries (even slot in the low half), each
    (start - obase[slot >> block_bits]) << cnt_bits | padded count."""
    sl = slots.long()
    if obase is not None:
        w = offsets[sl >> 1]
        u = torch.where((sl & 1) == 1, srl(w, 16), w) & 0xFFFF
        b = obase[sl >> block_bits].long() & 0xFFFF_FFFF
        start = b + (u >> cnt_bits).long()
        cnt = u & ((1 << cnt_bits) - 1)
    else:
        start = offsets[sl].long() & 0xFFFF_FFFF
        cnt = ((offsets[sl + 1].long() & 0xFFFF_FFFF) - start) \
            .to(torch.int32)
    return start, cnt


def seed_front_plain(a: torch.Tensor, b: torch.Tensor,
                     lengths: torch.Tensor, L: int, *, k: int, q: int,
                     slot_bits: int, offsets: torch.Tensor | None,
                     obase: torch.Tensor | None = None, cnt_bits: int = 0,
                     block_bits: int = 0):
    """The plain version of the seed front (kernels/seed_slots.py
    seed_front): the forward words from the upload blocks (``a``, ``b``
    uint8: genome_pack.read_words_from_upload) or as given (int32 word
    planes), their reverse complements, both strands stacked, the seed
    slots and the CSR offset decode → (rpacked2, rnplane2, offs, valid,
    start, cnt); rows [0, B) forward, [B, 2B) reverse complement.
    ``offsets`` None (the slots mode): no decode, → (rpacked2, rnplane2,
    offs, valid, slots), slots int32 [2B, Q] as extract_seed_slots_words
    gives them."""
    from urmap_tpu_torch import genome_pack as gpk

    nw = -(-L // gpk.BASES_PER_WORD)
    if a.dtype == torch.uint8:
        rp1, rn1 = gpk.read_words_from_upload(a, b, lengths, nw)
    else:
        rp1, rn1 = a, b
    rp_rc, rn_rc = gpk.revcomp_words(rp1, rn1, lengths, L)
    rpacked2 = torch.cat([rp1, rp_rc], dim=0)
    rnplane2 = torch.cat([rn1, rn_rc], dim=0)
    lengths2 = torch.cat([lengths, lengths], dim=0)
    slots, offs, valid = extract_seed_slots_words(
        rpacked2, rnplane2, lengths2, L, k=k, q=q, slot_bits=slot_bits)
    if offsets is None:
        return rpacked2, rnplane2, offs, valid, slots
    start, cnt = decode_offsets(offsets, slots, obase=obase,
                                cnt_bits=cnt_bits, block_bits=block_bits)
    return rpacked2, rnplane2, offs, valid, start, cnt


def gather_candidates(offsets: torch.Tensor, positions: torch.Tensor,
                      slots: torch.Tensor, seed_offs: torch.Tensor,
                      valid: torch.Tensor, *, p: int,
                      csr_aligned: bool = False, row128: bool = False,
                      obase: torch.Tensor | None = None,
                      off_cnt_bits: int = 0,
                      off_block_bits: int = 0) -> torch.Tensor:
    """CSR gather: per (read, seed), up to P genome positions →
    candidate starts int32[N, Q*P] (SENTINEL where invalid).

    ``offsets`` holds uint32 CSR offsets as int32 bit patterns (widened
    to int64 here); ``positions`` biased int32. Classic layout: one
    straddle-row window per seed, entries valid for lane < count.
    Aligned layout (``csr_aligned``): runs never cross a row, pads are
    SENTINEL, entries valid for lane < count and != SENTINEL.
    ``row128``: positions is [R, 128], one dense row per seed. Both are
    fetched by kernel B5's row entry on a CUDA device, whatever the
    table's length, and by its plain version on the CPU. ``obase``: ``offsets`` is the packed table of
    store.pack_offsets_row128: one word carries two uint16 slot
    entries (even slot in the low half), each
    (start - obase[slot >> block_bits]) << cnt_bits | padded count."""
    start, cnt = decode_offsets(offsets, slots, obase=obase,
                                cnt_bits=off_cnt_bits,
                                block_bits=off_block_bits)
    return gather_runs(positions, start, cnt, seed_offs, valid, p=p,
                       csr_aligned=csr_aligned, row128=row128)


def gather_runs(positions: torch.Tensor, start: torch.Tensor,
                cnt: torch.Tensor, seed_offs: torch.Tensor,
                valid: torch.Tensor, *, p: int, csr_aligned: bool = False,
                tier: int | None = None, tier_overflow_frac: int = 16,
                row128: bool = False) -> torch.Tensor:
    """The fetch half of gather_candidates, from each seed's decoded CSR
    run (start int64, cnt int32, both [N, Q]) → candidate starts
    int32[N, Q*P].

    ``tier`` (the aligned layout, a power of two < p; the tiered
    gather of urmap_tpu/map/seed.py): pass 1 fetches ``tier`` words a
    seed (a run of <= tier entries lives inside one tier-word block by
    store.align_runs' rule); the seeds whose count passes the tier are
    fetched again at full width in rounds of at most
    max(N*Q // tier_overflow_frac, 128) seeds until none is left, each
    round's condition read back by the host (``kernels.tier_rounds``
    counts the calls and rounds). The output is bit-identical to the
    untiered gather."""
    from urmap_tpu_torch import genome_pack as gpk
    from urmap_tpu_torch.kernels import lane_rotate

    n, q = cnt.shape
    if csr_aligned and not row128 and tier is not None and tier < p:
        return _tiered_gather(positions, start.reshape(-1), cnt.reshape(-1),
                              seed_offs.reshape(-1), valid.reshape(-1),
                              p=p, tier=tier,
                              overflow_frac=tier_overflow_frac) \
            .reshape(n, q * p)
    j = torch.arange(p, dtype=torch.int32, device=cnt.device)
    ok = (j[None, None, :] < cnt[:, :, None]) & valid[:, :, None]
    flat = start.reshape(-1)
    if row128:
        pos = lane_rotate.row128_fetch(positions, flat, p)
    elif csr_aligned:
        pos = lane_rotate.row128_fetch(positions, flat, p,
                                       row_words=align_row_words(p))
    else:
        pos = gpk.gather_window(positions, flat, p,
                                row_words=gpk.GATHER_ROW_WORDS)
    pos = pos.reshape(n, q, p)
    if row128 or csr_aligned:
        ok &= pos != SENTINEL               # pads between runs
    cand = pos - seed_offs[:, :, None]
    return torch.where(ok, cand, SENTINEL).reshape(n, q * p)


def _tiered_gather(positions: torch.Tensor, flat: torch.Tensor,
                   cnt: torch.Tensor, soff: torch.Tensor,
                   valid: torch.Tensor, *, p: int, tier: int,
                   overflow_frac: int) -> torch.Tensor:
    """gather_runs' tiered branch on flat per-seed arrays [N*Q] →
    int32[N*Q, P]: the port of urmap_tpu/map/seed.py's tier branch, its
    ``while_loop`` a Python loop on ``.any()`` and its
    ``jnp.nonzero(size=cap2, fill_value=0)`` ``_nonzero_padded``. The
    fill lanes alias seed 0, so a round writes back only the lanes
    ``do`` marks."""
    from urmap_tpu_torch.kernels import lane_rotate, tier_rounds
    from urmap_tpu_torch.map.pipeline import _any, _nonzero_padded

    if tier & (tier - 1):
        raise ValueError(f"tier {tier} is not a power of two")
    nq = flat.shape[0]
    j = torch.arange(p, dtype=torch.int32, device=cnt.device)
    narrow = lane_rotate.row128_fetch(positions, flat, tier, row_words=tier)
    ok1 = ((j[None, :tier] < cnt[:, None]) & (narrow != SENTINEL)
           & valid[:, None])
    cand = torch.full((nq, p), SENTINEL, dtype=torch.int32,
                      device=cnt.device)
    cand[:, :tier] = torch.where(ok1, narrow - soff[:, None], SENTINEL)

    rw = align_row_words(p)
    ov = valid & (cnt > tier)                              # overflow
    cap2 = min(max(nq // overflow_frac, 128), nq)
    done = torch.zeros(nq, dtype=torch.bool, device=cnt.device)
    rounds = 0
    while _any(ov & ~done, "tier"):
        rem = ov & ~done
        idx = _nonzero_padded(rem, cap2)
        do = rem[idx]
        full = lane_rotate.row128_fetch(positions, flat[idx], p,
                                        row_words=rw)
        okk = (j[None, :] < cnt[idx][:, None]) & (full != SENTINEL)
        c2 = torch.where(okk, full - soff[idx][:, None], SENTINEL)
        cand[idx] = torch.where(do[:, None], c2, cand[idx])
        done[idx] = done[idx] | do
        rounds += 1
    tier_rounds.add(rounds)
    return cand


def vote_top_candidates(cand: torch.Tensor, *, v: int):
    """cand int32[N, M] → (top_cand int32[N, V], votes int32[N, V]).

    Votes = number of seeds that proposed the exact same start; only
    run heads of the sorted row are eligible, so the top-V are
    distinct. Ties go to the lowest sorted position (a stable
    descending sort — torch.topk's tie order is not documented).
    votes == 0 marks empty lanes (cand == SENTINEL there)."""
    n, m = cand.shape
    sorted_c = torch.sort(cand, dim=-1).values
    idx = torch.arange(m, dtype=torch.int32, device=cand.device)[None, :]
    is_head = torch.cat(
        [torch.ones((n, 1), dtype=torch.bool, device=cand.device),
         sorted_c[:, 1:] != sorted_c[:, :-1]], dim=-1)
    headpos = torch.where(is_head, idx, m)
    nxt = torch.cat([headpos[:, 1:],
                     torch.full((n, 1), m, dtype=torch.int32,
                                device=cand.device)], dim=-1)
    # next_head[i] = position of the first head strictly after i
    next_head = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    votes = (next_head - idx).to(torch.int32)
    key = torch.where(is_head & (sorted_c != SENTINEL), votes, 0)
    top_votes, top_idx = torch.sort(key, dim=-1, descending=True,
                                    stable=True)
    top_votes, top_idx = top_votes[:, :v], top_idx[:, :v]
    top_cand = torch.gather(sorted_c, 1, top_idx)
    return torch.where(top_votes > 0, top_cand, SENTINEL), top_votes
