"""Bit-parallel packed genome and read words: 16 bases per 32-bit word.

Layout (the same as urmap_tpu/genome_pack.py): base g lives in bits
[2*(g%16), 2*(g%16)+1] of word g//16, and a parallel "is-N" plane holds
01 in the lane of every N base. The genome planes are interleaved
(code word, N word) so one window needs one row gather. Mismatch
counting is XOR + popcount:

    mism+N bits = ((a^b) | ((a^b)>>1) | nA | nB) & 0x55555555

Host half (numpy, JAX-free copies of the reference's functions) builds
the planes; device half (torch, int32 words per ``_bits``) gathers
windows and unpacks them, from the 1-D table or from its dense
[R, 128] view (the row128 layout, kernel B5). Guard words at both ends
read as all-N, so a window that runs off the genome reads as
mismatches.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from urmap_tpu_torch._bits import EVEN, funnel, popcount, rev2bit, srl

BASES_PER_WORD = 16
WORD_PAD = 16   # all-N guard words at each end
ROW_WORDS = 32  # table padding granularity (guard rows)
GATHER_ROW_WORDS = 16  # row width of the hot gathers (divides ROW_WORDS)


# ---- host half ---------------------------------------------------------

# urmap_tpu/genome_pack.py:pack_genome
def pack_genome(codes: np.ndarray):
    """uint8[G] codes → (interleaved uint32[2W'] planes, base_offset).

    base_offset: index of the word holding base 0 (= WORD_PAD)."""
    G = codes.shape[0]
    W = -(-G // BASES_PER_WORD)
    nlib = None
    if not os.environ.get("URMAP_NO_NATIVE_BUILD"):
        from urmap_tpu_torch.io import native as _native

        nlib = _native.lib()
    if nlib is not None:
        import ctypes

        from urmap_tpu_torch.io import native as _native
        from urmap_tpu_torch.utils.bigmem import big_empty

        back = 6 * ROW_WORDS
        total = WORD_PAD + W + back
        back += (-total) % 64
        total = WORD_PAD + W + back
        inter = big_empty(2 * total, np.uint32)
        inter[: 2 * WORD_PAD : 2] = 0
        inter[1 : 2 * WORD_PAD : 2] = 0x5555_5555
        inter[2 * (WORD_PAD + W) :: 2] = 0
        inter[2 * (WORD_PAD + W) + 1 :: 2] = 0x5555_5555
        p_u32 = ctypes.POINTER(ctypes.c_uint32)
        codes_c = np.ascontiguousarray(codes)
        base = inter.ctypes.data + 8 * WORD_PAD
        nlib.urmap_pack_genome(
            codes_c.ctypes.data_as(_native.p_u8), G,
            os.cpu_count() or 4, ctypes.cast(base, p_u32),
            ctypes.cast(base + 4, p_u32), 2)
        return inter, WORD_PAD
    packed = np.empty(W, np.uint32)
    nplane = np.empty(W, np.uint32)
    shifts = (np.arange(BASES_PER_WORD, dtype=np.uint32) * 2)
    CW = 1 << 26                                   # words per chunk
    for w0 in range(0, W, CW):
        w1 = min(w0 + CW, W)
        seg = codes[w0 * BASES_PER_WORD : w1 * BASES_PER_WORD]
        if seg.shape[0] < (w1 - w0) * BASES_PER_WORD:
            seg = np.concatenate(
                [seg, np.full((w1 - w0) * BASES_PER_WORD - seg.shape[0],
                              4, np.uint8)])
        c = seg.astype(np.uint32)
        isn = (c >= 4).astype(np.uint32)
        c &= 3
        cw = c.reshape(w1 - w0, BASES_PER_WORD)
        nw = isn.reshape(w1 - w0, BASES_PER_WORD)
        packed[w0:w1] = np.bitwise_or.reduce(cw << shifts[None, :], axis=1)
        nplane[w0:w1] = np.bitwise_or.reduce(nw << shifts[None, :], axis=1)
    back = 6 * ROW_WORDS
    total = WORD_PAD + W + back
    back += (-total) % 64   # interleaved length % 128 == 0
    packed = np.concatenate([np.zeros(WORD_PAD, np.uint32), packed,
                             np.zeros(back, np.uint32)])
    nplane = np.concatenate([np.full(WORD_PAD, 0x5555_5555, np.uint32),
                             nplane,
                             np.full(back, 0x5555_5555, np.uint32)])
    inter = np.empty(2 * packed.shape[0], np.uint32)
    inter[0::2] = packed
    inter[1::2] = nplane
    return inter, WORD_PAD


# urmap_tpu/genome_pack.py:pack_read_codes_host
def pack_read_codes_host(codes: np.ndarray):
    """Host 4-bases/byte packing of read codes for the upload:
    (packed uint8[B, ceil(L/4)], nmask uint8[B, ceil(L/8)]). Read codes
    are in {0,1,2,3,5}, so (code & 3) + N-bit round-trips exactly."""
    B, L = codes.shape
    from urmap_tpu_torch.io import native as _native

    nlib = _native.lib()
    if nlib is not None:
        import ctypes

        codes = np.ascontiguousarray(codes)
        packed = np.empty((B, -(-L // 4)), np.uint8)
        nmask = np.empty((B, -(-L // 8)), np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        nlib.urmap_pack_reads(
            codes.ctypes.data_as(u8p), B, L,
            packed.ctypes.data_as(u8p), nmask.ctypes.data_as(u8p))
        return packed, nmask
    return _pack_read_codes_numpy(codes)


# urmap_tpu/genome_pack.py:_pack_read_codes_numpy
def _pack_read_codes_numpy(codes: np.ndarray):
    """Pure-numpy twin of urmap_pack_reads."""
    B, L = codes.shape
    L4 = -(-L // 4) * 4
    L8 = -(-L // 8) * 8
    c = np.pad(codes, ((0, 0), (0, L4 - L)), constant_values=0)
    two = (c & 3).reshape(B, L4 // 4, 4)
    sh = np.array([0, 2, 4, 6], np.uint8)
    packed = np.bitwise_or.reduce(
        (two << sh[None, None, :]).astype(np.uint8), axis=2)
    isn = (np.pad(codes, ((0, 0), (0, L8 - L)), constant_values=0)
           >= 4).astype(np.uint8).reshape(B, L8 // 8, 8)
    shn = np.arange(8, dtype=np.uint8)
    nmask = np.bitwise_or.reduce(
        (isn << shn[None, None, :]).astype(np.uint8), axis=2)
    return packed, nmask


# ---- device half -------------------------------------------------------

def _lane_shifts(device) -> torch.Tensor:
    return torch.arange(BASES_PER_WORD, dtype=torch.int32, device=device) * 2


def _tail_n_mask(lengths: torch.Tensor, n_words: int) -> torch.Tensor:
    """int32[N, n_words] with 01 in every 2-bit lane at base index
    >= lengths (the pack_reads pad-is-N convention)."""
    base_idx = torch.arange(n_words, dtype=torch.int32,
                            device=lengths.device) * BASES_PER_WORD
    rem = (lengths[:, None] - base_idx[None, :]).clamp(0, BASES_PER_WORD)
    kept = torch.where(rem >= BASES_PER_WORD, -1,
                       (1 << (2 * rem).clamp(max=30)) - 1)
    return EVEN & ~kept


def read_words_from_upload(packed: torch.Tensor, nmask: torch.Tensor,
                           lengths: torch.Tensor, n_words: int):
    """Upload blocks from pack_read_codes_host → (rpacked, rnplane)
    int32[N, n_words]. The 4-base upload bytes are the word bytes,
    little-endian; the 1-bit N plane spreads to the 2-bit lanes with a
    Morton expand. Lanes past ``lengths`` are forced to N."""
    N = packed.shape[0]
    nb = 4 * n_words
    if packed.shape[1] < nb:
        packed = torch.nn.functional.pad(packed, (0, nb - packed.shape[1]))
    b = packed[:, :nb].to(torch.int32).reshape(N, n_words, 4)
    rpacked = (b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16)
               | (b[:, :, 3] << 24))
    hb = 2 * n_words
    if nmask.shape[1] < hb:
        nmask = torch.nn.functional.pad(nmask, (0, hb - nmask.shape[1]))
    h = nmask[:, :hb].to(torch.int32).reshape(N, n_words, 2)
    x = h[:, :, 0] | (h[:, :, 1] << 8)           # 16 N-bits per word
    x = (x | (x << 8)) & 0x00FF_00FF             # Morton spread to evens
    x = (x | (x << 4)) & 0x0F0F_0F0F
    x = (x | (x << 2)) & 0x3333_3333
    x = (x | (x << 1)) & 0x5555_5555
    return rpacked, x | _tail_n_mask(lengths, n_words)


def pack_reads(codes: torch.Tensor, lengths: torch.Tensor, n_words: int):
    """uint8[N, L] read codes → (packed, nplane) int32[N, n_words].
    Bases past L pack as N; ``lengths`` is unused, as in the reference
    (callers mask tail words)."""
    N, L = codes.shape
    c = codes.to(torch.int32)
    isn = (c >= 4).to(torch.int32)
    c = c & 3
    pad = n_words * BASES_PER_WORD - L
    if pad:
        c = torch.nn.functional.pad(c, (0, pad))
        isn = torch.nn.functional.pad(isn, (0, pad), value=1)
    cw = c.reshape(N, n_words, BASES_PER_WORD)
    nw = isn.reshape(N, n_words, BASES_PER_WORD)
    packed = torch.zeros((N, n_words), dtype=torch.int32, device=codes.device)
    nplane = torch.zeros_like(packed)
    for j in range(BASES_PER_WORD):
        packed |= cw[:, :, j] << (2 * j)
        nplane |= nw[:, :, j] << (2 * j)
    return packed, nplane


def revcomp_words(rpacked: torch.Tensor, rnplane: torch.Tensor,
                  lengths: torch.Tensor, L: int | None = None):
    """Word-space reverse complement, bit-identical to
    pack_reads(revcomp(codes)) given (rpacked, rnplane) =
    pack_reads(codes): a per-row word gather, a funnel shift by
    2*(len mod 16), a 2-bit-lane reversal and the complement (N lanes
    forced to the pad pattern 01). Lanes >= L pack code 00."""
    N, nw = rpacked.shape
    dev = rpacked.device
    lengths = lengths.to(torch.int32)
    z = torch.zeros((N, 1), dtype=torch.int32, device=dev)
    fp = torch.cat([z, rpacked, z], dim=1)       # fp[1 + w] = word w
    fn = torch.cat([z, rnplane, z], dim=1)
    u = torch.arange(nw, dtype=torch.int32, device=dev)[None, :]
    s = lengths[:, None] - 16 * (u + 1)          # fwd base of rc word u
    w0 = (torch.div(s, 16, rounding_mode="floor") + 1).clamp(0, nw).long()
    sh = (2 * (lengths % 16))[:, None].expand(N, nw)

    def vword(a):
        lo = torch.gather(a, 1, w0)
        hi = torch.gather(a, 1, w0 + 1)
        return funnel(lo, hi, sh)

    code = rev2bit(vword(fp))
    nbit = rev2bit(vword(fn))
    comp = ~code
    nmask2 = nbit | _tail_n_mask(lengths, nw)
    rc_code = (comp & ~(nmask2 | (nmask2 << 1))) | nmask2
    if L is not None and L < 16 * nw:
        lane = np.arange(16 * nw) < L
        lmask = np.zeros(nw, np.uint32)
        for w in range(nw):
            bits = 0
            for t in range(16):
                if lane[16 * w + t]:
                    bits |= 3 << (2 * t)
            lmask[w] = bits
        rc_code = rc_code & torch.from_numpy(lmask.view(np.int32)).to(dev)
    return rc_code, nmask2


def unpack_words_to_codes(rpacked: torch.Tensor, rnplane: torch.Tensor,
                          L: int) -> torch.Tensor:
    """(rpacked, rnplane) int32[N, nw] → uint8[N, L] read codes, N as
    code 5. Inverse of pack_reads for valid read codes."""
    sh = _lane_shifts(rpacked.device)[None, None, :]
    code = (rpacked[:, :, None] >> sh) & 3
    isn = (rnplane[:, :, None] >> sh) & 1
    out = torch.where(isn == 1, 5, code)
    N, nw = rpacked.shape
    return out.reshape(N, nw * BASES_PER_WORD)[:, :L].to(torch.uint8) \
        .contiguous()


def row_gather_window(table: torch.Tensor, starts: torch.Tensor, width: int,
                      *, row_words: int = ROW_WORDS) -> torch.Tensor:
    """table[starts[i] : starts[i]+width] per row, with the reference's
    row-view semantics: the table is seen as [M // row_words, row_words]
    rows, starts are clamped to [0, M-1] and row indexes to the last
    full row (callers pad tables with guard rows).

    Starts are widened to int64 before the clamp. The reference keeps
    the clamp-before-cast rule (urmap_tpu/genome_pack.py:106-119): a
    negative start must clip to the table HEAD, never wrap to a uint32
    near 2^32 and clip to the tail; int64 starts keep that for tables
    past 2^31 entries."""
    M = table.shape[0]
    nrows = M // row_words
    s = starts.to(torch.int64).clamp(0, M - 1)
    r0 = torch.div(s, row_words, rounding_mode="floor")
    t = (s - r0 * row_words)[:, None] + torch.arange(
        width, dtype=torch.int64, device=table.device)[None, :]
    r = (r0[:, None] + torch.div(t, row_words, rounding_mode="floor")) \
        .clamp(0, nrows - 1)
    return table[r * row_words + t % row_words]


def row128_window_fetch(table: torch.Tensor, starts: torch.Tensor,
                        width: int) -> torch.Tensor:
    """Window fetch from a table of M words, the dense [R, 128] view of
    the row128 layout or a 1-D table: table.flat[s : s + width] per row,
    with s = starts clipped to [0, M - width]. The plain version of
    kernel B5's window entry (kernels/lane_rotate.py).

    The reference gathers ceil(width/128) + 1 rows from s // 128 on,
    each row index clipped to R - 1, and funnels by s % 128; a clipped
    start never reads past the table, so that row clip changes no lane
    and this is equal on every lane."""
    s = starts.to(torch.int64).clamp(0, table.numel() - width)
    t = s[:, None] + torch.arange(width, dtype=torch.int64,
                                  device=table.device)[None, :]
    return table.reshape(-1)[t]


def gather_window(table: torch.Tensor, starts: torch.Tensor, width: int, *,
                  row_words: int = GATHER_ROW_WORDS) -> torch.Tensor:
    """table[starts[i] : starts[i]+width] per row, by the fetch the
    table's shape and device call for: every table on a CUDA device, of
    any length, and a [R, 128] table (row128 layout) anywhere go through
    kernel B5's window entry; a 1-D table on the CPU takes the
    narrow-row gather. The fetches agree wherever the window lies inside
    the table; they clamp a start past its end differently (callers keep
    used windows inside the guard words)."""
    from urmap_tpu_torch.kernels import lane_rotate

    if table.is_cuda or table.dim() == 2:
        return lane_rotate.row128_window_fetch(table, starts.to(torch.int64),
                                               width)
    return row_gather_window(table, starts, width, row_words=row_words)


def _gather_aligned(ginter: torch.Tensor, starts: torch.Tensor,
                    n_words: int, base_off: int, fetch=gather_window):
    """ONE window fetch from the interleaved table, funnel-aligned:
    (code words, N words) int32[N, n_words] for windows beginning at
    base ``starts[i]``."""
    s = starts.to(torch.int64)
    w0 = torch.div(s, BASES_PER_WORD, rounding_mode="floor") + base_off
    r = (s - (w0 - base_off) * BASES_PER_WORD).to(torch.int32)   # 0..15
    both = fetch(ginter, 2 * w0, 2 * (n_words + 1))
    both = both.reshape(both.shape[0], n_words + 1, 2)
    sh = (2 * r)[:, None].expand(-1, n_words)

    def fun(words):
        return funnel(words[:, :-1], words[:, 1:], sh)

    return fun(both[:, :, 0]), fun(both[:, :, 1])


def mismatch_counts_plain(ginter: torch.Tensor, base_off: int,
                          starts: torch.Tensor, rpacked: torch.Tensor,
                          rnplane: torch.Tensor, lengths: torch.Tensor,
                          fetch=gather_window) -> torch.Tensor:
    """Plain version of kernel B5's ``window_mismatches`` entry (gather
    + XOR + popcount). ``fetch`` is the window fetch in front:
    ``gather_window`` by default; ``row128_window_fetch`` gives the
    composition the entry equals on every lane, for any start."""
    N, nw = rpacked.shape
    ga, na = _gather_aligned(ginter, starts, nw, base_off, fetch)
    x = ga ^ rpacked
    bits = ((x | srl(x, 1)) | na | rnplane) & EVEN
    base_idx = torch.arange(nw, dtype=torch.int32,
                            device=rpacked.device) * BASES_PER_WORD
    rem = (lengths[:, None] - base_idx[None, :]).clamp(0, BASES_PER_WORD)
    tail = torch.where(rem >= BASES_PER_WORD, -1,
                       (1 << (2 * rem).clamp(max=30)) - 1)
    return popcount(bits & tail).sum(dim=1, dtype=torch.int32)


def gather_codes_plain(ginter: torch.Tensor, base_off: int,
                       starts: torch.Tensor, length: int,
                       fetch=gather_window) -> torch.Tensor:
    """Plain version of kernel B5's ``window_codes`` entry; ``fetch`` as
    in ``mismatch_counts_plain``."""
    nw = -(-length // BASES_PER_WORD)
    ga, na = _gather_aligned(ginter, starts, nw, base_off, fetch)
    sh = _lane_shifts(ga.device)[None, None, :]
    code = (ga[:, :, None] >> sh) & 3
    isn = (na[:, :, None] >> sh) & 1
    out = torch.where(isn == 1, 4, code)
    return out.reshape(ga.shape[0], nw * BASES_PER_WORD)[:, :length] \
        .to(torch.uint8).contiguous()


def mismatch_counts(ginter: torch.Tensor, base_off: int,
                    starts: torch.Tensor, rpacked: torch.Tensor,
                    rnplane: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Bit-parallel ungapped mismatch count per row: int32[N] mismatches
    over the first ``lengths`` bases. On a CUDA table one launch of
    kernel B5's fused entry, on a CPU table ``mismatch_counts_plain``
    (kernels/lane_rotate.py)."""
    from urmap_tpu_torch.kernels import lane_rotate

    return lane_rotate.window_mismatches(ginter, base_off, starts, rpacked,
                                         rnplane, lengths)


def gather_codes(ginter: torch.Tensor, base_off: int, starts: torch.Tensor,
                 length: int) -> torch.Tensor:
    """Byte-code window per row from the packed planes: uint8[N, length]
    with genome N as code 4 (the DP window feed). On a CUDA table one
    launch of kernel B5's fused entry, on a CPU table
    ``gather_codes_plain`` (kernels/lane_rotate.py)."""
    from urmap_tpu_torch.kernels import lane_rotate

    return lane_rotate.window_codes(ginter, base_off, starts, length)
