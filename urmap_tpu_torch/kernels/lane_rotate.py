"""Kernel B5 wrapper: narrow windows out of a table of 32-bit words.

CUDA tensors launch ``csrc/lane_rotate.cu`` (replaces
urmap_tpu/kernels/lane_rotate.py:rotate_narrow_pallas and the row
gathers in front of it); CPU tensors run the plain versions. Five
entries, counted separately:

  row128_fetch         one table row per start, SENTINEL past the
                       row's end (plain: map.seed._aligned_rows_fetch,
                       which at 128-word rows is _row128_fetch);
  row128_window_fetch  ``width`` words from a start clipped into the
                       table (plain: genome_pack.row128_window_fetch);
  window_codes         the window entry fused with what follows it on
                       the interleaved genome planes: fetch, funnel
                       shift, unpack to byte codes (plain:
                       genome_pack.gather_codes_plain);
  window_mismatches    fetch, funnel shift, XOR with the read's words,
                       N planes, tail mask, popcount, row sum (plain:
                       genome_pack.mismatch_counts_plain);
  rotate_narrow        the TPU function itself, on rows already
                       gathered: rows[i, (j + off[i]) % W] (plain:
                       ``rotate_narrow_plain`` below). The mapping path
                       never gathers whole rows, so nothing there calls
                       it; the tests hold it against the Pallas kernel.

The kernel indexes the table flat, so a table is the [R, 128] view of
the row128 layout or any 1-D table, of any length: no table on the card
is read by plain indexing. Tables and outputs are int32 words (uint32
bit patterns, ``_bits``); starts are int64, since a row128 table of a
human genome passes 2^31 words (the two fused entries take base
positions, int32 or int64, and widen them themselves).
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.kernels import Counter
from urmap_tpu_torch.kernels import _build

fetch_counter = Counter("row128_fetch")
window_counter = Counter("row128_window_fetch")
codes_counter = Counter("window_codes")
mismatch_counter = Counter("window_mismatches")
rotate_counter = Counter("rotate_narrow")


def row128_fetch(positions: torch.Tensor, flat_starts: torch.Tensor,
                 width: int, *, row_words: int = 128) -> torch.Tensor:
    """→ int32[N, width]: the first ``width`` entries at each CSR offset
    of a positions table whose runs never cross a row of ``row_words``
    words: [R, 128] (row128 layout) or 1-D (aligned layout, of any
    length); SENTINEL past the row's end. See
    map.seed._aligned_rows_fetch."""
    if not positions.is_cuda:
        from urmap_tpu_torch.map.seed import _aligned_rows_fetch

        if positions.dim() == 2 and row_words != positions.shape[1]:
            raise ValueError(f"table: rows of {positions.shape[1]} words, "
                             f"row_words {row_words}")
        fetch_counter.plain()
        return _aligned_rows_fetch(positions.reshape(-1), flat_starts, width,
                                   row_words)
    _build.load()
    out = torch.ops.urmap.row128_fetch(positions, flat_starts, width,
                                       row_words)
    fetch_counter.launched(width)
    return out


def row128_window_fetch(table: torch.Tensor, starts: torch.Tensor,
                        width: int) -> torch.Tensor:
    """→ int32[N, width] = table.flat[s : s + width] with s clipped to
    [0, M - width], M the table's words; the table is [R, 128] or 1-D.
    See genome_pack.row128_window_fetch."""
    if not table.is_cuda:
        from urmap_tpu_torch.genome_pack import row128_window_fetch as plain

        window_counter.plain()
        return plain(table, starts, width)
    _build.load()
    out = torch.ops.urmap.row128_window_fetch(table, starts, width)
    window_counter.launched(width)
    return out


def window_codes(ginter: torch.Tensor, base_off: int, starts: torch.Tensor,
                 length: int) -> torch.Tensor:
    """→ uint8[N, length]: the byte codes (genome N = 4) of the windows
    that begin at base ``starts[i]`` of the interleaved genome planes;
    see genome_pack.gather_codes."""
    if not ginter.is_cuda:
        from urmap_tpu_torch.genome_pack import gather_codes_plain

        codes_counter.plain()
        return gather_codes_plain(ginter, base_off, starts, length)
    _build.load()
    out = torch.ops.urmap.window_codes(ginter, base_off, starts, length)
    codes_counter.launched(length)
    return out


def window_mismatches(ginter: torch.Tensor, base_off: int,
                      starts: torch.Tensor, rpacked: torch.Tensor,
                      rnplane: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """→ int32[N]: mismatches of each read's words against the window at
    base ``starts[i]`` over the first ``lengths[i]`` bases; see
    genome_pack.mismatch_counts."""
    if not ginter.is_cuda:
        from urmap_tpu_torch.genome_pack import mismatch_counts_plain

        mismatch_counter.plain()
        return mismatch_counts_plain(ginter, base_off, starts, rpacked,
                                     rnplane, lengths)
    _build.load()
    out = torch.ops.urmap.window_mismatches(ginter, base_off, starts, rpacked,
                                            rnplane, lengths)
    mismatch_counter.launched()
    return out


def rotate_narrow_plain(rows: torch.Tensor, off: torch.Tensor,
                        width: int) -> torch.Tensor:
    """rows int32[N, W], off int32[N] → int32[N, width] with
    out[i, j] = rows[i, (j + off[i]) % W] (a circular rotate left, as
    the TPU kernel's seven conditional rolls give it)."""
    W = rows.shape[1]
    j = torch.arange(width, dtype=torch.int64, device=rows.device)
    return torch.gather(rows, 1, (j[None, :] + off.long()[:, None]) % W)


def rotate_narrow(rows: torch.Tensor, off: torch.Tensor,
                  width: int) -> torch.Tensor:
    """→ int32[N, width]; see rotate_narrow_plain."""
    if not rows.is_cuda:
        rotate_counter.plain()
        return rotate_narrow_plain(rows, off, width)
    _build.load()
    out = torch.ops.urmap.rotate_narrow(rows, off, width)
    rotate_counter.launched()
    return out
