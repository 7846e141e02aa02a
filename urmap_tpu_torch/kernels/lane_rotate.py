"""Kernel B5 wrapper: narrow windows out of a table of 32-bit words.

CUDA tensors launch ``csrc/lane_rotate.cu`` (replaces
urmap_tpu/kernels/lane_rotate.py:rotate_narrow_pallas and the row
gathers in front of it); CPU tensors run the plain versions. Three
entries, counted separately:

  row128_fetch         one table row per start, SENTINEL past the
                       row's end (plain: map.seed._aligned_rows_fetch,
                       which at 128-word rows is _row128_fetch);
  row128_window_fetch  ``width`` words from a start clipped into the
                       table (plain: genome_pack.row128_window_fetch);
  rotate_narrow        the TPU function itself, on rows already
                       gathered: rows[i, (j + off[i]) % W] (plain:
                       ``rotate_narrow_plain`` below). The mapping path
                       never gathers whole rows, so nothing there calls
                       it; the tests hold it against the Pallas kernel.

The kernel indexes the table flat, so a table is the [R, 128] view of
the row128 layout or any 1-D table, of any length: no table on the card
is read by plain indexing. Tables and outputs are int32 words (uint32
bit patterns, ``_bits``); starts are int64, since a row128 table of a
human genome passes 2^31 words.
"""

from __future__ import annotations

import torch

from urmap_tpu_torch.kernels import Counter
from urmap_tpu_torch.kernels import _build

fetch_counter = Counter("row128_fetch")
window_counter = Counter("row128_window_fetch")
rotate_counter = Counter("rotate_narrow")


def _fetch(table: torch.Tensor, starts: torch.Tensor, width: int,
           row_words: int, window: bool) -> torch.Tensor:
    if table.dim() not in (1, 2) or (table.dim() == 2
                                     and table.shape[1] != 128):
        raise ValueError(f"table: expected 1-D or [R, 128], got "
                         f"{tuple(table.shape)}")
    _build.require_cuda(table, "table", torch.int32, table.dim())
    _build.require_cuda(starts, "starts", torch.int64, 1)
    M = table.numel()
    if width < 1 or M < (width if window else row_words) or row_words < 1:
        raise ValueError(f"table of {M} words: width {width}, rows of "
                         f"{row_words} words")
    n = starts.shape[0]
    out = torch.empty((n, width), dtype=torch.int32, device=table.device)
    err = _build.lib().urmap_row128_fetch(
        table.data_ptr(), M, row_words, starts.data_ptr(), out.data_ptr(), n,
        width, int(window), _build.stream_ptr(table.device))
    _build.check(err, "urmap_row128_fetch")
    return out


def row128_fetch(positions: torch.Tensor, flat_starts: torch.Tensor,
                 width: int, *, row_words: int = 128) -> torch.Tensor:
    """→ int32[N, width]: the first ``width`` entries at each CSR offset
    of a positions table whose runs never cross a row of ``row_words``
    words: [R, 128] (row128 layout) or 1-D (aligned layout, of any
    length); SENTINEL past the row's end. See
    map.seed._aligned_rows_fetch."""
    if positions.dim() == 2 and row_words != positions.shape[1]:
        raise ValueError(f"table: rows of {positions.shape[1]} words, "
                         f"row_words {row_words}")
    if not positions.is_cuda:
        from urmap_tpu_torch.map.seed import _aligned_rows_fetch

        fetch_counter.plain_calls += 1
        return _aligned_rows_fetch(positions.reshape(-1), flat_starts, width,
                                   row_words)
    out = _fetch(positions, flat_starts, width, row_words, window=False)
    fetch_counter.launched()
    return out


def row128_window_fetch(table: torch.Tensor, starts: torch.Tensor,
                        width: int) -> torch.Tensor:
    """→ int32[N, width] = table.flat[s : s + width] with s clipped to
    [0, M - width], M the table's words; the table is [R, 128] or 1-D.
    See genome_pack.row128_window_fetch."""
    if not table.is_cuda:
        from urmap_tpu_torch.genome_pack import row128_window_fetch as plain

        window_counter.plain_calls += 1
        return plain(table, starts, width)
    out = _fetch(table, starts, width, 1, window=True)
    window_counter.launched(width)
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
        rotate_counter.plain_calls += 1
        return rotate_narrow_plain(rows, off, width)
    _build.require_cuda(rows, "rows", torch.int32, 2)
    _build.require_cuda(off, "off", torch.int32, 1)
    n, W = rows.shape
    if off.shape[0] != n or not 1 <= width <= W:
        raise ValueError(f"rotate_narrow: rows {tuple(rows.shape)}, off "
                         f"{tuple(off.shape)}, width {width}")
    out = torch.empty((n, width), dtype=torch.int32, device=rows.device)
    err = _build.lib().urmap_rotate_narrow(
        rows.data_ptr(), off.data_ptr(), out.data_ptr(), n, W, width,
        _build.stream_ptr(rows.device))
    _build.check(err, "urmap_rotate_narrow")
    rotate_counter.launched()
    return out
