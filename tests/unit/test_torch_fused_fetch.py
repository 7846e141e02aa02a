"""The fused genome fetches of the port against urmap_tpu (exact).

``genome_pack.gather_codes`` and ``mismatch_counts`` dispatch to kernel
B5's fused entries (kernels/lane_rotate.py): on a CPU tensor the plain
versions run, and these are held here to the reference's functions on
the same numpy inputs: a 1-D interleaved table and its [R, 128] view,
windows of 192 and 1,200 bases and of a length that is no multiple of
16, starts that are negative, 0, at r = 0 and r = 15 of a word, in the
guard words and past the table's end. All outputs are integers: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401  (one torch thread)
from tests.unit.test_torch_cuda import fused_fetch_inputs
from urmap_tpu import genome_pack as jgpk
from urmap_tpu_torch import genome_pack as tgpk
from urmap_tpu_torch.kernels import counters, lane_rotate

LENGTHS = [192, 1200, 37]


def _both(table, base_off, st, length, rcodes, lens):
    """(reference codes, reference counts, port codes, port counts)."""
    nw = -(-length // 16)
    jt, js = jnp.asarray(table.view(np.uint32)), jnp.asarray(st)
    jw = jgpk.pack_reads(jnp.asarray(rcodes), jnp.asarray(lens), nw)
    tt, ts = torch.from_numpy(table), torch.from_numpy(st)
    tw = tgpk.pack_reads(torch.from_numpy(rcodes), torch.from_numpy(lens), nw)
    return (np.asarray(jgpk.gather_codes(jt, base_off, js, length)),
            np.asarray(jgpk.mismatch_counts(jt, base_off, js, *jw,
                                            jnp.asarray(lens))),
            tgpk.gather_codes(tt, base_off, ts, length).numpy(),
            tgpk.mismatch_counts(tt, base_off, ts, *tw,
                                 torch.from_numpy(lens)).numpy())


def _inputs(length, two_d):
    table, base_off, st, rcodes, lens = fused_fetch_inputs(21, 200, length,
                                                           two_d)
    return table, base_off, st.astype(np.int32), rcodes, lens


@pytest.mark.parametrize("length", LENGTHS)
def test_row128_table_matches_reference_on_every_start(length):
    """[R, 128] table: both packages clip the word start to
    [0, M - width], so every start agrees, those past the end too."""
    table, base_off, st, rcodes, lens = _inputs(length, True)
    jc, jm, tc, tm = _both(table, base_off, st, length, rcodes, lens)
    assert tc.dtype == np.uint8 and tc.shape == (200, length)
    assert tm.dtype == np.int32
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("length", LENGTHS)
def test_flat_table_matches_reference_row_gather(length, monkeypatch):
    """1-D table on the CPU: the port copies the reference's narrow-row
    gather (GATHER_MODE "row", its accelerator path), equal on every
    start."""
    monkeypatch.setattr(jgpk, "GATHER_MODE", "row")
    table, base_off, st, rcodes, lens = _inputs(length, False)
    jc, jm, tc, tm = _both(table, base_off, st, length, rcodes, lens)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("length", LENGTHS)
def test_flat_table_against_reference_cpu_default(length):
    """The reference's CPU default ("slice") pins a window that runs
    past the table to M - width, the narrow-row gather clips the start
    to M - 1 and the row index to the last row: the two agree wherever
    the word window lies inside the table (every start a caller uses,
    the guard words included) and differ in what they return for the
    starts past its end, G + 2^20 and 2^31 - 1, named here (G + 1,600
    still lies in the guard words)."""
    table, base_off, st, rcodes, lens = _inputs(length, False)
    jc, jm, tc, tm = _both(table, base_off, st, length, rcodes, lens)
    M = table.shape[0]
    width = 2 * (-(-length // 16) + 1)
    w = 2 * (st.astype(np.int64) // 16 + base_off)
    inside = (w >= 0) & (w <= M - width)
    assert inside.sum() >= 180 and (~inside).sum() >= 3
    np.testing.assert_array_equal(tc[inside], jc[inside])
    np.testing.assert_array_equal(tm[inside], jm[inside])
    G = 40_000
    past = np.isin(st, [G + (1 << 20), (1 << 31) - 1])
    assert past.sum() == 2 and not inside[past].any()
    assert inside[st == G + 16 * 100].all()
    # negative starts clip to the table's head in both
    head = w < 0
    assert head.any()
    np.testing.assert_array_equal(tc[head], jc[head])


@pytest.mark.parametrize("two_d", [False, True])
def test_plain_with_window_clamp_is_the_composition(two_d):
    """What the kernels are held to on the card: the plain versions
    with the window entry's clamp (``fetch=row128_window_fetch``) equal
    the window fetch followed by the array ops, and equal the default
    plain versions wherever the window lies inside the table."""
    length = 192
    table, base_off, st, rcodes, lens = _inputs(length, two_d)
    tt, ts = torch.from_numpy(table), torch.from_numpy(st)
    nw = length // 16
    tw = tgpk.pack_reads(torch.from_numpy(rcodes), torch.from_numpy(lens), nw)
    tl = torch.from_numpy(lens)
    a = tgpk.gather_codes_plain(tt, base_off, ts, length,
                                fetch=tgpk.row128_window_fetch)
    b = tgpk.gather_codes_plain(tt, base_off, ts, length)
    c = tgpk.mismatch_counts_plain(tt, base_off, ts, *tw, tl,
                                   fetch=tgpk.row128_window_fetch)
    d = tgpk.mismatch_counts_plain(tt, base_off, ts, *tw, tl)
    w = 2 * (st.astype(np.int64) // 16 + base_off)
    inside = torch.from_numpy((w >= 0) & (w <= table.size - 2 * (nw + 1)))
    if two_d:                       # one clamp: equal on every start
        inside[:] = True
    assert torch.equal(a[inside], b[inside])
    assert torch.equal(c[inside], d[inside])
    # r = 0 and r = 15 at a word boundary: the window's first base
    codes = tgpk.gather_codes_plain(tt, base_off, torch.tensor([15, 16]), 17)
    assert torch.equal(codes[0, 1:], codes[1, :16])


def test_counters_count_plain_calls_on_the_cpu():
    names = [c.name for c in counters()]
    assert "window_codes" in names and "window_mismatches" in names
    assert names.index("window_mismatches") < names.index("window_codes") \
        < names.index("banded_dp")
    table, base_off, st, rcodes, lens = _inputs(37, False)
    for c in counters():
        c.reset()
    tt, ts = torch.from_numpy(table), torch.from_numpy(st)
    tgpk.gather_codes(tt, base_off, ts, 37)
    tw = tgpk.pack_reads(torch.from_numpy(rcodes), torch.from_numpy(lens), 3)
    tgpk.mismatch_counts(tt, base_off, ts, *tw, torch.from_numpy(lens))
    tgpk.mismatch_counts(tt, base_off, ts, *tw, torch.from_numpy(lens))
    assert (lane_rotate.codes_counter.plain_calls,
            lane_rotate.codes_counter.launches) == (1, 0)
    assert (lane_rotate.mismatch_counter.plain_calls,
            lane_rotate.mismatch_counter.launches) == (2, 0)
    # a 1-D table on the CPU takes the narrow-row gather, not B5's
    # window entry; a [R, 128] table takes that entry's plain version
    assert lane_rotate.window_counter.plain_calls == 0
    tgpk.gather_codes(tt.view(-1, 128), base_off, ts, 37)
    assert lane_rotate.window_counter.plain_calls == 1
    assert lane_rotate.codes_counter.plain_calls == 2
