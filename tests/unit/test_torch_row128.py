"""The row128 layout's device half and kernels B5 and B1' (plain
versions) against urmap_tpu, exact: every output is an integer.

``ginter_rows``; the two dense-row fetches against the JAX functions
(which take their jnp funnel on the CPU) with starts at both ends, past
the end and negative; the literal rotate against the Pallas kernel in
interpret mode; ``gather_candidates`` with packed and plain offsets;
the aligned layout read through its 128-word view; the byte-genome DP
against the jnp function and the Pallas kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from urmap_tpu import genome_pack as jgpk
from urmap_tpu.config import IndexConfig, ScoreConfig as JScore
from urmap_tpu.index import store as jstore
from urmap_tpu.index.build import build_index as jbuild
from urmap_tpu.kernels.banded_dp import banded_semiglobal_pallas
from urmap_tpu.kernels.lane_rotate import rotate_narrow_pallas
from urmap_tpu.map import dp as jdp
from urmap_tpu.map import seed as jseed
from urmap_tpu_torch import genome_pack as tgpk
from urmap_tpu_torch.config import ScoreConfig as TScore
from urmap_tpu_torch.index import build_index as tbuild
from urmap_tpu_torch.index import store as tstore
from urmap_tpu_torch.kernels import banded_dp as kdp
from urmap_tpu_torch.kernels import lane_rotate as krot
from urmap_tpu_torch.map import dp as tdp
from urmap_tpu_torch.map import seed as tseed
from tests.utils import make_seqdb

CPU = torch.device("cpu")


def i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n", [128 * 7, 128 * 7 + 38, 2])
def test_ginter_rows_matches(rng, n):
    g = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    want = jstore.ginter_rows(g)
    got = tstore.ginter_rows(g)
    assert got.shape == want.shape and got.shape[1] == 128
    np.testing.assert_array_equal(got, want)


def _starts(rng, M, width, n=200):
    """Window starts with the awkward cases in front: both ends of the
    table, the last start that fits, past the end, negative."""
    edge = [0, 1, 127, 128, M - width, M - width - 1, M - width + 1, M - 1,
            M, M + 500, -1, -129, -(1 << 20)]
    return np.concatenate([edge, rng.integers(0, M - width, n - len(edge))]
                          ).astype(np.int32)


@pytest.mark.parametrize("width", [16, 22, 26, 128, 129, 152, 256])
@pytest.mark.parametrize("rows", [3, 9])   # 9: more than one guard row
def test_row128_window_fetch_matches(rng, width, rows):
    """W = 256 (width <= 128) and W = 384 (width 129-256): equal to the
    reference on every lane."""
    table = rng.integers(0, 1 << 32, rows * 128, dtype=np.uint64) \
        .astype(np.uint32).reshape(rows, 128)
    starts = _starts(rng, rows * 128, width)
    want = jgpk.row128_window_fetch(jnp.asarray(table), jnp.asarray(starts),
                                    width)
    krot.window_counter.reset()
    for st in (starts, starts.astype(np.int64)):
        got = krot.row128_window_fetch(i32(table), torch.from_numpy(st),
                                       width)
        assert got.dtype == torch.int32 and got.shape == (len(st), width)
        np.testing.assert_array_equal(np.asarray(want), u32(got))
    assert (krot.window_counter.plain_calls,
            krot.window_counter.launches) == (2, 0)
    # the fetch through gather_window, as _gather_aligned reaches it
    np.testing.assert_array_equal(
        np.asarray(want),
        u32(tgpk.gather_window(i32(table), torch.from_numpy(starts), width)))


@pytest.mark.parametrize("width", [4, 16, 64, 128])
def test_row128_fetch_matches(rng, width):
    """One row per start (W = 128): SENTINEL in the lanes past the
    row's end, the row index clipped to the table."""
    R = 6
    table = rng.integers(-(1 << 31), 1 << 31, (R, 128)).astype(np.int32)
    starts = np.concatenate([
        [0, 127, 128, R * 128 - 1, R * 128 - width, R * 128, R * 128 + 77],
        rng.integers(0, R * 128, 150)]).astype(np.uint32)
    want = jseed._row128_fetch(jnp.asarray(table), jnp.asarray(starts), width)
    krot.fetch_counter.reset()
    got = krot.row128_fetch(torch.from_numpy(table),
                            torch.from_numpy(starts.astype(np.int64)), width)
    assert (krot.fetch_counter.plain_calls,
            krot.fetch_counter.launches) == (1, 0)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    past = (starts % 128)[:, None] + np.arange(width)[None, :] >= 128
    assert past.any() == (width > 1)
    assert (got.numpy()[past] == tseed.SENTINEL).all()


@pytest.mark.parametrize("W,width", [(128, 16), (256, 22), (256, 26),
                                     (384, 152), (128, 128)])
def test_rotate_narrow_matches_pallas(rng, W, width):
    """The literal rotate is circular, as the TPU kernel's rolls are:
    equal on every lane, wrapped ones included."""
    N = 300                                    # not a multiple of its block
    rows = rng.integers(-(1 << 31), 1 << 31, (N, W)).astype(np.int32)
    off = rng.integers(0, 128, N).astype(np.int32)
    off[:4] = [0, 127, 1, 64]
    want = np.asarray(rotate_narrow_pallas(jnp.asarray(rows),
                                           jnp.asarray(off), width,
                                           interpret=True))
    krot.rotate_counter.reset()
    got = krot.rotate_narrow(torch.from_numpy(rows), torch.from_numpy(off),
                             width).numpy()
    assert krot.rotate_counter.plain_calls == 1
    np.testing.assert_array_equal(want, got)
    used = off[:, None] + np.arange(width)[None, :] < W
    direct = np.stack([np.roll(rows[i], -off[i])[:width] for i in range(N)])
    np.testing.assert_array_equal(got[used], direct[used])


@pytest.fixture(scope="module")
def row128_tables():
    """One index, prepared as row128 (with packed offsets) by both
    packages."""
    import os

    rng = np.random.default_rng(3)
    db = make_seqdb(rng, [60_000, 30_000])
    cfg = IndexConfig(slot_bits=13)
    index = jbuild(db, cfg, backend="host")
    p = 4
    old = os.environ.get("URMAP_ROW128_BYTES")
    os.environ["URMAP_ROW128_BYTES"] = "1"
    try:
        jprep = jstore.prepare_tables(index, p)
        tprep = tstore.prepare_tables(tbuild(db, cfg, backend="host"), p)
    finally:
        if old is None:
            del os.environ["URMAP_ROW128_BYTES"]
        else:
            os.environ["URMAP_ROW128_BYTES"] = old
    assert jprep[1]["layout"] == tprep[1]["layout"] == "row128"
    return index, p, jprep, tprep


def test_prepared_row128_tables_equal(row128_tables):
    _index, _p, (jht, jmeta), (tht, tmeta) = row128_tables
    assert jmeta == tmeta and jmeta["off_bits"] is not None
    for k in ("offsets", "positions", "ginter", "opacked", "obase"):
        np.testing.assert_array_equal(np.asarray(jht[k]), np.asarray(tht[k]),
                                      err_msg=k)


def _seeds(rng, S, n=64, q=8):
    slots = rng.integers(0, S, size=(n, q)).astype(np.uint32)
    slots[0, :4] = [S - 1, S - 2, 0, 1]        # the last slot, both halves
    offs = rng.integers(0, 127, size=(n, q)).astype(np.int32)
    valid = rng.random((n, q)) < 0.8
    valid[0] = True
    return slots, offs, valid


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("maker", ["reference", "port"])
def test_gather_candidates_row128_matches(rng, row128_tables, monkeypatch,
                                          packed, maker):
    index, p, jprep, tprep = row128_tables
    ht, meta = jprep if maker == "reference" else tprep
    if not packed:
        monkeypatch.setenv("URMAP_NO_PACKED_OFFSETS", "1")
    dt = tstore.tables_from_numpy(ht, meta, CPU)
    assert dt["row128"] and dt["positions"].dim() == 2 \
        and dt["ginter"].dim() == 2
    assert (dt["off_bits"] is not None) == packed == ("obase" in dt)
    cb, bb = tuple(meta["off_bits"]) if packed else (0, 0)
    jt = jstore.tables_to_device(ht, use_packed_offsets=packed)
    slots, offs, valid = _seeds(rng, index.config.num_slots)
    want = jseed.gather_candidates(
        jt["offsets"], jt["positions"], jnp.asarray(slots), jnp.asarray(offs),
        jnp.asarray(valid), p=p, row128=True, obase=jt.get("obase"),
        off_cnt_bits=cb, off_block_bits=bb)
    got = tseed.gather_candidates(
        dt["offsets"], dt["positions"], i32(slots), torch.from_numpy(offs),
        torch.from_numpy(valid), p=p, row128=True, obase=dt.get("obase"),
        off_cnt_bits=cb, off_block_bits=bb)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert (got.numpy() != tseed.SENTINEL).any()


def test_packed_offsets_odd_slot_count(rng):
    """An odd number of slots: the last word holds one entry; a high
    obase makes the decoded starts pass 2^31."""
    p, S = 4, 9
    cb, bb = tstore.packed_offsets_bits(p)
    counts = rng.integers(0, p + 1, S)
    starts, total = tstore.align_runs_fixed(counts.astype(np.int64), 128)
    offsets = np.concatenate([starts, [total]]).astype(np.uint32)
    pk = tstore.pack_offsets_row128(offsets, p)
    assert pk["opacked"].shape[0] == 5
    R = -(-int(total) // 128) + 1
    pos = rng.integers(0, 1 << 20, (R, 128)).astype(np.int32)
    slots = np.arange(S, dtype=np.uint32)[None, :]
    offs = np.zeros((1, S), np.int32)
    valid = np.ones((1, S), bool)
    want = jseed.gather_candidates(
        jnp.asarray(pk["opacked"]), jnp.asarray(pos), jnp.asarray(slots),
        jnp.asarray(offs), jnp.asarray(valid), p=p, row128=True,
        obase=jnp.asarray(pk["obase"]), off_cnt_bits=cb, off_block_bits=bb)
    args = (i32(slots), torch.from_numpy(offs), torch.from_numpy(valid))
    got = tseed.gather_candidates(
        i32(pk["opacked"]), torch.from_numpy(pos), *args, p=p, row128=True,
        obase=i32(pk["obase"]), off_cnt_bits=cb, off_block_bits=bb)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    plain = tseed.gather_candidates(i32(offsets), torch.from_numpy(pos),
                                    *args, p=p, row128=True)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    # bases past 2^31: the starts must come out as uint32 values, which
    # a row index clipped to the last row shows
    high = pk["obase"] + np.uint32(0xF000_0000)
    far = tseed.gather_candidates(
        i32(pk["opacked"]), torch.from_numpy(pos), *args, p=p, row128=True,
        obase=i32(high), off_cnt_bits=cb, off_block_bits=bb)
    want_far = jseed.gather_candidates(
        jnp.asarray(pk["opacked"]), jnp.asarray(pos), jnp.asarray(slots),
        jnp.asarray(offs), jnp.asarray(valid), p=p, row128=True,
        obase=jnp.asarray(high), off_cnt_bits=cb, off_block_bits=bb)
    np.testing.assert_array_equal(np.asarray(want_far), far.numpy())


@pytest.mark.parametrize("words", [16 * 23, 16 * 23 + 5, 128 * 3])
@pytest.mark.parametrize("rw,width", [(16, 16), (16, 4), (32, 20)])
def test_row_fetch_of_a_1d_table_matches(rng, words, rw, width):
    """The row entry of B5 on a 1-D table of any length (the aligned
    layout, rows of ``rw`` words): equal to the reference's narrow-row
    fetch on every lane, the partial last row never read."""
    table = rng.integers(-(1 << 31), 1 << 31, words).astype(np.int32)
    nrows = words // rw
    starts = np.concatenate([
        [0, rw - 1, rw, nrows * rw - 1, nrows * rw - width, words - 1, words,
         words + 300], rng.integers(0, words, 120)]).astype(np.uint32)
    want = jseed._aligned_rows_fetch(jnp.asarray(table), jnp.asarray(starts),
                                     width, rw)
    krot.fetch_counter.reset()
    got = krot.row128_fetch(torch.from_numpy(table),
                            torch.from_numpy(starts.astype(np.int64)), width,
                            row_words=rw)
    assert (krot.fetch_counter.plain_calls,
            krot.fetch_counter.launches) == (1, 0)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    with pytest.raises(ValueError, match="row_words"):
        krot.row128_fetch(torch.from_numpy(table[:256]).view(2, 128),
                          torch.zeros(1, dtype=torch.int64), width,
                          row_words=rw)


def test_aligned_through_128_view_equals_narrow_rows(rng):
    """An aligned table read as 128-word rows (what the reference does
    on its accelerator) gives the candidates of the narrow-row fetch,
    which the port takes on either device, once lanes past each run's
    count are masked; the raw fetches differ there (a neighbouring
    run's entries against SENTINEL)."""
    p, S = 16, 700
    rw = tseed.align_row_words(p)
    counts = rng.integers(0, p + 1, S).astype(np.int64)
    starts, total = tstore.align_runs(counts, rw)
    M = int(total) + 64 + (-(int(total) + 64)) % 128
    table = np.full(M, tseed.SENTINEL, np.int32)
    for s0, c in zip(starts, counts):
        table[s0 : s0 + c] = rng.integers(-(1 << 31), 1 << 20, c)
    offsets = i32(np.concatenate([starts, [total]]).astype(np.uint32))
    pos = torch.from_numpy(table)
    slots, offs, valid = _seeds(rng, S, n=256)
    flat = torch.from_numpy(starts)[i32(slots).long()].reshape(-1)
    cnt = torch.from_numpy(counts)[i32(slots).long()].reshape(-1, 1)
    narrow = tseed._aligned_rows_fetch(pos, flat, p, rw)
    dense = tseed._row128_fetch(pos.view(-1, 128), flat, p)
    live = torch.arange(p)[None, :] < cnt
    assert torch.equal(narrow[live], dense[live])
    assert not torch.equal(narrow, dense)
    cand = tseed.gather_candidates(
        offsets, pos, i32(slots), torch.from_numpy(offs),
        torch.from_numpy(valid), p=p, csr_aligned=True)
    shape = (*slots.shape, p)
    dense_cand = torch.where(
        live.reshape(shape) & torch.from_numpy(valid)[:, :, None]
        & (dense.reshape(shape) != tseed.SENTINEL),
        dense.reshape(shape) - torch.from_numpy(offs)[:, :, None],
        tseed.SENTINEL).reshape(cand.shape)
    assert torch.equal(cand, dense_cand)
    want = jseed.gather_candidates(
        jnp.asarray(u32(offsets)), jnp.asarray(table), jnp.asarray(slots),
        jnp.asarray(offs), jnp.asarray(valid), p=p, csr_aligned=True)
    np.testing.assert_array_equal(np.asarray(want), cand.numpy())


def _dp_case(rng, G=3000, n=96, L=64, hw=8):
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[rng.random(G) < 0.01] = 4
    cand = rng.integers(0, G - L, n).astype(np.int32)
    # near 0 and near G: the windows run off both ends
    cand[:8] = [0, 1, -3, -hw - 5, G - L, G - L + 3, G - 5, G + 40]
    reads = np.full((n, L), 5, np.uint8)
    lens = rng.integers(L - 10, L + 1, n).astype(np.int32)
    lens[8:14] = [0, 1, L, L + 1, L + 7, -2]   # above L: no last row
    for i in range(n):
        s = int(np.clip(cand[i] + rng.integers(-hw + 1, hw), 0, G - L - 8))
        r = genome[s : s + L + 8].copy()
        if i % 4 == 1:
            o, d = int(rng.integers(4, L - 8)), int(rng.integers(1, 5))
            r = np.concatenate([r[:o], r[o + d:]])
        if i % 4 == 2:
            o, d = int(rng.integers(4, L - 8)), int(rng.integers(1, 5))
            r = np.concatenate([r[:o], rng.integers(0, 4, d), r[o:]])
        if i % 4 == 3:                       # a random tail: clip mode
            r[L - 20 :] = rng.integers(0, 4, len(r) - L + 20)
        r = r[:L]
        k = max(int(lens[i]), 0)
        reads[i, :k] = np.where(r == 4, 5, r)[:k]
    return genome, cand, reads, lens


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("hw", [8, 16])
def test_banded_semiglobal_matches(rng, clip, hw):
    genome, cand, reads, lens = _dp_case(rng, hw=hw)
    jsc, tsc = JScore(), TScore()
    co = tsc.clip_open if clip else None
    jargs = tuple(jnp.asarray(a) for a in (genome, cand, reads, lens))
    want = jdp.banded_semiglobal(*jargs, hw=hw, sc=jsc, clip_open=co)
    kern = banded_semiglobal_pallas(*jargs, hw=hw, sc=jsc, clip_open=co,
                                    interpret=True)
    targs = tuple(torch.from_numpy(a) for a in (genome, cand, reads, lens))
    cnt = kdp.semiglobal_clip_counter if clip else kdp.semiglobal_counter
    cnt.reset()
    got = tdp.banded_dispatch(*targs, hw=hw, sc=tsc, clip_open=co)
    assert (cnt.plain_calls, cnt.launches) == (1, 0)
    for name, w, k, g in zip(("score", "d0", "ungapped", "span"), want,
                             kern, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(k), g.numpy(), err_msg=name)
    assert (got[2] < got[0]).any()             # gapped winners among them
