"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a machine without a CUDA card. On the
card: ``python -m pytest tests -m cuda``. Every output is an integer,
so every comparison is exact.
"""

import functools

import numpy as np
import pytest
import torch

from tests.utils import make_seqdb, plant_pair, plant_read
from urmap_tpu_torch.config import MapConfig, ScoreConfig
from urmap_tpu_torch.index import build_index
from urmap_tpu_torch.kernels import counters
from urmap_tpu_torch.map import Mapper

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_kernels_match_plain_versions(cuda_device):
    import chip_smoke

    recs = chip_smoke.phase_kernels(cuda_device, np.random.default_rng(1),
                                    4096, 1024, 512)
    assert all(r["max_abs_err"] == 0 for r in recs.values()), recs
    assert {"tb_dops", "tb_dops_n128", "tb_dops_n16384", "tb_bits",
            "row128_fetch", "row128_window_fetch",
            "row128_window_fetch_w26", "row128_window_fetch_w152",
            "window_codes", "window_codes_row128", "window_codes_w1200",
            "window_mismatches", "window_mismatches_row128",
            "rotate_narrow", "banded_semiglobal",
            "banded_semiglobal_clip", "clip_tb"} <= set(recs)


def _tb_inputs(seed, n, L, hw, dev):
    """Windows with planted indels, drifted anchors, all-N and empty
    reads, and lengths above L, which have no last row (numpy from a
    seed, then onto the card)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=(n, L + 2 * hw + 48)).astype(np.uint8)
    win = g[:, 16 : 16 + L + 2 * hw].copy()
    reads = np.full((n, L), 5, np.uint8)
    lens = rng.integers(L - 20, L + 1, size=n).astype(np.int32)
    lens[::17] = np.resize([0, 1, L - 1, L, L + 5], len(lens[::17]))
    for i in range(n):
        s = 16 + hw + (int(rng.integers(-hw - 4, hw + 5)) if i % 5 == 4
                       else 0)
        r = g[i, s : s + L + 16].copy()
        if i % 5 == 1:
            o, d = int(rng.integers(8, L - 16)), int(rng.integers(1, min(hw, 12)))
            r = np.concatenate([r[:o], r[o + d :]])
        if i % 5 == 2:
            o, d = int(rng.integers(8, L - 16)), int(rng.integers(1, min(hw, 12)))
            r = np.concatenate([r[:o], rng.integers(0, 4, d), r[o:]])
        if i % 5 == 3 and i % 2:
            r[:] = 5
        reads[i] = r[:L]
    reads[np.arange(L)[None, :] >= lens[:, None]] = 5
    return tuple(torch.from_numpy(a).to(dev) for a in (win, reads, lens))


def tb_edge_cases(seed, n, L, hw):
    """numpy (windows, reads, lengths) for the traceback DP with the
    cases that pin its edges: row 0 takes hw insertions (the path
    reaches band cell 0) and then a 3-base deletion, whose chain the
    walk follows down to cell 0; row 1 takes hw deletions (the path
    reaches the band's last cell) and then a 2-base insertion there;
    rows 2, 3, 4 have lengths 0, L + 3 (no last row) and L; the rest are
    planted indels, drifted anchors and all-N reads of mixed lengths."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=(n, L + 4 * hw + 64)).astype(np.uint8)
    p = 16 + hw                                  # POS inside g's rows
    win = g[:, 16 : 16 + L + 2 * hw].copy()
    reads = np.full((n, L), 5, np.uint8)
    lens = rng.integers(max(L - 20, 1), L + 1, size=n).astype(np.int32)
    for i in range(n):
        s = p + (int(rng.integers(-hw - 4, hw + 5)) if i % 5 == 4 else 0)
        r = g[i, s : s + L + 16].copy()
        if i % 5 == 1:
            o, d = int(rng.integers(2, L - 6)), int(rng.integers(1, hw))
            r = np.concatenate([r[:o], r[o + d :]])
        if i % 5 == 2:
            o, d = int(rng.integers(2, L - 6)), int(rng.integers(1, hw))
            r = np.concatenate([r[:o], rng.integers(0, 4, d), r[o:]])
        if i % 5 == 3 and i % 2:
            r[:] = 5
        reads[i] = r[:L]
    row = g[0, p:]
    reads[0] = np.concatenate([row[:6], (row[6 : 6 + hw] + 1) % 4,
                               row[6:12], row[15:]])[:L]
    lens[0] = L
    if n > 1:
        row = g[1, p:]
        reads[1] = np.concatenate([row[:6], row[6 + hw : 12 + hw],
                                   (row[12 + hw : 14 + hw] + 2) % 4,
                                   row[12 + hw :]])[:L]
        lens[1] = L
    for i, ln in ((2, 0), (3, L + 3), (4, L)):
        if n > i:
            lens[i] = ln
    reads[np.arange(L)[None, :] >= lens[:, None]] = 5
    return win, reads, lens


@pytest.mark.parametrize("n", [1, 33, 128, 2048])
@pytest.mark.parametrize("hw,L", [(16, 160), (16, 150), (16, 37), (8, 160),
                                  (8, 150), (8, 37)])
def test_tb_dops_kernel_edges_match_plain(cuda_device, hw, L, n):
    """B6 with few and many winners, read lengths that are no multiple
    of 8 or 4, and the edge rows of ``tb_edge_cases``: equal to the plain
    version on every output."""
    from urmap_tpu_torch.kernels import tb_dp
    from urmap_tpu_torch.map import tb as plain

    args = tuple(torch.from_numpy(a).to(cuda_device)
                 for a in tb_edge_cases(11, n, L, hw))
    tb_dp.counter.reset()
    got = tb_dp.tb_dops_from_windows(*args, hw=hw, sc=ScoreConfig())
    torch.cuda.synchronize()
    assert tb_dp.counter.launches == 1 and tb_dp.counter.plain_calls == 0
    want = plain.tb_dops_from_windows(*args, hw=hw, sc=ScoreConfig())
    for name, g, w in zip(("score", "dops", "walk_ok"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("mode", ["dops", "bits"])
@pytest.mark.parametrize("hw,L", [(16, 160), (8, 100), (16, 101)])
def test_tb_kernel_matches_plain(cuda_device, mode, hw, L):
    from urmap_tpu_torch.kernels import tb_dp
    from urmap_tpu_torch.map import tb as plain

    win, reads, lens = _tb_inputs(3, 300, L, hw, cuda_device)
    name = "tb_dops_from_windows" if mode == "dops" else "tb_from_windows"
    cnt = tb_dp.counter if mode == "dops" else tb_dp.bits_counter
    cnt.reset()
    got = getattr(tb_dp, name)(win, reads, lens, hw=hw, sc=ScoreConfig())
    torch.cuda.synchronize()
    assert cnt.launches == 1 and cnt.plain_calls == 0
    want = getattr(plain, name)(win, reads, lens, hw=hw, sc=ScoreConfig())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_tb_kernel_refuses_uncompiled_halfwidth(cuda_device):
    """B6 has no kernel for hw=32: a dops record holds the deletion run
    in 6 bits, and a CUDA tensor raises with that reason, it never falls
    back. B7 has one, equal to its plain version."""
    from urmap_tpu_torch.kernels import tb_dp
    from urmap_tpu_torch.map import tb as plain

    win, reads, lens = _tb_inputs(4, 64, 96, 32, cuda_device)
    with pytest.raises(ValueError, match="no kernel for hw=32: a dops "
                                         "record holds the deletion run in "
                                         "6 bits"):
        tb_dp.tb_dops_from_windows(win, reads, lens, hw=32, sc=ScoreConfig())
    got = tb_dp.tb_from_windows(win, reads, lens, hw=32, sc=ScoreConfig())
    want = plain.tb_from_windows(win, reads, lens, hw=32, sc=ScoreConfig())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("max_read_len,tb_bits", [(160, True), (150, True),
                                                  (160, False)])
def test_cuda_mapper_matches_cpu_mapper(cuda_device, max_read_len, tb_bits):
    rng = np.random.default_rng(2)
    db = make_seqdb(rng, [200_000])
    reads = [plant_read(rng, db, n_snps=int(rng.integers(0, 6)),
                        ins=int(rng.integers(0, 2)) * 4) for _ in range(500)]
    codes = np.stack([r.codes for r in reads])
    lengths = np.full(len(reads), 150, np.int32)
    idx = build_index(db, backend="host")
    mcfg = MapConfig(batch_size=256, max_read_len=max_read_len,
                     tb_bits=tb_bits)
    for c in counters():
        c.reset()
    got = Mapper(idx, mcfg, device=cuda_device).map_codes(codes, lengths)
    by_name = {c.name: c for c in counters()}
    assert all(by_name[k].launches > 0 and by_name[k].plain_calls == 0
               for k in ("seed_front", "vote", "banded_dp"))
    assert by_name["tb_dops"].launches == (2 if tb_bits else 0)
    assert by_name["tb_dops"].plain_calls == 0
    want = Mapper(idx, mcfg, device="cpu").map_codes(codes, lengths)
    for f in ("mapped", "pos", "strand", "score", "second", "mapq",
              "gapped", "ungapped", "clipped", "suspect"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert (got.tb is not None) == tb_bits
    if tb_bits:
        assert got.tb["rows"].size > 0
        for k in got.tb:
            a, b = got.tb[k], want.tb[k]
            if k == "dops":
                # live lanes: a fill lane's window lies past the table's
                # end, where the card's fetch (kernel B5) and the CPU's
                # narrow-row gather clamp differently; never read
                a, b = a[:, got.tb["cols"]], b[:, want.tb["cols"]]
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("n,L", [(8192, 160), (300, 37), (300, 101),
                                 (1, 150), (300, 207)])
def test_clip_tb_kernel_matches_plain(cuda_device, n, L):
    """The clip traceback at se150_adapters' shape (8,192 lanes, reads
    of 150 in a block of 160: chip_smoke.clip_tb_inputs) and at other
    read blocks up to its 207, with lanes of length 0, above the block,
    of width 0 and cut short: equal to the plain version on every
    output."""
    import chip_smoke
    from urmap_tpu_torch.kernels import clip_tb
    from urmap_tpu_torch.map import clip_tb as plain

    sc = ScoreConfig()
    rng = np.random.default_rng(L)
    if L == chip_smoke.L_MAX:
        arrays = chip_smoke.clip_tb_inputs(rng, n)
    else:
        g = rng.integers(0, 4, (n, L + 64)).astype(np.uint8)
        win = g[:, : L + 48].copy()
        reads = np.full((n, L), 5, np.uint8)
        lens = rng.integers(max(L // 2, 1), L + 1, n).astype(np.int32)
        for i in range(n):
            r = g[i, : lens[i]].copy()
            t = int(rng.integers(0, lens[i] // 2 + 1))
            r[lens[i] - t :] = rng.integers(0, 4, t)
            reads[i, : lens[i]] = r
        widths = np.minimum(lens + 48, rng.integers(1, L + 49, n)) \
            .astype(np.int32)
        if n > 3:
            lens[-3:] = [0, L + 1, L]
            widths[-1] = 0
        arrays = (win, reads, lens, widths)
    args = tuple(torch.from_numpy(a).to(cuda_device) for a in arrays)
    clip_tb.counter.reset()
    got = clip_tb.clip_tb(*args, sc=sc, clip_open=sc.clip_open)
    torch.cuda.synchronize()
    assert clip_tb.counter.launches == 1
    assert clip_tb.counter.plain_calls == 0
    want = plain.clip_tb_from_windows(*args, sc=sc, clip_open=sc.clip_open)
    for name, g_, w in zip(("score", "recs", "ok"), got, want):
        assert g_.dtype == w.dtype and g_.shape == w.shape, name
        assert torch.equal(g_, w), name
    assert int(want[2].sum()) >= n - 3


def test_clip_tb_kernel_refuses_what_it_cannot_hold(cuda_device):
    """Reads above 207 bases (a warp holds 256 window columns) and
    gap_open above gap_extend (the deletion chain's closed form is not
    the host's there) raise ValueError; the mapping path never asks
    (kernels.clip_tb.enabled)."""
    from urmap_tpu_torch.kernels import clip_tb

    for L, sc in ((208, ScoreConfig()),
                  (150, ScoreConfig(gap_open=-1, gap_extend=-2))):
        args = (torch.zeros((4, L + 48), dtype=torch.uint8,
                            device=cuda_device),
                torch.zeros((4, L), dtype=torch.uint8, device=cuda_device),
                torch.full((4,), L, dtype=torch.int32, device=cuda_device),
                torch.full((4,), L, dtype=torch.int32, device=cuda_device))
        assert not clip_tb.enabled(L, sc)
        with pytest.raises(ValueError, match="clip_tb"):
            clip_tb.clip_tb(*args, sc=sc, clip_open=sc.clip_open)


def test_cuda_mapper_clip_tb_matches_cpu_mapper(cuda_device):
    """Reads with 65-75 base adapter tails: the clip-rescued gapped
    winners take the clip traceback on the card, its live records equal
    the CPU Mapper's, and the SAM writer's CIGARs from them equal the
    host clip DP's."""
    from urmap_tpu_torch.kernels import clip_tb
    from urmap_tpu_torch.map.cigar import cigars_nm_blob

    rng = np.random.default_rng(5)
    db = make_seqdb(rng, [200_000])
    reads = []
    for i in range(512):
        r = plant_read(rng, db, n_snps=1, dels=2 if i % 4 == 1 else 0)
        if i % 3 == 0:
            t = int(rng.integers(65, 76))
            r.codes = r.codes.copy()
            r.codes[150 - t :] = rng.integers(0, 4, t)
        reads.append(r)
    codes = np.stack([r.codes for r in reads])
    lengths = np.full(len(reads), 150, np.int32)
    idx = build_index(db, backend="host")
    mcfg = MapConfig(batch_size=256)
    clip_tb.counter.reset()
    got = Mapper(idx, mcfg, device=cuda_device).map_codes(codes, lengths)
    assert clip_tb.counter.launches == 2
    assert clip_tb.counter.plain_calls == 0
    want = Mapper(idx, mcfg, device="cpu").map_codes(codes, lengths)
    crow = np.nonzero(got.clipped & got.gapped & got.mapped)[0]
    assert crow.size > 50
    np.testing.assert_array_equal(got.clip_tb["rows"], crow)
    for k in got.clip_tb:
        a, b = got.clip_tb[k], want.clip_tb[k]
        if k == "recs":
            a, b = a[:, got.clip_tb["cols"]], b[:, want.clip_tb["cols"]]
        np.testing.assert_array_equal(a, b, err_msg=k)
    blob = cigars_nm_blob(db.codes, codes, got, ScoreConfig(),
                          clip_rows=got.clipped)
    got.clip_tb = None
    assert cigars_nm_blob(db.codes, codes, got, ScoreConfig(),
                          clip_rows=got.clipped)[0] == blob[0]


def test_cuda_end_clip_mapper_clip_tb_matches_cpu_mapper(cuda_device):
    """Under end_clip every mapped gapped winner (indels and adapter
    tails) takes the clip traceback on the card in place of B6: results
    and live records equal the CPU Mapper's, and the CIGARs replayed
    from them equal the host clip DP's."""
    from urmap_tpu_torch.kernels import clip_tb, tb_dp
    from urmap_tpu_torch.map.cigar import cigars_nm_blob

    rng = np.random.default_rng(6)
    db = make_seqdb(rng, [200_000])
    reads = []
    for i in range(512):
        r = plant_read(rng, db, n_snps=1, dels=3 if i % 4 == 1 else 0,
                       ins=2 if i % 4 == 2 else 0)
        if i % 3 == 0:
            t = int(rng.integers(30, 76))
            r.codes = r.codes.copy()
            r.codes[150 - t :] = rng.integers(0, 4, t)
        reads.append(r)
    codes = np.stack([r.codes for r in reads])
    lengths = np.full(len(reads), 150, np.int32)
    idx = build_index(db, backend="host")
    mcfg = MapConfig(batch_size=256, end_clip=True)
    clip_tb.counter.reset()
    tb_dp.counter.reset()
    got = Mapper(idx, mcfg, device=cuda_device).map_codes(codes, lengths)
    assert clip_tb.counter.launches == 2 and tb_dp.counter.launches == 0
    assert clip_tb.counter.plain_calls == 0
    want = Mapper(idx, mcfg, device="cpu").map_codes(codes, lengths)
    for f in ("mapped", "pos", "strand", "score", "mapq", "gapped"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    grow = np.nonzero(got.gapped & got.mapped)[0]
    assert grow.size > 200
    np.testing.assert_array_equal(got.clip_tb["rows"], grow)
    for k in got.clip_tb:
        a, b = got.clip_tb[k], want.clip_tb[k]
        if k == "recs":
            a, b = a[:, got.clip_tb["cols"]], b[:, want.clip_tb["cols"]]
        np.testing.assert_array_equal(a, b, err_msg=k)
    blob = cigars_nm_blob(db.codes, codes, got, ScoreConfig())
    got.clip_tb = None
    assert cigars_nm_blob(db.codes, codes, got, ScoreConfig())[0] == blob[0]


def fused_fetch_inputs(seed, n, length, two_d):
    """numpy inputs of the fused genome fetches: an interleaved table
    of packed planes (1-D, or its [R, 128] view), base starts that are
    negative, 0, at both ends of a word (r = 0 and r = 15), in the guard
    words, and past the table's end, and read words with lengths."""
    from urmap_tpu_torch import _bits
    from urmap_tpu_torch import genome_pack as gpk

    rng = np.random.default_rng(seed)
    G = 40_000
    codes = rng.integers(0, 4, G).astype(np.uint8)
    codes[rng.random(G) < 0.01] = 4
    inter, base_off = gpk.pack_genome(codes)
    table = _bits.as_i32(inter)
    if two_d:
        table = table.reshape(-1, 128)
    st = rng.integers(0, G - length, n)
    edge = [0, 15, 16, 31, -1, -15, -16, -17, -300, -(1 << 20),
            G - length, G - 3, G + 5, G + 16 * 100, G + (1 << 20),
            (1 << 31) - 1, -(1 << 31)]
    st[: len(edge)] = edge[:n]
    nw = -(-length // 16)
    rcodes = rng.integers(0, 4, (n, 16 * nw)).astype(np.uint8)
    rcodes[rng.random(rcodes.shape) < 0.02] = 5
    lens = rng.integers(0, length + 1, n).astype(np.int32)
    lens[:4] = [length, 0, 1, 16 * nw][: min(n, 4)]
    return table, base_off, st, rcodes, lens


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("two_d", [False, True])
@pytest.mark.parametrize("length", [192, 1200, 37])
def test_fused_fetch_kernels_match_plain(cuda_device, length, two_d, dtype):
    """B5's fused entries equal the window entry's plain version
    followed by the array ops, on every lane and for every start."""
    from urmap_tpu_torch import genome_pack as gpk
    from urmap_tpu_torch.kernels import lane_rotate

    n = 3000
    table, base_off, st, rcodes, lens = fused_fetch_inputs(13, n, length,
                                                           two_d)
    dev = cuda_device
    table = torch.from_numpy(table).to(dev)
    st = torch.from_numpy(st).to(dev).to(dtype)
    lens = torch.from_numpy(lens).to(dev)
    nw = -(-length // 16)
    rp, rn = gpk.pack_reads(torch.from_numpy(rcodes).to(dev), lens, nw)
    for c in (lane_rotate.codes_counter, lane_rotate.mismatch_counter):
        c.reset()
    got = lane_rotate.window_codes(table, base_off, st, length)
    want = gpk.gather_codes_plain(table, base_off, st, length,
                                  fetch=gpk.row128_window_fetch)
    assert got.dtype == want.dtype and torch.equal(got, want)
    got = gpk.mismatch_counts(table, base_off, st, rp, rn, lens)
    want = gpk.mismatch_counts_plain(table, base_off, st, rp, rn, lens,
                                     fetch=gpk.row128_window_fetch)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)
    for c in (lane_rotate.codes_counter, lane_rotate.mismatch_counter):
        assert c.launches == 1 and c.plain_calls == 0
    assert lane_rotate.codes_counter.widths == {length: 1}
    with pytest.raises(ValueError, match="starts"):
        lane_rotate.window_codes(table, base_off, st.to(torch.int16), length)
    with pytest.raises(ValueError, match="table"):
        lane_rotate.window_codes(table.view(-1, 64), base_off, st, length)


def test_operators_refuse_cpu_tensors(cuda_device):
    """The operators exist for CUDA tensors only: a CPU tensor handed to
    torch.ops.urmap.* raises, whatever the wrapper would have done."""
    from urmap_tpu_torch.kernels import _build

    _build.load()
    cand = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        torch.ops.urmap.vote(cand, 4)
    table = torch.zeros(256, dtype=torch.int32)
    starts = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(NotImplementedError):
        torch.ops.urmap.row128_window_fetch(table, starts, 16)
    with pytest.raises(NotImplementedError):
        torch.ops.urmap.window_codes(table, 16, starts, 32)
    # a CUDA table with CPU starts is refused by the operator's own check
    with pytest.raises(ValueError, match="starts"):
        torch.ops.urmap.window_codes(table.to(cuda_device), 16, starts, 32)


def _table(seed, rows, dev):
    rng = np.random.default_rng(seed)
    t = rng.integers(-(1 << 31), 1 << 31, (rows, 128)).astype(np.int32)
    return rng, torch.from_numpy(t).to(dev)


@pytest.mark.parametrize("width", [16, 22, 26, 152])
@pytest.mark.parametrize("window", [False, True])
def test_row128_fetch_kernel_matches_plain(cuda_device, width, window):
    """B5's two fetch entries at the paths' widths: W = 128 (width 16),
    256 (22, 26), 384 (152), with starts at both ends of the table, past
    it and negative."""
    from urmap_tpu_torch import genome_pack as gpk
    from urmap_tpu_torch.kernels import lane_rotate
    from urmap_tpu_torch.map import seed

    rows = 4096
    rng, table = _table(5, rows, cuda_device)
    M = rows * 128
    st = rng.integers(0, M, 50_000)
    st[:10] = [0, 127, 128, M - width, M - width + 1, M - 1, M, M + 4000,
               -1, -(1 << 33)]
    if not window:
        st = np.abs(st)                 # CSR offsets are unsigned
    st = torch.from_numpy(st).to(cuda_device)
    cnt = lane_rotate.window_counter if window else lane_rotate.fetch_counter
    kern = lane_rotate.row128_window_fetch if window \
        else lane_rotate.row128_fetch
    plain = gpk.row128_window_fetch if window else seed._row128_fetch
    cnt.reset()
    got = kern(table, st, width)
    torch.cuda.synchronize()
    assert cnt.launches == 1 and cnt.plain_calls == 0
    # both entries record the output width (the row entry's tells the
    # tiered gather's passes apart)
    assert cnt.widths == {width: 1}
    want = plain(table, st, width)
    assert got.dtype == want.dtype and torch.equal(got, want)
    with pytest.raises(ValueError, match="starts"):
        kern(table, st.to(torch.int32), width)
    with pytest.raises(ValueError, match="table"):
        kern(table.view(-1, 64), st, width)


@pytest.mark.parametrize("words", [128 * 40 + 48, 128 * 40, 16 * 11, 200])
@pytest.mark.parametrize("window", [False, True])
def test_fetch_kernel_takes_a_table_of_any_length(cuda_device, words, window):
    """A 1-D table whose length is no multiple of 128 words (the aligned
    layout's positions at rows of 16, the classic layout's positions and
    genome of a small index) is read by kernel B5 all the same, equal to
    the plain version on every lane."""
    from urmap_tpu_torch import genome_pack as gpk
    from urmap_tpu_torch.kernels import lane_rotate
    from urmap_tpu_torch.map import seed

    rng = np.random.default_rng(9)
    table = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, words).astype(np.int32)) \
        .to(cuda_device)
    width, rw = 16, 16
    st = rng.integers(0, words, 5000)
    st[:8] = [0, 15, 16, words - width, words - 1, words, words + 77,
              words - rw]
    if window:
        st[8:10] = [-1, -(1 << 33)]
    st = torch.from_numpy(st).to(cuda_device)
    cnt = lane_rotate.window_counter if window else lane_rotate.fetch_counter
    cnt.reset()
    if window:
        got = gpk.gather_window(table, st, width)
        want = gpk.row128_window_fetch(table, st, width)
    else:
        got = lane_rotate.row128_fetch(table, st, width, row_words=rw)
        want = seed._aligned_rows_fetch(table, st, width, rw)
    torch.cuda.synchronize()
    assert cnt.launches == 1 and cnt.plain_calls == 0
    assert got.dtype == want.dtype and torch.equal(got, want)
    if window:                      # inside the table: the words themselves
        inside = (st >= 0) & (st <= words - width)
        assert torch.equal(got[inside],
                           table.unfold(0, width, 1)[st[inside]])


@pytest.mark.parametrize("W,width", [(128, 16), (256, 26), (384, 152)])
def test_rotate_narrow_kernel_matches_plain(cuda_device, W, width):
    from urmap_tpu_torch.kernels import lane_rotate

    rng, table = _table(6, 3000, cuda_device)
    rows = table.repeat(1, W // 128).contiguous()
    off = torch.from_numpy(rng.integers(0, 128, 3000).astype(np.int32)) \
        .to(cuda_device)
    lane_rotate.rotate_counter.reset()
    got = lane_rotate.rotate_narrow(rows, off, width)
    torch.cuda.synchronize()
    assert lane_rotate.rotate_counter.launches == 1
    assert torch.equal(got, lane_rotate.rotate_narrow_plain(rows, off, width))


@functools.lru_cache(maxsize=None)
def dp_edge_inputs(n, L, hw, seed=5):
    """numpy (windows, reads, lengths) for B1: reads drawn from their
    windows at every band offset, with deletions and insertions, random
    adapter tails, unrelated and all-N reads, 1% read-N, genome N, and
    the lengths that pin the DP's edges (0, 1, below the seed length,
    L - 1, L, L + 5 and -3) among the rest (vectorised: N up to 32,768)."""
    rng = np.random.default_rng(seed)
    wlen = L + 2 * hw
    g = rng.integers(0, 4, size=(n, wlen + 16)).astype(np.uint8)
    g[rng.random(g.shape) < 0.002] = 4
    win = g[:, :wlen].copy()
    col = np.arange(L)[None, :]
    start = hw + rng.integers(-hw, hw + 1, size=n)[:, None]
    o = rng.integers(4, max(L - 8, 5), size=n)[:, None]
    d = rng.integers(1, max(min(hw, 9), 2), size=n)[:, None]
    kind = np.arange(n)[:, None] % 8
    src = start + col
    src = np.where((kind == 1) & (col >= o), src + d, src)      # deletion
    src = np.where((kind == 2) & (col >= o), src - d, src)      # insertion
    reads = np.take_along_axis(g, np.clip(src, 0, wlen + 15), 1)
    junk = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    ins = (kind == 2) & (col >= o) & (col < o + d)
    reads = np.where(ins | (kind == 3), junk, reads)            # unrelated
    tail = rng.integers(L // 5, L // 3 + 1, size=n)[:, None]
    reads = np.where((kind == 4) & (col >= L - tail), junk, reads)
    reads = np.where(reads == 4, 5, reads)
    reads[rng.random(reads.shape) < 0.01] = 5
    reads[kind[:, 0] == 6] = 5                                   # all-N
    lens = np.full(n, L, np.int32)
    lens[1::3] = L - 10
    lens[::7] = np.resize([0, 1, 5, L - 1, L, L + 5, -3], len(lens[::7]))
    reads[col >= lens[:, None]] = 5
    return win, reads.astype(np.uint8), lens


@functools.lru_cache(maxsize=None)
def _dp_plain(n, L, hw, clip):
    from urmap_tpu_torch.map import dp

    args = tuple(torch.from_numpy(a).cuda() for a in dp_edge_inputs(n, L, hw))
    sc = ScoreConfig()
    want = dp.banded_from_windows(*args, hw=hw, sc=sc,
                                  clip_open=sc.clip_open if clip else None)
    return args, want


@pytest.mark.parametrize("n", [1, 33, 8192, 32768])
@pytest.mark.parametrize("hw,L", [(16, 160), (8, 101), (32, 96), (16, 400)])
@pytest.mark.parametrize("clip", [False, True])
def test_banded_dp_kernel_matches_plain(cuda_device, clip, hw, L, n):
    """B1 in both modes equal to the plain version on every output. The
    kernel takes 4 lanes per candidate below 32,768 candidates and 2 from
    there on, so both compiled lane counts run. Plain mode runs in 16-bit
    pairs up to reads of ~300 codes and in 32 bits beyond: L = 400 takes
    the 32-bit body."""
    from urmap_tpu_torch.kernels import banded_dp

    args, want = _dp_plain(n, L, hw, clip)
    sc = ScoreConfig()
    cnt = banded_dp.clip_counter if clip else banded_dp.counter
    cnt.reset()
    got = banded_dp.banded_from_windows(
        *args, hw=hw, sc=sc, clip_open=sc.clip_open if clip else None)
    torch.cuda.synchronize()
    assert cnt.launches == 1 and cnt.plain_calls == 0
    for name, g, w in zip(("score", "d0", "d1", "ungapped"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("n", [33, 32768])
@pytest.mark.parametrize("hw,L", [(16, 160), (32, 96)])
@pytest.mark.parametrize("clip", [False, True])
def test_banded_dp_kernel_takes_any_byte(cuda_device, clip, hw, L, n):
    """B1 and B1' on bytes that are no codes: every other candidate's
    window and read bytes go through one permutation of 0-255, so most
    lie above 5. A window byte matches a read byte where the two are
    equal, as in the plain versions."""
    from urmap_tpu_torch.kernels import banded_dp
    from urmap_tpu_torch.map import dp

    perm = np.random.default_rng(3).permutation(256).astype(np.uint8)
    win, reads, lens = dp_edge_inputs(n, L, hw)
    odd = (np.arange(n) % 2 == 1)[:, None]
    win = np.where(odd, perm[win], win)
    reads = np.where(odd, perm[reads], reads)
    sc = ScoreConfig()
    co = sc.clip_open if clip else None
    args = tuple(torch.from_numpy(a).to(cuda_device)
                 for a in (win, reads, lens))
    got = banded_dp.banded_from_windows(*args, hw=hw, sc=sc, clip_open=co)
    want = dp.banded_from_windows(*args, hw=hw, sc=sc, clip_open=co)
    for name, g, w in zip(("score", "d0", "d1", "ungapped"), got, want):
        assert torch.equal(g, w), name
    # B1': candidate t's window is genome[t * wlen, (t + 1) * wlen)
    wlen = L + 2 * hw
    genome = torch.from_numpy(win.reshape(-1)).to(cuda_device)
    cand = torch.arange(n, dtype=torch.int32, device=cuda_device) * wlen + hw
    sg = (genome, cand) + args[1:]
    got = banded_dp.banded_semiglobal(*sg, hw=hw, sc=sc, clip_open=co)
    want = dp.banded_semiglobal(*sg, hw=hw, sc=sc, clip_open=co)
    for name, g, w in zip(("score", "d0", "ungapped", "span"), got, want):
        assert torch.equal(g, w), name


def vote_edge_inputs(n, m, seed=9):
    """int32[n, m] candidate starts in biased coordinates: runs of equal
    starts, SENTINEL lanes, all-SENTINEL rows, one-run rows, rows of
    equal runs, and starts from both ends of the int32 range."""
    from urmap_tpu_torch.map.seed import POS_BIAS, SENTINEL

    rng = np.random.default_rng(seed)
    base = (-POS_BIAS + rng.integers(0, 1 << 26, size=(n, 6))).astype(np.int64)
    cand = base[np.arange(n)[:, None], rng.integers(0, 6, size=(n, m))]
    cand = cand + rng.integers(0, 2, size=cand.shape)
    cand[:, :1] = rng.integers(-(2**31), SENTINEL, size=(n, 1))
    cand = cand.astype(np.int32)
    cand[rng.random(cand.shape) < 0.4] = SENTINEL
    cand[::11] = SENTINEL                                   # all invalid
    cand[1::11] = -POS_BIAS + 77                            # one run
    for i in range(2, n, 11):                               # equal runs
        k = max(m // 3, 1)
        vals = np.sort(rng.integers(0, 1000, size=3)) - POS_BIAS
        cand[i] = np.repeat(vals, k + 1)[:m]
        rng.shuffle(cand[i])
    return cand


@pytest.mark.parametrize("m", [2, 16, 64, 128])
@pytest.mark.parametrize("v", [1, 8, "m"])
def test_vote_kernel_edges_match_plain(cuda_device, m, v):
    """B4 at every M and V <= M, N not a multiple of the block."""
    from urmap_tpu_torch.kernels import vote
    from urmap_tpu_torch.map.seed import vote_top_candidates

    v = m if v == "m" else min(v, m)
    cand = torch.from_numpy(vote_edge_inputs(1027, m)).to(cuda_device)
    vote.counter.reset()
    got = vote.vote(cand, v=v)
    torch.cuda.synchronize()
    assert vote.counter.launches == 1 and vote.counter.plain_calls == 0
    want = vote_top_candidates(cand, v=v)
    for name, g, w in zip(("top", "votes"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("hw,L", [(16, 160), (8, 100), (32, 96), (12, 160),
                                  (24, 150), (40, 120)])
def test_banded_semiglobal_kernel_matches_plain(cuda_device, clip, hw, L):
    """B1' at the path's shape, at the other compiled half-widths and at
    half-widths of the runtime body, candidates off both ends of the
    genome."""
    from urmap_tpu_torch.kernels import banded_dp
    from urmap_tpu_torch.map import dp

    rng = np.random.default_rng(7)
    G, n = 50_000, 2000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[rng.random(G) < 0.01] = 4
    cand = rng.integers(0, G - L, n).astype(np.int32)
    cand[:8] = [0, 2, -7, -hw - 30, G - L, G - 9, G + 50, G - L + hw]
    lens = rng.integers(L - 12, L + 1, n).astype(np.int32)
    # outside [0, L]: above L no last row is reached, below 0 counts as 0
    lens[8:14] = [0, 1, L, L + 1, L + 5, -3]
    reads = np.full((n, L), 5, np.uint8)
    for i in range(n):
        s = int(np.clip(cand[i] + rng.integers(-hw + 1, hw), 0, G - L - 8))
        r = genome[s : s + L + 8].copy()
        if i % 4 == 1:
            r = np.delete(r, slice(40, 40 + int(rng.integers(1, 6))))
        if i % 4 == 2:
            r = np.insert(r, 50, rng.integers(0, 4, int(rng.integers(1, 6))))
        if i % 4 == 3:
            r[L - 30 :] = rng.integers(0, 4, len(r) - L + 30)
        reads[i] = np.where(r[:L] == 4, 5, r[:L])
    reads[np.arange(L)[None, :] >= lens[:, None]] = 5
    args = tuple(torch.from_numpy(a).to(cuda_device)
                 for a in (genome, cand, reads, lens))
    sc = ScoreConfig()
    co = sc.clip_open if clip else None
    cnt = banded_dp.semiglobal_clip_counter if clip \
        else banded_dp.semiglobal_counter
    cnt.reset()
    got = dp.banded_dispatch(*args, hw=hw, sc=sc, clip_open=co)
    torch.cuda.synchronize()
    assert cnt.launches == 1 and cnt.plain_calls == 0
    want = dp.banded_semiglobal(*args, hw=hw, sc=sc, clip_open=co)
    for name, g, w in zip(("score", "d0", "ungapped", "span"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    with pytest.raises(ValueError, match="no kernel for hw=272"):
        dp.banded_dispatch(*args, hw=272, sc=sc, clip_open=co)


@pytest.mark.parametrize("row128", [False, True])
def test_cuda_paired_mapper_matches_cpu(cuda_device, monkeypatch, row128):
    from urmap_tpu_torch.map.pair import PairedMapper

    if row128:
        monkeypatch.setenv("URMAP_ROW128_BYTES", "1")
    rng = np.random.default_rng(8)
    db = make_seqdb(rng, [300_000])
    pairs = [plant_pair(rng, db, length=150,
                        frag=int(rng.integers(250, 600)),
                        n_snps=int(rng.integers(0, 3)),
                        snp_every=(15 if i % 4 == 0 else None))
             for i in range(300)]
    c1 = np.stack([p[0].codes for p in pairs])
    c2 = np.stack([p[1].codes for p in pairs])
    ln = np.full(len(pairs), 150, np.int32)
    idx = build_index(db, backend="host")
    mcfg = MapConfig(batch_size=256)
    for c in counters():
        c.reset()
    pm = PairedMapper(Mapper(idx, mcfg, device=cuda_device))
    assert pm.mapper.row128 == row128
    got = pm.map_pair_codes(c1, ln, c2, ln)
    by_name = {c.name: c for c in counters()}
    assert all(by_name[k].launches > 0 and by_name[k].plain_calls == 0
               for k in ("seed_front", "vote", "banded_dp", "row128_fetch",
                         "window_codes", "window_mismatches", "tb_dops"))
    assert by_name["window_codes"].widths.get(mcfg.rescue_window, 0) > 0
    assert pm.stats["rescue_rounds"] > 0
    want = PairedMapper(Mapper(idx, mcfg, device="cpu")) \
        .map_pair_codes(c1, ln, c2, ln)
    np.testing.assert_array_equal(got.proper, want.proper)
    assert got.proper.mean() > 0.9
    for m in ("m1", "m2"):
        a, b = getattr(got, m), getattr(want, m)
        for f in ("mapped", "pos", "strand", "score", "second", "mapq",
                  "gapped", "ungapped", "clipped", "suspect"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{m}.{f}")
        for k in a.tb:
            x, y = a.tb[k], b.tb[k]
            if k == "dops":      # live lanes: fill lanes are never read
                x, y = x[:, a.tb["cols"]], y[:, b.tb["cols"]]
            np.testing.assert_array_equal(x, y, err_msg=f"{m}.tb.{k}")


# ---- every shape the reference maps --------------------------------------

def read_block(rng, n, L, k):
    """Read codes uint8[n, L] (1% read-N, all-N rows) and lengths with
    the edges: 0, below k, k, L - 1 and L."""
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 5
    codes[3::37] = 5
    lens = rng.integers(max(k, L - 40), L + 1, size=n).astype(np.int32)
    lens[::9] = np.resize([0, 1, k - 1, k, L - 1, L], len(lens[::9]))
    codes[np.arange(L)[None, :] >= lens[:, None]] = 5
    return codes, lens


def front_inputs(rng, n, L, k, upload, packed, slot_bits):
    """numpy inputs of the front at any size, with a synthetic CSR table:
    (a, b, lengths, tables) where a, b are the upload blocks or the word
    planes and tables holds offsets (int32 bit patterns), obase (or
    None), cnt_bits and block_bits."""
    from urmap_tpu_torch import genome_pack as gpk
    from urmap_tpu_torch.index import store

    codes, lens = read_block(rng, n, L, k)
    if upload:
        a, b = gpk.pack_read_codes_host(codes)
    else:
        a, b = (x.numpy() for x in gpk.pack_reads(
            torch.from_numpy(codes), torch.from_numpy(lens), -(-L // 16)))
    S = 1 << slot_bits
    off = np.concatenate([[0], np.cumsum(rng.integers(0, 4, size=S))])
    off = (off + np.uint64(0xFFFF_0000)).astype(np.uint32)  # wraps 2^32
    tabs = {"offsets": off.view(np.int32), "obase": None, "cnt_bits": 0,
            "block_bits": 0}
    if packed:
        pk = store.pack_offsets_row128(off, 4)
        assert pk is not None
        tabs = {"offsets": pk["opacked"].view(np.int32),
                "obase": pk["obase"].view(np.int32),
                "cnt_bits": pk["cnt_bits"], "block_bits": pk["block_bits"]}
    return a, b, lens, tabs


@pytest.mark.parametrize("n", [33, 8192, 32768])
@pytest.mark.parametrize("hw,L", [(1, 60), (7, 150), (12, 160), (17, 150),
                                  (24, 150), (31, 160), (33, 150),
                                  (40, 120), (40, 160), (100, 96),
                                  (271, 64)])
@pytest.mark.parametrize("clip", [False, True])
def test_banded_dp_runtime_halfwidths_match_plain(cuda_device, clip, hw, L,
                                                  n):
    """B1 at half-widths without a compiled body (the bodies compiled
    for 16, 32 and 271 with the half-width at run time, plain mode in
    16-bit pairs where they fit) equal to the plain version."""
    from urmap_tpu_torch.kernels import banded_dp

    args, want = _dp_plain(n, L, hw, clip)
    sc = ScoreConfig()
    got = banded_dp.banded_from_windows(
        *args, hw=hw, sc=sc, clip_open=sc.clip_open if clip else None)
    for name, g, w in zip(("score", "d0", "d1", "ungapped"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("hw,L,n,clip", [(16, 700, 33, False),
                                         (16, 700, 32768, False),
                                         (16, 700, 4096, True),
                                         (24, 704, 8192, True),
                                         (16, 2000, 8192, False),
                                         (16, 2000, 33, True),
                                         (8, 2000, 33, True),
                                         (32, 2000, 300, False),
                                         (16, 6000, 33, False),
                                         (8, 6000, 40, False),
                                         (24, 6000, 33, False)])
def test_banded_dp_long_reads_match_plain(cuda_device, hw, L, n, clip):
    """B1 on long read blocks: up to ~2,000 bases a full block of the
    compiled body, at 6,000 the runtime body with fewer candidates a
    block (a full block no longer fits shared memory)."""
    from urmap_tpu_torch.kernels import banded_dp

    args, want = _dp_plain(n, L, hw, clip)
    sc = ScoreConfig()
    got = banded_dp.banded_from_windows(
        *args, hw=hw, sc=sc, clip_open=sc.clip_open if clip else None)
    for name, g, w in zip(("score", "d0", "d1", "ungapped"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("mode", ["dops", "bits"])
@pytest.mark.parametrize("hw,L,n", [(1, 60, 300), (2, 100, 2048),
                                    (5, 101, 300), (12, 160, 2048),
                                    (19, 150, 300), (20, 160, 2048),
                                    (24, 150, 300), (31, 96, 2048),
                                    (16, 700, 300), (16, 2000, 64),
                                    (24, 704, 300)])
def test_tb_kernels_every_halfwidth_match_plain(cuda_device, mode, hw, L, n):
    """B6 and B7 at half-widths 1-31 (each variant of the runtime body)
    and on long read blocks, with the lengths that pin the edges."""
    from urmap_tpu_torch.kernels import tb_dp
    from urmap_tpu_torch.map import tb as plain

    if 2 <= hw <= 16:   # tb_edge_cases' deletions need hw - 1 <= 16
        args = tuple(torch.from_numpy(a).to(cuda_device)
                     for a in tb_edge_cases(13, n, L, hw))
    else:
        args = tuple(torch.from_numpy(a).to(cuda_device)
                     for a in dp_edge_inputs(n, L, hw))
    name = "tb_dops_from_windows" if mode == "dops" else "tb_from_windows"
    cnt = tb_dp.counter if mode == "dops" else tb_dp.bits_counter
    cnt.reset()
    got = getattr(tb_dp, name)(*args, hw=hw, sc=ScoreConfig())
    torch.cuda.synchronize()
    assert cnt.launches == 1 and cnt.plain_calls == 0
    want = getattr(plain, name)(*args, hw=hw, sc=ScoreConfig())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("hw,L", [(32, 96), (40, 100), (100, 64),
                                  (271, 40)])
def test_tb_bits_wide_halfwidths_match_plain(cuda_device, hw, L):
    """B7 above B6's 31: the 8-lane variant to hw 35, then 32 lanes."""
    from urmap_tpu_torch.kernels import tb_dp
    from urmap_tpu_torch.map import tb as plain

    args = tuple(torch.from_numpy(a).to(cuda_device)
                 for a in dp_edge_inputs(300, L, hw))
    got = tb_dp.tb_from_windows(*args, hw=hw, sc=ScoreConfig())
    want = plain.tb_from_windows(*args, hw=hw, sc=ScoreConfig())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_long_read_limits_are_the_kernels(cuda_device):
    """The limits card_limits names are where the kernels stop: one
    winner (B6) and one candidate (B1) launch at the limit's read block
    and are refused one base above it."""
    from urmap_tpu_torch.kernels import banded_dp, tb_dp

    sc = ScoreConfig()
    for hw in (16, 24):
        L = tb_dp.max_read_len(hw)
        for length, ok in ((L, True), (L + 1, False)):
            args = tuple(torch.from_numpy(a).to(cuda_device)
                         for a in dp_edge_inputs(3, length, hw))
            if ok:
                got = tb_dp.tb_dops_from_windows(*args, hw=hw, sc=sc)
                torch.cuda.synchronize()
                assert got[0].shape == (3,)
            else:
                with pytest.raises(RuntimeError, match="CUDA error"):
                    tb_dp.tb_dops_from_windows(*args, hw=hw, sc=sc)
    assert banded_dp.max_read_len(16) > 80_000


@pytest.mark.parametrize("m", [129, 200, 256, 2048, 4096])
@pytest.mark.parametrize("v", [1, 8, "m"])
def test_vote_kernel_many_candidates_match_plain(cuda_device, m, v):
    """B4's shared-memory body above 128 candidates a read."""
    from urmap_tpu_torch.kernels import vote
    from urmap_tpu_torch.map.seed import vote_top_candidates

    v = m if v == "m" else min(v, m)
    cand = torch.from_numpy(vote_edge_inputs(301, m)).to(cuda_device)
    vote.counter.reset()
    got = vote.vote(cand, v=v)
    torch.cuda.synchronize()
    assert vote.counter.launches == 1 and vote.counter.plain_calls == 0
    want = vote_top_candidates(cand, v=v)
    for name, g, w in zip(("top", "votes"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    with pytest.raises(ValueError, match="M <= 4096"):
        vote.vote(torch.zeros((2, 4097), dtype=torch.int32,
                              device=cuda_device), v=1)


@pytest.mark.parametrize("upload", [True, False])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("L,k,q", [(160, 24, 8), (150, 24, 8), (704, 24, 8),
                                   (40, 12, 3), (64, 32, 1)])
def test_seed_front_kernel_matches_plain(cuda_device, upload, packed, L, k,
                                         q):
    """The seed front against its plain version on every output: both
    inputs (the upload blocks, the word planes), plain and packed
    offsets, lengths 0, below k, L, and read-N."""
    from urmap_tpu_torch.kernels import seed_slots
    from urmap_tpu_torch.map.seed import seed_front_plain

    a, b, lens, tabs = front_inputs(np.random.default_rng(L + k), 2051, L,
                                    k, upload, packed, slot_bits=14)
    put = lambda x: None if x is None else torch.from_numpy(x).to(
        cuda_device)
    args = (put(a), put(b), put(lens), L)
    kw = dict(k=k, q=q, slot_bits=14, offsets=put(tabs["offsets"]),
              obase=put(tabs["obase"]), cnt_bits=tabs["cnt_bits"],
              block_bits=tabs["block_bits"])
    seed_slots.counter.reset()
    got = seed_slots.seed_front(*args, **kw)
    torch.cuda.synchronize()
    assert seed_slots.counter.launches == 1
    assert seed_slots.counter.plain_calls == 0
    want = seed_front_plain(*args, **kw)
    for name, g, w in zip(("rpacked2", "rnplane2", "offs", "valid", "start",
                           "cnt"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("upload", [True, False])
@pytest.mark.parametrize("L,k,q", [(160, 24, 8), (150, 24, 8), (704, 24, 8),
                                   (40, 12, 3), (64, 32, 1)])
def test_seed_front_slots_mode_matches_plain(cuda_device, upload, L, k, q):
    """The seed front's slots mode (offsets=None, the sharded routes'
    front) against its plain version: word planes, offs, valid and the
    slots, counted apart from the front proper."""
    from urmap_tpu_torch.kernels import seed_slots
    from urmap_tpu_torch.map.seed import seed_front_plain

    a, b, lens, _ = front_inputs(np.random.default_rng(L + k), 2051, L, k,
                                 upload, False, slot_bits=14)
    put = lambda x: torch.from_numpy(x).to(cuda_device)
    args = (put(a), put(b), put(lens), L)
    kw = dict(k=k, q=q, slot_bits=14, offsets=None)
    seed_slots.counter.reset()
    seed_slots.slots_counter.reset()
    got = seed_slots.seed_front(*args, **kw)
    torch.cuda.synchronize()
    assert seed_slots.slots_counter.launches == 1
    assert seed_slots.counter.launches == 0
    want = seed_front_plain(*args, **kw)
    assert len(got) == len(want) == 5
    for name, g, w in zip(("rpacked2", "rnplane2", "offs", "valid", "slots"),
                          got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("hw,max_read_len,p", [(12, 160, 16), (24, 704, 16),
                                               (16, 160, 32)])
def test_cuda_mapper_new_shapes_match_cpu(cuda_device, hw, max_read_len, p):
    """Mapper and PairedMapper at band half-widths 12 and 24 with the
    traceback on, at max_read_len 704 (reads above 624), and at Q x P =
    256: through the kernels only, equal to the CPU's."""
    from urmap_tpu_torch.map.pair import PairedMapper

    rng = np.random.default_rng(hw + p)
    db = make_seqdb(rng, [400_000])
    n = 300
    lens = np.where(np.arange(n) % 3 == 0, max_read_len,
                    np.minimum(150, max_read_len)).astype(np.int32)
    reads = [plant_read(rng, db, length=int(ln),
                        n_snps=int(rng.integers(0, 6)),
                        ins=int(rng.integers(0, 2)) * min(hw - 2, 10))
             for ln in lens]
    codes = np.full((n, max_read_len), 5, np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r.codes)] = r.codes
    idx = build_index(db, backend="host")
    mcfg = MapConfig(batch_size=256, max_read_len=max_read_len,
                     band_halfwidth=hw, positions_per_seed=p,
                     rescue_window=2 * max_read_len + 1200)
    for c in counters():
        c.reset()
    got = Mapper(idx, mcfg, device=cuda_device).map_codes(codes, lens)
    by_name = {c.name: c for c in counters()}
    assert all(by_name[k].launches > 0 and by_name[k].plain_calls == 0
               for k in ("seed_front", "vote", "banded_dp", "tb_dops"))
    want = Mapper(idx, mcfg, device="cpu").map_codes(codes, lens)
    for f in ("mapped", "pos", "strand", "score", "second", "mapq",
              "gapped", "ungapped", "clipped", "suspect"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for k in got.tb:
        a, b = got.tb[k], want.tb[k]
        if k == "dops":
            a, b = a[:, got.tb["cols"]], b[:, want.tb["cols"]]
        np.testing.assert_array_equal(a, b, err_msg=k)
    pairs = [plant_pair(rng, db, length=150, frag=int(rng.integers(250, 600)),
                        n_snps=int(rng.integers(0, 3))) for _ in range(100)]
    c1 = np.stack([q[0].codes for q in pairs])
    c2 = np.stack([q[1].codes for q in pairs])
    ln = np.full(len(pairs), 150, np.int32)
    pg = PairedMapper(Mapper(idx, mcfg, device=cuda_device)) \
        .map_pair_codes(c1, ln, c2, ln)
    pw = PairedMapper(Mapper(idx, mcfg, device="cpu")) \
        .map_pair_codes(c1, ln, c2, ln)
    np.testing.assert_array_equal(pg.proper, pw.proper)
    for m in ("m1", "m2"):
        for f in ("mapped", "pos", "strand", "score", "mapq", "gapped"):
            np.testing.assert_array_equal(getattr(getattr(pg, m), f),
                                          getattr(getattr(pw, m), f),
                                          err_msg=f"{m}.{f}")


def test_cuda_mapper_refuses_beyond_the_kernels(cuda_device):
    """A config past a kernel's limit is refused in __init__, before any
    table loads (index=None shows nothing was touched), naming it."""
    mcfg = MapConfig(max_read_len=12_000, rescue_window=30_000)
    with pytest.raises(ValueError, match=r"kernel B6 \(tb_dops\) holds at "
                                         r"most 10104 bases"):
        Mapper(None, mcfg, device=cuda_device)
    with pytest.raises(ValueError, match=r"kernel B4 \(vote\) takes at most "
                                         "4096"):
        Mapper(None, MapConfig(positions_per_seed=1024), device=cuda_device)


def test_banded_dp_clip_at_the_end_clip_main_dp_shape(cuda_device):
    """B1 in clip mode at the shape -endclip's main DP gives it: N =
    2 * (B / dp_capacity_frac) * V = 32,768 candidates at the default
    batch of 16,384, L = 160, hw = 16; equal to the plain version."""
    from urmap_tpu_torch.kernels import banded_dp

    mc = MapConfig(batch_size=16_384)
    n = 2 * (mc.batch_size // mc.dp_capacity_frac) * mc.top_candidates
    assert n == 32_768
    args, want = _dp_plain(n, 160, 16, True)
    sc = ScoreConfig()
    banded_dp.clip_counter.reset()
    got = banded_dp.banded_from_windows(*args, hw=16, sc=sc,
                                        clip_open=sc.clip_open)
    torch.cuda.synchronize()
    assert banded_dp.clip_counter.launches == 1
    for name, g, w in zip(("score", "d0", "d1", "ungapped"), got, want):
        assert torch.equal(g, w), name


def test_cli_map_endclip_on_the_card_equals_the_cpu(cuda_device, tmp_path,
                                                    monkeypatch):
    """``cli.main -map -endclip`` on the card writes the CPU run's SAM,
    through B1 in clip mode and without the traceback kernel (B6); with
    -secondpass the card path still runs no plain version (the second
    pass's CPU calls count as host-pass calls)."""
    import sys

    from tests.utils import write_fastq
    from urmap_tpu_torch import alphabet, cli

    rng = np.random.default_rng(8)
    db = make_seqdb(rng, [200_000])
    fa = str(tmp_path / "g.fa")
    with open(fa, "w") as f:
        f.write(">chr1\n" + alphabet.decode(db.codes[db.starts[0]:]) + "\n")
    reads = [plant_read(rng, db, n_snps=int(rng.integers(0, 4)),
                        dels=3 if i % 5 == 0 else 0) for i in range(300)]
    for r in reads[1::7]:
        r.codes[-60:] = rng.integers(0, 4, 60)
    for r in reads[2::11]:                 # junk: the second pass's rows
        r.codes[:] = rng.integers(0, 4, len(r.codes))
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, reads)
    ufi = str(tmp_path / "g.ufi")
    monkeypatch.setattr(sys, "argv", ["urmap"])
    assert cli.main(["-make_ufi", fa, "-output", ufi]) == 0
    for extra in (["-endclip"], ["-secondpass", "32"]):
        out = {}
        for dev in ("cpu", cuda_device):
            for c in counters():
                c.reset()
            sam = str(tmp_path / f"{dev}.sam")
            assert cli.main(["-map", fq, "-ufi", ufi, "-samout", sam,
                             "-batch", "128", "-quiet", *extra],
                            device=dev) == 0
            out[str(dev)] = open(sam, "rb").read()
        by_name = {c.name: c for c in counters()}
        assert all(c.plain_calls == 0 for c in counters())
        if extra == ["-endclip"]:
            assert by_name["banded_dp_clip"].launches > 0
            assert by_name["tb_dops"].launches == 0
        else:
            assert by_name["tb_dops"].launches == 3
            assert by_name["vote"].host_pass_calls > 0
        assert out["cuda"] == out["cpu"]


# ---- the tiered gather and tables past 2^31 words -------------------------

@pytest.mark.parametrize("tier", [4, 8])
def test_row_entry_tier_widths_match_plain(cuda_device, tier):
    """B5's row entry as the tiered gather's first pass runs it: a 1-D
    table at width = row_words = 4 and 8, starts at the rows' ends, past
    the table and in its last row."""
    from urmap_tpu_torch.kernels import lane_rotate
    from urmap_tpu_torch.map import seed

    rng = np.random.default_rng(tier)
    words = 128 * 3000
    table = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, words).astype(np.int32)).to(cuda_device)
    st = rng.integers(0, words, 262_144)
    st[:8] = [0, tier - 1, tier, words - 1, words - tier, words,
              words + 77, (1 << 32) - 1]
    st = torch.from_numpy(st).to(cuda_device)
    lane_rotate.fetch_counter.reset()
    got = lane_rotate.row128_fetch(table, st, tier, row_words=tier)
    torch.cuda.synchronize()
    assert lane_rotate.fetch_counter.widths == {tier: 1}
    want = seed._aligned_rows_fetch(table, st, tier, tier)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_row_entry_past_2_31_words(cuda_device):
    """B5's row entry over a [R, 128] table of 2^31 + 2^24 words (a human
    genome's row128 positions, 8.7 GB), a third of the starts past 2^31
    and some in the last row."""
    from urmap_tpu_torch.kernels import lane_rotate
    from urmap_tpu_torch.map import seed

    M = (1 << 31) + (1 << 24)
    free, _total = torch.cuda.mem_get_info(cuda_device)
    if free < 3 * M * 4:
        pytest.skip(f"needs {3 * M * 4:,} bytes free on the card (the "
                    f"table and the plain version's index), has {free:,}")
    rng = np.random.default_rng(31)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(31)
    table = torch.randint(-(1 << 31), (1 << 31) - 1, (M // 128, 128),
                          dtype=torch.int32, device=cuda_device,
                          generator=gen)
    n = 262_144
    st = rng.integers(0, M, n)
    st[: n // 3] = rng.integers(1 << 31, M, n // 3)
    st[-64:] = rng.integers(M - 128, M, 64)
    st[:5] = [(1 << 31) - 1, 1 << 31, M - 1, M - 16, M + 5]
    st = torch.from_numpy(st).to(cuda_device)
    got = lane_rotate.row128_fetch(table, st, 16)
    want = seed._row128_fetch(table, st, 16)
    assert torch.equal(got, want)
    # the words past 2^31 themselves, where the row holds them
    inside = ((st & 127) <= 112) & (st < M)
    flat = table.view(-1)
    assert torch.equal(got[inside, 0], flat[st[inside]])


def test_cuda_mapper_tiered_gather_matches_cpu(cuda_device, monkeypatch):
    """URMAP_TIER_GATHER=1: the card's Mapper over an aligned index with
    a repeat (overflow seeds) equals the CPU Mapper and its own untiered
    run; B5 launched at the tier width once a batch plus one full-width
    launch an overflow round."""
    from urmap_tpu_torch.kernels import lane_rotate, tier_rounds

    rng = np.random.default_rng(12)
    db = make_seqdb(rng, [400_000])
    unit = db.codes[5000:5400].copy()
    for i in range(40):
        s = 100_000 + 2000 * i
        db.codes[s : s + 400] = unit
    reads = [plant_read(rng, db, length=150, n_snps=int(rng.integers(0, 3)))
             for _ in range(480)]
    reads += [plant_read(rng, db, length=150, gpos=100_000 + 2000 * i + 100)
              for i in range(32)]
    codes = np.stack([r.codes for r in reads])
    ln = np.full(len(reads), 150, np.int32)
    idx = build_index(db, backend="host")
    mcfg = MapConfig(batch_size=256)
    monkeypatch.setenv("URMAP_TIER_GATHER", "1")
    m = Mapper(idx, mcfg, device=cuda_device)
    assert m.csr_aligned and m.gather_tier in (4, 8)
    for c in counters():
        c.reset()
    tier_rounds.reset()
    got = m.map_codes(codes, ln)
    fc = lane_rotate.fetch_counter
    assert fc.plain_calls == 0 and tier_rounds.calls == 2
    assert tier_rounds.rounds > 0
    assert fc.widths == {m.gather_tier: 2, 16: tier_rounds.rounds}
    want = Mapper(idx, mcfg, device="cpu").map_codes(codes, ln)
    monkeypatch.delenv("URMAP_TIER_GATHER")
    untiered = Mapper(idx, mcfg, device=cuda_device).map_codes(codes, ln)
    for f in ("mapped", "pos", "strand", "score", "second", "mapq",
              "gapped", "ungapped", "clipped", "suspect"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(got, f),
                                      getattr(untiered, f), err_msg=f)


@pytest.mark.parametrize("k,slot_bits", [(24, 14), (17, 11)])
def test_device_build_on_the_card_matches_host(cuda_device, tmp_path, k,
                                               slot_bits):
    """build_index(backend="device") on the card, in RAM and through the
    spill in several chunks, equals the host build; one chunk numbered
    past 2^31 equals the same on CPU tensors, at slot_bits 30 and 31."""
    from urmap_tpu_torch.config import IndexConfig
    from urmap_tpu_torch.index import build as bmod

    rng = np.random.default_rng(11)
    db = make_seqdb(rng, [60_000, 9_000])
    cfg = IndexConfig(k=k, slot_bits=slot_bits, max_positions_per_slot=8)
    want = build_index(db, cfg, backend="host")
    for kw in ({}, {"chunk": 7_001},
               {"chunk": 5_000, "spill_threshold": 9_000,
                "spill_dir": str(tmp_path)}):
        got = build_index(db, cfg, backend="device", **kw)
        np.testing.assert_array_equal(got.offsets, want.offsets)
        np.testing.assert_array_equal(got.positions, want.positions)
    assert not list(tmp_path.iterdir())
    codes = db.codes[: 20_000 + k - 1]
    for bits in (30, 31):
        on_card = bmod._chunk_sorted_slots(
            torch.from_numpy(codes).to(cuda_device), 3_000_000_000, k, bits)
        on_cpu = bmod._chunk_sorted_slots(torch.from_numpy(codes),
                                          3_000_000_000, k, bits)
        for a, b in zip(on_card, on_cpu):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(1000, 127), (3, 1), (4096, 128)])
def test_micro_passes_kernel_matches_plain(cuda_device, shape):
    """B8 (csrc/micro_passes.cu) against its plain version: a tail of rows
    no 2,048-row block covers at an odd width, three words, and whole
    16-byte vectors; then on a view whose base is not 16-byte aligned
    (the word-by-word loads)."""
    from urmap_tpu_torch.kernels import micro

    x = np.random.default_rng(12).integers(0, 1 << 32, size=shape,
                                           dtype=np.uint32).view(np.int32)
    x = torch.from_numpy(x).to(cuda_device)
    micro.counter.reset()
    got = micro.passes(x)
    torch.cuda.synchronize()
    assert (micro.counter.launches, micro.counter.plain_calls) == (1, 0)
    assert got.dtype == torch.int32 and torch.equal(got,
                                                    micro.plain_passes(x))
    flat = x.reshape(-1)
    if flat.numel() > 1:
        tail = flat[1:].reshape(1, -1)      # base one word past alignment
        assert torch.equal(micro.passes(tail), micro.plain_passes(tail))
    with pytest.raises(ValueError, match="passes"):
        torch.ops.urmap.micro_passes(x, -1)


@pytest.mark.parametrize("path", ["single", "paired", "clip", "endclip"])
def test_every_card_sync_lies_in_a_sync_span(cuda_device, path):
    """One batch under set_sync_debug_mode("warn"), tracing on: each
    synchronizing operation the card reports warns inside its own
    ``urmap.sync`` span, and ``host_syncs`` counts them all (single-end,
    pairs with rescue-only mates, single-end with adapter tails for the
    clip-rescue lane, and the same under end_clip)."""
    import warnings

    from urmap_tpu_torch.map.pair import PairedMapper
    from urmap_tpu_torch.utils import trace

    rng = np.random.default_rng(12)
    db = make_seqdb(rng, [300_000])
    mapper = Mapper(build_index(db, backend="host"),
                    MapConfig(batch_size=512, end_clip=path == "endclip"),
                    device=cuda_device)
    if path == "paired":
        pairs = [plant_pair(rng, db, length=150,
                            frag=int(rng.integers(250, 600)),
                            snp_every=(15 if i % 4 == 0 else None))
                 for i in range(256)]
        c1 = np.stack([p[0].codes for p in pairs])
        c2 = np.stack([p[1].codes for p in pairs])
        ln = np.full(len(pairs), 150, np.int32)
        pm = PairedMapper(mapper)

        def one():
            pm.finish_batch(pm.start_batch(c1, ln, c2, ln), ln, ln)
    else:
        reads = [plant_read(rng, db, n_snps=int(rng.integers(0, 6)),
                            ins=int(rng.integers(0, 2)) * 4)
                 for _ in range(512)]
        codes = np.stack([r.codes for r in reads])
        if path in ("clip", "endclip"):
            codes[::8, 85:] = rng.integers(0, 4, (64, 65))
        ln = np.full(len(reads), 150, np.int32)

        def one():
            mapper.finish_batch(mapper.start_batch(codes, ln), ln)
    one()                                   # builds and warms up
    caught = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            stack = trace._state().stack
            caught.append(stack[-1].id if stack
                          and stack[-1].name == "urmap.sync" else
                          f"{filename}:{lineno}")

    trace.drain()
    trace.enable()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                one()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        trace.disable()
    recs = trace.drain()
    syncs = sorted(r.id for r in recs if isinstance(r, trace.Span)
                   and r.name == "urmap.sync")
    assert [c for c in caught if isinstance(c, str)] == []
    assert sorted(caught) == syncs
    assert sum(r.n for r in recs if isinstance(r, trace.Count)
               and r.name == "host_syncs") == len(caught) > 0
