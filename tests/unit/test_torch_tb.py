"""The port's traceback DP (map/tb.py, the plain versions of kernels B6
and B7) against urmap_tpu/kernels/tb_dp.py on the same numpy inputs.

Everything is an integer: every comparison is exact (tolerance 0). The
Pallas kernels run in interpret mode, twice only (they are the slow
cases). The port's two host decoders (decode_tb_row over the raw bits,
decode_dops_row over the walked records) must agree with each other and
with the host DP ``traceback`` wherever the path stays in the band.
"""

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from urmap_tpu.config import ScoreConfig
from urmap_tpu.kernels import tb_dp as jtb
from urmap_tpu.map.cigar import traceback
from urmap_tpu_torch.kernels import tb_dp as ktb
from urmap_tpu_torch.map import cigar as tcigar
from urmap_tpu_torch.map import tb as ttb

SC = ScoreConfig()


def _planted_cases(rng, n, L, hw, glen=8000, max_indels=2, max_indel_len=6,
                   snp=0.03):
    """Random genome + n (read, pos) pairs with planted SNPs/indels whose
    net drift stays well inside the band."""
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    reads = np.zeros((n, L), np.uint8)
    lens = np.zeros(n, np.int32)
    poss = np.zeros(n, np.int64)
    for i in range(n):
        ln = int(rng.integers(L - 24, L + 1))
        pos = int(rng.integers(hw + 8, glen - L - 64))
        seq = list(genome[pos : pos + ln + 16])
        for _ in range(int(rng.integers(0, max_indels + 1))):
            at = int(rng.integers(8, ln - 8))
            sz = int(rng.integers(1, min(max_indel_len, hw // 2) + 1))
            if rng.random() < 0.5:
                ins = list(rng.integers(0, 4, size=sz))
                seq = seq[:at] + ins + seq[at:]
            else:
                seq = seq[:at] + seq[at + sz :]
        r = np.asarray(seq[:ln], np.uint8)
        m = rng.random(ln) < snp
        r[m] = (r[m] + rng.integers(1, 4, size=int(m.sum()))) % 4
        reads[i, :ln] = r
        reads[i, ln:] = 5
        lens[i] = ln
        poss[i] = pos
    return genome, reads, lens, poss


def _windows(genome, poss, L, hw):
    w = np.zeros((len(poss), L + 2 * hw), np.uint8)
    for i, p in enumerate(poss):
        w[i] = genome[p - hw : p + L + hw]
    return w


def _case(seed, n, L, hw, drift=False, odd_lengths=False):
    rng = np.random.default_rng(seed)
    genome, reads, lens, poss = _planted_cases(rng, n, L, hw)
    if drift:       # anchors off the true start: paths may leave the band
        poss = poss + rng.integers(-hw, hw + 1, size=n)
    if odd_lengths:
        lens[3] = 0
        reads[3] = 5                        # an all-N, empty row
        lens[5] = 1
        reads[5, 1:] = 5
        reads[7] = 5                        # all-N at full length
    return genome, reads, lens, poss, _windows(genome, poss, L, hw)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _np(outs):
    return tuple(o.numpy() for o in outs)


# (seed, N, L, hw, drifted anchors): L not a multiple of 8 or 4, both
# half-widths with a compiled kernel, the 6-bit d-field limit (hw 31)
SHAPES = [(1, 64, 96, 16, False), (2, 48, 100, 8, False),
          (3, 40, 101, 9, False), (4, 64, 96, 16, True),
          (5, 24, 61, 31, True)]


@pytest.mark.parametrize("seed,n,L,hw,drift", SHAPES)
def test_tb_from_windows_matches_jax(seed, n, L, hw, drift):
    _g, reads, lens, _p, win = _case(seed, n, L, hw, drift, odd_lengths=True)
    want = tuple(np.asarray(x) for x in jtb.tb_from_windows(
        win, reads, lens, hw=hw, sc=SC))
    got = _np(ttb.tb_from_windows(*_t(win, reads, lens), hw=hw, sc=SC))
    assert got[2].shape == (ttb.tb_words(L, hw), n)
    assert ttb.tb_words(L, hw) == jtb.tb_words(L, hw)
    assert ttb.tb_layout(L, hw) == jtb.tb_layout(L, hw)
    for name, g, w in zip(("score", "bend", "bits"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[0][3] == 0 and got[1][3] == hw      # length 0
    # pad rows (band cells W..Wp of every group) stay zero
    W, Wp, groups = ttb.tb_layout(L, hw)
    assert not got[2].reshape(groups, Wp, n)[:, W:].any()


@pytest.mark.parametrize("seed,n,L,hw,drift", SHAPES)
def test_dops_from_bits_matches_jax(seed, n, L, hw, drift):
    _g, reads, lens, _p, win = _case(seed, n, L, hw, drift, odd_lengths=True)
    score, bend, bits = jtb.tb_from_windows(win, reads, lens, hw=hw, sc=SC)
    want = tuple(np.asarray(x) for x in jtb.dops_from_bits(
        bits, bend, lens, hw=hw, L=L))
    got = _np(ttb.dops_from_bits(*_t(np.asarray(bits), np.asarray(bend),
                                     lens), hw=hw, L=L))
    assert got[0].shape == (ttb.dops_words(L), n)
    assert ttb.dops_words(L) == jtb.dops_words(L)
    np.testing.assert_array_equal(got[0], want[0], err_msg="dops")
    np.testing.assert_array_equal(got[1], want[1], err_msg="walk_ok")
    assert got[1].dtype == np.bool_
    # the start is forced, so every walk of a non-empty read ends at the
    # band centre: a path that left the band shows in the score instead
    assert not got[1][3] and got[1][np.arange(n) != 3].all()
    # the wrapper on CPU tensors runs the plain version end to end
    ktb.counter.reset()
    whole = _np(ktb.tb_dops_from_windows(*_t(win, reads, lens), hw=hw,
                                         sc=SC))
    assert ktb.counter.plain_calls == 1 and ktb.counter.launches == 0
    np.testing.assert_array_equal(whole[0], np.asarray(score))
    np.testing.assert_array_equal(whole[1], want[0])
    np.testing.assert_array_equal(whole[2], want[1])


def test_length_above_L_matches_jax():
    """A length above L has no last row: score 0, bend hw, and the walk
    starts at band cell 0 with every row live, in both packages."""
    n, L, hw = 16, 64, 8
    _g, reads, lens, _p, win = _case(6, n, L, hw)
    lens[::2] = L + 3
    want = tuple(np.asarray(x) for x in jtb.tb_dops_from_windows(
        win, reads, lens, hw=hw, sc=SC))
    got = _np(ttb.tb_dops_from_windows(*_t(win, reads, lens), hw=hw, sc=SC))
    for name, g, w in zip(("score", "dops", "walk_ok"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert not got[0][::2].any()


@pytest.mark.parametrize("hw,L", [(16, 160), (16, 150), (16, 37), (8, 160),
                                  (8, 150), (8, 37)])
def test_edge_cases_match_jax(hw, L):
    """The rows that pin kernel B6's edges on the card (a deletion chain
    that reaches band cell 0, an insertion at the band's last cell,
    lengths 0, L and L + 3, L no multiple of 8 or 4): the plain version
    the kernel is held to equals the reference on them."""
    from tests.unit.test_torch_cuda import tb_edge_cases

    n = 33
    win, reads, lens = tb_edge_cases(11, n, L, hw)
    want = tuple(np.array(x) for x in jtb.tb_dops_from_windows(
        win, reads, lens, hw=hw, sc=SC))
    got = _np(ttb.tb_dops_from_windows(*_t(win, reads, lens), hw=hw, sc=SC))
    # The reference's jnp twin takes its score at step ``lengths`` even
    # where that step is a masked no-op of the last 8-row group
    # (L < lengths <= 8 * ceil(L / 8): row 3, of length L + 3, at
    # L = 37); the TPU kernel itself, run in interpret mode, has no last
    # row there and scores 0, and so does the port. Records and walk_ok
    # agree.
    quirk = (lens > L) & (lens <= -(-L // 8) * 8)
    assert quirk[3] == (L == 37) and quirk.sum() == (L == 37)
    if quirk.any():
        kern = tuple(np.asarray(x) for x in jtb.tb_dops_from_windows_pallas(
            win, reads, lens, hw=hw, sc=SC, interpret=True))
        for name, g, w in zip(("score", "dops", "walk_ok"), got, kern):
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert (want[0][quirk] != 0).all()
        want[0][quirk] = 0
    for name, g, w in zip(("score", "dops", "walk_ok"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # rows 0 and 1 take the planted path: hw insertions then 3
    # deletions, hw deletions then 2 insertions
    recs = got[1].view(np.uint8).reshape(-1, n, 4).transpose(1, 0, 2) \
        .reshape(n, -1)[:, :L]
    for row, (ins, dels) in enumerate(((hw, 3), (2, hw))):
        assert got[2][row]
        assert int((recs[row] >> 6).sum()) == ins
        assert int((recs[row] & 63).sum()) == dels
    assert got[0][2] == 0 and not got[2][2] and not recs[2].any()   # empty
    assert got[0][3] == 0                                  # no last row


@pytest.mark.parametrize("mode", ["bits", "dops"])
def test_matches_pallas_interpret(mode):
    """Once per kernel at a small shape: the port's plain version equals
    the TPU kernel run in interpret mode."""
    n, L, hw = 32, 44, 8
    _g, reads, lens, _p, win = _case(6, n, L, hw, drift=True,
                                     odd_lengths=True)
    if mode == "bits":
        want = jtb.tb_from_windows_pallas(win, reads, lens, hw=hw, sc=SC,
                                          interpret=True)
        got = ttb.tb_from_windows(*_t(win, reads, lens), hw=hw, sc=SC)
    else:
        want = jtb.tb_dops_from_windows_pallas(win, reads, lens, hw=hw,
                                               sc=SC, interpret=True)
        got = ttb.tb_dops_from_windows(*_t(win, reads, lens), hw=hw, sc=SC)
    for g, w in zip(_np(got), want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("seed,n,L,hw,drift", SHAPES)
def test_decoders_agree_with_host_traceback(seed, n, L, hw, drift):
    """decode_tb_row over the bits == decode_dops_row over the records,
    and both == the host DP traceback where the banded score is the host
    score (always, for anchors at the planted start)."""
    genome, reads, lens, poss, win = _case(seed, n, L, hw, drift)
    score, bend, bits = _np(ttb.tb_from_windows(*_t(win, reads, lens),
                                                hw=hw, sc=SC))
    dops, walk_ok = _np(ttb.dops_from_bits(*_t(bits, bend, lens), hw=hw,
                                           L=L))
    n_gapped = 0
    for i in range(n):
        ln, p = int(lens[i]), int(poss[i])
        by_bits = tcigar.decode_tb_row(bits, i, int(bend[i]), ln, genome, p,
                                       reads[i], hw, L)
        # the host walk fails on exactly the rows the device walk flags
        assert (by_bits is not None) == bool(walk_ok[i]), i
        if by_bits is None:
            assert drift
            continue
        by_dops = tcigar.decode_dops_row(dops, i, ln, genome, p, reads[i])
        assert by_dops == by_bits, (i, by_dops, by_bits)
        hcig, hscore, hnm = traceback(genome, reads[i][:ln], p, SC)
        if not drift:
            assert score[i] == hscore, i
        if hscore == score[i]:
            assert by_bits[0] == hcig and by_bits[1] == hnm, i
            n_gapped += "I" in hcig or "D" in hcig
    assert n_gapped >= (0 if drift else n // 4)


def test_dops_decode_batch_native_matches_python_twin():
    """The port's io.native C++ replay against decode_dops_row."""
    from urmap_tpu_torch.io import native

    assert native.lib() is not None
    n, L, hw = 64, 96, 16
    genome, reads, lens, poss, win = _case(8, n, L, hw, drift=True)
    _s, dops, _ok = _np(ttb.tb_dops_from_windows(*_t(win, reads, lens),
                                                 hw=hw, sc=SC))
    cols = np.arange(n, dtype=np.int32)
    cigs, nm, span, ok = tcigar.dops_decode_batch(dops, cols, lens, genome,
                                                  poss, reads)
    (blob, off), nm_r, span_r, ok_r = tcigar.dops_decode_batch(
        dops, cols, lens, genome, poss, reads, raw=True)
    np.testing.assert_array_equal(ok, ok_r)
    for i in range(n):
        dec = tcigar.decode_dops_row(dops, i, int(lens[i]), genome,
                                     int(poss[i]), reads[i])
        assert (dec is not None) == bool(ok[i])
        if dec is not None:
            assert (cigs[i], nm[i], span[i]) == dec
            assert blob[off[i] : off[i + 1]].decode() == dec[0]


def test_cpu_tensors_run_plain_for_any_halfwidth():
    """hw outside HALF_WIDTHS is fine for CPU tensors (plain version):
    only a CUDA tensor needs a compiled kernel."""
    n, L, hw = 8, 40, 12
    _g, reads, lens, _p, win = _case(9, n, L, hw)
    assert hw not in ktb.HALF_WIDTHS
    got = _np(ktb.tb_from_windows(*_t(win, reads, lens), hw=hw, sc=SC))
    want = jtb.tb_from_windows(win, reads, lens, hw=hw, sc=SC)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
