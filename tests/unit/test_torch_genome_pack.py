"""urmap_tpu_torch.genome_pack against urmap_tpu.genome_pack (exact).

Host copies (pack_genome, pack_read_codes_host and its numpy twin) and
every device op of the port, on the same numpy inputs, read lengths
below one word, at 150 and at the 160 block width.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401  (one torch thread)
from urmap_tpu import genome_pack as jgpk
from urmap_tpu_torch import _bits
from urmap_tpu_torch import genome_pack as tgpk

L_BLOCK = 160
NW = 10


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _reads(rng, n=96):
    codes = rng.integers(0, 4, size=(n, L_BLOCK)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.03] = 5
    lengths = np.full(n, 150, np.int32)
    lengths[: n // 3] = L_BLOCK
    lengths[n // 3 : n // 3 + 16] = rng.integers(0, 16, 16)
    lengths[-4:] = 0
    codes[8:12] = 5
    codes[np.arange(L_BLOCK)[None, :] >= lengths[:, None]] = 5
    return codes, lengths


@pytest.mark.parametrize("native", [True, False])
def test_pack_genome_matches(rng, monkeypatch, native):
    if not native:
        monkeypatch.setenv("URMAP_NO_NATIVE_BUILD", "1")
    g = rng.integers(0, 4, size=10_007).astype(np.uint8)
    g[rng.random(g.shape[0]) < 0.02] = 4
    a, oa = jgpk.pack_genome(g)
    b, ob = tgpk.pack_genome(g)
    assert oa == ob
    np.testing.assert_array_equal(a, b)


def test_pack_read_codes_host_matches(rng):
    codes, _ = _reads(rng)
    for fn_j, fn_t in ((jgpk.pack_read_codes_host, tgpk.pack_read_codes_host),
                       (jgpk._pack_read_codes_numpy,
                        tgpk._pack_read_codes_numpy)):
        for ca, cb in zip(fn_j(codes[:, :150]), fn_t(codes[:, :150])):
            np.testing.assert_array_equal(ca, cb)


def test_popcount_and_rev2bit(rng):
    x = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    t = torch.from_numpy(x.view(np.int32))
    want = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(_bits.popcount(t).numpy(), want)
    np.testing.assert_array_equal(u32(_bits.rev2bit(t)),
                                  np.asarray(jgpk._rev2bit(jnp.asarray(x))))


def test_read_word_ops_match(rng):
    codes, lengths = _reads(rng)
    pk, nm = jgpk.pack_read_codes_host(codes)
    lj, lt = jnp.asarray(lengths), torch.from_numpy(lengths)
    ja = jgpk.read_words_from_upload(jnp.asarray(pk), jnp.asarray(nm), lj, NW)
    ta = tgpk.read_words_from_upload(torch.from_numpy(pk),
                                     torch.from_numpy(nm), lt, NW)
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(np.asarray(a), u32(b))
    jp = jgpk.pack_reads(jnp.asarray(codes), lj, NW)
    tp = tgpk.pack_reads(torch.from_numpy(codes), lt, NW)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), u32(b))
    for L in (L_BLOCK, 150, None):
        jr = jgpk.revcomp_words(*ja, lj, L)
        tr = tgpk.revcomp_words(*ta, lt, L)
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(np.asarray(a), u32(b))
    np.testing.assert_array_equal(
        np.asarray(jgpk.unpack_words_to_codes(*ja, L_BLOCK)),
        tgpk.unpack_words_to_codes(*ta, L_BLOCK).numpy())


@pytest.fixture(scope="module")
def ginter():
    rng = np.random.default_rng(7)
    g = rng.integers(0, 4, size=20_000).astype(np.uint8)
    g[1000:1100] = 4
    inter, off = jgpk.pack_genome(g)
    return inter, off


def test_row_gather_window_matches(rng, ginter):
    table = ginter[0]
    M = table.shape[0]
    starts = np.concatenate([rng.integers(0, M, 200), [-5, 0, M - 1, M + 40,
                                                        M - 3]]).astype(np.int32)
    for width, rw in ((16, 16), (22, 16), (34, 32)):
        want = jgpk.row_gather_window(jnp.asarray(table), jnp.asarray(starts),
                                      width, row_words=rw)
        got = tgpk.row_gather_window(torch.from_numpy(_bits.as_i32(table)),
                                     torch.from_numpy(starts), width,
                                     row_words=rw)
        np.testing.assert_array_equal(np.asarray(want), u32(got))


@pytest.mark.parametrize("L", [12, 150, L_BLOCK])
def test_window_gathers_and_mismatch_counts(rng, ginter, L):
    inter, off = ginter
    n = 128
    genome_len = 20_000
    starts = rng.integers(-40, genome_len + 40, n).astype(np.int32)
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 5
    lengths = np.full(n, L, np.int32)
    lengths[::5] = rng.integers(0, L + 1, len(lengths[::5]))
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    nw = -(-L // 16)
    jint, tint = jnp.asarray(inter), torch.from_numpy(_bits.as_i32(inter))
    js, ts = jnp.asarray(starts), torch.from_numpy(starts)
    for a, b in zip(jgpk._gather_aligned(jint, js, nw, off),
                    tgpk._gather_aligned(tint, ts, nw, off)):
        np.testing.assert_array_equal(np.asarray(a), u32(b))
    np.testing.assert_array_equal(
        np.asarray(jgpk.gather_codes(jint, off, js, L + 32)),
        tgpk.gather_codes(tint, off, ts, L + 32).numpy())
    jw = jgpk.pack_reads(jnp.asarray(codes), jnp.asarray(lengths), nw)
    tw = tgpk.pack_reads(torch.from_numpy(codes), torch.from_numpy(lengths),
                         nw)
    want = jgpk.mismatch_counts(jint, off, js, *jw, jnp.asarray(lengths))
    got = tgpk.mismatch_counts(tint, off, ts, *tw, torch.from_numpy(lengths))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_row128_window_fetch_waits_for_lane_rotate():
    """The lane-rotate port is in: the fetch no longer raises. A 2-D
    table goes through the kernel's wrapper, which on a CPU tensor runs
    the plain version; the start is clipped into the table."""
    from urmap_tpu_torch.kernels import lane_rotate

    table = torch.arange(4 * 128, dtype=torch.int32).reshape(4, 128)
    starts = torch.tensor([0, 120, 500, 9999, -3], dtype=torch.int32)
    want = torch.tensor([0, 120, 496, 496, 0])[:, None] + torch.arange(16)
    got = tgpk.row128_window_fetch(table, starts, 16)
    assert got.dtype == torch.int32 and torch.equal(got.long(), want)
    lane_rotate.window_counter.reset()
    via = tgpk.gather_window(table, starts, 16)
    assert torch.equal(via, got)
    assert (lane_rotate.window_counter.plain_calls,
            lane_rotate.window_counter.launches) == (1, 0)
