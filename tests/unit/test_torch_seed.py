"""urmap_tpu_torch seed stage against urmap_tpu (exact).

Hashing, the plain seed-slot extraction (kernel B3's plain version)
against the jnp function and the Pallas kernel in interpret mode, the
CSR gather on classic and aligned tables, and the vote (kernel B4's
plain version) against the jnp function and the Pallas kernel, with
engineered ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from urmap_tpu import genome_pack as jgpk
from urmap_tpu import hashing as jhash
from urmap_tpu.config import IndexConfig
from urmap_tpu.index.build import build_index as jbuild
from urmap_tpu.index.store import prepare_tables as jprepare
from urmap_tpu.kernels.seed_slots import seed_slots_words_pallas
from urmap_tpu.kernels.vote import vote_pallas
from urmap_tpu.map import seed as jseed
from urmap_tpu_torch import hashing as thash
from urmap_tpu_torch import genome_pack as tgpk
from urmap_tpu_torch.index.store import tables_to_device
from urmap_tpu_torch.kernels import vote as kvote
from urmap_tpu_torch.map import seed as tseed
from tests.utils import make_seqdb


def u32(t):
    return t.numpy().view(np.uint32)


def test_hash_words_match(rng):
    lo = rng.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    tl, th = torch.from_numpy(lo.view(np.int32)), torch.from_numpy(
        hi.view(np.int32))
    np.testing.assert_array_equal(
        np.asarray(jhash.hash_words(jnp.asarray(lo), jnp.asarray(hi))),
        u32(thash.hash_words(tl, th)))
    for bits in (17, 27, 30, 32):
        np.testing.assert_array_equal(
            np.asarray(jhash.words_to_slots(jnp.asarray(lo), jnp.asarray(hi),
                                            bits)),
            u32(thash.words_to_slots(tl, th, bits)))
    codes = rng.integers(0, 5, 3000).astype(np.uint8)
    for k in (24, 21):
        for a, b in zip(jhash.extract_words_np(codes, k),
                        thash.extract_words_np(codes, k)):
            np.testing.assert_array_equal(a, b)


def _planes(rng, n, L):
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 5
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    lengths[:8] = L
    lengths[8:12] = 0
    lengths[12:16] = 23
    codes[16:20] = 5                                   # all-N reads
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    nw = -(-L // 16)
    jw = jgpk.pack_reads(jnp.asarray(codes), jnp.asarray(lengths), nw)
    tw = tgpk.pack_reads(torch.from_numpy(codes), torch.from_numpy(lengths),
                         nw)
    return jw, tw, lengths


@pytest.mark.parametrize("L,k,q,slot_bits", [
    (150, 24, 8, 27),       # the slice's shape
    (160, 24, 8, 30),
    (80, 16, 8, 20),        # k == 16
    (150, 32, 5, 24),       # k == 32, odd q
    (100, 20, 6, 22),       # k % 4 != 0
])
def test_extract_seed_slots_words_matches_jnp(rng, L, k, q, slot_bits):
    jw, tw, lengths = _planes(rng, 96, L)
    want = jseed.extract_seed_slots_words(*jw, jnp.asarray(lengths), L, k=k,
                                          q=q, slot_bits=slot_bits)
    got = tseed.extract_seed_slots_words(*tw, torch.from_numpy(lengths), L,
                                         k=k, q=q, slot_bits=slot_bits)
    np.testing.assert_array_equal(np.asarray(want[0]), u32(got[0]))
    for a, b in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_extract_seed_slots_words_matches_pallas(rng):
    L, k, q, slot_bits = 160, 24, 8, 27
    jw, tw, lengths = _planes(rng, 160, L)
    s_k, o_k, v_k = seed_slots_words_pallas(
        *jw, jnp.asarray(lengths), L, k=k, q=q, slot_bits=slot_bits,
        block_r=128, interpret=True)
    s_t, o_t, v_t = tseed.extract_seed_slots_words(
        *tw, torch.from_numpy(lengths), L, k=k, q=q, slot_bits=slot_bits)
    v = np.asarray(v_k)
    np.testing.assert_array_equal(v, v_t.numpy())
    np.testing.assert_array_equal(np.asarray(o_k), o_t.numpy())
    # the Pallas kernel's slots are defined where valid (its contract)
    np.testing.assert_array_equal(np.asarray(s_k)[v], u32(s_t)[v])


@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(3)
    db = make_seqdb(rng, [60_000, 30_000])
    return db, jbuild(db, IndexConfig(slot_bits=13), backend="host")


@pytest.mark.parametrize("layout", ["classic", "aligned"])
def test_gather_candidates_matches(rng, small_index, monkeypatch, layout):
    _db, index = small_index
    # ~11 positions per slot: at p=16 the no-straddle pad exceeds 15%
    # (classic layout), at p=4 it does not (aligned layout)
    q, n = 8, 64
    p = 4 if layout == "aligned" else 16
    ht, meta = jprepare(index, p)
    assert meta["layout"] == layout, meta["layout"]
    S = index.config.num_slots
    slots = rng.integers(0, S, size=(n, q)).astype(np.uint32)
    offs = rng.integers(0, 127, size=(n, q)).astype(np.int32)
    valid = rng.random((n, q)) < 0.8
    want = jseed.gather_candidates(
        jnp.asarray(ht["offsets"]), jnp.asarray(ht["positions"]),
        jnp.asarray(slots), jnp.asarray(offs), jnp.asarray(valid), p=p,
        csr_aligned=meta["csr_aligned"])
    dt = tables_to_device(ht, torch.device("cpu"))
    got = tseed.gather_candidates(
        dt["offsets"], dt["positions"], torch.from_numpy(slots.view(np.int32)),
        torch.from_numpy(offs), torch.from_numpy(valid), p=p,
        csr_aligned=meta["csr_aligned"])
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _vote_cases(rng, n=160, m=128):
    base = rng.integers(0, 5000, size=(n, 8))
    cand = (base[np.arange(n)[:, None], rng.integers(0, 8, size=(n, m))]
            + rng.integers(0, 2, size=(n, m))).astype(np.int32)
    cand[rng.random((n, m)) < 0.5] = jseed.SENTINEL
    cand[:4] = jseed.SENTINEL                 # all-invalid rows
    cand[4:6] = 77                            # one run over every lane
    for i in range(6, 40):                    # equal-vote runs (ties)
        a, b = sorted(rng.integers(0, 10_000, size=2))
        cand[i] = jseed.SENTINEL
        cand[i, :5], cand[i, 5:10], cand[i, 10:15] = a, b + 1, b + 3
    cand[40:48] -= (1 << 31) - (1 << 16)      # biased (negative) starts
    return cand


@pytest.mark.parametrize("m", [128, 64])
def test_vote_matches_jnp_and_pallas(rng, m):
    cand = _vote_cases(rng, m=m)
    v = 8
    tc_ref, tv_ref = jseed.vote_top_candidates(jnp.asarray(cand), v=v)
    kvote.counter.reset()
    tc, tv = kvote.vote(torch.from_numpy(cand), v=v)
    assert kvote.counter.plain_calls == 1
    np.testing.assert_array_equal(np.asarray(tv_ref), tv.numpy())
    np.testing.assert_array_equal(np.asarray(tc_ref), tc.numpy())
    tc_k, tv_k = vote_pallas(jnp.asarray(cand), v=v, block_n=8,
                             interpret=True)
    np.testing.assert_array_equal(np.asarray(tv_k), tv.numpy())
    np.testing.assert_array_equal(np.asarray(tc_k), tc.numpy())


def test_seed_offsets_and_row_words():
    lens = np.array([0, 10, 24, 25, 150, 160], np.int32)
    for q in (1, 5, 8):
        np.testing.assert_array_equal(
            np.asarray(jseed.seed_offsets(jnp.asarray(lens), 24, q)),
            tseed.seed_offsets(torch.from_numpy(lens), 24, q).numpy())
    for p in (4, 16, 17, 64):
        assert tseed.align_row_words(p) == jseed.align_row_words(p)
