"""The seed front (kernel B3 redesigned) against urmap_tpu (exact).

The front's plain version (urmap_tpu_torch.map.seed.seed_front_plain,
what kernels/seed_slots.py seed_front runs on a CPU tensor) against the
reference's composition of the same steps: the forward words from the
upload blocks (genome_pack.read_words_from_upload) or from the codes
(pack_reads), their reverse complements (revcomp_words), both strands
stacked, the seed slots (map.seed.extract_seed_slots_words, the jnp
reference of the Pallas kernel) and the CSR gather (gather_candidates),
on classic, aligned and row128 tables (packed offsets and plain). The
front's words, seed offsets and valid flags, and the candidates built
from its decoded runs, must be bit-equal.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from urmap_tpu import genome_pack as jgpk
from urmap_tpu.config import IndexConfig
from urmap_tpu.index.build import build_index as jbuild
from urmap_tpu.index import store as jstore
from urmap_tpu.map import seed as jseed
from urmap_tpu_torch import genome_pack as tgpk
from urmap_tpu_torch.index import store as tstore
from urmap_tpu_torch.kernels import seed_slots as kseed
from urmap_tpu_torch.map import seed as tseed
from tests.unit.test_torch_cuda import front_inputs, read_block
from tests.utils import make_seqdb

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(21)
    db = make_seqdb(rng, [70_000, 30_000])
    return db, jbuild(db, IndexConfig(slot_bits=13), backend="host")


def _prepared(index, p, layout):
    if layout == "row128":
        os.environ["URMAP_ROW128_BYTES"] = "1"
    try:
        ht, meta = jstore.prepare_tables(index, p)
    finally:
        os.environ.pop("URMAP_ROW128_BYTES", None)
    assert meta["layout"] == layout, meta["layout"]
    return ht, meta


@pytest.mark.parametrize("upload", [True, False])
@pytest.mark.parametrize("layout,p,packed", [("classic", 16, False),
                                             ("aligned", 4, False),
                                             ("row128", 4, True),
                                             ("row128", 4, False)])
def test_seed_front_matches_jax_composition(world, monkeypatch, layout, p,
                                            packed, upload):
    db, index = world
    k, q, L, n = index.config.k, 8, 150, 96
    slot_bits = index.config.slot_bits
    ht, meta = _prepared(index, p, layout)
    if layout == "row128" and not packed:
        monkeypatch.setenv("URMAP_NO_PACKED_OFFSETS", "1")
    dt = tstore.tables_from_numpy(ht, meta, CPU)
    assert (dt["off_bits"] is not None) == packed
    cb, bb = dt["off_bits"] if packed else (0, 0)
    jt = jstore.tables_to_device(ht, use_packed_offsets=packed)

    rng = np.random.default_rng(
        [("classic", "aligned", "row128").index(layout), packed, upload])
    # most reads are planted, so the gather finds their runs
    codes, lens = read_block(rng, n, L, k)
    g = db.codes
    for i in range(0, n, 2):
        s = int(rng.integers(0, g.shape[0] - L))
        codes[i, : lens[i]] = np.where(g[s : s + lens[i]] >= 4, 5,
                                       g[s : s + lens[i]])
    nw = -(-L // 16)
    tl = torch.from_numpy(lens)
    if upload:
        pk, nm = tgpk.pack_read_codes_host(codes)
        jrp, jrn = jgpk.read_words_from_upload(jnp.asarray(pk),
                                               jnp.asarray(nm),
                                               jnp.asarray(lens), nw)
        a, b = torch.from_numpy(pk), torch.from_numpy(nm)
    else:
        jrp, jrn = jgpk.pack_reads(jnp.asarray(codes), jnp.asarray(lens), nw)
        a, b = tgpk.pack_reads(torch.from_numpy(codes), tl, nw)
    jrc, jrcn = jgpk.revcomp_words(jrp, jrn, jnp.asarray(lens), L)
    jrp2 = jnp.concatenate([jrp, jrc])
    jrn2 = jnp.concatenate([jrn, jrcn])
    jl2 = jnp.concatenate([jnp.asarray(lens)] * 2)
    slots, offs, valid = jseed.extract_seed_slots_words(
        jrp2, jrn2, jl2, L, k=k, q=q, slot_bits=slot_bits)
    want = jseed.gather_candidates(
        jt["offsets"], jt["positions"], slots, offs, valid, p=p,
        csr_aligned=meta["csr_aligned"], row128=layout == "row128",
        obase=jt.get("obase"), off_cnt_bits=cb, off_block_bits=bb)

    kseed.counter.reset()
    rp2, rn2, t_offs, t_valid, start, cnt = kseed.seed_front(
        a, b, tl, L, k=k, q=q, slot_bits=slot_bits, offsets=dt["offsets"],
        obase=dt.get("obase"), cnt_bits=cb, block_bits=bb)
    assert (kseed.counter.plain_calls,
            kseed.counter.launches) == (1, 0)
    got = tseed.gather_runs(dt["positions"], start, cnt, t_offs, t_valid,
                            p=p, csr_aligned=dt["csr_aligned"],
                            row128=dt["row128"])
    np.testing.assert_array_equal(np.asarray(jrp2).view(np.int32),
                                  rp2.numpy())
    np.testing.assert_array_equal(np.asarray(jrn2).view(np.int32),
                                  rn2.numpy())
    np.testing.assert_array_equal(np.asarray(offs), t_offs.numpy())
    np.testing.assert_array_equal(np.asarray(valid), t_valid.numpy())
    assert start.dtype == torch.int64 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert (got.numpy() != tseed.SENTINEL).sum() > n


@pytest.mark.parametrize("packed", [False, True])
def test_front_decodes_offsets_past_2_32(packed):
    """The runs the front decodes, against a numpy decode of the table at
    the reference's slots, on a table whose offsets pass 2^32: plain
    offsets wrap as uint32, the packed form's starts are 64-bit sums of
    its block base and delta."""
    rng = np.random.default_rng(5)
    L, k, q, sb = 96, 16, 4, 12
    a, b, lens, tabs = front_inputs(rng, 40, L, k, True, packed, sb)
    ta = [torch.from_numpy(x) for x in (a, b, lens)]
    out = kseed.seed_front(*ta, L, k=k, q=q, slot_bits=sb,
                           offsets=torch.from_numpy(tabs["offsets"]),
                           obase=None if tabs["obase"] is None
                           else torch.from_numpy(tabs["obase"]),
                           cnt_bits=tabs["cnt_bits"],
                           block_bits=tabs["block_bits"])
    start, cnt = out[4].numpy(), out[5].numpy()
    nw = -(-L // 16)
    jrp, jrn = jgpk.read_words_from_upload(*(jnp.asarray(x) for x in
                                             (a, b, lens)), nw)
    jrc, jrcn = jgpk.revcomp_words(jrp, jrn, jnp.asarray(lens), L)
    slots, _o, _v = jseed.extract_seed_slots_words(
        jnp.concatenate([jrp, jrc]), jnp.concatenate([jrn, jrcn]),
        jnp.concatenate([jnp.asarray(lens)] * 2), L, k=k, q=q, slot_bits=sb)
    sl = np.asarray(slots).astype(np.int64)
    off = tabs["offsets"].view(np.uint32).astype(np.int64)
    if packed:
        u = off[sl >> 1]
        u = np.where(sl & 1, u >> 16, u) & 0xFFFF
        base = tabs["obase"].view(np.uint32).astype(np.int64)
        want_start = base[sl >> tabs["block_bits"]] + (u >> tabs["cnt_bits"])
        want_cnt = u & ((1 << tabs["cnt_bits"]) - 1)
    else:
        want_start = off[sl]
        want_cnt = (off[sl + 1] - off[sl]) % (1 << 32)
    np.testing.assert_array_equal(start, want_start)
    np.testing.assert_array_equal(cnt, want_cnt)
    assert start.max() >= 0xFFFF_0000 and cnt.max() == 3
