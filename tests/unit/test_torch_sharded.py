"""The port's sharded-table helpers and the seed front's slots mode.

The table split, its files and the all-to-all slack sizing
(urmap_tpu_torch.dist.sharded, copied from urmap_tpu.dist.sharded) give
the reference's arrays on the same index; the slots mode's plain version
(map.seed.seed_front_plain with offsets=None) is bit-equal to
urmap_tpu's seed-slot extraction over both strands, the Pallas kernel in
interpret mode included, on reads with N bases and lengths below k;
make_mesh lays out and refuses meshes in a world of one rank (the
meshes of several ranks: tests/integration/test_torch_sharded.py).
"""

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from urmap_tpu_torch.dist import sharded as tsh


def _index_pair(seed, n, slot_bits):
    """The same genome indexed by both packages."""
    from urmap_tpu.index.build import build_index as jbuild
    from urmap_tpu.io.fasta import SeqDB as JSeqDB
    from urmap_tpu_torch import alphabet
    from urmap_tpu_torch.config import IndexConfig
    from urmap_tpu_torch.index import build_index as tbuild
    from urmap_tpu_torch.io.fasta import SeqDB

    rng = np.random.default_rng(seed)
    seq = alphabet.decode(rng.integers(0, 4, n).astype(np.uint8))
    from urmap_tpu.config import IndexConfig as JCfg

    kw = {} if slot_bits is None else {"slot_bits": slot_bits}
    return (tbuild(SeqDB.from_seqs(["chr1"], [seq]), IndexConfig(**kw),
                   backend="host"),
            jbuild(JSeqDB.from_seqs(["chr1"], [seq]), JCfg(**kw),
                   backend="host"))


def test_sharded_tables_roundtrip(tmp_path):
    """tests/unit/test_sharded.py's round trip on the port's copies, and
    the split equal to urmap_tpu's on the same index."""
    from urmap_tpu.dist import sharded as jsh

    tidx, jidx = _index_pair(1, 50_000, 14)
    want = tsh.shard_index_tables(tidx, 4)
    ref = jsh.shard_index_tables(jidx, 4)
    np.testing.assert_array_equal(want.offsets, ref.offsets)
    np.testing.assert_array_equal(want.positions, ref.positions)
    tsh.save_sharded_tables(tidx, str(tmp_path / "sh"), 4)
    got = tsh.load_sharded_tables(str(tmp_path / "sh"))
    assert got.num_shards == want.num_shards
    assert got.slots_per_shard == want.slots_per_shard
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.positions, want.positions)
    sub = tsh.load_sharded_tables(str(tmp_path / "sh"), shards=[1, 3])
    np.testing.assert_array_equal(sub.offsets[0], want.offsets[1])
    np.testing.assert_array_equal(sub.offsets[1], want.offsets[3])


@pytest.mark.parametrize("layout,slot_bits", [("classic", 15),
                                              ("aligned", None),
                                              ("row128", None)])
def test_shard_prepared_tables_equal_urmap_tpu(monkeypatch, layout,
                                               slot_bits):
    """The split of the map-ready tables equals the reference's on every
    layout, for 1, 2, 3 and 4 shards."""
    from urmap_tpu.dist import sharded as jsh
    from urmap_tpu.index.store import prepare_tables as jprep
    from urmap_tpu_torch.index.store import prepare_tables as tprep

    if layout == "row128":
        monkeypatch.setenv("URMAP_ROW128_BYTES", "1")
    tidx, jidx = _index_pair(2, 60_000, slot_bits)
    tht, tmeta = tprep(tidx, 16)
    jht, jmeta = jprep(jidx, 16)
    assert tmeta["layout"] == jmeta["layout"] == layout
    for s in (1, 2, 3, 4):
        a = tsh.shard_prepared_tables(tht, tmeta, s)
        b = jsh.shard_prepared_tables(jht, jmeta, s)
        assert a.slots_per_shard == b.slots_per_shard
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.positions, b.positions)


def test_a2a_slack_sizing(monkeypatch):
    """tests/unit/test_sharded.py's cases on the port's copy."""
    monkeypatch.delenv("URMAP_A2A_SLACK", raising=False)
    off = np.arange(0, 801, 100).astype(np.uint32)
    assert tsh.a2a_slack_from_index(off, 8, 1) == 2.0
    counts = np.array([350] + [50] * 7, np.int64)
    off2 = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint32)
    assert tsh.a2a_slack_from_index(off2, 8, 1) == pytest.approx(5.0)
    off3 = np.array([0, 700, 700, 700, 700, 700, 700, 700, 700],
                    np.uint32)
    assert tsh.a2a_slack_from_index(off3, 8, 1) == 8.0
    monkeypatch.setenv("URMAP_A2A_SLACK", "3.5")
    assert tsh.a2a_slack_from_index(off2, 8, 1) == 3.5


def _reads(rng, n, L, k):
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    codes[rng.random((n, L)) < 0.02] = 5          # read-N bases
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    lengths[:8] = L
    lengths[8:12] = 0                              # padded rows
    lengths[12:16] = k - 1                         # below k: all invalid
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    return codes, lengths


@pytest.mark.parametrize("L,k,q,slot_bits", [(150, 24, 8, 25),
                                             (100, 20, 6, 22),
                                             (150, 32, 5, 24)])
def test_slots_mode_plain_equals_urmap_tpu(L, k, q, slot_bits):
    """The slots mode's plain version, from the upload blocks and from
    word planes, against urmap_tpu's extraction over the same stacked
    strands: the jnp extraction on every lane, the Pallas kernel
    (interpret mode) where the seed is valid, as urmap_tpu's own test
    holds them."""
    import jax.numpy as jnp

    from urmap_tpu import genome_pack as jgpk
    from urmap_tpu.kernels.seed_slots import seed_slots_words_pallas
    from urmap_tpu.map.seed import extract_seed_slots_words_dispatch
    from urmap_tpu_torch import genome_pack as tgpk
    from urmap_tpu_torch.kernels import seed_slots

    codes, lengths = _reads(np.random.default_rng(L + k), 192, L, k)
    nw = -(-L // 16)
    cj, lj = jnp.asarray(codes), jnp.asarray(lengths)
    rp, rn = jgpk.pack_reads(cj, lj, nw)
    rrp, rrn = jgpk.revcomp_words(rp, rn, lj, L)
    rp2 = jnp.concatenate([rp, rrp])
    rn2 = jnp.concatenate([rn, rrn])
    l2 = jnp.concatenate([lj, lj])
    want = extract_seed_slots_words_dispatch(rp2, rn2, l2, L, k=k, q=q,
                                             slot_bits=slot_bits)
    pal = seed_slots_words_pallas(rp2, rn2, l2, L, k=k, q=q,
                                  slot_bits=slot_bits, block_r=128,
                                  interpret=True)
    want = [np.asarray(x) for x in want]
    valid = want[2]
    np.testing.assert_array_equal(np.asarray(pal[1]), want[1])
    np.testing.assert_array_equal(np.asarray(pal[2]), valid)
    np.testing.assert_array_equal(np.asarray(pal[0])[valid],
                                  want[0][valid])
    tl = torch.from_numpy(lengths)
    up = [torch.from_numpy(x) for x in tgpk.pack_read_codes_host(codes)]
    planes = tgpk.pack_reads(torch.from_numpy(codes), tl, nw)
    seed_slots.slots_counter.reset()
    for a, b in (up, planes):
        got = seed_slots.seed_front(a, b, tl, L, k=k, q=q,
                                    slot_bits=slot_bits, offsets=None)
        assert len(got) == 5
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.asarray(rp2).view(np.int32))
        np.testing.assert_array_equal(got[1].numpy(),
                                      np.asarray(rn2).view(np.int32))
        np.testing.assert_array_equal(got[2].numpy(), want[1])
        np.testing.assert_array_equal(got[3].numpy(), valid)
        np.testing.assert_array_equal(got[4].numpy(),
                                      want[0].view(np.int32))
    assert seed_slots.slots_counter.plain_calls == 2


@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    from urmap_tpu_torch.dist import multihost as mh

    assert not dist.is_initialized()
    assert mh.init_distributed("cpu") == "gloo"
    yield
    dist.destroy_process_group()


def test_make_mesh_in_a_world_of_one(world_of_one):
    """A world of one rank (no launcher) forms on an in-process store;
    its mesh is 1 x 1, and a mesh of more ranks than the world refuses,
    naming torchrun."""
    import torch.distributed as dist

    from urmap_tpu_torch.dist import multihost as mh

    assert (mh.process_index(), mh.process_count()) == (0, 1)
    mesh = tsh.make_mesh()
    assert mesh.shape == {"data": 1, "index": 1}
    assert (mesh.data_coord, mesh.index_coord) == (0, 0)
    assert dist.get_process_group_ranks(mesh.index_group) == [0]
    assert tsh.make_mesh(1, data=1).shape == {"data": 1, "index": 1}
    for kw in ({"data": 2, "index": 2}, {"index": 2}, {"n": 4}):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
            tsh.make_mesh(**kw)
    mh.barrier("alone")                 # a no-op for one rank
    assert [tsh._largest_pow2_divisor(n) for n in (1, 4, 6, 8, 12)] == \
        [1, 4, 2, 8, 4]


@pytest.mark.parametrize("route", ["a2a", "psum"])
def test_end_clip_sharded_mapper_in_a_world_of_one(world_of_one, tmp_path,
                                                   route):
    """Under end_clip the ShardedMapper of a 1 x 1 mesh gives the single
    Mapper's results, clip mode and clip traceback records (B6 off), and
    cigars_nm_blob the same bytes for both, without clip_open."""
    from tests.utils import make_seqdb, plant_read
    from urmap_tpu_torch.config import IndexConfig, MapConfig
    from urmap_tpu_torch.index import build_index
    from urmap_tpu_torch.map import Mapper
    from urmap_tpu_torch.map.cigar import cigars_nm_blob

    rng = np.random.default_rng(23)
    db = make_seqdb(rng, [120_000])
    idx = build_index(db, IndexConfig(slot_bits=15), backend="host")
    L, n = 150, 64
    codes = np.stack([plant_read(rng, db, length=L, n_snps=1,
                                 dels=3 if i % 3 == 0 else 0).codes
                      for i in range(n)])
    codes[1::3, L - 70 :] = rng.integers(0, 4, (len(codes[1::3]), 70))
    lengths = np.full(n, L, np.int32)
    mcfg = MapConfig(max_read_len=L, batch_size=n, end_clip=True)
    want = Mapper(idx, mcfg, device="cpu").map_codes(codes, lengths)
    sm = tsh.ShardedMapper(idx, tsh.make_mesh(), mcfg, route=route,
                           device="cpu")
    assert sm._clip and not sm.tb
    got = sm.map_codes(codes, lengths)
    for f in ("mapped", "pos", "strand", "score", "mapq", "gapped",
              "clipped"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.clip_open == want.clip_open == sm.sc.clip_open
    assert got.tb is None and (got.mapped & got.gapped).sum() >= n // 3
    for k in ("rows", "score", "pos", "strand", "dp_score"):
        np.testing.assert_array_equal(got.clip_tb[k], want.clip_tb[k])
    a, b = (cigars_nm_blob(db.codes, codes, r, sm.sc) for r in (got, want))
    assert a[0] == b[0]
