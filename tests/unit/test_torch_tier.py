"""The port's tiered gather (map.seed.gather_runs ``tier``, after
decode_offsets) against its untiered gather and urmap_tpu's tiered
gather_candidates (exact).

The genome of tests/unit/test_index.py's tiered-gather test: one 600 bp
unit pasted 40 times between random spacers, so the unit's k-mers fill
slots past the tier (under the cap), over 2^20 slots, where the unique
sequence's slots hold a position or two. With ``tier_overflow_frac=64`` a
round serves 128 seeds, so a batch with many repeat reads runs several
overflow rounds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401  (one torch thread)
from tests.utils import plant_read
from urmap_tpu.config import IndexConfig, MapConfig
from urmap_tpu.index.build import build_index as jbuild
from urmap_tpu.io.fasta import SeqDB
from urmap_tpu.map import seed as jseed
from urmap_tpu_torch.index import build_index as tbuild
from urmap_tpu_torch.index.store import tables_to_device
from urmap_tpu_torch.kernels import lane_rotate, tier_rounds
from urmap_tpu_torch.map import seed as tseed

MCFG = MapConfig(max_read_len=80, batch_size=64)
P = MCFG.positions_per_seed


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    unit = rng.integers(0, 4, size=600).astype(np.uint8)
    parts = [rng.integers(0, 4, size=200_000).astype(np.uint8)]
    for _ in range(40):
        parts.append(unit)
        parts.append(rng.integers(0, 4, size=1_000).astype(np.uint8))
    db = SeqDB.from_seqs(["chr1"], [np.concatenate(parts)])
    icfg = IndexConfig(slot_bits=20)
    rw = jseed.align_row_words(P)
    jt = jbuild(db, icfg, backend="host").host_tables(cap=P, row_align=rw)
    ht = tbuild(db, icfg, backend="host").host_tables(cap=P, row_align=rw)
    np.testing.assert_array_equal(jt["positions"], ht["positions"])
    unique = np.stack([plant_read(rng, db, length=80, strand=0, n_snps=1,
                                  gpos=int(rng.integers(0, 190_000))).codes
                       for _ in range(64)])
    repeat = np.stack([unit[o : o + 80] for o in
                       rng.integers(0, 520, size=64)]).astype(np.uint8)
    return {"icfg": icfg, "jt": jt, "dt": tables_to_device(
        ht, torch.device("cpu")), "unique": unique, "repeat": repeat}


def _seeds(icfg, reads):
    lens = np.full(reads.shape[0], reads.shape[1], np.int32)
    slots, offs, valid = jseed.extract_seed_slots(
        jnp.asarray(reads), jnp.asarray(lens), k=icfg.k,
        q=MCFG.seeds_per_read, slot_bits=icfg.slot_bits)
    return np.array(slots), np.array(offs), np.array(valid)


def _gathers(world, reads, tier):
    """(urmap_tpu tiered, port untiered, port tiered, rounds, per-seed
    counts and validity)."""
    slots, offs, valid = _seeds(world["icfg"], reads)
    jt, dt = world["jt"], world["dt"]
    want = jseed.gather_candidates(
        jnp.asarray(jt["offsets"]), jnp.asarray(jt["positions"]),
        jnp.asarray(slots), jnp.asarray(offs), jnp.asarray(valid), p=P,
        csr_aligned=True, tier=tier, tier_overflow_frac=64)
    start, cnt = tseed.decode_offsets(
        dt["offsets"], torch.from_numpy(slots.view(np.int32)))
    args = (dt["positions"], start, cnt, torch.from_numpy(offs),
            torch.from_numpy(valid))
    full = tseed.gather_runs(*args, p=P, csr_aligned=True)
    tier_rounds.reset()
    lane_rotate.fetch_counter.reset()
    got = tseed.gather_runs(*args, p=P, csr_aligned=True, tier=tier,
                            tier_overflow_frac=64)
    counts = np.diff(jt["offsets"].astype(np.int64))[slots]
    return (np.asarray(want), full.numpy(), got.numpy(), tier_rounds.rounds,
            counts, valid)


@pytest.mark.parametrize("tier", [4, 8])
def test_tiered_gather_matches(world, tier):
    """A batch of unique and repeat reads: several overflow rounds; the
    tiered gather equals the untiered one and urmap_tpu's tiered one."""
    reads = np.concatenate([world["unique"][:16], world["repeat"][:48]])
    want, full, got, rounds, counts, valid = _gathers(world, reads, tier)
    over = int((valid & (counts > tier)).sum())
    assert over > 2 * 128 and rounds == -(-over // 128)
    assert tier_rounds.calls == 1
    # one plain fetch at the tier width, then one a round at full width
    assert lane_rotate.fetch_counter.plain_calls == 1 + rounds
    np.testing.assert_array_equal(got, full)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tier", [4, 8])
def test_tiered_gather_without_overflow(world, tier):
    """Unique reads only: no seed passes the tier, zero rounds."""
    reads = world["unique"]
    want, full, got, rounds, counts, valid = _gathers(world, reads, tier)
    assert not (valid & (counts > tier)).any() and valid.any()
    assert rounds == 0 and tier_rounds.calls == 1
    np.testing.assert_array_equal(got, full)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tier", [4, 8])
def test_tiered_gather_every_seed_overflows(world, tier):
    """Repeat reads only: every valid seed passes the tier."""
    reads = world["repeat"]
    want, full, got, rounds, counts, valid = _gathers(world, reads, tier)
    assert valid.all() and (counts > tier).all()
    assert rounds == -(-int(valid.sum()) // 128)
    np.testing.assert_array_equal(got, full)
    np.testing.assert_array_equal(got, want)


def test_tier_must_be_a_power_of_two(world):
    slots, offs, valid = _seeds(world["icfg"], world["unique"][:4])
    dt = world["dt"]
    start, cnt = tseed.decode_offsets(
        dt["offsets"], torch.from_numpy(slots.view(np.int32)))
    with pytest.raises(ValueError, match="power of two"):
        tseed.gather_runs(dt["positions"], start, cnt,
                          torch.from_numpy(offs), torch.from_numpy(valid),
                          p=P, csr_aligned=True, tier=6)
