"""The wide second pass (MapConfig.second_pass_p) of the port against
urmap_tpu.

urmap_tpu/tests/integration/test_second_pass.py's cases, at its scale: a
1.5 Mbp genome at slot_bits 17 (slot load ~11), a first pass capped at
2 positions a seed that loses the true locus of many reads, and a
second pass at 16 that recovers them. The port's Mapper and
PairedMapper on the CPU must equal urmap_tpu's in every field, its
recovered rows must equal a direct map at the wide cap, and the
second pass's plain calls count as host-pass calls (kernels.host_pass),
not as the first pass's.
"""

import dataclasses

import numpy as np
import pytest

from tests.utils import make_seqdb, plant_pair, plant_read
from urmap_tpu.config import IndexConfig, MapConfig
from urmap_tpu.index.build import build_index as jbuild
from urmap_tpu.map.pair import PairedMapper as JPaired
from urmap_tpu.map.pipeline import Mapper as JMapper
from urmap_tpu_torch.index import build_index as tbuild
from urmap_tpu_torch.map import Mapper as TMapper
from urmap_tpu_torch.map import PairedMapper as TPaired

FIELDS = ("mapped", "pos", "strand", "score", "second", "mapq", "gapped",
          "ungapped", "clipped", "suspect", "lengths")
NARROW = MapConfig(max_read_len=120, batch_size=64, positions_per_seed=2)
BOTH = dataclasses.replace(NARROW, second_pass_p=16)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(29)
    db = make_seqdb(rng, [1_500_000])
    cfg = IndexConfig(slot_bits=17)
    return (rng, db, jbuild(db, cfg, backend="host"),
            tbuild(db, cfg, backend="host"))


def _same(a, b, rows=slice(None)):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f)[rows],
                                      getattr(b, f)[rows], err_msg=f)


def test_second_pass_recovers_recap_loss(world):
    from urmap_tpu_torch.kernels import counters

    rng, db, jidx, tidx = world
    reads = [plant_read(rng, db, length=120, n_snps=1) for _ in range(160)]
    codes = np.stack([r.codes for r in reads])
    lengths = np.full(len(reads), 120, np.int32)
    truth = np.asarray([r.gpos for r in reads])

    r1 = TMapper(tidx, NARROW, device="cpu").map_codes(codes, lengths)
    for c in counters():
        c.reset()
    tm = TMapper(tidx, BOTH, device="cpu")
    r2 = tm.map_codes(codes, lengths)
    _same(JMapper(jidx, BOTH).map_codes(codes, lengths), r2)
    recall1 = float(((r1.pos == truth) & r1.mapped).mean())
    recall2 = float(((r2.pos == truth) & r2.mapped).mean())
    assert recall1 < 0.9 and recall2 >= 0.99, (recall1, recall2)
    # the recovered rows equal a direct map at the wide cap
    wide = TMapper(tidx, dataclasses.replace(NARROW, positions_per_seed=16),
                   device="cpu").map_codes(codes, lengths)
    rec = ~r1.mapped & r2.mapped
    assert rec.any()
    _same(r2, wide, rec)
    np.testing.assert_array_equal(r2.pos[r1.mapped], r1.pos[r1.mapped])
    # both passes ran plain versions on the CPU; the second pass's calls
    # are counted apart
    by = {c.name: c for c in counters()}
    assert by["vote"].plain_calls > 0 and by["vote"].host_pass_calls > 0
    assert by["tb_dops"].host_pass_calls == 0     # no traceback there
    assert tm.second.device.type == "cpu"


def test_second_pass_paired_mates(world):
    """Unmapped mates recover, and pairs a recovery made concordant are
    promoted to proper (PairedMapper._recheck_pairs), as urmap_tpu."""
    rng, db, jidx, tidx = world
    pairs = [plant_pair(rng, db, length=120, frag=400) for _ in range(96)]
    c1 = np.stack([p[0].codes for p in pairs])
    c2 = np.stack([p[1].codes for p in pairs])
    ln = np.full(len(pairs), 120, np.int32)
    t1 = np.asarray([p[0].gpos for p in pairs])
    p1 = TPaired(TMapper(tidx, NARROW, device="cpu")).map_pair_codes(
        c1, ln, c2, ln)
    p2 = TPaired(TMapper(tidx, BOTH, device="cpu")).map_pair_codes(
        c1, ln, c2, ln)
    want = JPaired(JMapper(jidx, BOTH)).map_pair_codes(c1, ln, c2, ln)
    _same(want.m1, p2.m1)
    _same(want.m2, p2.m2)
    np.testing.assert_array_equal(want.proper, p2.proper)
    assert float(((p2.m1.pos == t1) & p2.m1.mapped).mean()) >= 0.99
    assert not np.any(p1.proper & ~p2.proper)
    assert (p2.proper & ~p1.proper).any()


def test_second_pass_carries_the_clip_flag(world):
    """A read recovered through the second pass's clip-rescue lane comes
    back clipped, so its CIGAR takes the clip-mode host traceback."""
    from urmap_tpu_torch.config import ScoreConfig
    from urmap_tpu_torch.map.cigar import cigars_nm_fast
    from urmap_tpu_torch.map.pipeline import revcomp_strand_codes

    rng, db, jidx, tidx = world
    L, tail, n = 150, 60, 64
    codes = np.empty((n, L), np.uint8)
    for i in range(n):
        codes[i, : L - tail] = plant_read(rng, db, length=L - tail,
                                          strand=0).codes
        codes[i, L - tail:] = rng.integers(0, 4, size=tail)
    lengths = np.full(n, L, np.int32)
    cfg = MapConfig(max_read_len=L, batch_size=64, positions_per_seed=2,
                    second_pass_p=16)
    res = TMapper(tidx, cfg, device="cpu").map_codes(codes, lengths)
    _same(JMapper(jidx, cfg).map_codes(codes, lengths), res)
    rec = res.mapped & res.clipped
    assert rec.sum() >= n // 3, int(rec.sum())
    cigs, _, _ = cigars_nm_fast(
        db.codes, revcomp_strand_codes(codes, res), res, ScoreConfig(),
        clip_rows=np.asarray(res.clipped))
    assert all("S" in cigs[i] for i in np.nonzero(rec & res.gapped)[0])
