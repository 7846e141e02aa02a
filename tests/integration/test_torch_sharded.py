"""The port's sharded mappers over gloo ranks on the CPU.

One world of 4 rank processes and one of 2, each started with torchrun's
environment set by hand, run every case of their world size in one go:
meshes 1x4, 2x2 and 4x1 on both routes and 1x2 on the a2a route,
single-end through ShardedMapper(..., device="cpu") and paired through
ShardedPairedMapper, the a2a route with its lane slack forced to 0.3
(overflow rounds), a skewed repeat genome and the row128 layout. The
rank processes import only the port (no JAX: this module imports
nothing of urmap_tpu at its top). MapResult / PairResult fields and the
live traceback records (dops[:, cols]) must equal the port's single
Mapper(device="cpu"), and at 2x2 on the a2a route urmap_tpu's
ShardedMapper on its 8-virtual-device CPU mesh. On the psum route every
rank of an index row must run the same DP and clip rounds.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIELDS = ("mapped", "pos", "strand", "score", "second", "mapq", "gapped",
          "ungapped", "clipped", "suspect")
L = 160
BATCH = 32
MESHES4 = [("a2a", 1, 4), ("a2a", 2, 2), ("a2a", 4, 1),
           ("psum", 1, 4), ("psum", 2, 2), ("psum", 4, 1)]


def _mcfg():
    from urmap_tpu_torch.config import MapConfig

    return MapConfig(max_read_len=L, batch_size=BATCH)


def _rank_main(work: str) -> None:
    """One rank: every case of the spec, then its results to
    rank<r>.pkl (rank 0 writes the mapped results; every rank its
    counters)."""
    import torch

    from urmap_tpu_torch.dist import multihost as mh
    from urmap_tpu_torch.dist import sharded as sh
    from urmap_tpu_torch.index import UfiIndex
    from urmap_tpu_torch.kernels import banded_dp

    torch.set_num_threads(1)
    with open(os.path.join(work, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    assert mh.init_distributed("cpu") == "gloo"
    rank = mh.process_index()
    out = {"meshes": {}, "refused": None}
    # the mesh layouts of this world, and a mesh short of the world
    import torch.distributed as dist

    world = mh.process_count()
    for d in (1, 2, world):
        if world % d:
            continue
        m = sh.make_mesh(data=d)
        out["meshes"][d] = (m.data, m.index, m.data_coord, m.index_coord,
                            dist.get_process_group_ranks(m.index_group))
    try:
        sh.make_mesh(data=1, index=world // 2)
    except ValueError as e:
        out["refused"] = str(e)
    for case in spec["cases"]:
        saved = {k: os.environ.get(k) for k in case["env"]}
        os.environ.update(case["env"])
        idx = UfiIndex.load(case["index"])
        m = sh.ShardedMapper(idx, sh.make_mesh(data=case["data"],
                                               index=case["index_ax"]),
                             _mcfg(), route=case["route"], device="cpu")
        for c in (banded_dp.counter, banded_dp.clip_counter):
            c.reset()
        codes, lens = spec["reads"][case["reads"]]
        res = {"se": m.map_codes(codes, lens)}
        se_stats = {"comm": m.comm.snapshot(),
                    "dp": banded_dp.counter.plain_calls,
                    "clip": banded_dp.clip_counter.plain_calls,
                    "slack": m.a2a_slack, "sps": m._sps,
                    "block": m._bs}
        if case["pairs"]:
            c1, l1, c2, l2 = spec["pairs"]
            res["pe"] = sh.ShardedPairedMapper(m).map_pair_codes(c1, l1, c2,
                                                                 l2)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        out[case["name"]] = {"stats": se_stats,
                             **(res if rank == 0 else {})}
        mh.barrier(case["name"])
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(work: str, n: int, port: int, timeout: int = 600) -> list:
    """Start n rank processes with torchrun's environment, wait, and
    load what each wrote."""
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=ROOT, RANK=str(r),
                   WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from tests.integration.test_torch_sharded import "
             "_rank_main; _rank_main(sys.argv[1])", work],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    out = []
    for r in range(n):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _block(reads):
    codes = np.full((len(reads), L), 5, np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r.codes)] = r.codes
        lengths[i] = len(r.codes)
    return codes, lengths


def _problem(work):
    """The genomes, indexes (saved for the ranks) and reads of every
    case: planted single-end reads of every kind (SNPs, indels, reverse
    strand, adapter tails for the clip-rescue lane, junk, short, N
    bases), planted pairs with mates for the rescue scan, and a genome
    whose middle third is a period-7 tandem repeat."""
    from tests.utils import make_seqdb, plant_pair, plant_read
    from urmap_tpu_torch import alphabet
    from urmap_tpu_torch.index import build_index
    from urmap_tpu_torch.io.fasta import SeqDB

    rng = np.random.default_rng(9)
    db = make_seqdb(rng, [150_000, 50_000])
    reads = []
    for i in range(96):
        kind = i % 8
        if kind in (0, 1):
            r = plant_read(rng, db, strand=kind, n_snps=int(rng.integers(0, 3)))
        elif kind == 2:
            r = plant_read(rng, db, ins=int(rng.integers(1, 6)), n_snps=1)
        elif kind == 3:
            r = plant_read(rng, db, dels=int(rng.integers(1, 6)))
        elif kind == 4:                    # adapter tail: clip rescue
            r = plant_read(rng, db, length=150 - 65, strand=0)
            r.codes = np.concatenate(
                [r.codes, rng.integers(0, 4, 65).astype(np.uint8)])
        elif kind == 5:                    # junk
            r = plant_read(rng, db)
            r.codes = rng.integers(0, 4, 150).astype(np.uint8)
        elif kind == 6:                    # short, one below k
            r = plant_read(rng, db, length=int(rng.choice([20, 60, 100])))
        else:                              # N bases
            r = plant_read(rng, db, n_snps=2)
            r.codes[rng.integers(0, 150, 3)] = 5
        reads.append(r)
    pairs = [plant_pair(rng, db, length=120, frag=int(rng.integers(250, 500)),
                        n_snps=1, snp_every=15 if i % 6 == 0 else None)
             for i in range(32)]
    c1, l1 = _block([p[0] for p in pairs])
    c2, l2 = _block([p[1] for p in pairs])
    tidx = build_index(SeqDB.from_seqs(
        [f"chr{i + 1}" for i in range(db.num_seqs)],
        [alphabet.decode(db.codes[int(s) : int(s) + int(n)])
         for s, n in zip(db.starts, db.lengths)]), backend="host")
    tidx.save(os.path.join(work, "g.ufi"))

    # the skewed genome (tests/unit/test_sharded.py): half the reads
    # inside the repeat, so their seeds query the same few slots
    glen = 120_000
    seq = rng.integers(0, 4, size=glen).astype(np.uint8)
    unit = rng.integers(0, 4, size=7).astype(np.uint8)
    third = glen // 3
    seq[third : 2 * third] = np.tile(unit, third // 7 + 1)[:third]
    skew = build_index(SeqDB.from_seqs(["chr1"], [alphabet.decode(seq)]),
                       backend="host")
    skew.save(os.path.join(work, "skew.ufi"))
    sk = np.full((48, L), 5, np.uint8)
    for i in range(48):
        p = (int(rng.integers(third + 50, 2 * third - 150)) if i % 2
             else int(rng.integers(0, third - 100)))
        sk[i, :100] = seq[p : p + 100]
    return {"db": db, "index": tidx, "skew": skew,
            "reads": {"main": _block(reads), "skew": (sk, np.full(48, 100,
                                                                np.int32))},
            "pairs": (c1, l1, c2, l2), "truth": [r.gpos for r in reads]}


def _case(name, work, route, d, i, reads="main", pairs=True, env=None,
          index="g.ufi"):
    return {"name": name, "route": route, "data": d, "index_ax": i,
            "reads": reads, "pairs": pairs, "env": env or {},
            "index": os.path.join(work, index)}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("world4"))
    prob = _problem(work)
    cases = [_case(f"{r}_{d}x{i}", work, r, d, i) for r, d, i in MESHES4]
    cases += [
        _case("overflow", work, "a2a", 1, 4, pairs=False,
              env={"URMAP_A2A_SLACK": "0.3"}),
        _case("skew", work, "a2a", 1, 4, reads="skew", pairs=False,
              index="skew.ufi"),
        _case("row128_a2a", work, "a2a", 2, 2,
              env={"URMAP_ROW128_BYTES": "1"}),
        _case("row128_psum", work, "psum", 2, 2, pairs=False,
              env={"URMAP_ROW128_BYTES": "1"})]
    with open(os.path.join(work, "spec.pkl"), "wb") as f:
        pickle.dump({"cases": cases, "reads": prob["reads"],
                     "pairs": prob["pairs"]}, f)
    return prob, run_ranks(work, 4, free_port())


@pytest.fixture(scope="module")
def world2(tmp_path_factory, world4):
    work = str(tmp_path_factory.mktemp("world2"))
    prob = world4[0]
    prob["index"].save(os.path.join(work, "g.ufi"))
    cases = [_case("a2a_1x2", work, "a2a", 1, 2)]
    with open(os.path.join(work, "spec.pkl"), "wb") as f:
        pickle.dump({"cases": cases, "reads": prob["reads"],
                     "pairs": prob["pairs"]}, f)
    return prob, run_ranks(work, 2, free_port())


_single = {}


def single(prob, which="main", env=None):
    """The port's single Mapper (and PairedMapper) on the CPU."""
    key = (which, tuple(sorted((env or {}).items())))
    if key not in _single:
        from urmap_tpu_torch.map import Mapper
        from urmap_tpu_torch.map.pair import PairedMapper

        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            m = Mapper(prob["skew" if which == "skew" else "index"], _mcfg(),
                       device="cpu")
            codes, lens = prob["reads"][which]
            se = m.map_codes(codes, lens)
            pe = (PairedMapper(m).map_pair_codes(*prob["pairs"])
                  if which == "main" else None)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        _single[key] = (se, pe)
    return _single[key]


def same_result(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert (a.tb is None) == (b.tb is None)
    if a.tb is not None:
        for k in ("rows", "score", "pos", "strand"):
            np.testing.assert_array_equal(a.tb[k], b.tb[k], err_msg=k)
        np.testing.assert_array_equal(a.tb["dops"][:, a.tb["cols"]],
                                      b.tb["dops"][:, b.tb["cols"]])


def same_pairs(a, b):
    same_result(a.m1, b.m1)
    same_result(a.m2, b.m2)
    np.testing.assert_array_equal(a.proper, b.proper)


@pytest.mark.parametrize("route,d,i", MESHES4)
def test_sharded_matches_single(world4, route, d, i):
    prob, ranks = world4
    got = ranks[0][f"{route}_{d}x{i}"]
    se, pe = single(prob)
    same_result(got["se"], se)
    same_pairs(got["pe"], pe)
    assert se.tb is not None and se.tb["rows"].size > 0
    assert se.clipped.any() and se.gapped.any()
    truth = np.asarray(prob["truth"])
    ok = got["se"].mapped & (got["se"].pos == truth)
    assert ok.sum() >= 60


def test_a2a_1x2_world_of_two(world2):
    prob, ranks = world2
    se, pe = single(prob)
    same_result(ranks[0]["a2a_1x2"]["se"], se)
    same_pairs(ranks[0]["a2a_1x2"]["pe"], pe)


def test_a2a_overflow_rounds(world4):
    """Slack 0.3: K lanes hold under a third of a rank's queries per
    owner, so every batch takes several rounds, and the result stays."""
    prob, ranks = world4
    got = ranks[0]["overflow"]
    assert got["stats"]["slack"] == 0.3
    comm = got["stats"]["comm"]
    assert comm["a2a_rounds"] >= 3 * comm["a2a_loops"] > 0
    same_result(got["se"], single(prob)[0])
    # every rank took the same rounds (the world all-reduce's condition)
    assert len({r["overflow"]["stats"]["comm"]["a2a_rounds"]
                for r in ranks}) == 1


def test_a2a_overflow_rounds_equal_round_model(world4):
    """The round model of the port's a2a_rounds tool
    (urmap_tpu_torch.tools.a2a_rounds.rounds_for_batch) against the
    loop's own count: each batch of the overflow run's reads, padded and
    packed as ShardedMapper.prepack does, split into the ranks' row
    blocks, each block's seed slots from B3's slots mode on the CPU (its
    forward rows, then their reverse complements: the rows the rank's
    loop routes), with the rank's K (slack 0.3) and rows. The model's
    rounds, summed over the batches, are the Comm counts of the run:
    a2a_rounds over a2a_loops loops."""
    import torch

    from urmap_tpu_torch.genome_pack import pack_read_codes_host
    from urmap_tpu_torch.kernels.seed_slots import seed_front
    from urmap_tpu_torch.map.pair import _pad_block
    from urmap_tpu_torch.tools.a2a_rounds import rounds_for_batch

    prob, ranks = world4
    stats = ranks[0]["overflow"]["stats"]
    icfg, mcfg = prob["index"].config, _mcfg()
    S, q, bs = 4, mcfg.seeds_per_read, stats["block"]
    rps = bs // S
    K = max(1, int(stats["slack"] * 2 * rps * q / S))
    codes, lens = prob["reads"]["main"]
    rounds = []
    for b0 in range(0, len(codes), bs):
        c, ln = _pad_block(codes[b0 : b0 + bs], lens[b0 : b0 + bs], bs,
                           mcfg.max_read_len)
        pk, nm = pack_read_codes_host(c)
        slots, valid = [], []
        for r in range(S):
            blk = slice(r * rps, (r + 1) * rps)
            *_, v, s = seed_front(torch.from_numpy(pk[blk]),
                                  torch.from_numpy(nm[blk]),
                                  torch.from_numpy(ln[blk]),
                                  mcfg.max_read_len, k=icfg.k, q=q,
                                  slot_bits=icfg.slot_bits, offsets=None)
            slots.append(s.numpy())
            valid.append(v.numpy())
        rounds.append(rounds_for_batch(
            np.concatenate(slots), np.concatenate(valid), sps=stats["sps"],
            n_shards=S, rows_per_dev=2 * rps, K=K))
    comm = stats["comm"]
    assert len(rounds) == comm["a2a_loops"] == 3
    assert sum(rounds) == comm["a2a_rounds"], (rounds, comm)
    assert max(rounds) > 1


def test_a2a_skewed_repeat_genome(world4):
    prob, ranks = world4
    got = ranks[0]["skew"]
    assert got["stats"]["slack"] >= 2.0
    se = single(prob, "skew")[0]
    same_result(got["se"], se)
    assert got["se"].mapped[::2].all()


def test_psum_rounds_equal_on_every_rank_of_an_index_row(world4):
    """The psum route's DP bucket rounds call collectives: every rank of
    an index row must take the same DP and clip rounds (replicated reads,
    exact int32 combine). The counts are per rank over all batches."""
    _, ranks = world4
    for route, d, i in MESHES4:
        if route != "psum":
            continue
        st = [r[f"{route}_{d}x{i}"]["stats"] for r in ranks]
        for row in range(d):
            mine = [st[row * i + j] for j in range(i)]
            for key in ("dp", "clip"):
                assert len({s[key] for s in mine}) == 1, (d, i, key, mine)
            assert len({s["comm"]["calls"]["all_gather"]
                        for s in mine}) == 1
        assert st[0]["dp"] > 0 and st[0]["clip"] > 0


@pytest.mark.parametrize("route", ["a2a", "psum"])
def test_row128_layout(world4, route):
    prob, ranks = world4
    env = {"URMAP_ROW128_BYTES": "1"}
    se, pe = single(prob, env=env)
    got = ranks[0][f"row128_{route}"]
    same_result(got["se"], se)
    same_result(got["se"], single(prob)[0])   # and the aligned layout's
    if route == "a2a":
        same_pairs(got["pe"], pe)


def test_mesh_layouts_and_refusal(world4):
    """Rank r sits at data = r // I, index = r % I; each index row is its
    own group; a mesh short of the world refuses, naming torchrun."""
    _, ranks = world4
    for r, out in enumerate(ranks):
        for d, (dd, ii, dc, ic, group) in out["meshes"].items():
            assert (dd, ii) == (d, 4 // d)
            assert (dc, ic) == (r // ii, r % ii)
            assert group == [dc * ii + j for j in range(ii)]
        assert "torchrun --nproc-per-node 2" in out["refused"]


def test_a2a_2x2_equals_urmap_tpu(world4):
    """urmap_tpu's ShardedMapper at 2x2 on the a2a route (8-virtual-device
    CPU mesh) against the port's 4 gloo ranks: single-end and paired,
    fields and live traceback records."""
    from urmap_tpu.config import MapConfig as JCfg
    from urmap_tpu.dist.sharded import (ShardedMapper as JSM,
                                        ShardedPairedMapper as JSPM,
                                        make_mesh)
    from urmap_tpu.index.build import build_index as jbuild
    from urmap_tpu.io.fasta import SeqDB as JSeqDB
    from urmap_tpu import alphabet

    prob, ranks = world4
    db = prob["db"]
    jdb = JSeqDB.from_seqs(
        [f"chr{i + 1}" for i in range(db.num_seqs)],
        [alphabet.decode(db.codes[int(s) : int(s) + int(n)])
         for s, n in zip(db.starts, db.lengths)])
    jm = JSM(jbuild(jdb, backend="host"), make_mesh(4, data=2, index=2),
             JCfg(max_read_len=L, batch_size=BATCH), route="a2a")
    assert jm.tb
    got = ranks[0]["a2a_2x2"]
    same_result(got["se"], jm.map_codes(*prob["reads"]["main"]))
    same_pairs(got["pe"], JSPM(jm).map_pair_codes(*prob["pairs"]))
