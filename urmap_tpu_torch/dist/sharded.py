"""Sharded mapping: the index tables split over a mesh of ranks.

A port of urmap_tpu/dist/sharded.py to torch.distributed. The mesh has
two axes, ("data", "index"):

  * data: batch parallelism over reads;
  * index: the CSR tables split by hash-slot range, so an index larger
    than one card spans the ranks of an index row. Each rank answers
    the seed lookups of the slots it owns.

Two routes combine the lookups across the index axis:

  * "a2a" (default): reads sharded over both axes. Each round packs a
    rank's unserved (read, seed) slot queries into per-owner lanes
    [S, K], an all-to-all sends them to the owners, each owner fetches
    its CSR runs (decode_offsets, then gather_runs: kernel B5's row entry
    on the card) and a second all-to-all sends the answers [S, K, P]
    home. Queries past the K lanes wait for the next round; the loop's
    condition is an all-reduce of the queries left over the world (one
    host sync a round, counted in ``Comm``).
  * "psum": reads replicated over the index axis. Each rank fetches the
    seeds it owns and one all-reduce over the index row sums the masked
    candidates (each seed is owned by exactly one rank); the DP bucket
    is split over the row, each rank running B1 on its chunk, and an
    all-gather rejoins the scores.

Process model (dist/multihost.py): one rank per device. Rank r sits at
data = r // I and index = r % I, as the reference lays devices out
(np.asarray(devs).reshape(data, index)). One process group per index
row, and the world group for the a2a loop's condition; every rank
creates every group, in the same order (``dist.new_group`` directly:
several ranks may share one card here, which a DeviceMesh of "cuda"
does not lay out). Every rank runs the same batches in the same order:
``start_batch`` takes the whole (replicated) host batch and maps the
rows the rank owns; ``finish_batch`` all-gathers the rows and the
traceback matrices, so every rank returns the whole batch (the
reference's single-process mesh does the same); ``finish_batch_local``
returns the rank's own rows and their global row indices, which the CLI
writes. On the a2a route rank r owns rows [r*rps, (r+1)*rps); on the
psum route the rows of data row d are replicated over its index ranks
and only index 0 returns them.

The device traceback runs on every rank over its rows, wherever
tb_enabled holds, and so does the clip traceback, wherever
clip_tb_enabled holds; the records rebase to global rows as in the
reference's _merge_tb / _merge_tb_pairs. (The reference turns it off
under multi-host; the SAM bytes are the same either way.)

The table and sizing functions from ``_largest_pow2_divisor`` to
``a2a_slack_from_index`` are the reference's, copied verbatim
(tests/unit/test_torch_copies.py holds them by text).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from urmap_tpu_torch.config import MapConfig, ScoreConfig
from urmap_tpu_torch.index.store import UfiIndex
from urmap_tpu_torch.map.dp import banded_packed
from urmap_tpu_torch.map.pipeline import (PACKED_COLS, MapResult,
                                          clip_mode, clip_tb_cols,
                                          clip_tb_enabled, clip_tb_past,
                                          clip_tb_rows,
                                          map_batch_device, merge_clip_tb,
                                          pack_out, refuse_beyond_card,
                                          tb_cols, tb_enabled, tb_rows,
                                          unpack_clip_tb, unpack_out,
                                          unpack_tb)
from urmap_tpu_torch.map.seed import (POS_BIAS, SENTINEL, decode_offsets,
                                      gather_runs)


@dataclass
class Mesh:
    """A ("data", "index") mesh over the world's ranks: this rank's
    place in it and the process group of its index row."""

    data: int
    index: int
    rank: int
    index_group: object

    @property
    def shape(self) -> dict:
        return {"data": self.data, "index": self.index}

    @property
    def data_coord(self) -> int:
        return self.rank // self.index

    @property
    def index_coord(self) -> int:
        return self.rank % self.index


def make_mesh(n: int | None = None, *, data: int | None = None,
              index: int | None = None) -> Mesh:
    """("data", "index") mesh over the world's ranks, with the
    reference's defaults (most ranks on the index axis). torch.distributed
    must be initialised (multihost.init_distributed). A mesh that does
    not span the world is refused: a rank outside it would own no rows."""
    world = dist.get_world_size()
    n = n or world
    if data is None and index is None:
        index = _largest_pow2_divisor(n)
        data = n // index
    elif data is None:
        data = n // index  # type: ignore[operator]
    elif index is None:
        index = n // data
    if data * index != n or n != world:
        raise ValueError(
            f"mesh {data}x{index} over a world of {world} rank(s): a mesh "
            "takes one rank per device and spans the world; launch "
            f"{data * index} ranks (torchrun --nproc-per-node "
            f"{data * index} -m urmap_tpu_torch ...)")
    rank = dist.get_rank()
    mine = None
    for d in range(data):
        g = dist.new_group([d * index + i for i in range(index)])
        if d == rank // index:
            mine = g
    return Mesh(data=data, index=index, rank=rank, index_group=mine)


# urmap_tpu/dist/sharded.py:_largest_pow2_divisor
def _largest_pow2_divisor(n: int) -> int:
    p = 1
    while n % (p * 2) == 0:
        p *= 2
    return p


# urmap_tpu/dist/sharded.py:ShardedTables
@dataclass
class ShardedTables:
    """Host-side stacked per-shard tables, ready for device_put.

    offsets: int32[S, sps + 1] local CSR offsets per shard (slot range
    [s*sps, (s+1)*sps), global slot space padded up to S*sps).
    positions: int32[S, pmax] local position arrays, padded with 0 past
    each shard's count (dead lanes are masked by the offsets).
    """

    num_shards: int
    slots_per_shard: int
    offsets: np.ndarray
    positions: np.ndarray


# urmap_tpu/dist/sharded.py:shard_index_tables
def shard_index_tables(index: UfiIndex, num_shards: int) -> ShardedTables:
    """Split the global CSR by hash-slot range into ``num_shards`` shards."""
    cfg = index.config
    S = num_shards
    sps = -(-cfg.num_slots // S)
    goff = index.offsets.astype(np.int64)
    # biased device coordinates (seed.POS_BIAS) — same as device_tables
    pos = (index.positions.astype(np.int64) - POS_BIAS).astype(np.int32)

    off_l = []
    pos_l = []
    pmax = 0
    for s in range(S):
        lo = min(s * sps, cfg.num_slots)
        hi = min((s + 1) * sps, cfg.num_slots)
        o = goff[lo : hi + 1] - goff[lo]
        if hi - lo < sps:  # pad tail shard's slot range with empty slots
            o = np.concatenate([o, np.full(sps - (hi - lo), o[-1], np.int64)])
        off_l.append(o.astype(np.uint32))
        p = pos[goff[lo] : goff[hi]]
        pmax = max(pmax, p.shape[0])
        pos_l.append(p)
    from urmap_tpu_torch.genome_pack import ROW_WORDS

    pmax = max(pmax, 1)
    pmax += 2 * ROW_WORDS + ((-pmax) % ROW_WORDS)  # row-gather guard pad
    positions = np.zeros((S, pmax), np.int32)
    for s, p in enumerate(pos_l):
        positions[s, : p.shape[0]] = p
    return ShardedTables(num_shards=S, slots_per_shard=sps,
                         offsets=np.stack(off_l), positions=positions)


# urmap_tpu/dist/sharded.py:shard_prepared_tables
def shard_prepared_tables(ht: dict, meta: dict,
                          num_shards: int) -> ShardedTables:
    """Split MAP-READY prepared tables (store.prepare_tables layout — the
    positions already biased, optionally row-ALIGNED) by hash-slot range.

    Alignment survives the split for free: each shard's local base is the
    global run start rounded DOWN to a multiple of the row width rw, so
    every local start keeps its residue mod g for all power-of-two
    g ≤ rw — the exact invariant seed._aligned_rows_fetch and the tiered
    gather rely on. No per-shard re-placement pass needed."""
    from urmap_tpu_torch.genome_pack import ROW_WORDS
    from urmap_tpu_torch.map.seed import align_row_words

    offsets = np.asarray(ht["offsets"])           # uint32 [num_slots+1]
    positions = ht["positions"]                   # int32, may be mmap
    num_slots = offsets.shape[0] - 1
    S = num_shards
    sps = -(-num_slots // S)
    layout = meta.get(
        "layout", "aligned" if meta.get("csr_aligned") else "classic")
    rw = 128 if layout == "row128" else align_row_words(int(meta["p"]))
    fill = SENTINEL if layout in ("aligned", "row128") else 0

    off_l, rng_l = [], []
    plen = 1
    for s in range(S):
        lo = min(s * sps, num_slots)
        hi = min((s + 1) * sps, num_slots)
        start, end = int(offsets[lo]), int(offsets[hi])
        base = start & ~(rw - 1)
        o = offsets[lo : hi + 1].astype(np.int64) - base
        if hi - lo < sps:  # pad tail shard's slot range with empty slots
            o = np.concatenate([o, np.full(sps - (hi - lo), o[-1], np.int64)])
        off_l.append(o.astype(np.uint32))
        rng_l.append((base, end))
        plen = max(plen, end - base)
    pmax = plen + 2 * ROW_WORDS
    pmax += (-pmax) % max(rw, ROW_WORDS)          # aligned-fetch row guard
    out_pos = np.full((S, pmax), fill, np.int32)
    for s, (base, end) in enumerate(rng_l):
        out_pos[s, : end - base] = positions[base:end]
    return ShardedTables(num_shards=S, slots_per_shard=sps,
                         offsets=np.stack(off_l), positions=out_pos)


# urmap_tpu/dist/sharded.py:save_sharded_tables
def save_sharded_tables(index: UfiIndex, path: str, num_shards: int) -> None:
    """Persist per-shard CSR files (one npz per hash-range shard) so a
    multi-host run can load only its own shards (SURVEY.md §2.7). The
    genome/seqdb rides in the base index directory (index.save)."""
    import json
    import os

    st = shard_index_tables(index, num_shards)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "shards.json"), "w") as f:
        json.dump({"num_shards": st.num_shards,
                   "slots_per_shard": st.slots_per_shard}, f)
    for s in range(st.num_shards):
        np.savez(os.path.join(path, f"shard{s}.npz"),
                 offsets=st.offsets[s], positions=st.positions[s])


# urmap_tpu/dist/sharded.py:load_sharded_tables
def load_sharded_tables(path: str,
                        shards: list[int] | None = None) -> ShardedTables:
    """Load all (or a subset of) shard files back into stacked arrays."""
    import json
    import os

    with open(os.path.join(path, "shards.json")) as f:
        meta = json.load(f)
    n = meta["num_shards"]
    idxs = list(range(n)) if shards is None else shards
    offs = []
    poss = []
    pmax = 1
    for s in idxs:
        with np.load(os.path.join(path, f"shard{s}.npz")) as z:
            offs.append(z["offsets"])
            poss.append(z["positions"])
            pmax = max(pmax, poss[-1].shape[0])
    positions = np.zeros((len(idxs), pmax), np.int32)
    for i, p in enumerate(poss):
        positions[i, : p.shape[0]] = p
    return ShardedTables(num_shards=n,
                         slots_per_shard=meta["slots_per_shard"],
                         offsets=np.stack(offs), positions=positions)


# urmap_tpu/dist/sharded.py:a2a_slack_from_index
def a2a_slack_from_index(offsets, n_index: int, sps: int) -> float:
    """Adaptive all_to_all lane slack (round-3 verdict missing item 5:
    K = slack·M/S was a blind 2.0× constant). Reads sample the genome,
    so the expected fraction of seed queries OWNED by shard s is ≈
    shard s's share of the UNCAPPED position mass — and a high-copy
    repeat family (few distinct k-mers × millions of occurrences)
    concentrates its whole query load on whichever shard hashes its
    slots, costing overflow-retry rounds on every batch at uniform
    slack. Sizing rule: 1.25× the hottest shard's mass share × S
    (shards at the mean need slack 1; the 1.25 covers batch-level
    sampling noise), floored at 2.0 (the measured-safe uniform default)
    and capped at S (K = M always finishes in one round).
    URMAP_A2A_SLACK overrides."""
    env = os.environ.get("URMAP_A2A_SLACK")
    if env:
        return float(env)
    S = n_index
    n_slots = offsets.shape[0] - 1
    total = int(offsets[-1])
    if total <= 0 or S <= 1:
        return 2.0
    cuts = np.asarray(offsets[np.minimum(np.arange(S + 1) * sps, n_slots)],
                      np.int64)
    max_frac = float(np.diff(cuts).max()) / total
    return float(min(max(2.0, 1.25 * S * max_frac), S))


class Comm:
    """The collectives of the sharded routes, counted: calls and bytes
    each rank sends by kind, the a2a loop's rounds and its loop calls.
    Every collective here takes CUDA tensors under NCCL and gloo alike
    (multihost docstring), so nothing is staged by this code."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.reset()

    def reset(self) -> None:
        self.calls: dict[str, int] = {}
        self.bytes: dict[str, int] = {}
        self.a2a_loops = 0
        self.a2a_rounds = 0

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = (self.bytes.get(kind, 0)
                            + t.numel() * t.element_size())

    def all_reduce(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """Sum over ``group`` (the index row; None: the world), in place."""
        self._count("all_reduce", t)
        dist.all_reduce(t, group=group)
        return t

    def all_gather(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """[n, ...] from each rank of ``group`` → [size * n, ...] in rank
        order."""
        size = dist.get_world_size(group)
        out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
        self._count("all_gather", t)
        dist.all_gather(list(out.chunk(size)), t.contiguous(), group=group)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Row block s of ``t`` [S, ...] to index rank s; row block s of
        the result came from index rank s."""
        out = torch.empty_like(t)
        self._count("all_to_all", t)
        dist.all_to_all_single(out, t.contiguous(),
                               group=self.mesh.index_group)
        return out

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "a2a_loops": self.a2a_loops, "a2a_rounds": self.a2a_rounds}


def _owner_fetch(offsets, positions, rel, seed_offs, owned, *, p: int,
                 csr_aligned: bool, tier: int | None, row128: bool):
    """The rank's CSR fetch of shard-local slots ``rel`` [N, Q]: the
    decode on its offsets shard, then gather_runs (kernel B5's row entry
    on the card; the tiered gather's own rounds stay local)."""
    start, cnt = decode_offsets(offsets, rel)
    return gather_runs(positions, start, cnt, seed_offs, owned, p=p,
                       csr_aligned=csr_aligned, tier=tier, row128=row128)


def _psum_gather_runner(offsets, positions, *, sps: int, p: int,
                        csr_aligned: bool, tier: int | None,
                        row128: bool, comm: Comm):
    """Owner answers and one all-reduce over the index row (reads are
    replicated there). The reference's two psums (the masked candidates
    and the hit counts) ride one all-reduce of both stacked."""
    my_base = comm.mesh.index_coord * sps

    def gather_runner(slots, offs, valid):
        rel = slots - my_base
        owned = valid & (rel >= 0) & (rel < sps)
        cand = _owner_fetch(offsets, positions, rel.clamp(0, sps - 1), offs,
                            owned, p=p, csr_aligned=csr_aligned, tier=tier,
                            row128=row128)
        # exactly one shard owns each (read, seed): sum masked partials
        hit = cand != SENTINEL
        both = comm.all_reduce(torch.stack(
            [torch.where(hit, cand, 0), hit.to(torch.int32)]),
            comm.mesh.index_group)
        return torch.where(both[1] > 0, both[0], SENTINEL)

    return gather_runner


def _psum_dp_runner(ginter, base_off: int, *, mcfg: MapConfig,
                    sc: ScoreConfig, comm: Comm):
    """The DP bucket split over the index row: each rank runs B1 on its
    chunk of ceil(n / S) lanes, one all-gather of the four outputs
    stacked rejoins them. Lanes past n (the last chunk's pad) repeat
    lane n - 1 and are sliced off. Every rank of the row calls this in
    the same rounds: the reads are replicated over the row and the
    combine is exact int32, so the bucket loop's condition is equal on
    all of them."""
    S = comm.mesh.index
    my = comm.mesh.index_coord

    def dp_runner(flat_cand, flat_reads, flat_lens, flat_rp, flat_rn):
        n = flat_cand.shape[0]
        chunk = -(-n // S)
        lanes = torch.arange(my * chunk, (my + 1) * chunk,
                             device=flat_cand.device).clamp(max=n - 1)
        outs = banded_packed(
            ginter, base_off, flat_cand[lanes], flat_reads[lanes],
            flat_lens[lanes], flat_rp[lanes], flat_rn[lanes],
            hw=mcfg.band_halfwidth, sc=sc,
            clip_open=clip_mode(mcfg, sc))
        got = comm.all_gather(torch.stack(outs).T.contiguous(),
                              comm.mesh.index_group)        # [S*chunk, 4]
        return tuple(got[:n, j] for j in range(4))

    return dp_runner


def _a2a_gather_runner(offsets, positions, *, sps: int, p: int,
                       csr_aligned: bool, tier: int | None, row128: bool,
                       slack: float, comm: Comm):
    """Fixed-capacity all-to-all seed routing (the reference's
    _a2a_gather_runner, its while_loop a Python loop): per round a
    stable sort of the unserved queries by owner, each one's rank among
    its owner's queries, the first K per owner sent; the owner answers
    with its CSR fetch at offset 0; the answers go home. Invalid seeds
    never route and stay SENTINEL."""
    S = comm.mesh.index
    my_base = comm.mesh.index_coord * sps
    SENT_Q = -1

    def gather_runner(slots, offs, valid):
        m, q = slots.shape
        M = m * q
        K = max(1, int(slack * M / S))
        dev = slots.device
        fslot = slots.reshape(-1)
        owner = torch.div(fslot, sps, rounding_mode="floor").clamp(0, S - 1)
        cand_pos = torch.full((M, p), SENTINEL, dtype=torch.int32,
                              device=dev)
        served = ~valid.reshape(-1)
        iota = torch.arange(M, dtype=torch.int64, device=dev)
        rounds = 0
        while True:
            # the loop's condition over the world, as the reference's
            # psum over ("data", "index"): one host sync a round
            rem = comm.all_reduce((~served).any().to(torch.int32)
                                  .reshape(1))
            if int(rem.item()) == 0:
                break
            ow = torch.where(served, S, owner)   # served: a dummy owner
            order = torch.sort(ow, stable=True).indices
            so = ow[order]
            counts = torch.bincount(so, minlength=S + 1)
            first = torch.cumsum(counts, 0) - counts
            rank = iota - first[so]
            okK = (rank < K) & (so < S)
            # the lanes past K and the served queries land in a dummy
            # cell of a [S + 1, K + 1] block, cut off before sending
            send = torch.full((S + 1, K + 1), SENT_Q, dtype=torch.int32,
                              device=dev)
            send[torch.where(okK, so, S), torch.where(okK, rank, K)] = \
                fslot[order]
            recv = comm.all_to_all(send[:S, :K].contiguous())    # [S, K]
            rel = recv - my_base
            owned = (rel >= 0) & (rel < sps) & (recv != SENT_Q)
            relc = rel.clamp(0, sps - 1).reshape(-1, 1)
            resp = _owner_fetch(offsets, positions, relc,
                                torch.zeros_like(relc), owned.reshape(-1, 1),
                                p=p, csr_aligned=csr_aligned, tier=tier,
                                row128=row128)                  # [S*K, P]
            back = comm.all_to_all(resp.reshape(S, K, p))
            got = back[so.clamp(max=S - 1), rank.clamp(max=K - 1)]
            cand_pos[order] = torch.where(okK[:, None], got,
                                          cand_pos[order])
            served[order] = served[order] | okK
            rounds += 1
        comm.a2a_loops += 1
        comm.a2a_rounds += rounds
        cand = torch.where(cand_pos == SENTINEL, SENTINEL,
                           cand_pos - offs.reshape(-1, 1))
        return cand.reshape(m, q * p)

    return gather_runner


def _make_runners(tables: dict, *, route: str, sps: int, mcfg: MapConfig,
                  sc: ScoreConfig, a2a_slack: float, comm: Comm):
    """(gather_runner, dp_runner) of a rank over its shard of the
    tables."""
    kw = dict(sps=sps, p=mcfg.positions_per_seed,
              csr_aligned=tables["csr_aligned"], tier=tables["gather_tier"],
              row128=tables["row128"], comm=comm)
    if route == "a2a":
        gr = _a2a_gather_runner(tables["offsets"], tables["positions"],
                                slack=a2a_slack, **kw)
        return gr, None   # reads sharded over both axes: the DP is local
    gr = _psum_gather_runner(tables["offsets"], tables["positions"], **kw)
    dr = _psum_dp_runner(tables["ginter"], tables["base_off"], mcfg=mcfg,
                         sc=sc, comm=comm)
    return gr, dr


class ShardedMapper:
    """The Mapper's surface (prepack / start_batch / finish_batch /
    map_codes / second_pass) over a sharded mesh, so the CLI's pipelined
    drain drives either.

    ``route``: "a2a" (default) or "psum" (module docstring). ``device``:
    this rank's card ("cuda": cuda:{LOCAL_RANK % device_count()}) unless
    the caller asks for the CPU. The prepared tables are the single
    Mapper's (``prepared``, or load_prepared / prepare_tables), split by
    slot range with shard_prepared_tables on the plain offsets (the
    packed row128 offsets are not sharded); each rank keeps its shard and
    the whole genome. ``finish_batch_local`` gives the CLI this rank's
    rows."""

    def __init__(self, index: UfiIndex, mesh: Mesh,
                 mcfg: MapConfig | None = None, sc: ScoreConfig | None = None,
                 route: str = "a2a", *, device="cuda",
                 prepared: tuple[dict, dict] | None = None):
        from urmap_tpu_torch.dist.multihost import rank_device
        from urmap_tpu_torch.index.store import (effective_gather_tier,
                                                 load_prepared,
                                                 prepare_tables,
                                                 tables_to_device)
        from urmap_tpu_torch.map.pipeline import WideSecondPass

        if route not in ("a2a", "psum"):
            raise ValueError(f"route {route!r}: a2a or psum")
        self.device = rank_device(device)
        self.mcfg = mcfg or MapConfig()
        refuse_beyond_card(self.mcfg, self.device)
        self.index = index
        self.mesh = mesh
        self.route = route
        self.icfg = index.config
        self.sc = sc or ScoreConfig()
        self.packed_upload = True
        self.comm = Comm(mesh)
        n_index = mesh.index
        p = self.mcfg.positions_per_seed
        if prepared is None:
            prepared = load_prepared(index, p) or prepare_tables(index, p)
        ht, meta = prepared
        self.csr_aligned = bool(meta["csr_aligned"])
        self.gather_tier = effective_gather_tier(meta)
        self.row128 = meta.get("layout") == "row128"
        st = shard_prepared_tables(ht, meta, n_index)
        self._sps = st.slots_per_shard
        # adaptive all-to-all lane slack from the uncapped per-shard
        # position mass (a2a_slack_from_index)
        self.a2a_slack = a2a_slack_from_index(index.offsets, n_index,
                                              self._sps)
        # batch rows per step: the configured batch, rounded up to split
        # evenly over the batch axes
        n_rows = mesh.data * (n_index if route == "a2a" else 1)
        self._rows = n_rows
        self._bs = -(-max(self.mcfg.batch_size, 2 * n_rows)
                     // (2 * n_rows)) * (2 * n_rows)
        # this rank's row block of a step, and whether it returns it
        self._block = mesh.rank if route == "a2a" else mesh.data_coord
        self._owner = route == "a2a" or mesh.index_coord == 0
        s = mesh.index_coord
        self.tables = tables_to_device(
            {"offsets": st.offsets[s], "positions": st.positions[s],
             "ginter": ht["ginter"], "base_off": ht["base_off"],
             "genome_max_biased": ht["genome_max_biased"],
             "layout": meta.get("layout")}, self.device)
        self.tables.update(csr_aligned=self.csr_aligned,
                           gather_tier=self.gather_tier, row128=self.row128,
                           off_bits=None)
        del st
        self.tb = tb_enabled(self.mcfg)
        # the clip traceback's matrix rides every single-end batch's
        # output (lanes with do 0 where this rank's clip lane ran no
        # round): the all-gather takes one size from every rank
        self._clip = clip_tb_enabled(self.mcfg, self.sc)
        self.clip_open = clip_mode(self.mcfg, self.sc)
        self._runners = _make_runners(self.tables, route=route,
                                      sps=self._sps, mcfg=self.mcfg,
                                      sc=self.sc, a2a_slack=self.a2a_slack,
                                      comm=self.comm)
        self.second = (WideSecondPass(index, self.mcfg, self.sc)
                       if self.mcfg.second_pass_p else None)

    def second_pass(self, codes, lengths, result) -> MapResult:
        """Host-CPU wide-gather recovery (pipeline.Mapper.second_pass)."""
        if self.second is None:
            return result
        return self.second(codes, lengths, result)

    # ---- the Mapper's surface (the CLI's run_stream drives it) ----

    def prepack(self, codes: np.ndarray, lengths: np.ndarray):
        """Host upload prep (pad to the mesh-even block + 2-bit pack) of
        the whole batch, which every rank is fed."""
        from urmap_tpu_torch.genome_pack import pack_read_codes_host
        from urmap_tpu_torch.map.pair import _pad_block

        B = codes.shape[0]
        if B > self._bs:
            raise ValueError(f"batch {B} > sharded block {self._bs}")
        c, ln = _pad_block(codes, lengths, self._bs, self.mcfg.max_read_len)
        pk, nm = pack_read_codes_host(c)
        return pk, nm, ln, B

    def _rps(self, rows: int) -> int:
        return rows // self._rows

    def _mine(self, *blocks, rows: int):
        """This rank's row block of each host block, on its device."""
        rps = self._rps(rows)
        r0 = self._block * rps
        return [torch.from_numpy(np.ascontiguousarray(b[r0 : r0 + rps]))
                .to(self.device) for b in blocks]

    def start_batch(self, codes, lengths, *, prepacked=None):
        pk, nm, ln, B = (prepacked if prepacked is not None
                         else self.prepack(codes, lengths))
        pk, nm, ln = self._mine(pk, nm, ln, rows=self._bs)
        gr, dr = self._runners
        out = map_batch_device(self.tables, None, ln, icfg=self.icfg,
                               mcfg=self.mcfg, sc=self.sc,
                               packed_reads=(pk, nm), tb=self.tb,
                               clip_tb=self._clip,
                               gather_runner=gr, dp_runner=dr)
        packed = pack_out(out).reshape(-1)
        if self.tb:
            packed = torch.cat([packed, out["_tb"].reshape(-1)])
        if self._clip:
            cm = out.get("_clip_tb")
            if cm is None:
                cm = torch.zeros((clip_tb_rows(self.mcfg),
                                  clip_tb_cols(self._rps(self._bs),
                                               self.mcfg)),
                                 dtype=torch.int32, device=self.device)
            packed = torch.cat([packed, cm.reshape(-1)])
        return packed, B

    def _gather_owners(self, flat: torch.Tensor) -> np.ndarray:
        """Every rank's flat output → [owners, n] on the host, the
        row-owning ranks' in row order (a collective: every rank calls
        it for every batch, in order)."""
        got = self.comm.all_gather(flat[None]).cpu().numpy()
        owners = [r for r in range(got.shape[0])
                  if self.route == "a2a" or r % self.mesh.index == 0]
        return got[owners]

    def _split(self, arr: np.ndarray, rps: int, cols: int, tb_nrows: int):
        """Flat per-rank outputs [n_sh, ...] → (rows [n_sh * rps, cols],
        traceback matrices over ``tb_nrows`` rows each, side by side
        [tb_rows, n_sh * C], or None)."""
        split = rps * cols
        rows = arr[:, :split].reshape(-1, cols)
        if not self.tb:
            return rows, None
        C = tb_cols(tb_nrows, self.mcfg)
        mats = arr[:, split : split + tb_rows(self.mcfg) * C] \
            .reshape(arr.shape[0], tb_rows(self.mcfg), C)
        return rows, np.concatenate(list(mats), axis=1)

    def _clip_mats(self, arr: np.ndarray, tb_nrows: int):
        """The clip traceback matrices at the end of each rank's flat
        single-end output, side by side [clip_tb_rows, n_sh * C], or
        None."""
        if not self._clip:
            return None
        C = clip_tb_cols(tb_nrows, self.mcfg)
        nr = clip_tb_rows(self.mcfg)
        mats = arr[:, arr.shape[1] - nr * C :].reshape(arr.shape[0], nr, C)
        return np.concatenate(list(mats), axis=1)

    def _merge_clip(self, arr: np.ndarray, rows_per_shard: int) -> dict:
        """Per-shard clip blocks → one dict with global rows and columns
        (shard s owns batch rows [s*rps, (s+1)*rps), as _merge_tb)."""
        Cl = clip_tb_cols(rows_per_shard, self.mcfg)
        nsh = arr.shape[1] // Cl
        return merge_clip_tb(
            [unpack_clip_tb(arr[:, s * Cl : (s + 1) * Cl])
             for s in range(nsh)],
            [s * rows_per_shard for s in range(nsh)])

    def _merge_tb(self, arr: np.ndarray, rows_per_shard: int) -> dict:
        """Per-shard dops blocks → one host tb dict with global row and
        column indices (urmap_tpu/dist/sharded.py ShardedMapper._merge_tb:
        shard s owns batch rows [s*rps, (s+1)*rps), and shard order keeps
        the rows ascending)."""
        from urmap_tpu_torch.map.pipeline import TB_META_ROWS

        hw, L = self.mcfg.band_halfwidth, self.mcfg.max_read_len
        Cl = tb_cols(rows_per_shard, self.mcfg)
        nsh = arr.shape[1] // Cl
        parts = []
        for s in range(nsh):
            p = unpack_tb(arr[:, s * Cl : (s + 1) * Cl], hw, L)
            p["rows"] += s * rows_per_shard
            p["cols"] += s * Cl
            parts.append(p)
        return {
            "rows": np.concatenate([p["rows"] for p in parts]),
            "score": np.concatenate([p["score"] for p in parts]),
            "pos": np.concatenate([p["pos"] for p in parts]),
            "strand": np.concatenate([p["strand"] for p in parts]),
            "cols": np.concatenate([p["cols"] for p in parts]),
            "dops": arr[TB_META_ROWS:], "hw": hw, "L": L,
        }

    def finish_batch(self, handle, lengths) -> MapResult:
        """The whole batch on every rank (an all-gather of the rows and
        traceback matrices)."""
        out, B = handle
        rps = self._rps(self._bs)
        got = self._gather_owners(out)
        rows, tbmat = self._split(got, rps, PACKED_COLS, rps)
        merged = {k: v[:B] for k, v in unpack_out(rows).items()}
        res = MapResult.from_device(merged, np.asarray(lengths)[:B],
                                    self.clip_open)
        if tbmat is not None:
            res.tb = self._merge_tb(tbmat, rps)
        clipmat = self._clip_mats(got, rps)
        if clipmat is not None:
            res.clip_tb = self._merge_clip(clipmat, rps)
            clip_tb_past(res, self.mcfg, clip_tb_cols(rps, self.mcfg), rps)
        return res

    def _local_rows(self, B: int, rows: int):
        """Global indices of this rank's returned rows below B (empty
        where another rank of its index row returns them)."""
        rps = self._rps(rows)
        if not self._owner:
            return np.zeros(0, np.int64)
        r0 = self._block * rps
        return np.arange(r0, min(r0 + rps, B), dtype=np.int64)

    def finish_batch_local(self, handle, lengths):
        """This rank's rows → (MapResult over them, their global row
        indices), no collective: each rank formats and writes its own
        rows, and the rank-ordered shard merge gives the whole SAM
        (dist/multihost.py). The traceback records keep their local row
        indices, which are the result's."""
        out, B = handle
        rps = self._rps(self._bs)
        rows = self._local_rows(B, self._bs)
        arr = out.cpu().numpy()[None]
        packed, tbmat = self._split(arr, rps, PACKED_COLS, rps)
        res = MapResult.from_device(unpack_out(packed[: rows.size]),
                                    np.asarray(lengths)[rows], self.clip_open)
        if tbmat is not None and rows.size:
            res.tb = unpack_tb(tbmat, self.mcfg.band_halfwidth,
                               self.mcfg.max_read_len)
        clipmat = self._clip_mats(arr, rps)
        if clipmat is not None and rows.size:
            res.clip_tb = unpack_clip_tb(clipmat)
            clip_tb_past(res, self.mcfg, clipmat.shape[1], rps)
        return res, rows

    def map_codes(self, codes: np.ndarray, lengths: np.ndarray) -> MapResult:
        from urmap_tpu_torch.map.pipeline import merge_tb_batches

        B = codes.shape[0]
        outs = []
        for s in range(0, B, self._bs):
            h = self.start_batch(codes[s : s + self._bs],
                                 lengths[s : s + self._bs])
            outs.append(self.second_pass(
                codes[s : s + self._bs], lengths[s : s + self._bs],
                self.finish_batch(h, lengths[s : s + self._bs])))
        if len(outs) == 1:
            return outs[0]
        merged = {f: np.concatenate([getattr(o, f) for o in outs])
                  for f in ("mapped", "pos", "strand", "score", "second",
                            "mapq", "gapped", "ungapped", "clipped",
                            "suspect")}
        res = MapResult(lengths=np.asarray(lengths)[:B],
                        clip_open=self.clip_open, **merged)
        res.tb = merge_tb_batches([o.tb for o in outs],
                                  range(0, B, self._bs))
        res.clip_tb = merge_clip_tb([o.clip_tb for o in outs],
                                    range(0, B, self._bs))
        return res


class ShardedPairedMapper:
    """Paired-end over a ShardedMapper, with map.pair.PairedMapper's
    surface (prepack / start_batch / finish_batch / finish_batch_local /
    map_pair_codes / second_pass / format_py). Both mates of a pair map
    on the same rank; only the candidate stage crosses the index axis."""

    def __init__(self, mapper: ShardedMapper):
        from urmap_tpu_torch.map.pair import PairedMapper

        self.mapper = mapper
        self.index = mapper.index
        self.mcfg = mapper.mcfg
        self.sc = mapper.sc
        self.device = mapper.device
        self.packed_upload = True
        # pair batches are half the read batch (PairedMapper), kept
        # mesh-even by ShardedMapper._bs
        self.pair_batch = mapper._bs // 2
        self.tb = mapper.tb
        self.clip_open = mapper.clip_open
        self.stats = {"rescue_rounds": 0, "batches": 0}
        # the single-card host side, bound to this object: the upload
        # prep at pair_batch, the batch loop, the formatter and the
        # per-mate second pass (they touch self.pair_batch / self.index /
        # self.sc / self.mcfg / the batch surface / the mapper's second
        # pass)
        for name in ("prepack", "map_pair_codes", "format_py",
                     "second_pass", "_recheck_pairs"):
            setattr(self, name,
                    functools.partial(getattr(PairedMapper, name), self))

    def start_batch(self, codes1, lengths1, codes2, lengths2, *,
                    prepacked=None):
        from urmap_tpu_torch.map.pair import map_pairs_packed

        m = self.mapper
        *blocks, B = (prepacked if prepacked is not None
                      else self.prepack(codes1, lengths1, codes2, lengths2))
        gr, dr = m._runners
        out = map_pairs_packed(m.tables, *m._mine(*blocks,
                                                  rows=self.pair_batch),
                               icfg=m.icfg, mcfg=self.mcfg, sc=self.sc,
                               tb=self.tb, stats=self.stats,
                               gather_runner=gr, dp_runner=dr)
        self.stats["batches"] += 1
        return out, B

    def _result(self, arr, lengths1, lengths2, rows):
        from urmap_tpu_torch.map.pair import PairResult

        C = PACKED_COLS
        return PairResult(
            m1=MapResult.from_device(unpack_out(arr[:, 0:C]),
                                     np.asarray(lengths1)[rows],
                                     self.clip_open),
            m2=MapResult.from_device(unpack_out(arr[:, C : 2 * C]),
                                     np.asarray(lengths2)[rows],
                                     self.clip_open),
            proper=arr[:, 2 * C].astype(bool))

    def _merge_tb_pairs(self, arr: np.ndarray, bpl: int) -> tuple:
        """PE twin of _merge_tb (urmap_tpu/dist/sharded.py
        ShardedMapper._merge_tb_pairs): per-shard rows [0, bpl) are
        mate 1 and [bpl, 2*bpl) mate 2 → (m1_tb, m2_tb) with global pair
        rows."""
        from urmap_tpu_torch.map.pipeline import TB_META_ROWS

        hw, L = self.mcfg.band_halfwidth, self.mcfg.max_read_len
        Cl = tb_cols(2 * bpl, self.mcfg)
        nsh = arr.shape[1] // Cl
        sides = ([], [])
        for s in range(nsh):
            p = unpack_tb(arr[:, s * Cl : (s + 1) * Cl], hw, L)
            p["cols"] += s * Cl
            m1 = p["rows"] < bpl
            for side, sel, base in ((0, m1, 0), (1, ~m1, bpl)):
                sides[side].append({
                    "rows": p["rows"][sel] - base + s * bpl,
                    "score": p["score"][sel], "pos": p["pos"][sel],
                    "strand": p["strand"][sel],
                    "cols": p["cols"][sel]})

        def cat(parts):
            return {
                "rows": np.concatenate([q["rows"] for q in parts]),
                "score": np.concatenate([q["score"] for q in parts]),
                "pos": np.concatenate([q["pos"] for q in parts]),
                "strand": np.concatenate([q["strand"] for q in parts]),
                "cols": np.concatenate([q["cols"] for q in parts]),
                "dops": arr[TB_META_ROWS:], "hw": hw, "L": L,
            }

        return cat(sides[0]), cat(sides[1])

    def finish_batch(self, handle, lengths1, lengths2):
        """The whole pair batch on every rank (an all-gather)."""
        m = self.mapper
        out, B = handle
        rpp = m._rps(self.pair_batch)
        arr, tbmat = m._split(m._gather_owners(out), rpp,
                              2 * PACKED_COLS + 1, 2 * rpp)
        res = self._result(arr[:B], lengths1, lengths2, slice(0, B))
        if tbmat is not None:
            res.m1.tb, res.m2.tb = self._merge_tb_pairs(tbmat, rpp)
        return res

    def finish_batch_local(self, handle, lengths1, lengths2):
        """This rank's pair rows → (PairResult, global pair-row indices);
        see ShardedMapper.finish_batch_local."""
        m = self.mapper
        out, B = handle
        rpp = m._rps(self.pair_batch)
        rows = m._local_rows(B, self.pair_batch)
        arr, tbmat = m._split(out.cpu().numpy()[None], rpp,
                              2 * PACKED_COLS + 1, 2 * rpp)
        res = self._result(arr[: rows.size], lengths1, lengths2, rows)
        if tbmat is not None and rows.size:
            res.m1.tb, res.m2.tb = self._merge_tb_pairs(tbmat, rpp)
        return res, rows
