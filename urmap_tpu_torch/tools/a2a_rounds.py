"""a2a overflow-round accounting of the port under repeat-skewed slot
loads.

The port of tools/a2a_rounds.py. The sharded a2a route
(dist/sharded._a2a_gather_runner) serves at most K = slack*M/S queries
per destination shard a round; hot shards (a low-diversity repeat
family concentrates its query mass on whichever shard owns its slots)
overflow K and cost extra all_to_all rounds every batch. The loop is
deterministic, each round serving the first K unserved queries per
destination, so

    rounds(device) = ceil(max_dest_count / K),  global = max over devices

is exact: it equals the loop's own count (Comm.a2a_rounds a loop). This
tool samples read batches from a genome (optionally repeat-laden), takes
their real seed slots from kernel B3's slots mode (the seed front with
no offsets table: forward rows, then the reverse complements, the layout
the sharded routes run), and reports the per-batch round distribution
at the adaptive slack (dist/sharded.a2a_slack_from_index) against the
former 2.0 constant.

Same flags, the same table and the same last JSON line
(``"metric": "a2a_rounds"``) as the source, with one flag added: the
source runs on the CPU; the port runs the seed front on the CUDA card,
or on the CPU with ``--cpu``. Without a card and without ``--cpu`` it
raises before any work.

    python -m urmap_tpu_torch.tools.a2a_rounds [--genome-mbp 64]
        [--repeat-frac 0.25] [--index-cache DIR] [--shards 8]
        [--batches 16] [--batch 8192] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


# tools/a2a_rounds.py:rounds_for_batch
def rounds_for_batch(slots: np.ndarray, valid: np.ndarray, *, sps: int,
                     n_shards: int, rows_per_dev: int, K: int) -> int:
    """Exact round count of the fixed-capacity a2a loop for one batch.

    slots/valid [m, q] are the batch's seed queries in device row order
    (m = 2B rows, fwd then rc — matching the [2B] strand layout the
    runner sees); reads shard contiguously over devices (data*index
    axes), ``rows_per_dev`` rows each. Each device needs
    ceil(max over destinations of its query count / K) rounds; the
    while_loop's psum condition runs every device to the global max."""
    m = slots.shape[0]
    worst = 1
    for d0 in range(0, m, rows_per_dev):
        s = slots[d0 : d0 + rows_per_dev].reshape(-1)
        v = valid[d0 : d0 + rows_per_dev].reshape(-1)
        owner = np.clip(s[v].astype(np.int64) // sps, 0, n_shards - 1)
        if owner.size == 0:
            continue
        hist = np.bincount(owner, minlength=n_shards)
        worst = max(worst, int(-(-hist.max() // K)))
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mbp", type=float, default=64.0)
    ap.add_argument("--repeat-frac", type=float, default=0.25)
    ap.add_argument("--index-cache", default="",
                    help="use an existing index (e.g. the at-scale "
                         "repeat cache) instead of building one")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--cpu", action="store_true",
                    help="run the seed front on the CPU (its plain "
                         "version) instead of the CUDA card")
    args = ap.parse_args(argv)

    import torch

    from urmap_tpu_torch.config import IndexConfig, MapConfig
    from urmap_tpu_torch.device import require_device
    from urmap_tpu_torch.dist.sharded import a2a_slack_from_index
    from urmap_tpu_torch.genome_pack import pack_read_codes_host
    from urmap_tpu_torch.kernels.seed_slots import seed_front
    from urmap_tpu_torch.tools.synth import synth_reads

    # the card unless --cpu: raises here, before any work, without one
    device = require_device("cpu" if args.cpu else "cuda")
    rng = np.random.default_rng(0)
    if args.index_cache:
        from urmap_tpu_torch.index import UfiIndex

        index = UfiIndex.load(args.index_cache)
        db = index.seqdb
    else:
        from urmap_tpu_torch.index.build import build_index
        from urmap_tpu_torch.io.fasta import SeqDB
        from urmap_tpu_torch.tools.accuracy import plant_repeat_families

        seq = rng.integers(0, 4, size=int(args.genome_mbp * 1e6)) \
            .astype(np.uint8)
        if args.repeat_frac > 0:
            plant_repeat_families(rng, seq, args.repeat_frac)
        db = SeqDB.from_seqs(["chr1"], [seq])
        index = build_index(
            db, IndexConfig(slot_bits=IndexConfig.auto_slot_bits(
                db.total_len)), backend="host")
    icfg = index.config
    mcfg = MapConfig()
    S = args.shards
    sps = -(-icfg.num_slots // S)
    slack_ad = a2a_slack_from_index(index.offsets, S, sps)

    B = args.batch
    rows_per_dev = max(1, 2 * B // (S * args.data_axis))
    lengths = torch.full((B,), args.read_len, dtype=torch.int32,
                         device=device)

    def batch_slots(codes):
        # the seed front's slots mode over the upload blocks: [2B, Q]
        # slots and validity, forward rows then the reverse complements
        a, b = (torch.from_numpy(x).to(device)
                for x in pack_read_codes_host(codes))
        _, _, _, v, s = seed_front(a, b, lengths, codes.shape[1],
                                   k=icfg.k, q=mcfg.seeds_per_read,
                                   slot_bits=icfg.slot_bits, offsets=None)
        return s.cpu().numpy(), v.cpu().numpy()

    results = {}
    for name, slack in (("adaptive", slack_ad), ("const2", 2.0)):
        M = rows_per_dev * mcfg.seeds_per_read
        K = max(1, int(slack * M / S))
        rounds = []
        for b in range(args.batches):
            codes, _, _ = synth_reads(rng, db, B, args.read_len)
            s, v = batch_slots(codes)
            rounds.append(rounds_for_batch(s, v, sps=sps, n_shards=S,
                                           rows_per_dev=rows_per_dev, K=K))
        r = np.asarray(rounds)
        results[name] = {"slack": round(float(slack), 3), "K": K,
                         "rounds_p50": int(np.percentile(r, 50)),
                         "rounds_max": int(r.max())}
        print(f"{name:9s} slack={slack:5.2f} K={K:5d} rounds: "
              f"p50={np.percentile(r, 50):.0f} max={r.max()}")
    print(json.dumps({"metric": "a2a_rounds", "shards": S,
                      "repeat_frac": args.repeat_frac, **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
