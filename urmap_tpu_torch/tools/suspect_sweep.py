"""Suspect-gate threshold sensitivity of the port.

The port of tools/suspect_sweep.py. One mapping pass with the DEVICE
cap disabled (suspect_deficit huge) exports, per read, everything
needed to re-apply the gate at any threshold T >= suspect_remap_deficit
on the host:

    deficit  = L*match - score           (host-computable)
    sat_flag = res.suspect               (sat-evidence & deficit > remap
                                          tier — the device's raw signal)
    capped_T = sat_flag & (deficit > T)  -> mapq := min(mapq, cap)

so a full threshold sweep costs ONE run per corpus. Reports
precision/recall@MAPQ>=1 and >=10 per T, including the derived default
(ScoreConfig.mismatch_equiv(6)). Same flags and the same table as the
source; the reads map on the CUDA card, or on the CPU with ``--cpu``.
Without a card and without ``--cpu`` it raises before any work.
``--index-cache`` loads an index directory (the genome's first
sequence must be ``--genome-mbp`` long).

    python -m urmap_tpu_torch.tools.suspect_sweep [--genome-mbp 64]
        [--reads 40000] [--repeat-frac 0.25] [--index-cache DIR] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def reapply_gate(res, lengths, T: int, sc, mcfg) -> np.ndarray:
    """The MAPQs of a run with the device cap off (``res``), with the
    suspect gate applied on the host at threshold ``T``: reads flagged
    suspect whose deficit from a perfect score exceeds T are capped at
    ``mcfg.suspect_mapq_cap``."""
    deficit = lengths * sc.match - res.score
    capped = np.asarray(res.suspect, bool) & (deficit > T) & res.mapped
    return np.where(capped, np.minimum(res.mapq, mcfg.suspect_mapq_cap),
                    res.mapq)


def sweep(argv=None) -> dict:
    """The tool's run: prints its lines and returns what it mapped
    (``index``, ``mcfg``, ``sc``, ``device``, ``codes``, ``lengths``,
    ``res``, ``correct``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=40_000)
    ap.add_argument("--genome-mbp", type=float, default=64.0)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--snp-rate", type=float, default=0.01)
    ap.add_argument("--indel-rate", type=float, default=0.10)
    ap.add_argument("--repeat-frac", type=float, default=0.25)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--slop", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="map on the CPU (the plain versions of the "
                         "kernels) instead of the CUDA card")
    ap.add_argument("--positions-per-seed", type=int, default=8)
    ap.add_argument("--index-cache", default="")
    args = ap.parse_args(argv)

    from urmap_tpu_torch.config import IndexConfig, MapConfig, ScoreConfig
    from urmap_tpu_torch.device import require_device
    from urmap_tpu_torch.index.build import build_index
    from urmap_tpu_torch.io.fasta import SeqDB
    from urmap_tpu_torch.map.pipeline import Mapper
    from urmap_tpu_torch.tools.accuracy import (plant_repeat_families,
                                                simulate)

    # the card unless --cpu: raises here, before any work, without one
    device = require_device("cpu" if args.cpu else "cuda")
    rng = np.random.default_rng(0)
    glen = int(args.genome_mbp * 1e6)
    cache = args.index_cache
    if cache and os.path.exists(os.path.join(cache, "header.json")):
        from urmap_tpu_torch.index import UfiIndex

        index = UfiIndex.load(cache)
        db = index.seqdb
        assert int(db.lengths[0]) == glen
        print(f"# cached index {cache}")
    else:
        seq = rng.integers(0, 4, size=glen).astype(np.uint8)
        if args.repeat_frac > 0:
            plant_repeat_families(rng, seq, args.repeat_frac)
        db = SeqDB.from_seqs(["chr1"], [seq])
        index = build_index(
            db, IndexConfig(slot_bits=IndexConfig.auto_slot_bits(
                db.total_len)), backend="host")

    sc = ScoreConfig()
    # device cap OFF (deficit gate unreachable), remap tier at its
    # default so res.suspect carries the raw sat & deficit>remap signal
    mcfg = MapConfig(max_read_len=args.read_len, batch_size=args.batch,
                     positions_per_seed=args.positions_per_seed,
                     suspect_deficit=1 << 20)
    mapper = Mapper(index, mcfg, device=device)

    rng_reads = np.random.default_rng(1)
    codes, tpos, tstrand = simulate(rng_reads, db, args.reads,
                                    args.read_len, args.snp_rate,
                                    args.indel_rate)
    lengths = np.full(args.reads, args.read_len, np.int32)
    t0 = time.monotonic()
    res = mapper.map_codes(codes, lengths)
    print(f"# mapped in {time.monotonic() - t0:.0f}s  "
          f"(read-len {args.read_len}, snp {args.snp_rate:.0%}, "
          f"repeat {args.repeat_frac:.0%})")

    correct = (res.mapped & (np.abs(res.pos - tpos) <= args.slop)
               & (res.strand == tstrand))
    derived = sc.mismatch_equiv(6)
    print(f"# derived suspect_deficit = mismatch_equiv(6) = {derived}; "
          f"remap tier = {sc.mismatch_equiv(3)}")
    print(f"{'T':>4} {'cap_n':>7} "
          f"{'prec@1':>8} {'rec@1':>8} {'prec@10':>8} {'rec@10':>8}")
    deficit = lengths * sc.match - res.score
    sat = np.asarray(res.suspect, bool)          # raw gate signal
    for T in sorted({derived - 6, derived - 3, derived, derived + 3,
                     derived + 6}):
        capped = sat & (deficit > T) & res.mapped
        mq = reapply_gate(res, lengths, T, sc, mcfg)
        row = [f"{T:>4} {int(capped.sum()):>7}"]
        for q in (1, 10):
            called = res.mapped & (mq >= q)
            prec = (correct & called).sum() / max(called.sum(), 1)
            rec = (correct & called).sum() / args.reads
            row.append(f"{prec:>8.4f} {rec:>8.4f}")
        print(" ".join(row))
    return {"index": index, "mcfg": mcfg, "sc": sc, "device": device,
            "codes": codes, "lengths": lengths, "res": res,
            "correct": correct}


def main(argv=None):
    sweep(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
