"""Mapping accuracy of the port: precision and recall by MAPQ threshold.

The port of tools/accuracy.py (the URMAP paper's headline accuracy
metric: simulate reads with known true locations and error profiles,
map them, report precision and recall at each MAPQ cutoff). A call is
correct if the reported POS is within ``--slop`` bases of the planted
location on the right strand. Same flags, the same per-MAPQ table and
the same last JSON line (``"metric": "accuracy_roc"``) as the source;
the index is built on the host, and the reads map on the CUDA card, or
on the CPU with ``--cpu``. Without a card and without ``--cpu`` it
raises before any work.

    python -m urmap_tpu_torch.tools.accuracy [--reads 20000]
        [--genome-mbp 4] [--repeat-frac 0.25] [--veryfast] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


# tools/accuracy.py:simulate (its alphabet import names this package)
def simulate(rng, db, n, length, snp_rate, indel_rate):
    """Planted reads with per-read random SNP count and occasional indel."""
    from urmap_tpu_torch import alphabet

    start = int(db.starts[0])
    ref_len = int(db.lengths[0])
    codes = np.full((n, length), alphabet.READ_N, np.uint8)
    truth_pos = np.zeros(n, np.int64)
    truth_strand = np.zeros(n, np.int8)
    for i in range(n):
        p = int(rng.integers(0, ref_len - length - 16))
        gp = start + p
        frag = db.codes[gp : gp + length + 8].copy()
        if rng.random() < indel_rate:
            off = int(rng.integers(10, length - 10))
            if rng.random() < 0.5:  # deletion 1-4
                d = int(rng.integers(1, 5))
                frag = np.concatenate([frag[:off], frag[off + d:]])
            else:  # insertion 1-4
                ins = rng.integers(0, 4, size=int(rng.integers(1, 5)))
                frag = np.concatenate([frag[:off], ins.astype(np.uint8),
                                       frag[off:]])
        frag = frag[:length]
        mut = rng.random(length) < snp_rate
        frag[mut] = (frag[mut] + rng.integers(1, 4, size=int(mut.sum()))) % 4
        strand = int(rng.integers(0, 2))
        if strand:
            frag = alphabet.revcomp(frag)
        codes[i] = frag
        truth_pos[i] = gp
        truth_strand[i] = strand
    return codes, truth_pos, truth_strand


# tools/accuracy.py:plant_repeat_families
def plant_repeat_families(rng, seq: np.ndarray, frac: float) -> None:
    """Overwrite ~``frac`` of the genome with realistic repeat content
    (round-3 verdict item 2: the old model was pairwise 5 kb segment
    copies — no HIGH-COPY families, which are what actually hammer the
    vote/candidate/MAPQ machinery and the a2a slot skew on real GRCh38).
    Budget split, mirroring the human repeat landscape in spirit:

      55%  SINE-like: one 300 bp consensus copied thousands of times,
           each copy independently diverged ~8% (Alu-like: near-identical
           short elements everywhere),
      25%  LINE-like: one 6 kb consensus at ~4% divergence (long
           elements — a read fits INSIDE one, making copies ambiguous),
      10%  exact segmental duplications (5 kb head→tail copies, zero
           divergence: the hardest MAPQ case),
      10%  low-complexity tandem (period 5-9): a handful of distinct
           k-mers carrying huge position mass — the a2a hot-shard case.

    In-place on ``seq`` (uint8 codes)."""
    glen = seq.shape[0]
    budget = int(glen * frac)

    def diverged(cons, rate):
        c = cons.copy()
        m = rng.random(c.shape[0]) < rate
        c[m] = (c[m] + rng.integers(1, 4, size=int(m.sum()))) % 4
        return c

    # SINE-like family
    sine = rng.integers(0, 4, size=300).astype(np.uint8)
    n_sine = int(budget * 0.55) // 300
    for _ in range(n_sine):
        d = int(rng.integers(0, glen - 300))
        seq[d : d + 300] = diverged(sine, 0.08)
    # LINE-like family
    line = rng.integers(0, 4, size=6000).astype(np.uint8)
    for _ in range(int(budget * 0.25) // 6000):
        d = int(rng.integers(0, glen - 6000))
        seq[d : d + 6000] = diverged(line, 0.04)
    # exact segmental duplications
    for _ in range(int(budget * 0.10) // 5000):
        srcp = int(rng.integers(0, glen // 2 - 5000))
        d = int(rng.integers(glen // 2, glen - 5000))
        seq[d : d + 5000] = seq[srcp : srcp + 5000]
    # low-complexity tandem runs
    placed = 0
    target = int(budget * 0.10)
    while placed < target:
        period = int(rng.integers(5, 10))
        run = int(rng.integers(2000, 8000))
        unit = rng.integers(0, 4, size=period).astype(np.uint8)
        d = int(rng.integers(0, glen - run))
        seq[d : d + run] = np.tile(unit, run // period + 1)[:run]
        placed += run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=20_000)
    ap.add_argument("--genome-mbp", type=float, default=4.0)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--snp-rate", type=float, default=0.01)
    ap.add_argument("--indel-rate", type=float, default=0.10)
    ap.add_argument("--slop", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--cpu", action="store_true",
                    help="map on the CPU (the plain versions of the "
                         "kernels) instead of the CUDA card")
    ap.add_argument("--positions-per-seed", type=int, default=0,
                    help="override MapConfig.positions_per_seed")
    ap.add_argument("--min-votes", type=int, default=0,
                    help="override MapConfig.min_votes (0 = config default)")
    ap.add_argument("--veryfast", action="store_true",
                    help="build a -veryfast index (+2 slot_bits) and "
                         "apply config.VERYFAST_MAP_OVERRIDES")
    ap.add_argument("--endclip", action="store_true",
                    help="MapConfig.end_clip (X-drop-analog soft "
                         "clipping) — compare ROC vs the default")
    ap.add_argument("--second-pass", type=int, default=0,
                    help="MapConfig.second_pass_p: host wide-gather "
                         "recovery — measures recovery under repeat "
                         "load at scale")
    ap.add_argument("--repeat-frac", type=float, default=0.0,
                    help="fraction of the genome made of duplicated "
                         "segments — reads there are ambiguous; a good "
                         "mapper reports them at MAPQ 0, so precision at "
                         "MAPQ>=10 should stay ~1.0 while recall drops")
    ap.add_argument("--index-cache", default="",
                    help="directory to save/load the built index + "
                         "prepared tables (the at-scale repeat runs "
                         "re-use one build across configs; the genome "
                         "is deterministic in the seed, so a cache hit "
                         "is bit-equal to a rebuild)")
    args = ap.parse_args(argv)

    from urmap_tpu_torch.config import IndexConfig, MapConfig
    from urmap_tpu_torch.device import require_device
    from urmap_tpu_torch.index.build import build_index
    from urmap_tpu_torch.io.fasta import SeqDB
    from urmap_tpu_torch.map.pipeline import Mapper

    # the card unless --cpu: raises here, before any work, without one
    device = require_device("cpu" if args.cpu else "cuda")
    rng = np.random.default_rng(0)
    glen = int(args.genome_mbp * 1e6)
    cache = args.index_cache
    if cache and os.path.exists(os.path.join(cache, "header.json")):
        from urmap_tpu_torch.index import UfiIndex

        t0 = time.monotonic()
        index = UfiIndex.load(cache)
        db = index.seqdb
        assert int(db.lengths[0]) == glen, (db.lengths[0], glen)
        print(f"# cached index loaded in {time.monotonic() - t0:.0f}s")
    else:
        seq = rng.integers(0, 4, size=glen).astype(np.uint8)
        if args.repeat_frac > 0:
            t0 = time.monotonic()
            plant_repeat_families(rng, seq, args.repeat_frac)
            print(f"# repeats planted in {time.monotonic() - t0:.0f}s")
        db = SeqDB.from_seqs(["chr1"], [seq])
        sbits = IndexConfig.auto_slot_bits(db.total_len)
        if args.veryfast:
            sbits = min(sbits + 2, 30)
        t0 = time.monotonic()
        index = build_index(db, IndexConfig(slot_bits=sbits,
                                            veryfast=args.veryfast),
                            backend="host")
        print(f"# index built in {time.monotonic() - t0:.0f}s")
        if cache:
            index.save(cache)
    mkw = dict(max_read_len=args.read_len, batch_size=args.batch)
    if args.veryfast:
        from urmap_tpu_torch.config import VERYFAST_MAP_OVERRIDES

        mkw.update(VERYFAST_MAP_OVERRIDES)
    if args.positions_per_seed:
        mkw["positions_per_seed"] = args.positions_per_seed
    if args.min_votes:
        mkw["min_votes"] = args.min_votes
    if args.endclip:
        mkw["end_clip"] = True
    if args.second_pass:
        mkw["second_pass_p"] = args.second_pass
    if cache:
        from urmap_tpu_torch.index.store import load_prepared, save_prepared

        pp = mkw.get("positions_per_seed", MapConfig.positions_per_seed)
        for p_ in [pp] + ([args.second_pass] if args.second_pass else []):
            if load_prepared(index, p_) is None:
                t0 = time.monotonic()
                save_prepared(index, cache, p_)
                print(f"# prepared p={p_} cached in "
                      f"{time.monotonic() - t0:.0f}s")
    mapper = Mapper(index, MapConfig(**mkw), device=device)

    # reads come from their OWN rng stream so a cache hit simulates the
    # same reads as a fresh build (the genome rng consumed differently)
    rng_reads = np.random.default_rng(1)
    codes, tpos, tstrand = simulate(rng_reads, db, args.reads,
                                    args.read_len,
                                    args.snp_rate, args.indel_rate)
    lengths = np.full(args.reads, args.read_len, np.int32)
    t0 = time.monotonic()
    res = mapper.map_codes(codes, lengths)
    el = time.monotonic() - t0

    correct = (res.mapped & (np.abs(res.pos - tpos) <= args.slop)
               & (res.strand == tstrand))
    print(f"{args.reads} reads ({args.snp_rate:.0%} SNP, "
          f"{args.indel_rate:.0%} indel), {el:.1f}s")
    print(f"{'MAPQ>=':>8} {'called':>8} {'correct':>8} "
          f"{'precision':>10} {'recall':>8}")
    roc = []
    for q in (0, 1, 10, 20, 30, 40, 42):
        called = res.mapped & (res.mapq >= q)
        nc = int(called.sum())
        ncor = int((called & correct).sum())
        prec = ncor / max(nc, 1)
        rec = ncor / args.reads
        roc.append({"mapq": q, "called": nc, "precision": round(prec, 5),
                    "recall": round(rec, 5)})
        print(f"{q:>8} {nc:>8} {ncor:>8} {prec:>10.4f} {rec:>8.4f}")
    print(json.dumps({"metric": "accuracy_roc", "roc": roc,
                      "mapped_frac": round(float(res.mapped.mean()), 5)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
