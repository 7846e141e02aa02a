"""Make GRCh38-scale command-line corpora from an index directory.

The port of tools/make_g38_corpus.py. Loads the SeqDB from an index
directory (``UfiIndex.load``: the tables stay on disk), plants
``--reads`` single-end reads (1% SNP + 8% indel, bench.py's headline
profile) and ``--reads``/2 FR pairs, and writes FASTQ plus
global-coordinate truth arrays that tools/check_sam_truth.py scores
(read names r<idx> / p<idx>; the pair truth array is [2, n] = R1/R2
leftmost coordinates). Same flags as the source, and the FASTQs and
``.npy`` arrays are byte-equal to its. It does no device work: no card
is needed or held.

    python -m urmap_tpu_torch.tools.make_g38_corpus --index-cache DIR
        [--reads 1048576] [--out-dir /tmp] [--prefix g38] [--seed 11]
        [--se-only | --pe-only]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index-cache", required=True)
    ap.add_argument("--reads", type=int, default=1_048_576)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--indel-frac", type=float, default=0.08)
    ap.add_argument("--out-dir", default="/tmp")
    ap.add_argument("--prefix", default="g38")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--se-only", action="store_true")
    ap.add_argument("--pe-only", action="store_true")
    args = ap.parse_args(argv)

    from urmap_tpu_torch.index import UfiIndex
    from urmap_tpu_torch.tools.synth import (synth_pairs, synth_reads,
                                             write_fastq)

    t0 = time.monotonic()
    # SeqDB only — mmap-loads instantly; tables stay on disk
    index = UfiIndex.load(args.index_cache)
    db = index.seqdb
    print(f"# SeqDB loaded in {time.monotonic() - t0:.0f}s "
          f"({db.total_len:,} bp)", flush=True)
    rng = np.random.default_rng(args.seed)
    od, px, L = args.out_dir, args.prefix, args.read_len

    if not args.pe_only:
        t0 = time.monotonic()
        codes, truth, _ = synth_reads(rng, db, args.reads, L,
                                      indel_frac=args.indel_frac)
        write_fastq(os.path.join(od, f"{px}_se.fq"), codes, L,
                    name_prefix=b"r")
        np.save(os.path.join(od, f"{px}_se_truth.npy"), truth)
        print(f"# SE: {args.reads:,} reads -> {px}_se.fq in "
              f"{time.monotonic() - t0:.0f}s", flush=True)

    if not args.se_only:
        t0 = time.monotonic()
        n_pairs = args.reads // 2
        r1, r2, t1, t2 = synth_pairs(rng, db, n_pairs, L,
                                     indel_frac=args.indel_frac)
        write_fastq(os.path.join(od, f"{px}_r1.fq"), r1, L, name_prefix=b"p")
        write_fastq(os.path.join(od, f"{px}_r2.fq"), r2, L, name_prefix=b"p")
        np.save(os.path.join(od, f"{px}_pe_truth.npy"), np.stack([t1, t2]))
        print(f"# PE: {n_pairs:,} pairs -> {px}_r1/r2.fq in "
              f"{time.monotonic() - t0:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
