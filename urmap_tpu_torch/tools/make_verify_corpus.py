"""Make the port's end-to-end verify corpus.

The port of tools/make_verify_corpus.py. Synthesizes a 2 Mbp
3-chromosome genome, plants SE reads (exact / SNP / indel / revcomp /
junk) and proper pairs + rescue pairs, writes FASTA/FASTQ plus a truth
TSV, and builds the index directory with the port's command line
(``-make_ufi``, on the host: no card needed). Every file it writes is
byte-equal to the source's.

    python -m urmap_tpu_torch.tools.make_verify_corpus [outdir=/tmp/verify_e2e]

Then map it on the card:

    python -m urmap_tpu_torch -map DIR/se.fq -ufi DIR/g.ufi -samout se.sam
    python -m urmap_tpu_torch -map DIR/r1.fq -reverse DIR/r2.fq \\
        -ufi DIR/g.ufi -samout pe.sam

se_truth.tsv holds ``r<i>  global pos  strand`` (pos -1: a junk read);
pe_truth.tsv ``p<i>  R1 pos  R2 pos  rescue`` (rescue 1: R2 mutated
every 15th base, placed only by the mate-rescue scan).
"""

from __future__ import annotations

import os
import sys

import numpy as np


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else "/tmp/verify_e2e"
    os.makedirs(out, exist_ok=True)

    from urmap_tpu_torch import alphabet
    from urmap_tpu_torch.tools.synth import make_seqdb, plant_pair, plant_read

    rng = np.random.default_rng(11)
    db = make_seqdb(rng, [1_000_000, 600_000, 400_000])

    fa = os.path.join(out, "g.fa")
    with open(fa, "w") as f:
        for i in range(db.num_seqs):
            st, ln = int(db.starts[i]), int(db.lengths[i])
            s = alphabet.decode(db.codes[st : st + ln])
            f.write(f">{db.labels[i]}\n")
            for j in range(0, len(s), 70):
                f.write(s[j : j + 70] + "\n")

    # ---- SE reads ----
    n = 3000
    reads, truth = [], []
    for i in range(n):
        kind = i % 6
        if kind == 0:
            r = plant_read(rng, db, n_snps=0)
        elif kind == 1:
            r = plant_read(rng, db, n_snps=3)
        elif kind == 2:
            r = plant_read(rng, db, ins=2)
        elif kind == 3:
            r = plant_read(rng, db, dels=2)
        elif kind == 4:
            r = plant_read(rng, db, strand=1, n_snps=1)
        else:
            r = None  # junk
        if r is None:
            seq = alphabet.decode(
                rng.integers(0, 4, size=150).astype(np.uint8))
            reads.append(seq)
            truth.append((-1, -1))
        else:
            reads.append(r.seq)
            truth.append((r.gpos, r.strand))
    with open(os.path.join(out, "se.fq"), "w") as f, \
            open(os.path.join(out, "se_truth.tsv"), "w") as t:
        for i, (seq, (gpos, strand)) in enumerate(zip(reads, truth)):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
            t.write(f"r{i}\t{gpos}\t{strand}\n")

    # ---- PE reads ----
    npair = 1500
    with open(os.path.join(out, "r1.fq"), "w") as f1, \
            open(os.path.join(out, "r2.fq"), "w") as f2, \
            open(os.path.join(out, "pe_truth.tsv"), "w") as t:
        for i in range(npair):
            rescue = (i % 5 == 4)
            r1, r2, _ = plant_pair(rng, db,
                                   snp_every=15 if rescue else None)
            f1.write(f"@p{i}\n{r1.seq}\n+\n{'I' * len(r1.seq)}\n")
            f2.write(f"@p{i}\n{r2.seq}\n+\n{'I' * len(r2.seq)}\n")
            t.write(f"p{i}\t{r1.gpos}\t{r2.gpos}\t{int(rescue)}\n")

    # ---- index ----
    from urmap_tpu_torch.cli import main as cli_main

    ufi = os.path.join(out, "g.ufi")
    cli_main(["-make_ufi", fa, "-output", ufi])
    print(f"corpus written to {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
