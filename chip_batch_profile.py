"""Device launches and device-busy time of one single-end batch and one
pair batch, for one or more checkouts of this repository in turns, on
one CUDA card: the numbers that compare two trees of the port.

    python3 chip_batch_profile.py --tree . --tree /path/to/parent ...

Each ``--tree`` runs in a process of its own that imports that tree's
``urmap_tpu_torch`` (so a parent checkout is measured with its own
code) and this script's helpers from ``chip_smoke.py`` beside it. The
process builds the smoke's world at a smaller read count (a synthetic
genome of GRCh38 chr21's length, its index, aligned and row128 tables,
16,384 planted reads and 8,192 planted pairs, all from ``--seed``),
maps one warm batch, then profiles ``--reps`` batches of each kind with
torch.profiler (chip_smoke.profile_call): the aligned single-end batch
(default MapConfig, batch 16,384, traceback on) and the pair batch
(PairedMapper on the row128 tables, 8,192 pairs). It prints one JSON
line per tree and batch: device launches, device busy ms, idle share,
the port's kernels' device ms, the card's name and power limit.
Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def one_tree(tree: str, seed: int, reps: int) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import importlib.util

    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import urmap_tpu_torch
    from urmap_tpu_torch.config import MapConfig
    from urmap_tpu_torch.index import build_index
    from urmap_tpu_torch.index.store import prepare_tables
    from urmap_tpu_torch.io.fasta import SeqDB
    from urmap_tpu_torch.map import Mapper
    from urmap_tpu_torch.map.pair import PairedMapper

    cs.check(os.path.dirname(urmap_tpu_torch.__file__)
             == os.path.join(tree, "urmap_tpu_torch"),
             f"urmap_tpu_torch came from {urmap_tpu_torch.__file__}")
    dev = torch.device("cuda")
    smi = cs.smi_line()
    work = os.path.join(HERE, "build", "chip_batch_profile")
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng([seed, 1])
    fa = os.path.join(work, "genome.fa")
    cs.write_fasta(fa, cs.make_genome(rng, cs.CHR21_LEN))
    db = SeqDB.from_fasta(fa)
    index = build_index(db, backend="host")
    p = MapConfig().positions_per_seed
    prepared = prepare_tables(index, p)
    os.environ["URMAP_ROW128_BYTES"] = "1"
    prepared128 = prepare_tables(index, p)
    del os.environ["URMAP_ROW128_BYTES"]
    codes, _truth, _strand = cs.plant_reads(rng, db, cs.B)
    c1, c2, _pt = cs.plant_pairs(rng, db, cs.B // 2)
    mcfg = MapConfig(batch_size=cs.B)
    mapper = Mapper(index, mcfg, device=dev, prepared=prepared)
    pm = PairedMapper(Mapper(index, mcfg, device=dev, prepared=prepared128))
    lens = np.full(len(codes), cs.READ_LEN, np.int32)
    pl = np.full(len(c1), cs.READ_LEN, np.int32)

    def single():
        pk = mapper.prepack(codes, lens)
        return lambda: mapper.finish_batch(
            mapper.start_batch(codes, lens, prepacked=pk), lens)

    def paired():
        pk = pm.prepack(c1, pl, c2, pl)
        return lambda: pm.finish_batch(
            pm.start_batch(c1, pl, c2, pl, prepacked=pk), pl, pl)

    for kind, make in (("single_end", single), ("paired", paired)):
        fn = make()
        fn()                                        # warm batch
        torch.cuda.synchronize()
        for r in range(reps):
            prof = cs.profile_call(fn, os.path.join(work, f"{kind}.txt"))
            print(json.dumps({
                "tree": tree, "batch": kind, "rep": r, "gpu": smi,
                **{k: prof[k] for k in ("device_launches", "device_busy_ms",
                                        "device_idle_share",
                                        "profiled_wall_ms",
                                        "port_kernels_device_ms")}}),
                flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout to measure (repeat; in this order)")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_batch_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if args.one is not None:
        one_tree(args.one, args.seed, args.reps)
        return 0
    for tree in args.tree or [HERE]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", os.path.abspath(tree),
                              "--seed", str(args.seed),
                              "--reps", str(args.reps)], cwd=HERE)
        if res.returncode != 0:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
