"""The port's command line as several processes on the CPU (gloo).

CLI processes started with torchrun's environment set by hand, each
``cli.main(argv, device="cpu")``: ``-mesh 2x2`` over 4 ranks single-end
and paired (``-reverse``), whose merged SAM body equals the single-process
run's record for record (each rank writes the rows it owns, so the merge
orders them by rank, as urmap_tpu's does: compared sorted, as urmap_tpu's
own mesh CLI test compares them); data-parallel ``-map`` over 2 ranks
with ``-mesh auto``, which stays on one device a rank for this small
index, byte for byte; and ``-mesh 2x2`` in a world of one process, which
refuses and names torchrun.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests.integration.test_torch_sharded import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CLI = ("import sys; from urmap_tpu_torch import cli; "
       "sys.exit(cli.main(sys.argv[1:], device='cpu'))")


def run_cli(n: int, args: list, timeout: int = 600) -> list:
    """n CLI processes with torchrun's environment (none for n = 1) →
    their CompletedProcess-like (returncode, stderr) pairs."""
    port = str(free_port())
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        if n > 1:
            env.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                       MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CLI, *args], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    return [(p.returncode, err.decode()) for p in procs
            for _out, err in [p.communicate(timeout=timeout)]]


def body(path: str) -> list:
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@")]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tests.utils import make_seqdb, plant_pair, plant_read, write_fastq
    from urmap_tpu_torch import alphabet, cli

    d = tmp_path_factory.mktemp("mcli")
    rng = np.random.default_rng(43)
    db = make_seqdb(rng, [150_000, 60_000])
    fa = str(d / "g.fa")
    with open(fa, "w") as f:
        for lab, s, n in zip(db.labels, db.starts, db.lengths):
            f.write(f">{lab}\n{alphabet.decode(db.codes[s : s + n])}\n")
    reads = []
    for i in range(200):
        kind = i % 5
        if kind == 0:
            r = plant_read(rng, db, n_snps=2)
        elif kind == 1:
            r = plant_read(rng, db, dels=3)
        elif kind == 2:
            r = plant_read(rng, db, length=90, strand=0)
            r.codes = np.concatenate(
                [r.codes, rng.integers(0, 4, 60).astype(np.uint8)])
        elif kind == 3:
            r = plant_read(rng, db)
            r.codes = rng.integers(0, 4, 150).astype(np.uint8)
        else:
            r = plant_read(rng, db, ins=2)
        reads.append(r)
    write_fastq(str(d / "se.fq"), reads)
    pairs = [plant_pair(rng, db, length=120, frag=int(rng.integers(250, 500)),
                        snp_every=15 if i % 8 == 0 else None)
             for i in range(80)]
    write_fastq(str(d / "r1.fq"), [p[0] for p in pairs])
    write_fastq(str(d / "r2.fq"), [p[1] for p in pairs])
    assert cli.main(["-make_ufi", fa, "-output", str(d / "g.ufi")]) == 0
    return d


def _map(corpus, n, out, *extra, quiet=True):
    args = ["-map", str(corpus / "se.fq"), "-ufi", str(corpus / "g.ufi"),
            "-samout", str(corpus / out), "-batch", "32", *extra]
    if quiet:
        args.append("-quiet")
    if "-reverse" in extra:
        args[1] = str(corpus / "r1.fq")
    runs = run_cli(n, args)
    for rc, err in runs:
        assert rc == 0, err[-4000:]
    return runs


def test_mesh_2x2_single_end_and_paired(corpus):
    _map(corpus, 1, "one.sam")
    _map(corpus, 4, "m22.sam", "-mesh", "2x2")
    one, m22 = body(str(corpus / "one.sam")), body(str(corpus / "m22.sam"))
    assert len(one) == 200 and sorted(m22) == sorted(one)
    assert m22 != one                         # rank order, not read order
    rev = ("-reverse", str(corpus / "r2.fq"))
    _map(corpus, 1, "pe.sam", *rev)
    _map(corpus, 4, "pe22.sam", *rev, "-mesh", "2x2", "-route", "a2a")
    pe, pe22 = body(str(corpus / "pe.sam")), body(str(corpus / "pe22.sam"))
    assert len(pe) == 160 and sorted(pe22) == sorted(pe)
    assert not [p for p in os.listdir(corpus) if ".shard" in p]


def test_data_parallel_map_with_mesh_auto(corpus):
    """Two ranks map their own byte ranges; -mesh auto keeps each on one
    device (the tables are far below 0.6 of a device's memory); rank 0's
    merge gives the single-process body byte for byte."""
    if not os.path.exists(corpus / "one.sam"):
        _map(corpus, 1, "one.sam")
    runs = _map(corpus, 2, "dp.sam", "-mesh", "auto", quiet=False)
    assert all("-mesh auto: single device" in err for _rc, err in runs)
    assert all("backend gloo" in err for _rc, err in runs)
    assert body(str(corpus / "dp.sam")) == body(str(corpus / "one.sam"))


def test_mesh_in_a_world_of_one_refuses(corpus):
    [(rc, err)] = run_cli(1, ["-map", str(corpus / "se.fq"), "-ufi",
                              str(corpus / "g.ufi"), "-samout",
                              str(corpus / "no.sam"), "-mesh", "2x2"])
    assert rc != 0
    assert "torchrun --nproc-per-node 4" in err
    assert not os.path.exists(corpus / "no.sam")
