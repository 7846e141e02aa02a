"""urmap_tpu_torch imports and maps without JAX and without urmap_tpu.

A subprocess makes ``import jax`` fail, imports every module of the
port and nothing else of this repository, builds the index on the host
and with the device backend on the CPU (equal tables), and maps 64
planted reads (half of them with an indel, so the device-traceback
records are replayed) on the CPU through the single-end SAM path with
the default MapConfig, then a pair batch over a row128 table, then the command line
(``cli.main`` -make_ufi and -map on the CPU, then -map on a sharded 1 x 1
mesh; ``cli``, ``__main__``, ``dist.multihost`` and ``dist.sharded``
imported by name), then the accuracy tool (``tools.accuracy.main`` with
``--cpu`` at a tiny size), then the other four tools imported by name
and their read synthesis (``tools.synth``: ``make_seqdb``,
``synth_reads``), then kernel B8's plain version
(``kernels.micro.plain_passes`` against numpy) and its tool
(``tools.bench_microvpu``) by name. Afterwards no module named
``urmap_tpu`` or ``urmap_tpu.*``, no ``jax*``, and no ``bench``, ``tests*`` or
``tools*`` of this repository may be loaded. The machine with the card
has no JAX.
"""

import os
import subprocess
import sys

import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from urmap_tpu_torch import require_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
sys.modules["jax"] = None                   # import jax now fails
import numpy as np
import urmap_tpu_torch
for m in pkgutil.walk_packages(urmap_tpu_torch.__path__, "urmap_tpu_torch."):
    importlib.import_module(m.name)
from urmap_tpu_torch import alphabet
from urmap_tpu_torch.config import MapConfig
from urmap_tpu_torch.io import sam_native
from urmap_tpu_torch.io.fasta import SeqDB
from urmap_tpu_torch.io.fastq import FastqReader
from urmap_tpu_torch.index import build_index
from urmap_tpu_torch.map import Mapper
from urmap_tpu_torch.map.cigar import cigars_nm_blob

rng = np.random.default_rng(0)
db = SeqDB.from_seqs(["chr1"], [alphabet.decode(
    rng.integers(0, 4, 60_000).astype(np.uint8))])
pos = rng.integers(int(db.starts[0]), int(db.starts[0]) + 59_000, 64)
codes = db.codes[pos[:, None] + np.arange(153)[None, :]].copy()
for i in range(0, 64, 4):                   # a 3-base deletion
    codes[i, 70:150] = codes[i, 73:153]
codes = codes[:, :150].copy()
codes[1::2] = alphabet.COMP_CODE[codes[1::2, ::-1]]
mapper = Mapper(build_index(db, backend="host"), MapConfig(batch_size=64),
                device="cpu")
assert mapper.tb
# the device build (extract, hash and sort in torch) in 4 chunks
dev_index = build_index(db, backend="device", device="cpu", chunk=16_000)
assert (dev_index.offsets == mapper.index.offsets).all()
assert (dev_index.positions == mapper.index.positions).all()
with tempfile.TemporaryDirectory() as d:
    fq = os.path.join(d, "r.fq")
    with open(fq, "w") as f:
        for i, c in enumerate(codes):
            f.write(f"@r{i}\n{alphabet.decode(c)}\n+\n{'I' * 150}\n")
    batch = next(iter(FastqReader(fq, batch_size=64)))
res = mapper.map_codes(batch.codes, batch.lengths)
assert res.mapped.all() and (res.pos == pos).all(), res.pos
assert (res.strand == np.arange(64) % 2).all()
assert res.gapped[::4].all() and res.tb["rows"].size == 16
blob, off, nm, _ = cigars_nm_blob(db.codes, batch.codes, res, mapper.sc)
sam = sam_native.format_single_end(batch, res, (blob, off), nm, db)
assert sam.count(b"\n") == 64 and sam.count(b"3D") == 16
assert sam_native.available()
# a pair batch over a row128 table: FR pairs 300 bases apart
os.environ["URMAP_ROW128_BYTES"] = "1"
from urmap_tpu_torch.map.pair import PairedMapper
m128 = Mapper(mapper.index, MapConfig(batch_size=64), device="cpu")
assert m128.row128 and m128.off_bits is not None
p1 = pos[:32]
c1 = db.codes[p1[:, None] + np.arange(150)[None, :]]
c2 = alphabet.COMP_CODE[db.codes[p1[:, None] + 150 + np.arange(150)[None, :]]
                        [:, ::-1]]
ln = np.full(32, 150, np.int32)
pres = PairedMapper(m128).map_pair_codes(c1, ln, c2, ln)
assert pres.proper.all() and (pres.m1.pos == p1).all()
assert (pres.m2.pos == p1 + 150).all() and (pres.m2.strand == 1).all()
# the command line: -make_ufi, then -map on the CPU
import urmap_tpu_torch.__main__, urmap_tpu_torch.dist.multihost
import urmap_tpu_torch.dist.sharded
from urmap_tpu_torch import cli
with tempfile.TemporaryDirectory() as d:
    fa, fq = os.path.join(d, "g.fa"), os.path.join(d, "r.fq")
    with open(fa, "w") as f:
        f.write(">chr1\n" + alphabet.decode(db.codes[db.starts[0]:]) + "\n")
    with open(fq, "w") as f:
        for i, c in enumerate(codes):
            f.write(f"@r{i}\n{alphabet.decode(c)}\n+\n{'I' * 150}\n")
    ufi, sam = os.path.join(d, "g.ufi"), os.path.join(d, "o.sam")
    assert cli.main(["-make_ufi", fa, "-output", ufi]) == 0
    assert cli.main(["-map", fq, "-ufi", ufi, "-samout", sam, "-batch", "64",
                     "-quiet"], device="cpu") == 0
    body = [ln for ln in open(sam) if not ln.startswith("@")]
    assert len(body) == 64 and sum("3D" in ln for ln in body) == 16
    # a sharded 1 x 1 mesh in a world of one process (gloo, in-process)
    sam1 = os.path.join(d, "m.sam")
    assert cli.main(["-map", fq, "-ufi", ufi, "-samout", sam1, "-batch",
                     "64", "-quiet", "-mesh", "1x1", "-route", "psum"],
                    device="cpu") == 0
    assert [ln for ln in open(sam1) if not ln.startswith("@")] == body
# the accuracy tool at a tiny size on the CPU: its table and JSON line
import contextlib, io, json
from urmap_tpu_torch.tools import accuracy
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert accuracy.main(["--cpu", "--genome-mbp", "0.05", "--reads", "64",
                          "--batch", "64", "--repeat-frac", "0.25"]) == 0
roc = json.loads(out.getvalue().splitlines()[-1])
assert roc["metric"] == "accuracy_roc" and len(roc["roc"]) == 7
assert roc["roc"][0]["called"] > 48, roc
# the other tools: their read synthesis (copies of bench.py's and
# tests/utils.py's functions) runs without either file
from urmap_tpu_torch.tools import (a2a_rounds, make_g38_corpus,
                                   make_verify_corpus, suspect_sweep, synth)
sdb = synth.make_seqdb(np.random.default_rng(2), [20_000, 10_000])
assert sdb.num_seqs == 2 and int(sdb.lengths.sum()) == 30_000
sc_, st_, ss_ = synth.synth_reads(np.random.default_rng(3), sdb, 32, 150,
                                  indel_frac=0.1)
assert sc_.shape == (32, 150) and sc_.max() <= 3
first = sdb.codes[st_[ss_ == 0, None] + np.arange(24)[None, :]]
assert (sc_[ss_ == 0, :24] == first).mean() > 0.9
assert callable(a2a_rounds.rounds_for_batch) and callable(suspect_sweep.sweep)
assert callable(make_g38_corpus.main) and callable(make_verify_corpus.main)
# kernel B8's plain version and its tool, by name
import torch
from urmap_tpu_torch.kernels import micro
from urmap_tpu_torch.tools import bench_microvpu
w = np.arange(12, dtype=np.uint32).reshape(3, 4) * np.uint32(0x9E3779B9)
h = w.copy()
for i in range(micro.PASSES):
    h *= np.uint32(0x9E3779B1 + 2 * i + 1)
    h ^= h >> np.uint32(15)
    h += np.uint32(0x85EBCA6B)
got = micro.plain_passes(torch.from_numpy(w.view(np.int32)))
assert (got.numpy().view(np.uint32) == h).all()
assert callable(bench_microvpu.run) and callable(bench_microvpu.main)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m in ("jax", "jaxlib", "urmap_tpu", "bench", "tests", "tools")
    or m.startswith(("jax.", "jaxlib.", "urmap_tpu.", "tests.", "tools."))))
assert not bad, bad
print("NOJAX-OK")
"""


def test_port_imports_and_maps_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NOJAX-OK" in out.stdout


def test_require_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: require_device('cuda') works")
    with pytest.raises(RuntimeError, match="cuda"):
        require_device("cuda")
    assert require_device("cpu") == torch.device("cpu")
