"""The port's tools against the repository's, on the CPU.

urmap_tpu_torch/tools/{suspect_sweep, a2a_rounds, make_verify_corpus,
make_g38_corpus}.py are ports of the tools of the same name under
tools/. Each source is loaded from its file, as it runs from the
command line, and both run with the same arguments (the port's
suspect_sweep and a2a_rounds with ``--cpu``, a2a_rounds' one flag that
the source lacks): the suspect sweep prints the same table, a2a_rounds
the same last JSON line, and the two corpus tools write the same files
byte for byte. Then the port's rounds_for_batch against a step-level
simulation of the a2a loop, and the premise of the suspect sweep: the
gate re-applied on the host at the derived threshold gives the MAPQs of
a run with the gate on the device. Integers, text and bytes:
tolerance 0.
"""

import contextlib
import filecmp
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from urmap_tpu_torch.tools import a2a_rounds as ta2a
from urmap_tpu_torch.tools import make_g38_corpus as tg38
from urmap_tpu_torch.tools import make_verify_corpus as tverify
from urmap_tpu_torch.tools import suspect_sweep as tsweep

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SWEEP_ARGV = ["--cpu", "--genome-mbp", "0.3", "--reads", "1000",
              "--batch", "256"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test of this file runs
    (test_torch_repeats.py says why: parallel test workers oversubscribe
    the cores, and the port's many small CPU ops then stall)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _source(name):
    """tools/<name>.py loaded from its file, as a script would run it."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_reference", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = fn(*args)
    assert rc in (0, None)
    return out.getvalue().splitlines()


def _table(lines):
    """The sweep's output less its timing line."""
    return [ln for ln in lines if not ln.startswith("# mapped in")]


def test_suspect_sweep_matches_source():
    want = _table(_stdout(_source("suspect_sweep").main, SWEEP_ARGV))
    got = _table(_stdout(tsweep.main, SWEEP_ARGV))
    assert got == want
    assert got[0].startswith("# derived suspect_deficit")
    assert len(got) == 2 + 5


@pytest.mark.parametrize("slack", [None, "0.3"])
def test_a2a_rounds_matches_source(monkeypatch, slack):
    """The same last JSON line; with URMAP_A2A_SLACK=0.3 (both tools'
    adaptive slack reads it) the batches take several rounds, so the
    slot counts per shard are compared, not only a round each."""
    if slack is not None:
        monkeypatch.setenv("URMAP_A2A_SLACK", slack)
    argv = ["--genome-mbp", "0.3", "--shards", "4", "--batches", "2",
            "--batch", "512"]
    src = _source("a2a_rounds")
    monkeypatch.setattr(sys, "argv", ["a2a_rounds.py", *argv])
    want = json.loads(_stdout(src.main)[-1])
    got = json.loads(_stdout(ta2a.main, ["--cpu", *argv])[-1])
    assert got == want
    assert got["metric"] == "a2a_rounds"
    if slack is not None:
        assert got["adaptive"]["slack"] == 0.3
        assert got["adaptive"]["rounds_max"] > 1


def _same_tree(a, b):
    """Every file under a and b, byte for byte, and the same names."""
    names = []
    for d, _dirs, files in os.walk(a):
        names += [os.path.relpath(os.path.join(d, f), a) for f in files]
    theirs = [os.path.relpath(os.path.join(d, f), b)
              for d, _dirs, files in os.walk(b) for f in files]
    assert sorted(names) == sorted(theirs)
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    return sorted(names)


def test_verify_corpus_byte_equal(tmp_path, monkeypatch):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "source")
    monkeypatch.setattr(sys, "argv", ["make_verify_corpus.py", theirs])
    _stdout(_source("make_verify_corpus").main)
    _stdout(tverify.main, [ours])
    names = _same_tree(ours, theirs)
    for f in ("g.fa", "se.fq", "se_truth.tsv", "r1.fq", "r2.fq",
              "pe_truth.tsv", os.path.join("g.ufi", "header.json"),
              os.path.join("g.ufi", "positions.npy")):
        assert f in names


def test_g38_corpus_byte_equal(tmp_path, monkeypatch):
    from urmap_tpu_torch.index import build_index
    from urmap_tpu_torch.tools.synth import make_seqdb

    ufi = str(tmp_path / "g.ufi")
    build_index(make_seqdb(np.random.default_rng(3), [300_000]),
                backend="host").save(ufi)
    ours, theirs = tmp_path / "port", tmp_path / "source"
    ours.mkdir()
    theirs.mkdir()
    argv = ["--index-cache", ufi, "--reads", "2048", "--seed", "5"]
    monkeypatch.setattr(sys, "argv", ["make_g38_corpus.py", *argv,
                                      "--out-dir", str(theirs)])
    _stdout(_source("make_g38_corpus").main)
    _stdout(tg38.main, [*argv, "--out-dir", str(ours)])
    names = _same_tree(str(ours), str(theirs))
    assert names == ["g38_pe_truth.npy", "g38_r1.fq", "g38_r2.fq",
                     "g38_se.fq", "g38_se_truth.npy"]
    assert np.load(ours / "g38_pe_truth.npy").shape == (2, 1024)


def _simulate_loop(slots, valid, sps, S, rows_per_dev, K):
    """A step-level simulation of the a2a loop body (the simulation of
    tests/unit/test_sharded.py test_a2a_round_model): per device, per
    round, a stable sort of the unserved queries by destination and the
    first K of each destination served."""
    worst = 1
    m = slots.shape[0]
    for d0 in range(0, m, rows_per_dev):
        fslot = slots[d0 : d0 + rows_per_dev].reshape(-1)
        served = ~valid[d0 : d0 + rows_per_dev].reshape(-1)
        owner = np.clip(fslot.astype(np.int64) // sps, 0, S - 1)
        r = 0
        while not served.all():
            r += 1
            ow = np.where(served, S, owner)
            order = np.argsort(ow, kind="stable")
            so = ow[order]
            counts = np.bincount(so, minlength=S + 1)
            start = np.concatenate([[0], np.cumsum(counts)])[:-1]
            rank = np.arange(so.shape[0]) - start[so]
            served[order] |= (rank < K) & (so < S)
            assert r <= 1000
        worst = max(worst, max(r, 1))
    return worst


def test_rounds_for_batch_equals_loop_simulation(rng):
    S, sps = 4, 64
    for _trial in range(8):
        m, q = 32, 8
        slots = rng.integers(0, S * sps, size=(m, q)).astype(np.int64)
        if rng.random() < 0.7:             # most queries on shard 0
            mask = rng.random(slots.shape) < 0.8
            slots[mask] = rng.integers(0, sps, size=int(mask.sum()))
        valid = rng.random(slots.shape) < 0.9
        for K in (1, 3, 8, 50):
            for rows in (8, 16, 32):
                want = _simulate_loop(slots, valid, sps, S, rows, K)
                got = ta2a.rounds_for_batch(slots, valid, sps=sps,
                                            n_shards=S, rows_per_dev=rows,
                                            K=K)
                assert got == want, (K, rows, got, want)


@pytest.mark.parametrize("snp", ["0.01", "0.03"])
def test_sweep_premise_host_gate_equals_device_gate(snp):
    """The sweep maps with the device cap off and re-applies the gate on
    the host. At T = mismatch_equiv(6), the default suspect_deficit
    (config.resolve_suspect_deficits), that must give exactly the MAPQs
    of a Mapper with the default MapConfig's gate, on the same reads,
    and every other field unchanged. At 3% SNPs the gate caps reads."""
    import dataclasses

    from urmap_tpu_torch.config import resolve_suspect_deficits
    from urmap_tpu_torch.map import Mapper

    with contextlib.redirect_stdout(io.StringIO()):
        run = tsweep.sweep([*SWEEP_ARGV, "--snp-rate", snp])
    res, mcfg, sc = run["res"], run["mcfg"], run["sc"]
    gated_cfg = dataclasses.replace(mcfg, suspect_deficit=None)
    T, _remap = resolve_suspect_deficits(gated_cfg, sc)
    assert T == sc.mismatch_equiv(6)
    gated = Mapper(run["index"], gated_cfg, device="cpu").map_codes(
        run["codes"], run["lengths"])
    host = tsweep.reapply_gate(res, run["lengths"], T, sc, mcfg)
    np.testing.assert_array_equal(gated.mapq, host)
    for f in ("mapped", "pos", "strand", "score", "suspect", "clipped"):
        np.testing.assert_array_equal(getattr(gated, f), getattr(res, f),
                                      err_msg=f)
    if snp == "0.03":
        assert (host != res.mapq).sum() > 0
