"""The port's disk radix spill build (index.build._RadixSpill) against its
in-RAM build and urmap_tpu's host build (exact).

The spill path runs here on genomes of 70 kbp by forcing a small
``spill_threshold`` (urmap_tpu's own spill tests: tests/unit/
test_index.py), with the native build kernels and with their numpy
twins (URMAP_NO_NATIVE_BUILD=1), at (k, slot_bits) (24, 14) and
(17, 11), in one chunk (the default) and in eleven (``chunk`` 7,000 words:
several appends to each bucket file, and words that straddle a chunk's
edge). The spill directory must be gone after the build, whether it
succeeded or raised; the command line's -make_ufi over the spill path
writes index directories byte-equal to urmap_tpu's.
"""

import filecmp
import os
import sys
import tempfile

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one torch thread)
from urmap_tpu import alphabet
from urmap_tpu import cli as jcli
from urmap_tpu.config import IndexConfig
from urmap_tpu.index import build as jbuild_mod
from urmap_tpu.io.fasta import SeqDB
from urmap_tpu_torch import cli as tcli
from urmap_tpu_torch.index import build as tbuild_mod


@pytest.fixture(scope="module")
def db():
    """Random sequence with a tandem repeat (slots past the cap) and an N
    run (words that do not index)."""
    rng = np.random.default_rng(17)
    seq = np.concatenate([
        rng.integers(0, 4, 50_000), np.tile([0, 1, 2, 3], 300),
        np.full(37, 4), rng.integers(0, 4, 10_000)]).astype(np.uint8)
    return SeqDB.from_seqs(["c1", "c2"], [
        seq, rng.integers(0, 4, 9_000).astype(np.uint8)])


def _assert_same(a, b):
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.positions, b.positions)
    assert a.offsets.dtype == b.offsets.dtype == np.uint32
    assert a.positions.dtype == b.positions.dtype == np.uint32


@pytest.mark.parametrize("chunk", [tbuild_mod.HOST_CHUNK, 7_000])
@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("k,slot_bits", [(24, 14), (17, 11)])
def test_spill_build_matches(db, tmp_path, monkeypatch, native, k,
                             slot_bits, chunk):
    if not native:
        monkeypatch.setenv("URMAP_NO_NATIVE_BUILD", "1")
    assert (tbuild_mod._native_lib() is not None) == native
    cfg = IndexConfig(k=k, slot_bits=slot_bits, max_positions_per_slot=8)
    finals, appends = [], []
    real = tbuild_mod._RadixSpill.finalize

    def spy(self, *a):
        finals.append(self.nbuck)
        return real(self, *a)

    monkeypatch.setattr(tbuild_mod._RadixSpill, "finalize", spy)
    for name in ("add", "add_partitioned"):
        def count(self, *a, real=getattr(tbuild_mod._RadixSpill, name)):
            appends.append(1)
            return real(self, *a)

        monkeypatch.setattr(tbuild_mod._RadixSpill, name, count)
    spill = tbuild_mod.build_index(db, cfg, spill_threshold=9_000,
                                   chunk=chunk, spill_dir=str(tmp_path),
                                   backend="host")
    assert finals == [1 << min(8, slot_bits)]      # the spill path ran
    n_words = db.total_len - k + 1
    assert len(appends) == -(-n_words // chunk)    # in as many chunks
    assert (len(appends) > 1) == (chunk < n_words)
    assert os.listdir(tmp_path) == []              # and left nothing
    inram = tbuild_mod.build_index(db, cfg, backend="host")
    assert len(finals) == 1                        # the in-RAM path
    _assert_same(spill, inram)
    ref = jbuild_mod.build_index(db, cfg, backend="host",
                                 spill_threshold=9_000,
                                 spill_dir=str(tmp_path))
    _assert_same(spill, ref)
    assert (np.diff(inram.offsets.astype(np.int64)) <= 8).all()


def test_host_chunk_is_the_references_host_chunk():
    """urmap_tpu's host backend extracts max(DEFAULT_CHUNK, 2^27) words a
    chunk; the port's default chunk is that size."""
    assert tbuild_mod.HOST_CHUNK == max(jbuild_mod.DEFAULT_CHUNK, 1 << 27)


@pytest.mark.parametrize("native", [True, False])
def test_spill_dir_removed_when_the_build_raises(db, tmp_path, monkeypatch,
                                                 native):
    if not native:
        monkeypatch.setenv("URMAP_NO_NATIVE_BUILD", "1")

    def boom(self, *a):
        assert os.listdir(self.dir)                # buckets were written
        raise RuntimeError("finalize failed")

    monkeypatch.setattr(tbuild_mod._RadixSpill, "finalize", boom)
    with pytest.raises(RuntimeError, match="finalize failed"):
        tbuild_mod.build_index(db, IndexConfig(k=24, slot_bits=14),
                               spill_threshold=9_000,
                               spill_dir=str(tmp_path), backend="host")
    assert os.listdir(tmp_path) == []


def test_make_ufi_over_the_spill_writes_equal_directories(db, tmp_path,
                                                          monkeypatch):
    """-make_ufi of both packages with the spill threshold lowered alike
    (build_index's keyword default) and the spill under a temporary
    directory of its own (tempfile's default, which neither CLI
    overrides)."""
    fa = str(tmp_path / "g.fa")
    with open(fa, "w") as f:
        for lab, s, n in zip(db.labels, db.starts, db.lengths):
            f.write(f">{lab}\n{alphabet.decode(db.codes[s : s + n])}\n")
    spill_root = tmp_path / "spill"
    spill_root.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(spill_root))
    calls = []
    for mod in (jbuild_mod, tbuild_mod):
        monkeypatch.setitem(mod.build_index.__kwdefaults__,
                            "spill_threshold", 9_000)
        real = mod._RadixSpill.finalize

        def spy(self, *a, real=real):
            calls.append(self.dir)
            return real(self, *a)

        monkeypatch.setattr(mod._RadixSpill, "finalize", spy)
    monkeypatch.setattr(sys, "argv", ["urmap"])
    for name, mod in (("j", jcli), ("t", tcli)):
        assert mod.main(["-make_ufi", fa, "-output",
                         str(tmp_path / f"{name}.ufi"),
                         "-slot_bits", "14"]) == 0
    assert len(calls) == 2
    assert all(os.path.dirname(c) == str(spill_root) for c in calls)
    assert os.listdir(spill_root) == []
    j, t = str(tmp_path / "j.ufi"), str(tmp_path / "t.ufi")
    files = sorted(os.path.relpath(os.path.join(b, n), j)
                   for b, _d, names in os.walk(j) for n in names)
    theirs = sorted(os.path.relpath(os.path.join(b, n), t)
                    for b, _d, names in os.walk(t) for n in names)
    assert files == theirs and len(files) > 3
    match, mismatch, errors = filecmp.cmpfiles(j, t, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
