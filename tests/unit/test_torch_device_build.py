"""The port's device index build against urmap_tpu's, on the CPU.

``urmap_tpu_torch.hashing.extract_words`` and
``index.build._chunk_sorted_slots`` on CPU tensors against their JAX
functions (jnp on the CPU), bit for bit, and
``build_index(backend="device", device="cpu")`` against urmap_tpu's
``build_index(backend="device")`` and the port's host build: offsets and
positions equal (exact), in one chunk and in several (words that
straddle a chunk's edge), in RAM and through the disk radix spill, over
N runs and over slots past the cap. Inputs come from numpy seeds.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from urmap_tpu import hashing as jhash
from urmap_tpu.config import IndexConfig as JCfg
from urmap_tpu.index import build as jbuild
from urmap_tpu.io.fasta import SeqDB as JSeqDB
from urmap_tpu_torch import hashing as thash
from urmap_tpu_torch.config import IndexConfig
from urmap_tpu_torch.index import build as tbuild
from urmap_tpu_torch.io.fasta import SeqDB


def _genome(seed: int, n: int) -> np.ndarray:
    """Random bases with N runs (code 4) of 1 to 40 bases."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    for s in rng.integers(0, n - 40, n // 2_000):
        codes[s : s + int(rng.integers(1, 41))] = 4
    return codes


@pytest.mark.parametrize("k", [1, 12, 13, 16, 17, 24, 32])
def test_extract_words_matches_jax(k):
    codes = _genome(k, 3_001)
    want = [np.asarray(x) for x in jhash.extract_words(jnp.asarray(codes), k)]
    got = thash.extract_words(torch.from_numpy(codes), k)
    assert all(x.dtype == torch.int32 for x in got[:2])
    assert got[2].dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), want[0])
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert 0 < want[2].sum() < len(want[2]) - 4


def test_extract_words_refuses_what_jax_refuses():
    codes = torch.zeros(10, dtype=torch.uint8)
    for k in (0, 33):
        with pytest.raises(ValueError, match="k must be"):
            thash.extract_words(codes, k)
    with pytest.raises(ValueError, match="shorter than k"):
        thash.extract_words(codes, 11)


@pytest.mark.parametrize("base_pos", [0, 3_000_000_000])
@pytest.mark.parametrize("slot_bits", [10, 31])
def test_chunk_sorted_slots_matches_jax(slot_bits, base_pos):
    k = 24
    codes = _genome(slot_bits, 20_000)
    sl, po = jbuild._chunk_sorted_slots(jnp.asarray(codes),
                                        np.uint32(base_pos), k, slot_bits)
    sl, po = np.asarray(sl), np.asarray(po)
    n = np.searchsorted(sl, np.uint32(1 << slot_bits))
    got = tbuild._chunk_sorted_slots(torch.from_numpy(codes), base_pos, k,
                                     slot_bits)
    assert got[0].dtype == got[1].dtype == np.uint32
    np.testing.assert_array_equal(got[0], sl[:n])
    np.testing.assert_array_equal(got[1], po[:n])
    assert 0 < n < len(codes) - k + 1
    assert int(got[1].min()) >= base_pos
    if slot_bits == 31:      # slots at and past 2^30 sort where they belong
        assert (got[0] >= 1 << 30).any()


def _seqs(case: str):
    """(chromosome code arrays, IndexConfig fields) of a build case."""
    rng = np.random.default_rng(len(case))
    if case == "n_runs":
        return [_genome(3, 40_000), _genome(4, 9_000)], {}
    if case == "cap":                     # a tandem repeat past the cap
        return [np.concatenate([
            rng.integers(0, 4, 20_000), np.tile([0, 1, 2, 3, 1], 400),
            rng.integers(0, 4, 9_000)]).astype(np.uint8)], {
                "max_positions_per_slot": 8}
    return [rng.integers(0, 4, 30_000).astype(np.uint8),
            rng.integers(0, 4, 8_000).astype(np.uint8)], {}


# case → (genome, build keywords): one chunk; 7,001-word chunks (six);
# the spill (threshold 9,000 words) in 5,000-word chunks (eight)
CASES = {"one_chunk": ("plain", {}),
         "chunks": ("plain", {"chunk": 7_001}),
         "spill": ("plain", {"chunk": 5_000, "spill_threshold": 9_000}),
         "n_runs": ("n_runs", {"chunk": 7_001}),
         "cap": ("cap", {"chunk": 7_001}),
         "cap_spill": ("cap", {"chunk": 5_000, "spill_threshold": 9_000})}


@pytest.mark.parametrize("case", list(CASES))
def test_device_build_matches_jax_and_host(case, tmp_path, monkeypatch):
    genome, kw = CASES[case]
    seqs, fields = _seqs(genome)
    names = [f"c{i}" for i in range(len(seqs))]
    fields = {"k": 24, "slot_bits": 14, **fields}
    spill = {}
    if "spill_threshold" in kw:
        spill = {"spill_dir": str(tmp_path)}
    want = jbuild.build_index(JSeqDB.from_seqs(names, seqs), JCfg(**fields),
                              backend="device", **kw, **spill)
    db = SeqDB.from_seqs(names, seqs)
    adds = []
    real_add = tbuild._RadixSpill.add

    def counted(self, sl, po, sorted_by_slot=False):
        adds.append(sorted_by_slot)
        return real_add(self, sl, po, sorted_by_slot)

    monkeypatch.setattr(tbuild._RadixSpill, "add", counted)
    got = tbuild.build_index(db, IndexConfig(**fields), backend="device",
                             device="cpu", **kw, **spill)
    monkeypatch.undo()
    host = tbuild.build_index(db, IndexConfig(**fields), backend="host")
    for other in (want, host):
        np.testing.assert_array_equal(got.offsets, other.offsets)
        np.testing.assert_array_equal(got.positions, other.positions)
    assert got.offsets.dtype == got.positions.dtype == np.uint32
    assert os.listdir(tmp_path) == []
    n_words = len(db.codes) - fields["k"] + 1
    if spill:
        assert adds == [True] * -(-n_words // kw["chunk"]) and len(adds) > 4
    else:
        assert adds == []
    if genome == "cap":   # the repeat's ~400 copies a word, cut to 8
        assert np.diff(got.offsets.astype(np.int64)).max() == 8
        assert got.num_positions < n_words - 1_000


def test_device_build_defaults_and_refusals(monkeypatch):
    seqs, _ = _seqs("plain")
    db = SeqDB.from_seqs(["c0", "c1"], seqs)
    assert tbuild.build_index.__kwdefaults__["backend"] == "device"
    assert tbuild.DEFAULT_CHUNK == jbuild.DEFAULT_CHUNK
    chunks = []
    real = tbuild._chunk_sorted_slots

    def seen(codes, base_pos, k, slot_bits):
        chunks.append((codes.device.type, base_pos, codes.shape[0]))
        return real(codes, base_pos, k, slot_bits)

    monkeypatch.setattr(tbuild, "_chunk_sorted_slots", seen)
    tbuild.build_index(db, backend="device", device="cpu")
    assert chunks == [("cpu", 0, len(db.codes))]  # DEFAULT_CHUNK: one
    tbuild.build_index(db, backend="host")         # host: no device chunk
    assert len(chunks) == 1
    with pytest.raises(ValueError, match="backend"):
        tbuild.build_index(db, backend="xla")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the device build runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        tbuild.build_index(db, backend="device")
    with pytest.raises(RuntimeError, match="cuda"):
        tbuild.build_index(db)                     # the default: the card
    assert len(chunks) == 1
