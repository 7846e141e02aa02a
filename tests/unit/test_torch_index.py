"""urmap_tpu_torch index against urmap_tpu's (exact).

The port's host build and prepare_tables must give urmap_tpu's tables,
every array and meta, for the classic, aligned and row128 layouts; an
index and a prepared cache saved by urmap_tpu load in the port; and
tables_from_numpy carries urmap_tpu's prepared tables to the device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from urmap_tpu.config import IndexConfig
from urmap_tpu.index import store as jstore
from urmap_tpu.index.build import build_index as jbuild
from urmap_tpu_torch.index import build_index as tbuild
from urmap_tpu_torch.index import store as tstore
from tests.utils import make_seqdb


@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(5)
    d = make_seqdb(rng, [90_000, 40_000, 20_000])
    # a tandem repeat: its slots exceed the caps below, so the even
    # subsample (build cap, recapped) runs
    unit = d.codes[1000:1037].copy()
    d.codes[20_000:24_070] = np.tile(unit, 110)[:4070]
    return d


@pytest.mark.parametrize("native", [True, False])
def test_host_build_matches(db, monkeypatch, native):
    if not native:
        monkeypatch.setenv("URMAP_NO_NATIVE_BUILD", "1")
    for cfg in (IndexConfig(slot_bits=15, max_positions_per_slot=32), None):
        a = jbuild(db, cfg, backend="host")
        b = tbuild(db, cfg, backend="host")
        # each package has its own IndexConfig class: compare the fields
        assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.positions, b.positions)


def _assert_prepared_equal(a, b):
    ht_a, meta_a = a
    ht_b, meta_b = b
    assert meta_a == meta_b
    assert set(ht_a) == set(ht_b)
    for key, val in ht_a.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(val, ht_b[key], err_msg=key)
            assert val.dtype == ht_b[key].dtype, key
        else:
            assert val == ht_b[key], key


@pytest.mark.parametrize("case", ["classic", "aligned", "row128"])
def test_prepare_tables_matches(db, monkeypatch, case):
    slot_bits, p = {"classic": (15, 16), "aligned": (18, 16),
                    "row128": (15, 16)}[case]
    if case == "row128":
        monkeypatch.setenv("URMAP_ROW128_BYTES", "1")
    cfg = IndexConfig(slot_bits=slot_bits)
    a = jstore.prepare_tables(jbuild(db, cfg, backend="host"), p)
    b = tstore.prepare_tables(tbuild(db, cfg, backend="host"), p)
    assert a[1]["layout"] == case
    _assert_prepared_equal(a, b)


def test_load_index_and_prepared_saved_by_urmap_tpu(db, tmp_path):
    idx = jbuild(db, IndexConfig(slot_bits=16), backend="host")
    path = str(tmp_path / "g.ufi")
    idx.save(path)
    jstore.save_prepared(idx, path, 16)
    got = tstore.UfiIndex.load(path)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(idx.config)
    assert got.path == path
    np.testing.assert_array_equal(got.offsets, idx.offsets)
    np.testing.assert_array_equal(got.positions, idx.positions)
    np.testing.assert_array_equal(got.seqdb.codes, idx.seqdb.codes)
    want = jstore.load_prepared(jstore.UfiIndex.load(path), 16)
    _assert_prepared_equal(want, tstore.load_prepared(got, 16))
    # and the other way: the port's save loads in urmap_tpu
    path2 = str(tmp_path / "h.ufi")
    got.save(path2)
    back = jstore.UfiIndex.load(path2)
    np.testing.assert_array_equal(back.positions, idx.positions)


def test_tables_from_numpy(db, monkeypatch):
    cfg = IndexConfig(slot_bits=16)
    ht, meta = jstore.prepare_tables(jbuild(db, cfg, backend="host"), 16)
    dev = torch.device("cpu")
    tables = tstore.tables_from_numpy(ht, meta, dev)
    own = tstore.tables_to_device(
        tstore.prepare_tables(tbuild(db, cfg, backend="host"), 16)[0], dev)
    for key in ("offsets", "positions", "ginter"):
        assert tables[key].dtype == torch.int32
        assert torch.equal(tables[key], own[key]), key
    np.testing.assert_array_equal(tables["offsets"].numpy().view(np.uint32),
                                  ht["offsets"])
    assert tables["base_off"] == own["base_off"] == ht["base_off"]
    assert tables["genome_max_biased"] == int(ht["genome_max_biased"])
    assert tables["csr_aligned"] == meta["csr_aligned"]
    monkeypatch.setenv("URMAP_ROW128_BYTES", "1")
    ht128, meta128 = jstore.prepare_tables(jbuild(db, cfg, backend="host"),
                                           16)
    # the row128 layout comes up as dense [R, 128] tables with the
    # packed offsets in place of the plain ones
    assert not tables["row128"] and tables["off_bits"] is None
    t128 = tstore.tables_from_numpy(ht128, meta128, dev)
    assert t128["row128"] and t128["off_bits"] == tuple(meta128["off_bits"])
    assert t128["positions"].shape == (ht128["positions"].shape[0] // 128,
                                       128)
    assert t128["ginter"].dim() == 2 and t128["ginter"].shape[1] == 128
    np.testing.assert_array_equal(
        t128["offsets"].numpy().view(np.uint32), ht128["opacked"])
    np.testing.assert_array_equal(
        t128["obase"].numpy().view(np.uint32), ht128["obase"])
    monkeypatch.setenv("URMAP_NO_PACKED_OFFSETS", "1")
    plain = tstore.tables_from_numpy(ht128, meta128, dev)
    assert plain["off_bits"] is None and "obase" not in plain
    np.testing.assert_array_equal(
        plain["offsets"].numpy().view(np.uint32), ht128["offsets"])
