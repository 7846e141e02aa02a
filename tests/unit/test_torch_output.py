"""The batch's flat output (urmap_tpu_torch/map/output.py), packed and
split back on the CPU.

Each case builds a batch's device output by hand, calls and traceback
matrices of random integers, packs it with ``Layout.pack`` and splits
the packed arrays with ``Layout.result`` / ``Layout.pairs`` (and, for
two batches, ``join``). The calls must equal the inputs, and the B6 and
clip traceback dicts must hold exactly the inputs' live lanes, rows
re-based to the batch, each lane's record column intact. Integers:
tolerance 0.
"""

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from urmap_tpu_torch.config import MapConfig
from urmap_tpu_torch.map.output import Layout, join
from urmap_tpu_torch.map.pipeline import (CLIP_META_ROWS, TB_META_ROWS,
                                          clip_tb_cols, clip_tb_rows,
                                          tb_cols, tb_rows)
from urmap_tpu_torch.map.seed import POS_BIAS

MCFG = MapConfig(max_read_len=64)
ROWS = 256
FLAGS = ("mapped", "gapped", "dp_ran", "clipped", "suspect")


def _calls(g, n: int) -> dict:
    def i32(lo, hi):
        return torch.from_numpy(g.integers(lo, hi, n).astype(np.int32))

    out = {f: torch.from_numpy(g.random(n) < 0.5) for f in FLAGS}
    out.update(strand=i32(0, 2), pos=i32(-2**31, 2**31 - 1),
               score=i32(-2**15 + 1, 2**15), second=i32(-2**15 + 1, 2**15),
               ungapped=i32(-2**15 + 1, 2**15), mapq=i32(0, 256))
    return out


def _matrix(g, shape, nrows: int) -> torch.Tensor:
    """A traceback matrix: row 0 a distinct row below ``nrows`` per lane,
    row 1 the do / ok / strand bits, the other rows anything."""
    m = g.integers(-2**31, 2**31 - 1, shape).astype(np.int32)
    m[0] = g.choice(nrows, shape[1], replace=False)
    m[1] = g.integers(0, 8, shape[1]) << 16
    return torch.from_numpy(m)


def _records(mats, meta: int, rows: int, extra=()):
    """The live lanes (do and ok) of each shard's matrix, in order, with
    the shard's rows re-based: (fields, record columns)."""
    want = {k: [] for k in ("rows", "score", "pos", "strand", *extra)}
    cols = []
    for s, m in enumerate(mats):
        m = m.numpy()
        live = ((m[1] >> 16) & 3) == 3
        want["rows"].append(m[0][live] + s * rows)
        want["score"].append(m[2][live])
        want["pos"].append(m[3][live].astype(np.int64) + POS_BIAS)
        want["strand"].append((m[1] >> 18)[live] & 1)
        for i, k in enumerate(extra):
            want[k].append(m[4 + i][live])
        cols.append(m[meta:, live])
    return ({k: np.concatenate(v) for k, v in want.items()},
            np.concatenate(cols, axis=1))


def _same_records(got: dict, want: tuple, key: str) -> None:
    fields, cols = want
    for k, v in fields.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(got[key][:, got["cols"]], cols)


def _same_calls(res, outs: list, n: int) -> None:
    for f in ("mapped", "gapped", "clipped", "suspect", "strand", "score",
              "second", "ungapped", "mapq"):
        want = np.concatenate([o[f].numpy() for o in outs])[:n]
        np.testing.assert_array_equal(getattr(res, f), want, err_msg=f)
    want = np.concatenate([o["pos"].numpy() for o in outs])[:n]
    np.testing.assert_array_equal(res.pos, want.astype(np.int64) + POS_BIAS)


def _mate(tb: tuple, rows: int, second: bool) -> tuple:
    """A pair batch's records of one mate, its rows re-based."""
    fields, cols = tb
    r = fields["rows"] % (2 * rows)
    shard = fields["rows"] // (2 * rows)
    sel = (r >= rows) if second else (r < rows)
    got = {k: v[sel] for k, v in fields.items()}
    got["rows"] = (r - rows * second + shard * rows)[sel]
    return got, cols[:, sel]


@pytest.mark.parametrize("kind,shards,clip", [
    ("single", 1, None), ("single", 1, "ran"),
    ("single", 2, None), ("single", 2, "ran"), ("single", 2, "pad"),
    ("batches", 2, "ran"), ("pairs", 1, None), ("pairs", 2, None)])
def test_pack_then_split_gives_the_inputs(kind, shards, clip):
    g = np.random.default_rng([shards, len(kind), len(clip or "")])
    paired = kind == "pairs"
    rows = ROWS // shards if kind != "batches" else ROWS
    layout = Layout(MCFG, rows, paired=paired, tb=True,
                    pad_clip=clip == "pad")
    tb_shape = (tb_rows(MCFG), tb_cols(rows * (1 + paired), MCFG))
    clip_shape = (clip_tb_rows(MCFG), clip_tb_cols(rows, MCFG))
    outs, flat = [], []
    for s in range(shards):
        out = ({"m1": _calls(g, rows), "m2": _calls(g, rows),
                "proper": torch.from_numpy(g.random(rows) < 0.5)}
               if paired else _calls(g, rows))
        out["_tb"] = _matrix(g, tb_shape, rows * (1 + paired))
        # "pad": the clip pass ran on shard 0 only; the mesh pads shard 1
        if clip == "ran" or (clip == "pad" and s == 0):
            out["_clip_tb"] = _matrix(g, clip_shape, rows)
        outs.append(out)
        flat.append(layout.pack(out).numpy())
    tb = _records([o["_tb"] for o in outs], TB_META_ROWS,
                  rows * (1 + paired))
    clips = [o.get("_clip_tb", torch.zeros(clip_shape, dtype=torch.int32))
             for o in outs]
    ctb = _records(clips, CLIP_META_ROWS, rows, extra=("dp_score",))
    n = shards * rows - 3
    lengths = np.arange(n, dtype=np.int32)
    if kind == "batches":
        # two single-card batches, then joined
        res = join([layout.result(a[None], lengths[s * rows:][:rows], None)
                    for s, a in enumerate(flat)], lengths)
    elif paired:
        got = layout.pairs(np.stack(flat), lengths, lengths + 1, None)
        for m, key, second in ((got.m1, "m1", False), (got.m2, "m2", True)):
            _same_calls(m, [o[key] for o in outs], n)
            _same_records(m.tb, _mate(tb, rows, second), "dops")
            assert m.clip_tb is None
        np.testing.assert_array_equal(
            got.proper,
            np.concatenate([o["proper"].numpy() for o in outs])[:n])
        np.testing.assert_array_equal(got.m2.lengths, lengths + 1)
        return
    else:
        res = layout.result(np.stack(flat), lengths, None)
    _same_calls(res, outs, n)
    np.testing.assert_array_equal(res.lengths, lengths)
    _same_records(res.tb, tb, "dops")
    if clip is None:
        assert res.clip_tb is None
    else:
        _same_records(res.clip_tb, ctb, "recs")
