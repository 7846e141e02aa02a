"""The batch's device-to-host output: its one flat array, packed on the
device and split on the host.

A batch sends the host ONE int32 array, in one copy. A rank's array
holds, in order:

  calls  [rows, cols]   pipeline.pack_out's columns (PACKED_COLS); the
                        rows of a pair batch hold mate 1's, mate 2's,
                        then proper (2 * PACKED_COLS + 1 columns)
  tb     [tb_rows, tb_cols]   B6's records (pipeline.tb_pass_device),
                        where tb_enabled holds; a pair batch's lanes
                        cover both mates, rows [0, rows) mate 1 and
                        [rows, 2 * rows) mate 2
  clip   [clip_tb_rows, clip_tb_cols]   the clip traceback's records
                        (pipeline.clip_tb_pass_device): on one card in
                        the batches whose clip pass ran, on a mesh in
                        every batch, zeros where it did not run (the
                        all-gather takes one size from every rank)

The host holds the arrays of the ranks that own rows, [shards, n] (one
card: [1, n]); shard s holds the batch's rows [s * rows, (s + 1) *
rows). ``Layout`` packs a batch and splits it back into the calls and
the traceback dicts (views of the downloaded array where there is one
shard); ``join`` joins the results of consecutive batches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from urmap_tpu_torch.config import MapConfig
from urmap_tpu_torch.map.pipeline import (PACKED_COLS, MapResult,
                                          clip_tb_cols, clip_tb_past,
                                          clip_tb_rows, merge_clip_tb,
                                          merge_tb_batches, pack_out,
                                          tb_cols, tb_rows, unpack_clip_tb,
                                          unpack_out, unpack_tb)

# a MapResult's per-read fields
FIELDS = ("mapped", "pos", "strand", "score", "second", "mapq", "gapped",
          "ungapped", "clipped", "suspect")


def _join(merge, parts: list, row_offsets):
    """One part as it is, else ``merge``'s join of the parts."""
    return parts[0] if len(parts) == 1 else merge(parts, row_offsets)


def _mates(tb: dict, rows: int) -> tuple[dict, dict]:
    """A pair batch's B6 dict → mate 1's and mate 2's, each with its
    own rows (mate 2's re-based by ``rows``) and the whole matrix."""
    first = tb["rows"] < rows
    return tuple({**tb, **{k: tb[k][sel] for k in ("score", "pos",
                                                    "strand", "cols")},
                  "rows": tb["rows"][sel] - base}
                 for sel, base in ((first, 0), (~first, rows)))


@dataclass(frozen=True)
class Layout:
    """A rank's flat output: ``rows`` batch rows (pair rows where
    ``paired``), B6's matrix where ``tb``, and where ``pad_clip`` (a
    mesh under clip_tb_enabled) the clip matrix in every batch."""

    mcfg: MapConfig
    rows: int
    paired: bool = False
    tb: bool = False
    pad_clip: bool = False

    @property
    def cols(self) -> int:
        return 2 * PACKED_COLS + 1 if self.paired else PACKED_COLS

    def _clip_shape(self) -> tuple[int, int]:
        return clip_tb_rows(self.mcfg), clip_tb_cols(self.rows, self.mcfg)

    def pack(self, out: dict) -> torch.Tensor:
        """A batch's device output (map_batch_device's, or
        map_pairs_device's) → the flat int32 array."""
        if self.paired:
            calls = torch.cat([pack_out(out["m1"]), pack_out(out["m2"]),
                               out["proper"].to(torch.int32)[:, None]],
                              dim=1)
        else:
            calls = pack_out(out)
        mats = [out["_tb"]] if self.tb else []
        clip = out.get("_clip_tb")
        if clip is None and self.pad_clip:
            clip = torch.zeros(self._clip_shape(), dtype=torch.int32,
                               device=calls.device)
        if clip is not None:
            mats.append(clip)
        if not mats:
            return calls.reshape(-1)
        return torch.cat([m.reshape(-1) for m in (calls, *mats)])

    def _split(self, arr: np.ndarray, n: int):
        """[shards, size] → (the first n rows of calls, the per-shard tb
        dicts or None, the per-shard clip dicts or None; no dicts where
        n is 0)."""
        end = self.rows * self.cols
        calls = [a[:end].reshape(self.rows, self.cols) for a in arr]
        calls = (calls[0] if len(calls) == 1
                 else np.concatenate(calls))[:n]
        tbs = clips = None
        if n and self.tb:
            shape = (tb_rows(self.mcfg),
                     tb_cols(self.rows * (1 + self.paired), self.mcfg))
            tb_end = end + shape[0] * shape[1]
            tbs = [unpack_tb(a[end:tb_end].reshape(shape),
                             self.mcfg.band_halfwidth,
                             self.mcfg.max_read_len) for a in arr]
            end = tb_end
        if n and arr.shape[1] > end:
            clips = [unpack_clip_tb(a[end:].reshape(self._clip_shape()))
                     for a in arr]
        return calls, tbs, clips

    def result(self, arr: np.ndarray, lengths: np.ndarray,
               clip_open: int | None) -> MapResult:
        """The batch's first ``lengths.size`` rows, from the owners'
        arrays [shards, size]; the traceback dicts with the batch's row
        numbers (none where no row is kept)."""
        calls, tbs, clips = self._split(arr, lengths.size)
        res = MapResult.from_device(unpack_out(calls), lengths, clip_open)
        offs = range(0, len(arr) * self.rows, self.rows)
        if tbs:
            res.tb = _join(merge_tb_batches, tbs, offs)
        if clips:
            res.clip_tb = _join(merge_clip_tb, clips, offs)
            clip_tb_past(res, self.mcfg, self._clip_shape()[1], self.rows)
        return res

    def pairs(self, arr: np.ndarray, lengths1: np.ndarray,
              lengths2: np.ndarray, clip_open: int | None):
        """The PairResult of a pair batch's first ``lengths1.size``
        rows, as ``result``; both mates' tb dicts share the matrix."""
        from urmap_tpu_torch.map.pair import PairResult

        calls, tbs, _ = self._split(arr, lengths1.size)
        C = PACKED_COLS
        m1 = MapResult.from_device(unpack_out(calls[:, :C]), lengths1,
                                   clip_open)
        m2 = MapResult.from_device(unpack_out(calls[:, C : 2 * C]),
                                   lengths2, clip_open)
        if tbs:
            offs = range(0, len(arr) * self.rows, self.rows)
            halves = [_mates(t, self.rows) for t in tbs]
            m1.tb = _join(merge_tb_batches, [h[0] for h in halves], offs)
            m2.tb = _join(merge_tb_batches, [h[1] for h in halves], offs)
        return PairResult(m1=m1, m2=m2, proper=calls[:, 2 * C].astype(bool))


def join(results: list, lengths) -> MapResult:
    """The results of consecutive batches → one result over their
    rows, with the traceback dicts re-based (merge_tb_batches,
    merge_clip_tb: or every gapped winner pays the host DP again). One
    result comes back as it is."""
    if len(results) == 1:
        return results[0]
    n = sum(r.mapped.size for r in results)
    offs = np.cumsum([0] + [r.mapped.size for r in results[:-1]])
    res = MapResult(lengths=np.asarray(lengths)[:n],
                    clip_open=results[0].clip_open,
                    **{f: np.concatenate([getattr(r, f) for r in results])
                       for f in FIELDS})
    res.tb = merge_tb_batches([r.tb for r in results], offs)
    res.clip_tb = merge_clip_tb([r.clip_tb for r in results], offs)
    return res
