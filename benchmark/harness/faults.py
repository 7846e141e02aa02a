"""Faults planted under the timed path, for the readings the check's
limits are set from (readings.py) and for the tests that see the check
fail. Each is a context manager that patches the program in this
process and restores it on exit.

  ``eighth``      every 8th read of a batch left out (both mates of
                  every 8th pair): emitted unmapped, as the device
                  results reach the host;
  ``no_rescue``   the mate-rescue scan of map/pair.py finds nothing;
  ``shift``       every 8th ungapped read's POS one base on (the first
                  mate's of a pair), as the results reach the host.
"""

from __future__ import annotations

from contextlib import contextmanager


def _leave_out(res) -> None:
    rows = slice(None, None, 8)
    res.mapped[rows] = False
    res.mapq[rows] = 0


def _shift(res) -> None:
    rows = slice(None, None, 8)
    res.pos[rows] += ~res.gapped[rows]


@contextmanager
def _after_finish(se_fn, pair_fn):
    from urmap_tpu_torch.map import pipeline
    from urmap_tpu_torch.map.pair import PairedMapper

    se, pe = pipeline.Mapper.finish_batch, PairedMapper.finish_batch

    def finish_se(self, handle, lengths):
        res = se(self, handle, lengths)
        se_fn(res)
        return res

    def finish_pe(self, handle, l1, l2):
        res = pe(self, handle, l1, l2)
        pair_fn(res)
        return res

    pipeline.Mapper.finish_batch = finish_se
    PairedMapper.finish_batch = finish_pe
    try:
        yield
    finally:
        pipeline.Mapper.finish_batch = se
        PairedMapper.finish_batch = pe


def _eighth_pair(res) -> None:
    _leave_out(res.m1)
    _leave_out(res.m2)
    res.proper[::8] = False


@contextmanager
def _no_rescue():
    import torch

    from urmap_tpu_torch.map import pair

    scan = pair._rescue_scan

    def nothing(tables, anchor_pos, *args, **kwargs):
        none = torch.full_like(anchor_pos, pair.NEG)
        return {"pos": torch.zeros_like(anchor_pos), "score": none,
                "ungapped": none.clone()}

    pair._rescue_scan = nothing
    try:
        yield
    finally:
        pair._rescue_scan = scan


def planted(name: str):
    """The context manager of the fault ``name``."""
    if name == "eighth":
        return _after_finish(_leave_out, _eighth_pair)
    if name == "shift":
        return _after_finish(_shift, lambda res: _shift(res.m1))
    if name == "no_rescue":
        return _no_rescue()
    raise ValueError(f"no fault {name!r}")
