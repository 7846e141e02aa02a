"""Device pipeline: ``Mapper.start_batch`` / ``PairedMapper.start_batch``
on the dispatch thread (every launch of a batch is queued here, and the
verify, DP and rescue rounds read their conditions back); the median
over the window's untraced batches, in ms."""

import statistics


def read(run):
    v = [m["dispatch_ms"] for m in run["batches"]]
    return statistics.median(v) if v else None
