"""Host output: ``second_pass``, ``map/cigar.py`` ``cigars_nm_blob`` and
``io/sam_native.py``'s formatter, on a worker thread; the median over
the window's untraced batches, in ms."""

import statistics


def read(run):
    v = [m["format_ms"] for m in run["batches"]]
    return statistics.median(v) if v else None
