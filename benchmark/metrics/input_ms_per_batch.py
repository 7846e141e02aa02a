"""Host input: ``io/fastq.py`` FastqReader's next batch and
``Mapper.prepack`` / ``PairedMapper.prepack``, on the prefetch thread;
the median over the window's untraced batches, in ms."""

import statistics


def read(run):
    v = [m["input_ms"] for m in run["batches"]]
    return statistics.median(v) if v else None
