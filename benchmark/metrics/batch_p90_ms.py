"""Stream: ``utils/stream.py`` ``run_stream`` with ``cmd_map``'s stages.
The 90th percentile, over the window's batches that the profiler did
not overlap, of the time from the batch leaving the reader to its SAM
bytes being committed, in ms. The harness closes the loop at a few
batches between the reader and the formatted SAM, so above the host
output's capacity this reads about that many batch periods: it moves
with the period (1 / ``reads_per_s``) and with stalls that a rate
averages away."""

import statistics


def read(run):
    lat = [(m["t_commit"] - m["t_leave"]) * 1e3 for m in run["batches"]]
    return statistics.quantiles(lat, n=10)[8] if len(lat) >= 2 else None
