"""batch_p90_s: the 90th percentile of every batch of the window, each
timed on the host clock from the runner's call to its amplitudes on the
host (``statistics.quantiles``, exclusive method)."""

import statistics


def read(run):
    if len(run.times) < 2:
        return None
    return statistics.quantiles(run.times, n=10)[-1]
