"""device_idle_pct: the share of the profiled window in which no operation
ran on the device: 1 - the union of the device intervals of the
``torch.profiler`` trace over the window's host seconds (``trace.py``)."""


def read(run):
    tr = run.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
