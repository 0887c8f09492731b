"""contraction_roofline: the floor of a batch (``roofline.py``, the
frozen copy of the port's floor, over the compiled scheme times the
slices) over the time of a batch in the profiled window (its host seconds
over its batches), in percent."""


def read(run):
    tr = run.trace
    if tr is None or not tr["batches"] or run.roofline_s <= 0:
        return None
    return 100.0 * run.roofline_s / (tr["window_s"] / tr["batches"])
