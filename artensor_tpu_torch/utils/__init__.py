"""Numeric helpers shared by the planner and the runtime (host-side, pure
Python).  Port of the log-space sums of ``artensor_tpu/utils/__init__.py``."""

import math

LOG10_2 = math.log10(2.0)


def log2sumexp2(values):
    """log2(sum_i 2^{v_i}) computed stably; 0.0 for an empty list."""
    if not len(values):
        return 0.0
    m = max(values)
    return m + math.log2(sum(2.0 ** (v - m) for v in values))


def log10sumexp2(values):
    """log10(sum_i 2^{v_i}) computed stably; 0.0 for an empty list."""
    if not len(values):
        return 0.0
    m = max(values)
    return math.log10(sum(2.0 ** (v - m) for v in values)) + m * LOG10_2
