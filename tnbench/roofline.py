"""The least time the card could take for a compiled scheme: the
benchmark's frozen copy of the port's floor.

Copied from ``artensor_tpu_torch/runtime/metrics.py``
(``scheme_roofline_seconds``, ``step_flops``, ``step_traffic_bytes``,
``plan_bytes``) and ``runtime/gatherk.py`` (``gk_bytes``, ``_used_rows``)
at commit 20f345e, with the constants they read (``kernels.H100_*``,
``planner/cost.MMA_K_STEP``; ``STEP_OVERHEAD_S`` was 0 and is left out),
so that a later change to the program's cost model does not move the
yardstick.  It reads the compiled steps' shapes and kernel plans and
nothing else of the program.

Each step costs max(flops / rate, bytes / 3.35 TB/s).  The rate is the
3xTF32 one (495 / 3 TFLOP/s), scaled by min(1, K / 8) for a product that
contracts K values.  A dot fallback step counts each lowered product's
operands read once and its result written once (twice that for a reorder
it carries); a kernel step counts the smaller of that and its kernel's own
bytes (a GK step reads X's rows once, not the gathered view).  Blind to
the host and to the copies around a product, so it lies below any
measured time.
"""

from functools import reduce
from operator import mul

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, HBM3
TF32_FLOP_PER_S = 495e12           # dense TF32 tensor cores
FLOAT32_RATE = TF32_FLOP_PER_S / 3.0   # 3xTF32: float32-accurate products
MMA_K_STEP = 8.0


def _prod(xs):
    return reduce(mul, xs, 1)


def _lows(s):
    return [s.lowered] if getattr(s, "lowered", None) is not None \
        else list(getattr(s, "lowered_chunks", ()) or ())


def step_flops(low):
    """Real flops of one lowered product (four real products a complex
    one)."""
    (cx, _cy), (bx, _by) = low.dnums
    b = _prod(low.shape_l[d] for d in bx)
    k = _prod(low.shape_l[d] for d in cx)
    m = _prod(low.shape_l) // max(b * k, 1)
    n = _prod(low.shape_r) // max(b * k, 1)
    return 2 * b * m * n * k * 4


def step_traffic_bytes(low):
    """Operands read and result written once, split complex float32, and
    the reorder pass a step carries (a gather counts twice a stream)."""
    total = (_prod(low.shape_l) + _prod(low.shape_r)
             + _prod(low.phys_y)) * 8.0
    if low.re_out is not None:
        extra = _prod(low.re_out.dims) * 8.0
        total += extra * (2 if getattr(low.re_out, "mode", "transpose")
                          == "transpose" else 4)
    return total


def _used_rows(p):
    return len(np.unique(p.gi)), len(np.unique(p.gj))


def plan_bytes(p):
    """Bytes a kernel plan's call moves for one slice instance."""
    kind = type(p).__name__
    if kind == "GKPlan":
        return 8 * (p.x_elems + p.H * p.K + p.y_elems)
    if kind == "GGKPlan":
        row = p.row
        nx, nw = _used_rows(p)
        if type(row).__name__ == "GKPlan":
            return 8 * (nx * row.x_elems + nw * row.H * row.K
                        + p.B * row.y_elems)
        return 8 * (nx * row.F * row.K + nw * row.H * row.K
                    + p.B * row.F * row.H)
    if kind == "LanePlan":
        return 8 * (p.x_elems + p.w_elems + p.y_elems)
    if kind == "PairPlan":
        return 8 * (p.K * p.M + p.K * p.N + p.M * p.N)
    raise TypeError(f"unknown kernel plan {kind}")


def _compute_s(low):
    (cx, _cy), _ = low.dnums
    k = _prod(low.shape_l[d] for d in cx)
    return step_flops(low) / (FLOAT32_RATE * min(1.0, k / MMA_K_STEP))


def scheme_roofline_seconds(steps):
    """The floor of one slice of the run steps ``steps``."""
    total = 0.0
    for s in steps:
        lows = _lows(s)
        if getattr(s, "lane", None) is not None:
            nbytes = min(sum(step_traffic_bytes(low) for low in lows),
                         plan_bytes(s.lane))
            total += max(sum(_compute_s(low) for low in lows),
                         nbytes / HBM_BYTES_PER_S)
            continue
        for low in lows:
            total += max(_compute_s(low),
                         step_traffic_bytes(low) / HBM_BYTES_PER_S)
    return total
