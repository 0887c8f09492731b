"""Cost model of a compiled scheme: flops, traffic, peak live bytes, and the
calibrated wall estimate that ranks schemes and picks the slice width.

Port of ``artensor_tpu/runtime/metrics.py``.  The device-neutral half keeps
the JAX logic and gives the JAX numbers on equal schemes: ``step_flops``,
``scheme_flops``, ``step_traffic_bytes``, ``slice_dynamic_ids``, the peak
timeline (``scheme_peak_live_bytes``, ``scheme_peak_bytes_at_width``),
``step_overhead_bytes`` and ``reorder_census``.  ``scheme_roofline_seconds``
(the floor ``bench`` divides by) is rebuilt on the H100's rates.

The time model is rebuilt for one H100 (``kernels.H100_*``).  A kernel
step is charged the bound of the design its CUDA kernel runs
(``plan_design_bound``: GK and GGK by ``gatherk.gk_form``, bytes for the
stream form and 3xTF32 for the mma form; bytes for RGRow, RGFlat and Lane;
3xTF32 for Pair), times a measured factor for its kernel family, plus the
copies the step makes around the kernel (GK's ``pre`` reorder, Pair's
input reorders and row gather: each read and written once).  A dot
fallback step is charged its ``torch.matmul`` products at the float32
rate against its bytes, and every step its gather / concat / select passes
(``step_overhead_bytes``).  A plan's ``est_s`` (a TPU roofline, kept by
the lane planner to rank its candidates) is never read here.

The factors come from ``data/calibration_h100.json``, fitted on the card
by ``scripts/fit_calibration_torch_port.py``; without the file they are
the identity.  ``segmented_wall_estimate`` charges the segmented executor
(``segmented.py``) the same per-slice device cost plus a measured replay
cost per CUDA graph (``SEGMENT_REPLAY_S``); ``ContractionReport`` and
``Timer`` carry ``TensorNetworkSimulation.contraction``'s report.
"""

import json
import math
import os
import time
from dataclasses import dataclass, field
from functools import reduce
from operator import mul

from .. import kernels
from ..planner.cost import HBM_BUDGET_BYTES, STEP_OVERHEAD_W1_S

CALIBRATION_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "calibration_h100.json")
FAMILIES = ("gk", "ggk", "rgrow", "rgflat", "lane", "pair")


def _prod(xs):
    return reduce(mul, xs, 1)


def _lows(s):
    return [s.lowered] if getattr(s, "lowered", None) is not None \
        else list(getattr(s, "lowered_chunks", ()) or ())


# -- flops, traffic, peak live bytes (device-neutral) ------------------------

def step_flops(low, complex_algo="naive"):
    """Real flops of one lowered step (split-complex matmul counting)."""
    (cx, _cy), (bx, _by) = low.dnums
    B = _prod(low.shape_l[d] for d in bx)
    K = _prod(low.shape_l[d] for d in cx)
    M = _prod(low.shape_l) // max(B * K, 1)
    N = _prod(low.shape_r) // max(B * K, 1)
    mults = 3 if complex_algo == "karatsuba" else 4
    return 2 * B * M * N * K * mults


def scheme_flops(steps, complex_algo="naive"):
    return sum(step_flops(low, complex_algo)
               for s in steps for low in _lows(s))


def step_traffic_bytes(low, bytes_per_elem=4.0, split_components=2):
    """Minimum device bytes of one lowered step (read operands + write
    result), plus the reorder pass when the step carries one (gathers cost
    ~2x a streaming pass)."""
    n_ops = _prod(low.shape_l) + _prod(low.shape_r) + _prod(low.phys_y)
    total = n_ops * bytes_per_elem * split_components
    if low.re_out is not None:
        extra = _prod(low.re_out.dims) * bytes_per_elem * split_components
        total += extra * (2 if getattr(low.re_out, "mode", "transpose")
                          == "transpose" else 4)
    return total


def scheme_roofline_seconds(steps, muladds_per_s=None, bytes_per_s=None,
                            complex_algo="naive"):
    """A per-slice floor of the card's time for the lowered scheme: each
    step costs max(flops / rate, bytes / 3.35 TB/s) plus
    ``planner.cost.STEP_OVERHEAD_S`` (0.0: the port charges no per-step
    floor; the fitted width-1 overhead is host time that graph replay
    removes).  ``muladds_per_s`` (the JAX name; real flops a second):
    default the 3xTF32 rate ``kernels.H100_TF32_FLOP_PER_S / 3``, scaled
    by min(1, K / ``MMA_K_STEP``) for a product contracting K values;
    ``bytes_per_s`` default ``kernels.H100_HBM_BYTES_PER_S``.

    A dot fallback step counts each lowered product's minimum traffic
    (``step_traffic_bytes``).  A kernel step (GK, GGK, RGRow, RGFlat, Lane,
    Pair) counts the smaller of that and its kernel's own bytes
    (``plan_bytes``, as ``plan_design_bound`` does): GK reads X's rows
    once, not the gathered view that its lowered product names, so the
    lowered traffic would put the floor above what the kernel moves.
    Blind to the host and to the copies around a product
    (``step_overhead_bytes``), so it stays below the measured wall: the
    ratio of the two is what ``python -m artensor_tpu_torch bench`` calls
    ``roofline_achieved``."""
    from ..planner.cost import MMA_K_STEP, STEP_OVERHEAD_S

    flops_rate = muladds_per_s or kernels.H100_TF32_FLOP_PER_S / 3.0
    byte_rate = bytes_per_s or kernels.H100_HBM_BYTES_PER_S

    def compute_s(low):
        (cx, _cy), _ = low.dnums
        k = _prod(low.shape_l[d] for d in cx)
        rate = flops_rate * min(1.0, k / MMA_K_STEP)
        return step_flops(low, complex_algo) / rate

    total = 0.0
    for s in steps:
        lows = _lows(s)
        if getattr(s, "lane", None) is not None:
            nbytes = min(sum(step_traffic_bytes(low) for low in lows),
                         plan_bytes(s.lane)[1])
            total += max(sum(compute_s(low) for low in lows),
                         nbytes / byte_rate) + STEP_OVERHEAD_S
            continue
        for low in lows:
            total += max(compute_s(low),
                         step_traffic_bytes(low) / byte_rate) \
                + STEP_OVERHEAD_S
    return total


def slice_dynamic_ids(steps, slicing_axes):
    """Buffer ids that vary by slice: seeded by the tensors the slice
    selection touches, propagated through the scheme (a step's output is
    dynamic when either operand is)."""
    dyn = {tid for spec in slicing_axes for (tid, *_rest) in spec}
    for s in steps:
        if s.i in dyn or s.j in dyn:
            dyn.add(s.i)
    return dyn


def dot_copy_elems(low, bl=False, br=False, width=1):
    """The permuted operand copies that ``ops/field._split_dot`` holds at
    once in ``apply_lowered``'s dot of ``low`` (``bl`` / ``br``: the left /
    right operand, after the swap, carries a width axis of ``width``), as
    ``(left, right)`` split-pair elements, per width instance for a
    batched operand.  An operand is copied unless its permutation into
    matrix form is the identity on its axes longer than 1 (a permuted view
    that the product takes as it is counts as a copy: an upper bound); the
    larger operand is copied a component at a time (half its elements),
    the smaller whole."""
    from .lowering import batched_dnums

    (ca, cb), (ba, bb) = batched_dnums(low, bl, br)[0]
    shp_l = ((width,) if bl else ()) + tuple(low.shape_l)
    shp_r = ((width,) if br else ()) + tuple(low.shape_r)

    def copied(shape, first, last):
        free = [d for d in range(len(shape)) if d not in first + last]
        perm = [d for d in (*first, *free, *last) if shape[d] > 1]
        return perm != sorted(perm)

    n_l, n_r = _prod(shp_l), _prod(shp_r)
    left_big = n_l >= n_r
    cp_l = copied(shp_l, tuple(ba), tuple(ca))
    cp_r = copied(shp_r, tuple(bb) + tuple(cb), ())
    el = (0.5 if left_big else 1.0) * _prod(low.shape_l) if cp_l else 0
    er = (1.0 if left_big else 0.5) * _prod(low.shape_r) if cp_r else 0
    return el, er


def _peak_timeline(steps, slicing_axes=None, bytes_per_elem=4.0,
                   split_components=2, dot_width=None):
    """(timeline, unit): per program point, the (dynamic, static) elements
    of the live set plus the step's transients (aligned-gather copies and
    chunk outputs, cross-merge pre-selection outputs, GK ``pre`` copies,
    the GGK W-side take and output copy), as the JAX model counts them.
    ``slicing_axes``: when given, slice-invariant buffers land in the
    static component (shared by every width instance); without it
    everything counts as dynamic.  ``dot_width``: when given, each step
    the dot fallback runs also holds its permuted operand copies
    (``dot_copy_elems`` at that width, the largest chunk's for a chunked
    step), which the JAX model leaves to XLA."""
    dyn = None if slicing_axes is None else \
        slice_dynamic_ids(steps, slicing_axes)
    is_dyn = (lambda tid: True) if dyn is None else (lambda tid: tid in dyn)
    unit = bytes_per_elem * split_components

    def in_sizes(low):
        return _prod(low.shape_l), _prod(low.shape_r)

    # first-use size of every buffer (live from the start)
    size = {}
    for s in steps:
        lows = _lows(s)
        if not lows:
            continue
        if getattr(s, "gathers", None) is not None:
            tot_i = sum(_prod(low.shape_l) for low in lows)
            tot_j = sum(_prod(low.shape_r) for low in lows)
            size.setdefault(s.i, tot_i)
            size.setdefault(s.j, tot_j)
        else:
            a, b = in_sizes(lows[0])
            swapped = getattr(lows[0], "swapped", False)
            size.setdefault(s.i, b if swapped else a)
            size.setdefault(s.j, a if swapped else b)
    live = dict(size)
    timeline = [(sum(v for t, v in size.items() if is_dyn(t)),
                 sum(v for t, v in size.items() if not is_dyn(t)))]
    for s in steps:
        lows = _lows(s)
        if not lows:
            continue
        out = sum(_prod(low.phys_y) for low in lows)
        out_dyn = is_dyn(s.i) or is_dyn(s.j)
        extra_d = extra_s = 0
        lane = getattr(s, "lane", None)
        if getattr(s, "gathers", None) is not None and lane is None:
            # gathered operand copies of the current chunk + every chunk
            # output held until the final concat
            gi = max(_prod(low.shape_l) for low in lows)
            gj = max(_prod(low.shape_r) for low in lows)
            swapped = getattr(lows[0], "swapped", False)
            di, dj = (is_dyn(s.j), is_dyn(s.i)) if swapped \
                else (is_dyn(s.i), is_dyn(s.j))
            extra_d += (gi if di else 0) + (gj if dj else 0)
            extra_s += (0 if di else gi) + (0 if dj else gj)
            if out_dyn:
                extra_d += out
            else:
                extra_s += out
        elif lane is not None and hasattr(lane, "bj_rows"):
            # GGK step, two program points: A the kernel (inputs + W-side
            # take (+ pre-reorder X copy) + output), B the output copy
            # after it, when both operands and the take are dead
            row = lane.row
            w_id = s.j if row.w_is_j else s.i
            x_id = s.i if row.w_is_j else s.j
            wk = lane.bj_rows * row.H * row.K
            if is_dyn(w_id):
                extra_d += wk
            else:
                extra_s += wk
            ld = sum(v for t, v in live.items() if is_dyn(t))
            ls = sum(v for t, v in live.items() if not is_dyn(t))
            dead_d = sum(live.get(t, 0) for t in {s.i, s.j} if is_dyn(t))
            dead_s = sum(live.get(t, 0) for t in {s.i, s.j}
                         if not is_dyn(t))
            if getattr(row, "pre_perm", None) is not None:
                pre = lane.bi_rows * _prod(row.view_x)
                src = live.get(x_id, 0)
                if is_dyn(x_id):
                    timeline.append((ld + pre, ls))
                    ld += pre - src
                    dead_d += pre - src
                else:
                    timeline.append((ld, ls + pre))
                    ls += pre - src
                    dead_s += pre - src
            timeline.append((ld + (out if out_dyn else 0) + extra_d,
                             ls + (0 if out_dyn else out) + extra_s))
            timeline.append((ld - dead_d + 2 * (out if out_dyn else 0),
                             ls - dead_s + 2 * (0 if out_dyn else out)))
            live[s.i] = out
            live[s.j] = 0
            continue
        elif lane is not None and getattr(lane, "pre", None) is not None:
            # GK step with a pre reorder: the permuted X copy
            x_id = s.i if getattr(lane, "w_is_j", True) else s.j
            pre_elems = _prod(lane.pre.dims)
            if is_dyn(x_id):
                extra_d += pre_elems
            else:
                extra_s += pre_elems
        elif getattr(s, "post_select", None) is not None:
            if out_dyn:           # pre-selection output + selected copy
                extra_d += out
            else:
                extra_s += out
        if dot_width is not None and lane is None:
            copies = []
            for low in lows:
                ids = (s.j, s.i) if low.swapped else (s.i, s.j)
                dl, dr = (is_dyn(t) for t in ids)
                el, er = dot_copy_elems(low, dot_width > 1 and dl,
                                        dot_width > 1 and dr, dot_width)
                copies.append(((el if dl else 0) + (er if dr else 0),
                               (0 if dl else el) + (0 if dr else er)))
            cd, cs = max(copies, key=lambda c: dot_width * c[0] + c[1])
            extra_d += cd
            extra_s += cs
        ld = sum(v for t, v in live.items() if is_dyn(t))
        ls = sum(v for t, v in live.items() if not is_dyn(t))
        timeline.append((ld + (out if out_dyn else 0) + extra_d,
                         ls + (0 if out_dyn else out) + extra_s))
        live[s.i] = out
        live[s.j] = 0
    return timeline, unit


def scheme_peak_live_bytes(steps, bytes_per_elem=4.0, split_components=2,
                           slicing_axes=None):
    """Per-slice peak live set in bytes (see ``_peak_timeline``)."""
    timeline, unit = _peak_timeline(steps, slicing_axes, bytes_per_elem,
                                    split_components)
    return max(d + st for d, st in timeline) * unit


def scheme_peak_bytes_at_width(steps, width, slicing_axes,
                               bytes_per_elem=4.0, split_components=2):
    """Total peak bytes when ``width`` slices run at once: dynamic live sets
    replicate per width instance, slice-invariant buffers are shared."""
    timeline, unit = _peak_timeline(steps, slicing_axes, bytes_per_elem,
                                    split_components)
    return max(width * d + st for d, st in timeline) * unit


def kernel_table_bytes(steps):
    """Device bytes of the GK plans' index tables (``gatherk._device_
    tables``: ``xoff``, ``yoff`` and ``koff`` as int64), uploaded by a
    run's first call and kept with the plans."""
    from .gatherk import GKPlan

    return sum(8 * (len(s.lane.xoff) + len(s.lane.yoff) + len(s.lane.koff))
               for s in steps if isinstance(getattr(s, "lane", None), GKPlan))


def scheme_device_peak_bytes(steps, width, slicing_axes,
                             bytes_per_elem=4.0, split_components=2):
    """The peak the port's runner allocates at ``width`` beyond its staged
    operands: the live-set model of ``scheme_peak_bytes_at_width`` with
    the dot fallback's operand copies at each of its steps (``_peak_
    timeline``'s ``dot_width``), plus the GK plans' device tables
    (``kernel_table_bytes``).  ``chip_smoke.py`` and
    ``tests/test_torch_cuda.py`` hold the card's measured peak to it plus
    the staged operands and ``planner/cost.PEAK_RESERVE_BYTES``."""
    timeline, unit = _peak_timeline(steps, slicing_axes, bytes_per_elem,
                                    split_components, dot_width=width)
    return max(width * d + st for d, st in timeline) * unit \
        + kernel_table_bytes(steps)


def step_overhead_bytes(s, lows):
    """Device bytes a step moves around its products: aligned gathers (the
    gathered copy written, then read again: 2 passes over each gathered
    operand per chunk), chunked merges' concat (2 passes over the output)
    and a cross merge's post-selection (the full output read, the kept
    rows written)."""
    unit = 4.0 * 2  # f32 split pair
    extra = 0.0
    if getattr(s, "gathers", None) is not None:
        for low in lows:
            extra += 2 * unit * (_prod(low.shape_l) + _prod(low.shape_r))
        if len(lows) > 1:
            extra += 2 * unit * sum(_prod(low.phys_y) for low in lows)
    if getattr(s, "post_select", None) is not None:
        y_pre = sum(_prod(low.phys_y) for low in lows)
        rows = s.reshape[0] if s.reshape else y_pre   # merged batch rows
        row_elems = y_pre // max(1, rows)
        extra += unit * (y_pre + len(s.post_select) * row_elems)
    return extra


def reorder_census(steps):
    census = {"none": 0, "transpose": 0, "gather": 0}
    for s in steps:
        for low in _lows(s):
            census[getattr(low.re_out, "mode", "transpose")
                   if low.re_out else "none"] += 1
    return census


# -- bounds of the card's kernels --------------------------------------------

def bounds(nbytes, flops, form):
    """The bounds of a call, in ms: FP32 FMA (``bound_ms``, and which of
    bytes and operations sets it), 3xTF32 on the tensor cores, and that of
    the design ``form`` runs (``design_bound_ms``: "stream" bytes, "mma"
    3xTF32, any other form FP32 FMA), at the card's peak rates
    (``kernels.H100_*``)."""
    t_bytes = nbytes / kernels.H100_HBM_BYTES_PER_S
    t_ops = flops / kernels.H100_FP32_FLOP_PER_S
    t_tc = 3 * flops / kernels.H100_TF32_FLOP_PER_S
    design = {"stream": t_bytes, "mma": max(t_bytes, t_tc)}.get(
        form, max(t_bytes, t_ops))
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_3xtf32_ms=1e3 * max(t_bytes, t_tc),
                design_bound_ms=1e3 * design)


def _copy_s(elems):
    """One read and one write of ``elems`` split-complex values."""
    return 2 * 8.0 * elems / kernels.H100_HBM_BYTES_PER_S


def plan_bytes(p):
    """``(family, bytes)`` of a kernel plan's call for one slice instance
    (both operands per instance): what its kernel must move, each operand
    read once and the output written once (a GK step reads X's rows once,
    not the gathered view; a gathered step reads only the rows its
    targets name)."""
    from .gatherk import GGKPlan, GKPlan, RGRow, _used_rows, gk_bytes
    from .lanes import LanePlan, PairPlan

    if isinstance(p, GKPlan) or (isinstance(p, GGKPlan) and isinstance(
            p.row, GKPlan)):
        return ("gk" if isinstance(p, GKPlan) else "ggk",
                gk_bytes(p, 1, True, True))
    if isinstance(p, GGKPlan):
        row = p.row
        nx, nw = _used_rows(p)
        return ("rgrow" if isinstance(row, RGRow) else "rgflat",
                8 * (nx * row.F * row.K + nw * row.H * row.K
                     + p.B * row.F * row.H))
    if isinstance(p, LanePlan):
        return "lane", 8 * (p.x_elems + p.w_elems + p.y_elems)
    if isinstance(p, PairPlan):
        return "pair", 8 * (p.K * p.M + p.K * p.N + p.M * p.N)
    raise TypeError(f"unknown kernel plan {type(p).__name__}")


def plan_design_bound(p):
    """``(family, kernel seconds, copy seconds)`` of a kernel plan for one
    slice instance (both operands per instance): the bound of the design
    its kernel runs, and the copies its step makes around it."""
    from .gatherk import gk_flops, gk_form

    fam, nbytes = plan_bytes(p)
    if fam in ("gk", "ggk"):
        form = gk_form(p, 1, True, True)
        b = bounds(nbytes, gk_flops(p, 1, True, True), form)
        copy = _copy_s(_prod(p.pre.dims)) if p.pre is not None else 0.0
        return fam, 1e-3 * b["design_bound_ms"], copy
    if fam == "pair":
        b = bounds(nbytes, p.flops, "mma")
        copy = sum(_copy_s(_prod(r.dims)) for r in (p.re_i, p.re_j)
                   if r is not None)
        if p.v_perm is not None:
            copy += _copy_s(p.K * p.N)
        return fam, 1e-3 * b["design_bound_ms"], copy
    return fam, nbytes / kernels.H100_HBM_BYTES_PER_S, 0.0


def plan_seconds(p, calibration=None):
    """A kernel plan's modeled seconds for one slice instance: its design
    bound times its family's factor, plus its copies."""
    fam, t, copy = plan_design_bound(p)
    return load_calibration(calibration)["family_factors"][fam] * t + copy


def dot_seconds(low):
    """A dot fallback product: its ``torch.matmul`` flops at the float32
    rate (no TF32) against its bytes at the memory rate."""
    return max(step_flops(low) / kernels.H100_FP32_FLOP_PER_S,
               step_traffic_bytes(low) / kernels.H100_HBM_BYTES_PER_S)


# -- calibration and the wall estimate ----------------------------------------

_CALIBRATION = {}


def load_calibration(path=None, refresh=False):
    """The fitted factors of the wall estimate (cached per path): from
    ``path``, default ``data/calibration_h100.json``; identity factors when
    the file is absent."""
    path = path or CALIBRATION_PATH
    if path in _CALIBRATION and not refresh:
        return _CALIBRATION[path]
    cal = {"kern_factor": 1.0, "dot_factor": 1.0, "byte_factor": 0.0,
           "step_overhead_w1_s": None,
           "family_factors": {f: 1.0 for f in FAMILIES}}
    if os.path.exists(path):
        with open(path) as f:
            got = json.load(f)
        fams = dict(cal["family_factors"], **got.get("family_factors", {}))
        cal.update({k: got[k] for k in cal if k in got})
        cal["family_factors"] = fams
    _CALIBRATION[path] = cal
    return cal


def scheme_wall_components(steps, calibration=None):
    """Decompose the per-slice model: ``(kern_s, dot_s, bytes_per_slice,
    n_steps)``.  ``kern_s`` sums each kernel step's design bound times its
    family's factor, plus the copies around the kernel; ``dot_s`` the dot
    fallback's products and every step's gather / concat / select passes
    (none around a GGK, RGRow or RGFlat kernel, which reads the rows in
    place); ``bytes_per_slice`` every step's minimum traffic plus those
    passes."""
    fam_f = load_calibration(calibration)["family_factors"]
    kern_s = dot_s = bytes_ps = 0.0
    n_steps = 0
    for s in steps:
        n_steps += 1
        lows = _lows(s)
        for low in lows:
            bytes_ps += step_traffic_bytes(low)
        ggk_fused = getattr(s, "gathers", None) is not None \
            and getattr(s, "lane", None) is not None
        over = 0.0 if ggk_fused else step_overhead_bytes(s, lows)
        bytes_ps += over
        dot_s += over / kernels.H100_HBM_BYTES_PER_S
        if getattr(s, "lane", None) is not None:
            fam, t, copy = plan_design_bound(s.lane)
            kern_s += fam_f[fam] * t + copy
            continue
        for low in lows:
            dot_s += dot_seconds(low)
    return kern_s, dot_s, bytes_ps, n_steps


def scheme_wall_estimate(steps, k_sliced, xla_traffic_factor=1.0,
                         hbm_budget_bytes=None, slicing_axes=None,
                         calibration=None, width=None):
    """Calibrated end-to-end wall estimate on the card: per-slice step
    costs plus the per-step host overhead amortized by the slice width:
    ``width``, or by default the widest whose at-width peak fits the
    budget.  ``xla_traffic_factor`` (the JAX name) scales the dot
    fallback's time.  Returns ``(seconds, width, peak_bytes)``."""
    budget = hbm_budget_bytes or HBM_BUDGET_BYTES
    cal = load_calibration(calibration)
    kern_s, dot_s, bytes_ps, n_steps = scheme_wall_components(
        steps, calibration)
    per_slice = (cal["kern_factor"] * kern_s
                 + cal["dot_factor"] * xla_traffic_factor * dot_s
                 + cal["byte_factor"] * bytes_ps
                 / kernels.H100_HBM_BYTES_PER_S)
    overhead_w1 = cal["step_overhead_w1_s"] or STEP_OVERHEAD_W1_S
    peak = scheme_peak_live_bytes(steps, slicing_axes=slicing_axes)
    n_slices = 2 ** k_sliced
    if width is None:
        width = 1
        while (width < min(256, n_slices)
               and scheme_peak_bytes_at_width(steps, width * 2,
                                              slicing_axes) <= budget):
            width *= 2
    total = n_slices * (per_slice + n_steps * overhead_w1 / width)
    return total, width, peak


def max_safe_slice_batch(steps, requested, hbm_budget_bytes=None,
                         slicing_axes=None):
    """Largest power-of-two slice width <= ``requested`` whose at-width
    peak live set fits the budget."""
    budget = hbm_budget_bytes or HBM_BUDGET_BYTES
    w = 1
    while (w < requested
           and scheme_peak_bytes_at_width(steps, w * 2, slicing_axes)
           <= budget):
        w *= 2
    return max(1, min(requested, w))


def choose_slice_width(steps, k_sliced, slicing_axes=None, cap=128,
                       hbm_budget_bytes=None):
    """The slice width the wall estimate picks (the widest whose at-width
    peak fits the budget), capped at ``cap``."""
    _, w_est, _ = scheme_wall_estimate(
        steps, k_sliced, slicing_axes=slicing_axes,
        hbm_budget_bytes=hbm_budget_bytes)
    return max(1, min(cap, w_est))


def dividing_slice_width(steps, k_sliced, slicing_axes=None, cap=128,
                         hbm_budget_bytes=None):
    """``choose_slice_width`` halved until it divides the ``2**k_sliced``
    slices (the sliced runner's rule), as the JAX package's ``bench.py``
    takes it.  ``steps``: the steps the device runs."""
    width = choose_slice_width(steps, k_sliced, slicing_axes, cap,
                               hbm_budget_bytes)
    while (2 ** k_sliced) % width:
        width //= 2
    return width


# What one segment's graph replay adds to a slice group: a one-kernel
# graph replayed back to back takes 10.3-13.8 us a replay (three
# measurements, ``chip_smoke.py`` "segmented" phase, "NVIDIA H100 80GB
# HBM3, 700.00 W"); the segmented run's replay wall at 16 steps a segment
# less one segment's, over the extra replays, is below that phase's
# resolution (30 us over 32 extra replays of the 1k default scheme at
# width 8).  It takes the place of the JAX package's per-segment dispatch
# of a TPU program.
SEGMENT_REPLAY_S = 12.6e-6


def segmented_wall_estimate(steps, n_slices, width, segment_steps=64,
                            replay_s=None):
    """Wall estimate of the SEGMENTED run on the card: the calibrated
    per-slice device cost (``scheme_wall_components``, the model of
    ``scheme_wall_estimate`` without its host term, which the graphs
    remove) plus one replay cost (``SEGMENT_REPLAY_S``) per segment per
    slice group.  ``steps``: the steps the executor walks (after the
    static folds).  Returns ``(total_seconds, per_slice_device_s,
    n_segments)``."""
    cal = load_calibration()
    kern_s, dot_s, bytes_ps, n_steps = scheme_wall_components(steps)
    per_slice = (cal["kern_factor"] * kern_s + cal["dot_factor"] * dot_s
                 + cal["byte_factor"] * bytes_ps
                 / kernels.H100_HBM_BYTES_PER_S)
    n_seg = math.ceil(n_steps / segment_steps)
    d = SEGMENT_REPLAY_S if replay_s is None else replay_s
    width = max(1, width)
    n_batches = math.ceil(n_slices / width)
    total = n_batches * (width * per_slice + n_seg * d)
    return total, per_slice, n_seg


@dataclass
class ContractionReport:
    """Filled by ``TensorNetworkSimulation.contraction(report=...)``."""

    predicted_flops: float = 0.0       # per full contraction (all slices)
    wall_s: float = 0.0
    compile_s: float = 0.0             # warm-up and CUDA-graph capture
    num_slices: int = 1
    num_steps: int = 0
    reorders: dict = field(default_factory=dict)
    tc: float = 0.0                    # planner log10 per-slice mul-adds
    sc: float = 0.0
    executor: str = ""                 # "graph", "eager", "segmented",
                                       # "rescaled" or "checkpointed"
    slice_batch: int = 1               # the width the run used

    @property
    def tflops(self):
        return self.predicted_flops / self.wall_s / 1e12 \
            if self.wall_s else 0.0

    def summary(self):
        return (f"{self.num_steps} steps x {self.num_slices} slices, "
                f"predicted {self.predicted_flops:.3e} flops, wall "
                f"{self.wall_s:.3f}s ({self.tflops:.2f} TFLOP/s), "
                f"capture {self.compile_s:.2f}s, {self.executor} at width "
                f"{self.slice_batch}, reorders {self.reorders}")


class Timer:
    """Wall seconds of a ``with`` block (``elapsed``)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
