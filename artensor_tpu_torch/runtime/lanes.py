"""Lane steps and pair steps: their planners, the lane scheduler, the
wrappers of the lane and pair CUDA kernels and their plain PyTorch
versions.

Port of ``artensor_tpu/runtime/lanes.py``.  A lane step contracts a big
operand X with a small one W (at most ``SMALL_W_ELEMS`` elements) whose
contract legs sit in a run at one END of X's storage: the leading legs
(``head``) or the trailing ones (``tail``).  X is viewed as (grid legs
``g``, looped row-contract legs ``c``, the lane run ``L``, the protected
free run ``f``), and for every combo c the step computes

    head  Y[g, h, f] += Wp[c, h, l] . X[g, c, l, f]
    tail  Y[g, f, h] += X[g, c, f, l] . Wp[c, l, h]

where ``Wp = W_flat[wp_idx] * wp_sign`` is the block-diagonal "lane
matrix": it contracts the lane-resident contract legs and carries the
lane-resident free legs through unchanged (H = lane-free x fresh legs).

``plan_lane_step`` and ``schedule_step`` keep the JAX planners' step-form
logic and reject strings, so the port's scheme equals the JAX scheme step
for step.  They also keep the JAX selection rules that were fitted to the
TPU; none of them is a limit of the CUDA kernel:

* ``est_s`` — the roofline estimate from v5e rates (``MXU_FLOPS_PER_S``,
  ``HBM_BYTES_PER_S``) with the MXU's 128-padding — ranks the candidate
  splits and orientations;
* the gates ``roofline`` (``ROOFLINE_SLACK``), ``vmem``
  (``VMEM_WINDOW_BUDGET``, ``_padded_elems``), ``tile-div``,
  ``g-in-tile``/``g-in-tile-y``, ``block-small`` and the caps ``LANE_CAP``,
  ``H_CAP``, ``COMBO_CAP``, ``WP_ELEMS_CAP`` decide which steps plan.

Three rules differ from the JAX package.  The orientations are an argument
of ``schedule_step`` instead of the ``ORIENTATIONS`` module global that the
JAX retail scheduler swaps.  ``schedule_step`` takes its gather-K candidate
whenever ``plan_gk_step`` plans it (the port's GK plans carry no time
estimate; JAX kept GK unless a lane plan was estimated 1.25x faster), and
its pair candidate is the port's ``plan_pair_step``.  ``prune_lane_plans``
ranks kernel plans by ``flops`` where JAX ranked them by ``est_s``.  The
census tests hold the resulting schemes equal to JAX's on the committed
n30 plans.

The lane kernel (``csrc/lane.cu``) does not build Wp.  The plan turns
``wp_idx`` / ``wp_sign`` into an address table over the nonzero entries
only: for output h, its ``T`` terms as a lane row ``xd[t, h]`` (a combo and
a lane value, at X offset ``doff[d]``) and a W index ``wi[t, h]``, so the
kernel computes ``Y[g, h, f] = sum_t X[xoff[g] + doff[xd[t, h]] + f*x_fs]
. W[wi[t, h]]`` in both orientations.  The Wp product does ``L / T`` times
that work (16x on the n30 sc25 path's step).  ``lane_plain`` is the JAX
form: Wp by gather x mask, one product per combo.

A pair step contracts two big operands whose contract legs can be brought
to the front of both: ``(K, M)^T . (K, N) -> (M, N)``.  The planner keeps
the JAX step-form logic (grouped output rows, ``re_i`` / ``re_j`` input
reorders to the (contract, rows) form, the ``v_perm`` row gather when only
j's contract-digit order differs) and drops the TPU limits: the 256-tile
and ``PAIR_K_CAP`` shape rules (the CUDA kernel masks ragged tiles and
walks any K) and the MXU roofline gate (every step that passes the
step-form checks runs the kernel).

Every kernel wrapper (``lane_call``, ``pair_call``) takes its plain
PyTorch version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.  ``launches`` on each wrapper counts kernel launches
(none while a CUDA graph is captured: ``kernels.launch``).
"""

from dataclasses import dataclass, field as dc_field, replace
from functools import reduce
from operator import mul

import numpy as np
import torch

from .. import kernels
from ..ops import permute
from .lowering import (apply_reorder, physical_shape, plan_reorder,
                       preferred_output_order)

LANE_CAP = 256        # max lane-leg product of the big operand
H_CAP = 1024          # max output lane product (lane-free x fresh)
COMBO_CAP = 16        # max row-contract index combinations
WP_ELEMS_CAP = 1 << 19   # max elements of the lane matrix
MIN_X_ELEMS = 1 << 16    # below this the dot fallback's cost is irrelevant
SMALL_W_ELEMS = 1 << 13  # "small operand" bound
BLOCK_ELEMS = 1 << 18    # target X-block elements per TPU kernel program
F_MIN = 1 << 10          # min elements of the protected free run before a
                         # consumer-contract leg is hoisted out of it
# TPU-fitted ranking and gates (JAX values; one v5e core): the float32
# HIGHEST MXU rate, the lane kernel's streaming rate, the slack of the
# roofline gate, and the VMEM budget of its block windows
MXU_FLOPS_PER_S = 28.6e12
HBM_BYTES_PER_S = 450e9
ROOFLINE_SLACK = 2.5
VMEM_WINDOW_BUDGET = 64 * 1024 * 1024
LANE_STEPS_CAP = 160  # max kernel plans per scheme (prune_lane_plans)

RETAIL = ("head", "tail")   # orientations of the retail second chance

LAST_REJECT = None


def _prod(xs):
    return reduce(mul, xs, 1)


def _rej(msg):
    """Record why the most recent planner call rejected (diagnostics)."""
    global LAST_REJECT
    LAST_REJECT = msg
    return None


def _strides(dims):
    out, s = [], 1
    for d in reversed(dims):
        out.append(s)
        s *= int(d)
    return out[::-1]


def _digits(idx_arr, dims):
    """Mixed-radix digits of ``idx_arr`` over ``dims`` (row-major)."""
    out = []
    rem = idx_arr
    for d in reversed(dims):
        out.append(rem % d)
        rem = rem // d
    out.reverse()
    return out


def kernel_precision(field):
    """The field's precision as the kernels take it, clamped as the JAX
    kernels clamp theirs (``lanes.py:86-96``): 'default' and 'highest'
    pass through, anything else (a 'high' field) gives None, and the
    kernels keep full precision.  On the H100 'default' selects the
    one-pass TF32 form of the tensor-core kernels
    (``kernels.tc_passes``); the FMA kernels keep float32 at every
    precision."""
    precision = getattr(field, "precision", None)
    if precision is None or precision.name not in ("default", "highest"):
        return None
    return precision


def _lane_splits(legs, dim_of):
    """Candidate lane sizes: (count, L) per run with product <= LANE_CAP."""
    out = []
    L = 1
    for k, l in enumerate(legs):
        L *= dim_of[l]
        if L > LANE_CAP:
            break
        out.append((k + 1, L))
    return out


def _split_big_small(ix_i, ix_j, dims_i, dims_j):
    if _prod(dims_i) >= _prod(dims_j):
        return True, ix_i, dims_i, ix_j, dims_j
    return False, ix_j, dims_j, ix_i, dims_i


def fallback_output_order(ix_i, ix_j, iy_set, dims_i, dims_j,
                          consumer_contract=(), pinned=()):
    """Output order of a step that runs the dot fallback: pinned legs,
    then the consumer's contract legs, then the rest, each in the dot's
    natural order."""
    base = preferred_output_order(ix_i, ix_j, iy_set, dims_i, dims_j)
    cset = set(consumer_contract)
    pset = set(pinned)
    return tuple(list(pinned)
                 + [l for l in base if l in cset and l not in pset]
                 + [l for l in base if l not in cset and l not in pset])


def _padded_elems(dims):
    """Elements a TPU VMEM window occupies: minor dim padded to the
    128-lane tile, second-minor to the 8-sublane tile."""
    dims = [int(d) for d in dims if d]
    if not dims:
        return 1
    p = 1
    for d in dims[:-2]:
        p *= d
    if len(dims) >= 2:
        p *= -(-dims[-2] // 8) * 8
    return p * (-(-dims[-1] // 128) * 128)


@dataclass(frozen=True)
class LanePlan:
    """Static metadata for one lane step: the JAX plan's fields, then the
    kernel's address table."""

    w_is_j: bool
    orient: str          # 'head' (lanes leading) | 'tail' (lanes trailing)
    view_x: tuple        # X view dims, storage order
    combo_axes: tuple    # indices into view_x of looped row-contract legs
    x_axes: tuple        # per view axis: ('g',leg)|('c',leg)|('L',)|('f',)
    y_axes: tuple        # output axes in iy order: ('g',leg)|('H',)|('f',)
    block: int           # the TPU kernel's block along the free run
    L: int
    H: int
    n_combos: int
    wp_idx: object       # int32 gather into w_flat:
                         #   head (n_combos, H, L); tail (n_combos, L, H)
    wp_sign: object      # float32 0/1 mask, same shape
    view_y: tuple        # output view dims (iy order)
    dims_y: tuple        # logical output dims (iy order)
    flops: int           # real flops of the table form: 8 * y_elems * T
    est_s: float         # TPU-fitted roofline estimate (ranks candidates)
    T: int = 0           # terms per output (nonzero Wp entries per h)
    xd: object = None    # (T, H) int32 lane row d = c*L + l of term t of h
    wi: object = None    # (T, H) int32 W flat index of that term
    doff: object = None  # (n_combos*L,) int64 X offset of each lane row
    xoff: object = None  # (G,) int64 X offset of each grid point
    yoff: object = None  # (G,) int64 Y offset of each grid point
    x_fs: int = 0        # f stride in X
    y_fs: int = 0        # f stride in Y
    y_hs: int = 0        # h stride in Y
    F: int = 0           # free-run length
    x_elems: int = 0
    w_elems: int = 0
    y_elems: int = 0
    x_dims: tuple = ()   # X's stored dims, W's, and the step as one einsum
    w_dims: tuple = ()   #   over them (output in iy order): a yardstick
    spec: str = ""
    _dev: dict = dc_field(default_factory=dict, repr=False, compare=False)


def _einsum_spec(ix_x, ix_w, iy):
    """The step as one einsum spec over X's and W's stored legs."""
    letter = {}
    for l in (*ix_x, *ix_w, *iy):
        letter.setdefault(l, "abcdefghijklmnopqrstuvwxyABCDEFGHIJKLMNOPQRSTUVWXY"
                          [len(letter)])
    word = lambda ix: "".join(letter[l] for l in ix)
    return f"{word(ix_x)},{word(ix_w)}->{word(iy)}"


def _address_table(plan, dim_of):
    """The kernel's address table of a lane plan: the nonzero terms of
    each output h, the grid offsets and the strides."""
    sx = _strides(plan.view_x)
    sy = _strides(plan.view_y)
    kinds = [k for k, _ in plan.x_axes]
    lx, fx = kinds.index("L"), kinds.index("f")
    ykinds = [k for k, _ in plan.y_axes]
    hy, fy = ykinds.index("H"), ykinds.index("f")
    # combo offsets: digits over the combo axes, the last fastest (the
    # JAX kernel's combo numbering)
    c_dims = [plan.view_x[k] for k in plan.combo_axes]
    ci = np.arange(plan.n_combos, dtype=np.int64)
    c_off = np.zeros(plan.n_combos, dtype=np.int64)
    for k, dig in zip(plan.combo_axes, _digits(ci, c_dims)):
        c_off += dig * sx[k]
    # every Wp as (n_combos, H, L): the nonzero entries of each row h
    mask = plan.wp_sign if plan.orient == "head" \
        else plan.wp_sign.transpose(0, 2, 1)
    idx = plan.wp_idx if plan.orient == "head" \
        else plan.wp_idx.transpose(0, 2, 1)
    if not np.isin(mask, (0.0, 1.0)).all():
        raise ValueError("lane matrix mask is not 0/1")
    nz = (mask != 0).transpose(1, 0, 2).reshape(plan.H, -1)   # (H, C*L)
    per_h = nz.sum(axis=1)
    T = int(per_h[0])
    if T < 1 or (per_h != T).any():
        raise ValueError("lane matrix rows have unequal term counts")
    h_of, cl = np.nonzero(nz)            # row-major: h-major, then c, l
    c, l = cl // plan.L, cl % plan.L
    wi = idx[c, h_of, l].reshape(plan.H, T)
    doff = (c_off[:, None]
            + np.arange(plan.L, dtype=np.int64)[None, :] * sx[lx]).reshape(-1)
    g_legs = [l for k, l in plan.x_axes if k == "g"]
    g_dims = [dim_of[l] for l in g_legs]
    ypos = {l: k for k, (kind, l) in enumerate(plan.y_axes) if kind == "g"}
    xg = [sx[k] for k, (kind, _) in enumerate(plan.x_axes) if kind == "g"]
    yg = [sy[ypos[l]] for l in g_legs]
    G = _prod(g_dims)
    gi = np.arange(G, dtype=np.int64)
    xoff = np.zeros(G, dtype=np.int64)
    yoff = np.zeros(G, dtype=np.int64)
    for dig, a, b in zip(_digits(gi, g_dims), xg, yg):
        xoff += dig * a
        yoff += dig * b
    y_elems = _prod(plan.view_y)
    return replace(
        plan, flops=8 * y_elems * T, T=T,
        xd=np.ascontiguousarray(cl.reshape(plan.H, T).T).astype(np.int32),
        wi=np.ascontiguousarray(wi.T).astype(np.int32), doff=doff,
        xoff=xoff, yoff=yoff, x_fs=sx[fx], y_fs=sy[fy], y_hs=sy[hy],
        F=plan.view_x[fx], x_elems=_prod(plan.view_x),
        w_elems=_prod(plan.w_dims), y_elems=y_elems)


def plan_lane_step(ix_i, ix_j, iy, dims_i, dims_j, lane_count=None, pin=0,
                   orient="head"):
    """Build a LanePlan for the step, or None if ineligible (sets
    ``LAST_REJECT``).

    ``lane_count`` pins the lane run length (legs after the ``pin`` pinned
    prefix for 'head', trailing legs for 'tail'); by default every split
    of the head orientation is tried and the best ``est_s`` kept (the
    sparse compiler's chain; the tail orientation comes only through
    ``schedule_step``).  ``pin`` leading X legs (e.g. a sparse
    amplitude-batch axis) stay leading grid legs in the output.
    """
    if lane_count is None:
        best = None
        _b, ix_x0, dims_x0, _w, _dw = _split_big_small(
            ix_i, ix_j, dims_i, dims_j)
        dox = {l: int(d) for l, d in zip(ix_x0, dims_x0)}
        for k, _L in _lane_splits(ix_x0[pin:], dox):
            p = plan_lane_step(ix_i, ix_j, iy, dims_i, dims_j,
                               lane_count=k, pin=pin, orient="head")
            if p is not None and (best is None or p.est_s < best.est_s):
                best = p
        return best
    # w_is_j True <=> operand i is the big X side and j is the small W side
    w_is_j, ix_x, dims_x, ix_w, dims_w = _split_big_small(
        ix_i, ix_j, dims_i, dims_j)
    if _prod(dims_x) < MIN_X_ELEMS or _prod(dims_w) > SMALL_W_ELEMS:
        return _rej("size")
    set_x, set_w, set_y = set(ix_x), set(ix_w), set(iy)
    if set_x & set_w & set_y:
        return _rej("shared-batch")
    contract = [l for l in ix_x if l in set_w and l not in set_y]
    n_legs = [l for l in ix_w if l in set_y]
    if set(ix_w) != set(contract) | set(n_legs) or len(set_y) != len(iy):
        return _rej("w-legs")
    dim_of = {}
    for l, d in zip(ix_x, dims_x):
        dim_of[l] = int(d)
    for l, d in zip(ix_w, dims_w):
        dim_of[l] = int(d)

    pinned = list(ix_x[:pin])
    if any(l not in set_y for l in pinned):
        return _rej("pinned-contracted")
    if orient == "head":
        lane_legs = list(ix_x[pin:pin + lane_count])
    else:
        if lane_count > len(ix_x) - pin:
            return _rej("lanes-hit-pin")
        lane_legs = list(ix_x[len(ix_x) - lane_count:])
    L = _prod(dim_of[l] for l in lane_legs)
    if L > LANE_CAP:
        return _rej("L-cap")
    lane_set = set(lane_legs)
    row_legs = [l for l in ix_x if l not in lane_set]
    combo_legs = [l for l in row_legs if l in contract]
    n_combos = _prod(dim_of[l] for l in combo_legs)
    if n_combos > COMBO_CAP:
        return _rej("combos")
    lane_free = [l for l in lane_legs if l not in contract]
    rows_free = [l for l in row_legs if l not in contract]
    H = _prod(dim_of[l] for l in lane_free) * _prod(dim_of[l] for l in n_legs)
    if H > H_CAP or n_combos * L * H > WP_ELEMS_CAP:
        return _rej("H-cap")
    hset = set(lane_free) | set(n_legs)
    h_legs = [l for l in iy if l in hset]
    if len(h_legs) != len(hset):
        return _rej("iy-h")

    # TPU-fitted roofline gate: padded MXU time against the stream time
    rows_total = _prod(dim_of[l] for l in rows_free)
    x_elems = _prod(dims_x)
    compute_s = (4 * 2 * rows_total * max(L, 128) * max(H, 128) * n_combos
                 / MXU_FLOPS_PER_S)
    traffic_s = 4 * (2 * x_elems + 2 * rows_total * H
                     + 2 * n_combos * L * H) / HBM_BYTES_PER_S
    if compute_s > ROOFLINE_SLACK * traffic_s:
        return _rej("roofline")
    est_s = max(compute_s, traffic_s)

    # ---- structural iy checks -------------------------------------------
    combo_set = set(combo_legs)
    rest_rows = [l for l in row_legs if l not in set(pinned)]
    if tuple(iy[:pin]) != tuple(pinned):
        return _rej("iy-pin")
    if orient == "head":
        # f run = longest iy SUFFIX kept in X's row order; combo legs at
        # X's very end sit beyond it
        skip = 0
        while (skip < len(rest_rows)
               and rest_rows[-(skip + 1)] in combo_set):
            skip += 1
        rr = rest_rows[:len(rest_rows) - skip]
        n_f = 0
        while (n_f < len(rr) and n_f < len(iy)
               and iy[-(n_f + 1)] == rr[-(n_f + 1)]
               and rr[-(n_f + 1)] not in combo_set):
            n_f += 1
        f_legs = rr[len(rr) - n_f:] if n_f else []
        head = list(iy[:len(iy) - n_f])
    else:
        # f run = longest iy run (right after the pin) kept in X row
        # order; combo legs at X's very front sit before it
        skip = 0
        while skip < len(rest_rows) and rest_rows[skip] in combo_set:
            skip += 1
        rr = rest_rows[skip:]
        n_f = 0
        while (n_f < len(rr) and pin + n_f < len(iy)
               and iy[pin + n_f] == rr[n_f]
               and rr[n_f] not in combo_set):
            n_f += 1
        f_legs = rr[:n_f]
        head = list(iy[:pin]) + list(iy[pin + n_f:])
    if not f_legs:
        return _rej("no-f-run")
    F = _prod(dim_of[l] for l in f_legs)
    grid_legs = pinned + [l for l in rest_rows
                          if l not in combo_set and l not in set(f_legs)]
    h_pos = [k for k, l in enumerate(head) if l in hset]
    if h_pos and h_pos[-1] - h_pos[0] + 1 != len(h_pos):
        return _rej("h-contig")
    if set(head) - hset != set(grid_legs):
        return _rej("head-set")
    inner_budget = max(1, BLOCK_ELEMS // max(n_combos * L, 1))
    block = max(1, min(F, inner_budget))
    while F % block:
        block -= 1
    if block < 128 and (grid_legs or combo_legs):
        return _rej("block-small")
    # TPU block rules (Mosaic): a partial blocked f axis needs %128 when
    # minor ('head'), %8 when second-minor ('tail')
    if orient == "head":
        if block != F and block % 128:
            return _rej("tile-div")
    else:
        if block != F and block % 8:
            return _rej("tile-div")

    # ---- lane matrix gather (host) -----------------------------------------
    lane_c = [l for l in lane_legs if l in contract]
    w_strides = dict(zip(ix_w, _strides([dim_of[l] for l in ix_w])))
    li = np.arange(L, dtype=np.int64)
    lane_vals = dict(zip(lane_legs,
                         _digits(li, [dim_of[l] for l in lane_legs])))
    hi = np.arange(H, dtype=np.int64)
    h_vals = dict(zip(h_legs, _digits(hi, [dim_of[l] for l in h_legs]))) \
        if h_legs else {}
    ci = np.arange(max(n_combos, 1), dtype=np.int64)
    combo_vals = dict(zip(combo_legs,
                          _digits(ci, [dim_of[l] for l in combo_legs]))) \
        if combo_legs else {}
    # head: wp (n_combos, H, L) used as wp @ v; tail: (n_combos, L, H)
    if orient == "head":
        ldim, hdim = 2, 1
        shape = (n_combos, H, L)
    else:
        ldim, hdim = 1, 2
        shape = (n_combos, L, H)
    idx = np.zeros(shape, dtype=np.int64)
    mask = np.ones(shape, dtype=np.float32)

    def _bc(arr, axis):
        sh = [1, 1, 1]
        sh[axis] = arr.shape[0]
        return arr.reshape(sh)

    for l in lane_c:
        idx += _bc(lane_vals[l], ldim) * w_strides[l]
    for l in combo_legs:
        idx += _bc(combo_vals[l], 0) * w_strides[l]
    for l in n_legs:
        idx += _bc(h_vals[l], hdim) * w_strides[l]
    for l in lane_free:
        mask = mask * (_bc(lane_vals[l], ldim)
                       == _bc(h_vals[l], hdim)).astype(np.float32)

    # ---- views -----------------------------------------------------------
    x_axes = []
    for l in ix_x:
        if l in lane_set:
            if not x_axes or x_axes[-1][0] != "L":
                x_axes.append(("L", None))
        elif l in set(f_legs):
            if not x_axes or x_axes[-1][0] != "f":
                x_axes.append(("f", None))
        elif l in combo_set:
            x_axes.append(("c", l))
        else:
            x_axes.append(("g", l))
    y_axes = []
    placed_h = False
    k = 0
    iy_list = list(iy)
    while k < len(iy_list):
        l = iy_list[k]
        if l in hset:
            if not placed_h:
                y_axes.append(("H", None))
                placed_h = True
            k += 1
        elif l in set(f_legs):
            y_axes.append(("f", None))
            k += len(f_legs)
        else:
            y_axes.append(("g", l))
            k += 1
    if not placed_h:
        y_axes.append(("H", None))

    # TPU block rule: squeezed ('g') axes may not sit in the last two
    # block positions
    if [k for k, _l in x_axes[-2:]].count("g"):
        return _rej("g-in-tile")
    if [k for k, _l in y_axes[-2:]].count("g"):
        return _rej("g-in-tile-y")

    def _xdim(kind, l):
        if kind == "L":
            return L
        if kind == "f":
            return F
        return dim_of[l]

    view_dims = tuple(_xdim(kind, l) for kind, l in x_axes)
    combo_axes = tuple(k for k, (kind, l) in enumerate(x_axes)
                       if kind == "c")
    view_y = tuple(H if kind == "H" else (F if kind == "f" else dim_of[l])
                   for kind, l in y_axes)
    dims_y = tuple(dim_of[l] for l in iy)
    # TPU VMEM demand of the double-buffered re/im block windows, padded
    # to the (8, 128) tile
    xwin = [view_dims[k] if kind in ("c", "L") else block
            for k, (kind, l) in enumerate(x_axes) if kind != "g"]
    ywin = [H if kind == "H" else block
            for kind, l in y_axes if kind != "g"]
    vmem = 4 * 2 * 2 * (_padded_elems(xwin) + _padded_elems(ywin)
                        + _padded_elems(list(idx.shape)))
    if vmem > VMEM_WINDOW_BUDGET:
        return _rej("vmem")
    plan = LanePlan(w_is_j, orient, view_dims, combo_axes, tuple(x_axes),
                    tuple(y_axes), block, L, H, n_combos,
                    idx.astype(np.int32), mask, view_y, dims_y, 0, est_s,
                    x_dims=tuple(dim_of[l] for l in ix_x),
                    w_dims=tuple(dim_of[l] for l in ix_w),
                    spec=_einsum_spec(ix_x, ix_w, iy))
    return _address_table(plan, dim_of)


def schedule_step(ix_i, ix_j, iy_set, dims_i, dims_j, consumer_contract=(),
                  pin=0, orientations=("head",)):
    """Choose the step's output order and, when one fits, its kernel plan.

    Tries every lane split in each orientation of ``orientations``;
    candidate output orders hoist the consumer's contract legs to the
    output end matching the orientation (leading for 'head', trailing for
    'tail'), with only the protected free run immobile.  Then the gather-K
    candidate (``gk_output_order`` + ``plan_gk_step``), which wins whenever
    it plans; then the best lane plan; then, for two big operands, the
    pair kernel with the (i-free legs, j-free legs) order.  When nothing
    plans the step keeps the dot fallback's ``fallback_output_order``.

    Returns (iy, plan_or_None).
    """
    from .gatherk import gk_output_order, plan_gk_step

    w_is_j, ix_x, dims_x, ix_w, dims_w = _split_big_small(
        ix_i, ix_j, dims_i, dims_j)
    set_x, set_w = set(ix_x), set(ix_w)
    dim_of = {}
    for l, d in zip(ix_x, dims_x):
        dim_of[l] = int(d)
    for l, d in zip(ix_w, dims_w):
        dim_of[l] = int(d)
    new = [l for l in ix_w if l in iy_set and l not in set_x]
    cset = set(consumer_contract)
    best = None
    if (_prod(dims_x) >= MIN_X_ELEMS and _prod(dims_w) <= SMALL_W_ELEMS
            and not (set_x & set_w & iy_set)):
        contract_set = {l for l in ix_x if l in set_w and l not in iy_set}
        pinned = list(ix_x[:pin])
        for o in orientations:
            legs = ix_x[pin:] if o == "head" else tuple(reversed(ix_x))
            for k, _L in _lane_splits(legs, dim_of):
                if o == "tail" and k > len(ix_x) - pin:
                    break
                if o == "head":
                    lane_legs = list(ix_x[pin:pin + k])
                else:
                    lane_legs = list(ix_x[len(ix_x) - k:])
                lane_set = set(lane_legs)
                row_legs = [l for l in ix_x[pin:] if l not in lane_set]
                rows_free = [l for l in row_legs if l in iy_set
                             and l not in set_w]
                lane_free = [l for l in lane_legs
                             if l in iy_set and l not in set_w]
                # protected f run: minimal free run of >= F_MIN elements at
                # the end OPPOSITE the lanes; everything else is hoistable
                seq = (list(reversed(row_legs)) if o == "head"
                       else list(row_legs))
                skip = 0
                while skip < len(seq) and seq[skip] in contract_set:
                    skip += 1
                n_f = 0
                fprod = 1
                for l in seq[skip:]:
                    if l in contract_set:
                        break
                    if fprod >= F_MIN and l in cset:
                        break
                    n_f += 1
                    fprod *= dim_of[l]
                if o == "head":
                    f_legs = row_legs[len(row_legs) - skip - n_f:
                                      len(row_legs) - skip]
                else:
                    f_legs = row_legs[skip:skip + n_f]
                gables = [l for l in rows_free if l not in set(f_legs)]
                if o == "head":
                    h = [l for l in lane_free + new if l in cset]
                    h += [l for l in lane_free + new if l not in cset]
                    head = [l for l in gables if l in cset] + h
                    rest = [l for l in gables if l not in cset]
                    iy_k = tuple(pinned + head + rest + f_legs)
                else:
                    h = [l for l in lane_free + new if l not in cset]
                    h += [l for l in lane_free + new if l in cset]
                    rest = [l for l in gables if l not in cset]
                    tail_g = [l for l in gables if l in cset]
                    iy_k = tuple(pinned + f_legs + rest + tail_g + h)
                p = plan_lane_step(ix_i, ix_j, iy_k, dims_i, dims_j,
                                   lane_count=k, pin=pin, orient=o)
                if p is not None and (best is None
                                      or p.est_s < best[1].est_s):
                    best = (iy_k, p)
    iy_gk = gk_output_order(ix_i, ix_j, iy_set, dims_i, dims_j, pin=pin,
                            consumer_contract=consumer_contract)
    gkp = plan_gk_step(ix_i, ix_j, iy_gk, dims_i, dims_j, pin=pin)
    if gkp is not None:
        return iy_gk, gkp
    if best is not None:
        return best
    if (_prod(dims_i) > SMALL_W_ELEMS and _prod(dims_j) > SMALL_W_ELEMS
            and not (set_x & set_w & iy_set) and pin == 0):
        rows_i = [l for l in ix_i if l in iy_set]
        rows_j = [l for l in ix_j if l in iy_set and l not in set(rows_i)]
        iy_p = tuple(rows_i + rows_j)
        p = plan_pair_step(ix_i, ix_j, iy_p, dims_i, dims_j)
        if p is not None:
            return iy_p, p
    return fallback_output_order(ix_i, ix_j, iy_set, dims_i, dims_j,
                                 consumer_contract,
                                 pinned=tuple(ix_x[:pin])), None


def prune_lane_plans(steps, cap=LANE_STEPS_CAP):
    """Keep only the ``cap`` kernel plans of a compiled scheme with the
    most work (``flops``: the port's GK, GGK and pair plans carry no time
    estimate); the rest revert to the dot lowering, their orders as
    scheduled.  Returns the number of plans kept."""
    laned = [(k, s) for k, s in enumerate(steps) if s.lane is not None]
    if len(laned) <= cap:
        return len(laned)
    laned.sort(key=lambda t: -t[1].lane.flops)
    for k, s in laned[cap:]:
        steps[k] = replace(s, lane=None)
    return cap


# -- lane kernel ---------------------------------------------------------------

def _lane_tables(plan, device):
    """The plan's address table as tensors on ``device``, uploaded once."""
    key = ("table", str(device))
    if key not in plan._dev:
        to = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a),
                                           dtype=dt).to(device)
        plan._dev[key] = dict(xd=to(plan.xd, torch.int32),
                              wi=to(plan.wi, torch.int32),
                              doff=to(plan.doff, torch.long),
                              xoff=to(plan.xoff, torch.long),
                              yoff=to(plan.yoff, torch.long))
    return plan._dev[key]


def lane_plain(plan, xr, xi, wr, wi, x_batched, w_batched):
    """Plain version of the lane kernel (same operands as ``lane_call``),
    in the JAX form: the lane matrix Wp by gather x mask, then one
    product per combo over X viewed as (grid, combo, L, f), one slice
    instance at a time (bounds the temporaries)."""
    W = kernels.slice_width(x_batched, w_batched, xr, wr)
    dev = xr.device
    key = ("wp", str(dev))
    if key not in plan._dev:
        plan._dev[key] = (torch.as_tensor(plan.wp_idx, dtype=torch.long,
                                          device=dev),
                          torch.as_tensor(plan.wp_sign, device=dev))
    idx, sign = plan._dev[key]
    kinds = [k for k, _ in plan.x_axes]
    g_pos = [k for k, kind in enumerate(kinds) if kind == "g"]
    g_legs = [l for k, l in plan.x_axes if k == "g"]
    g_dims = tuple(plan.view_x[k] for k in g_pos)
    perm = g_pos + list(plan.combo_axes) + [kinds.index("L"),
                                            kinds.index("f")]
    # (g..., H, f) -> the output view's axis order
    src = {("g", l): n for n, l in enumerate(g_legs)}
    src[("H", None)] = len(g_legs)
    src[("f", None)] = len(g_legs) + 1
    yperm = [src[a] for a in plan.y_axes]

    def x_view(c):          # (G, C, L, F)
        return permute.regroup((c,), plan.view_x, perm, (
            _prod(g_dims), plan.n_combos, plan.L, plan.F))[0]

    def wp(c):              # (C, H, L)
        m = c[idx] * sign
        return m.transpose(-1, -2) if plan.orient == "tail" else m

    lead = (W,) if (x_batched or w_batched) else ()
    yr = torch.empty(lead + (plan.y_elems,), dtype=xr.dtype, device=dev)
    yi = torch.empty_like(yr)
    for s in range(W):
        vr = x_view(xr[s] if x_batched else xr)
        vi = x_view(xi[s] if x_batched else xi)
        mr = wp(wr[s] if w_batched else wr)
        mi = wp(wi[s] if w_batched else wi)
        re = im = None
        for c in range(plan.n_combos):
            a, b, u, v = mr[c], mi[c], vr[:, c], vi[:, c]
            pr = torch.matmul(a, u) - torch.matmul(b, v)       # (G, H, F)
            pi = torch.matmul(b, u) + torch.matmul(a, v)
            re = pr if re is None else re + pr
            im = pi if im is None else im + pi
        for out, t in ((yr, re), (yi, im)):
            t = t.reshape(g_dims + (plan.H, plan.F)).permute(yperm)
            permute.copy((t,), ((out[s] if lead else out).view(t.shape),))
    return yr, yi


def lane_call(plan, xr, xi, wr, wi, x_batched, w_batched):
    """The lane kernel's wrapper.  ``xr``/``xi``: X as ``(X,)`` or
    ``(W, X)`` in its stored order; ``wr``/``wi``: W's stored elements
    ``(w,)`` or ``(W, w)``.  Returns Y ``(Y,)`` or ``(W, Y)``."""
    W = kernels.slice_width(x_batched, w_batched, xr, wr)
    xl = (W,) if x_batched else ()
    wl = (W,) if w_batched else ()
    dev = kernels.check_operands("lane", (xr, xi, wr, wi),
                                 (xl + (plan.x_elems,),) * 2
                                 + (wl + (plan.w_elems,),) * 2)
    if dev.type == "cpu":
        return lane_plain(plan, xr, xi, wr, wi, x_batched, w_batched)
    t = _lane_tables(plan, dev)
    lead = (W,) if (x_batched or w_batched) else ()
    yr = torch.empty(lead + (plan.y_elems,), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    n = kernels.launch(
        "lane", kernels.load().lane_launch, dev,
        *map(kernels.ptr, (xr, xi, wr, wi, yr, yi, t["xd"], t["wi"],
                           t["doff"], t["xoff"], t["yoff"])),
        len(plan.xoff), len(plan.doff), plan.H, plan.T, plan.F, plan.x_fs,
        plan.y_fs, plan.y_hs, plan.x_elems if x_batched else 0,
        plan.w_elems if w_batched else 0, plan.y_elems if lead else 0, W)
    lane_call.launches += n
    return yr, yi


lane_call.launches = 0


def apply_lane_step(field, x, y, plan, bx=False, by=False):
    """Execute one lane step on SplitField pairs.  ``bx``/``by``: the
    operand carries a leading slice-width axis."""
    xv, wv, bxv, bwv = (x, y, bx, by) if plan.w_is_j else (y, x, by, bx)
    xlead = (xv[0].shape[0],) if bxv else ()
    wlead = (wv[0].shape[0],) if bwv else ()
    xr, xi = permute.contiguous(permute.reshape(xv, xlead + (-1,)))
    wr, wi = permute.contiguous(permute.reshape(wv, wlead + (-1,)))
    yr, yi = lane_call(plan, xr, xi, wr, wi, bxv, bwv)
    return field.reshape((yr, yi), (xlead or wlead)
                         + physical_shape(plan.dims_y))


# -- pair kernel ---------------------------------------------------------------

@dataclass(frozen=True)
class PairPlan:
    """Fused complex product for steps where BOTH operands are big."""

    K: int
    M: int
    N: int
    v_perm: object       # int64 K-permutation of j's rows (or None)
    dims_y: tuple
    flops: int
    re_i: object = None  # input Reorder to (contract, rows) form (or None)
    re_j: object = None
    # ``v_perm`` on each device it ran on (``apply_pair_step``)
    _dev: dict = dc_field(default_factory=dict, init=False, repr=False,
                          compare=False)


def plan_pair_step(ix_i, ix_j, iy, dims_i, dims_j):
    """Build a PairPlan, or None if the step does not fit."""
    set_i, set_j, set_y = set(ix_i), set(ix_j), set(iy)
    if set_i & set_j & set_y:
        return _rej("pair-shared")
    if _prod(dims_i) <= SMALL_W_ELEMS or _prod(dims_j) <= SMALL_W_ELEMS:
        return _rej("pair-small")
    dim_of = {}
    for l, d in zip(ix_i, dims_i):
        dim_of[l] = int(d)
    for l, d in zip(ix_j, dims_j):
        dim_of[l] = int(d)
    contract = [l for l in ix_i if l in set_j and l not in set_y]
    nc = len(contract)
    if not nc:
        return _rej("pair-outer")
    rows_i = [l for l in ix_i if l not in set(contract)]
    rows_j = [l for l in ix_j if l not in set(contract)]
    if set(rows_i) & set_j or set(rows_j) & set_i:
        return _rej("pair-extra-shared")
    # iy must group i-rows then j-rows; within each group any order works
    # (the input reorders absorb it)
    if tuple(iy) != tuple([l for l in iy if l in set(rows_i)]
                          + [l for l in iy if l in set(rows_j)]):
        return _rej("pair-iy")
    rows_i = [l for l in iy if l in set(rows_i)]
    rows_j = [l for l in iy if l in set(rows_j)]

    def _pre(ix, rows):
        want = tuple(contract) + tuple(rows)
        if tuple(ix) == want:
            return None
        pos = {l: k for k, l in enumerate(ix)}
        return plan_reorder(tuple(dim_of[l] for l in ix),
                            tuple(pos[l] for l in want),
                            (_prod(dim_of[l] for l in contract),
                             _prod(dim_of[l] for l in rows)))

    re_i = _pre(ix_i, rows_i)
    K = _prod(dim_of[l] for l in contract)
    M = _prod(dim_of[l] for l in rows_i)
    N = _prod(dim_of[l] for l in rows_j)
    v_perm = None
    if set(ix_j[:nc]) == set(contract) and tuple(ix_j[nc:]) == tuple(rows_j):
        # only j's contract-digit order differs: align its K rows to i's
        # order with one row gather (whole contiguous rows) instead of a
        # full reorder
        re_j = None
        if tuple(ix_j[:nc]) != tuple(contract):
            strides = {}
            s = 1
            for l in reversed(ix_j[:nc]):
                strides[l] = s
                s *= dim_of[l]
            rem = np.arange(K, dtype=np.int64)
            digits = {}
            for l in reversed(contract):
                digits[l] = rem % dim_of[l]
                rem = rem // dim_of[l]
            v_perm = sum(digits[l] * strides[l] for l in contract)
    else:
        re_j = _pre(ix_j, rows_j)
    dims_y = tuple(dim_of[l] for l in iy)
    return PairPlan(K, M, N, v_perm, dims_y, 8 * M * N * K, re_i, re_j)


def pair_plain(plan, xr, xi, vr, vi, x_batched, v_batched, tf32=False):
    """Plain version of the pair kernel (same operands as ``pair_call``):
    the four real products of X^T . V with ``torch.matmul``.  ``tf32``:
    the operands rounded as the kernel's one-pass form rounds them
    (``kernels.tf32_round``), the products still in float32."""
    K, M, N = plan.K, plan.M, plan.N
    if tf32:
        xr, xi, vr, vi = map(kernels.tf32_round, (xr, xi, vr, vi))
    lead = (kernels.slice_width(x_batched, v_batched, xr, vr),) \
        if (x_batched or v_batched) else ()
    xt = lambda c: c.reshape(((c.shape[0],) if x_batched else ())
                             + (K, M)).transpose(-1, -2)
    vv = lambda c: c.reshape(((c.shape[0],) if v_batched else ()) + (K, N))
    re = torch.matmul(xt(xr), vv(vr)) - torch.matmul(xt(xi), vv(vi))
    im = torch.matmul(xt(xr), vv(vi)) + torch.matmul(xt(xi), vv(vr))
    return (re.reshape(lead + (M * N,)).contiguous(),
            im.reshape(lead + (M * N,)).contiguous())


def pair_call(plan, xr, xi, vr, vi, x_batched, v_batched, passes=3):
    """The pair kernel's wrapper.  ``xr``/``xi``: X as ``(K*M,)`` or
    ``(W, K*M)`` in (K, M) row-major form; ``vr``/``vi``: V as ``(K*N,)``
    or ``(W, K*N)``.  Returns Y ``(M*N,)`` or ``(W, M*N)``.  ``passes``:
    3 (3xTF32) or 1 (one TF32 pass, ``kernels.tc_passes``; counted in
    ``pair_call.one_pass``); the CPU's plain version multiplies in
    float32 at either."""
    K, M, N = plan.K, plan.M, plan.N
    W = kernels.slice_width(x_batched, v_batched, xr, vr)
    xl = (W,) if x_batched else ()
    vl = (W,) if v_batched else ()
    dev = kernels.check_operands("pair", (xr, xi, vr, vi),
                                 (xl + (K * M,),) * 2 + (vl + (K * N,),) * 2)
    if dev.type == "cpu":
        return pair_plain(plan, xr, xi, vr, vi, x_batched, v_batched)
    lead = (W,) if (x_batched or v_batched) else ()
    yr = torch.empty(lead + (M * N,), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    n = kernels.launch(
        "pair", kernels.load().pair_launch, dev,
        *map(kernels.ptr, (xr, xi, vr, vi, yr, yi)), K, M, N,
        K * M if x_batched else 0, K * N if v_batched else 0,
        M * N if lead else 0, W, passes)
    pair_call.launches += n
    pair_call.one_pass += n if passes == 1 else 0
    return yr, yi


pair_call.launches = 0
pair_call.one_pass = 0      # launches in one TF32 pass


def apply_pair_step(field, x, y, plan, bx=False, by=False):
    """Execute a both-big pair step on SplitField pairs: the input reorders
    and the ``v_perm`` row gather, then the kernel at the field's
    precision (``kernel_precision``).  ``bx``/``by``: the operand carries
    a leading slice-width axis."""
    xlead = (x[0].shape[0],) if bx else ()
    ylead = (y[0].shape[0],) if by else ()
    if plan.re_i is not None:
        x = apply_reorder(field, x, plan.re_i, xlead)
    if plan.re_j is not None:
        y = apply_reorder(field, y, plan.re_j, ylead)
    vs = field.reshape(y, ylead + (plan.K, plan.N))
    if plan.v_perm is not None:
        dev = vs[0].device
        if str(dev) not in plan._dev:
            plan._dev[str(dev)] = torch.as_tensor(
                np.ascontiguousarray(plan.v_perm), dtype=torch.long).to(dev)
        vs = field.take(vs, plan._dev[str(dev)], axis=len(ylead))
    xr, xi = permute.contiguous(permute.reshape(x, xlead + (-1,)))
    vr, vi = permute.contiguous(permute.reshape(vs, ylead + (-1,)))
    yr, yi = pair_call(plan, xr, xi, vr, vi, bx, by,
                       kernels.tc_passes(kernel_precision(field)))
    return field.reshape((yr, yi), (xlead or ylead)
                         + physical_shape(plan.dims_y))
