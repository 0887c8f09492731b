"""Compile a contraction tree into a static dense (full-amplitude) scheme.

Port of ``artensor_tpu/runtime/scheme.py``.  A scheme is a plain-Python
list of steps fixed on the host: each step names its operand buffers, its
label orders and dims, its dot lowering (``runtime/lowering.py``) and,
where a hand-written kernel takes it, a kernel plan.  Layouts are
time-ordered (every output's legs sorted by the step that contracts
them), and kernels are selected per step in the JAX order: gather-K, the
lane kernel, the both-big pair kernel, then the pre-permuted gather-K
form; ``prune_lane_plans`` caps the kernel steps.

``contraction_scheme`` runs the JAX flow with the JAX defaults: the
gate-block fusion pass (``fuse.py``), each rewrite kept only if the
compiled scheme's wall estimate drops, then producer-order negotiation
(``negotiate.py``) over the layout requests ``_compile_dense`` collects.
The estimate is the H100 model (``metrics.py``), as in the port's sparse
compiler, so the default form's choices may differ from the JAX
package's; given the same order and overrides, the steps are the JAX
compiler's (the port's pre-permuted GK form has no estimate gate:
``ROADMAP.md`` Queue C).
"""

import dataclasses
from dataclasses import dataclass

from . import gatherk, tracing
from .gatherk import GKPlan, plan_gk_step, plan_gk_step_pre
from .lanes import plan_lane_step, plan_pair_step, prune_lane_plans
from .lowering import Lowered, _prod, lower_step, preferred_output_order
from .sparse import _layout_request_candidates, _time_sorted_output

# schemes of more tensors than this compile without kernel plans (the JAX
# package's pod-scale cut)
LANE_SCHEDULE_MAX_TENSORS = 300


@dataclass(frozen=True)
class DenseStep:
    i: int
    j: int
    ix_i: tuple
    ix_j: tuple
    iy: tuple
    dims_i: tuple
    dims_j: tuple
    lowered: Lowered
    lane: object = None   # GKPlan / LanePlan / PairPlan when a kernel runs


def _relabel(ix_i, ix_j, iy):
    """Map arbitrary bond labels of one step to dense ints."""
    lab = {}
    for b in [*ix_i, *ix_j, *iy]:
        lab.setdefault(b, len(lab))
    return (
        tuple(lab[b] for b in ix_i),
        tuple(lab[b] for b in ix_j),
        tuple(lab[b] for b in iy),
    )


def internal_nodes_in_execution_order(ctree):
    """Internal vertices ordered leaves -> root in the DFS convention
    (larger-sc child first)."""
    ctree.mark_representatives()
    out = []
    stack = [ctree.root]
    while stack:
        v = stack.pop()
        if v.is_leaf():
            continue
        out.append(v)
        if v.left.sc > v.right.sc:
            stack += [v.left, v.right]
        else:
            stack += [v.right, v.left]
    out.reverse()
    return out


def make_dense_step(i, j, ix_i, ix_j, iy, dims_i, dims_j, lane=None):
    ix_i2, ix_j2, iy2 = _relabel(ix_i, ix_j, iy)
    low = lower_step(ix_i2, ix_j2, iy2, tuple(dims_i), tuple(dims_j))
    return DenseStep(i, j, ix_i2, ix_j2, iy2,
                     tuple(dims_i), tuple(dims_j), low, lane)


def contraction_scheme(ctree, lane_schedule=True, negotiate=True,
                       fuse=True):
    """Dense (full-amplitude) scheme.

    Returns ``(steps, output_bonds)``: the steps and the bond labels of the
    result's axes (the open legs) in the order the executor produces them.

    ``lane_schedule``: time-ordered layouts and kernel plans (default);
    False compiles the plain dot lowering in transpose-free orders.
    ``negotiate``: producer-order negotiation over the layout requests.
    ``fuse``: gate-block fusion, each rewrite kept only if the compiled
    scheme's wall estimate drops.  The compile runs in a
    ``scheme.compile`` span, the two passes in ``scheme.fuse`` and
    ``scheme.negotiate`` spans under it (``compile_stats``).
    """
    from . import negotiate as _neg

    with tracing.span("scheme.compile", kind="dense"):
        if not lane_schedule or not negotiate \
                or len(ctree.tn.tensor_bonds) > LANE_SCHEDULE_MAX_TENSORS:
            steps, ob, _ = _compile_dense(ctree, lane_schedule, None)
            return steps, ob
        if fuse:
            from ..planner.tree import ContractionTree
            from .fuse import fuse_by_estimate
            from .metrics import scheme_wall_estimate

            tn = ctree.tn

            def estimate(order):
                ct = ctree if order is None else ContractionTree(tn, order)
                s, _ob, _req = _compile_dense(ct, lane_schedule, None)
                return scheme_wall_estimate(s, 0)[0]

            fused = fuse_by_estimate(ctree.to_order_dfs(), tn.tensor_bonds,
                                     tn.bond_dims, estimate)
            if fused != [tuple(p) for p in ctree.to_order_dfs()]:
                ctree = ContractionTree(tn, fused)

        def compile_fn(overrides):
            steps, ob, req = _compile_dense(ctree, lane_schedule, overrides)
            return (steps, ob), steps, req

        return _neg.negotiate(compile_fn)


def compile_stats(compile_span=None):
    """What a scheme compile (its ``scheme.compile`` span; default the
    last) spent on its passes, read from its spans: ``fuse_s``,
    ``fuse_compiles``, ``rewrites``, ``negotiate_s`` and
    ``negotiate_compiles`` (zeros for a pass that did not run)."""
    out = dict(fuse_s=0.0, fuse_compiles=0, rewrites=0, negotiate_s=0.0,
               negotiate_compiles=0)
    compile_span = compile_span or tracing.last("scheme.compile")
    if compile_span is None:
        return out
    for sp in tracing.children(compile_span):
        if sp.name == "scheme.fuse":
            out.update(fuse_s=sp.seconds, fuse_compiles=sp.attrs["compiles"],
                       rewrites=sp.attrs["rewrites"])
        elif sp.name == "scheme.negotiate":
            out.update(negotiate_s=sp.seconds,
                       negotiate_compiles=sp.attrs["compiles"])
    return out


def _compile_dense(ctree, lane_schedule, _overrides):
    """One compile, with the output orders of the steps in ``_overrides``
    (step index -> bond order) replaced.  Returns ``(steps,
    output_bonds, requests)``: ``requests`` maps a producer step's index
    to its candidate output orders (friendliest first)."""
    tn = ctree.tn
    if len(tn.tensor_bonds) > LANE_SCHEDULE_MAX_TENSORS:
        lane_schedule = False
    dims = {b: int(d) for b, d in tn.bond_dims.items()}
    bond_order = {}    # id(node) -> tuple of bond labels of its result axes
    steps = []
    output_bonds = ()
    produced_by = {}   # rep tensor id -> index of the step that wrote it
    fresh_of = {}      # rep tensor id -> legs taken from its SMALL operand
                       # (the producer kernel's H block; layout requests
                       # keep it contiguous)
    requests = {}      # producer step index -> candidate output orders
    if ctree.root.is_leaf():
        # a single-tensor network: no steps, the staged tensor is the result
        return steps, list(tn.tensor_bonds[ctree.root.leaf_id]), requests
    vertices = internal_nodes_in_execution_order(ctree)
    # the step index at which each bond is contracted
    time_of = {}
    for t, v in enumerate(vertices):
        for child in (v.left, v.right):
            if child.is_leaf():
                bond_order.setdefault(
                    id(child), tuple(tn.tensor_bonds[child.leaf_id]))
        all_b = set()
        for child in (v.left, v.right):
            all_b |= (set(tn.tensor_bonds[child.leaf_id])
                      if child.is_leaf() else set(child.boundary.keys()))
        for b in all_b - set(v.boundary.keys()):
            time_of.setdefault(b, t)
    for v in vertices:
        ix_left = bond_order[id(v.left)]
        ix_right = bond_order[id(v.right)]
        if v.rep == v.left.rep:
            i, j = v.left.rep, v.right.rep
            ix_i, ix_j = ix_left, ix_right
        else:
            i, j = v.right.rep, v.left.rep
            ix_i, ix_j = ix_right, ix_left
        yset = set(v.boundary.keys())
        dims_i = [dims[b] for b in ix_i]
        dims_j = [dims[b] for b in ix_j]
        size_i, size_j = _prod(dims_i), _prod(dims_j)
        if lane_schedule:
            base = [b for b in ix_i if b in yset]
            base += [b for b in ix_j if b in yset and b not in set(base)]
            iy = tuple(_time_sorted_output(
                list(ix_i), list(ix_j), base, time_of, size_i >= size_j,
                full_sort=(max(size_i, size_j) < gatherk.MIN_X_ELEMS
                           or min(size_i, size_j) > gatherk.HK_CAP)))
        else:
            iy = preferred_output_order(ix_i, ix_j, yset)
        t = len(steps)
        overridden = (_overrides is not None and t in _overrides
                      and set(_overrides[t]) == yset)
        if overridden:
            iy = tuple(_overrides[t])
        assert set(iy) == yset
        step = make_dense_step(i, j, ix_i, ix_j, iy, dims_i, dims_j)
        if lane_schedule:
            a = (step.ix_i, step.ix_j, step.iy, step.dims_i, step.dims_j)
            lane = (plan_gk_step(*a) or plan_lane_step(*a)
                    or plan_pair_step(*a)
                    # no-f-run residuals: one run-collapsed transpose of X
                    # into a GK-friendly order (iy unchanged)
                    or plan_gk_step_pre(*a))
            if lane is not None:
                step = dataclasses.replace(step, lane=lane)
            elif (max(size_i, size_j) >= gatherk.MIN_X_ELEMS
                  and not overridden):
                # dot fallback on a big operand: keep the transpose-free
                # natural order rather than pay a reorder of a big
                # intermediate; small steps keep the time order, and an
                # overridden step its negotiated order
                iy = preferred_output_order(ix_i, ix_j, yset,
                                            dims_i, dims_j)
                step = make_dense_step(i, j, ix_i, ix_j, iy,
                                       dims_i, dims_j)
            if (isinstance(lane, GKPlan)
                    and lane.pre is not None and lane.px is not None
                    and (_overrides is None
                         or produced_by.get(i if lane.w_is_j else j)
                         not in _overrides)):
                # ask X's producer to emit a GK-friendly order directly
                x_tid = i if lane.w_is_j else j
                ix_x0 = ix_i if lane.w_is_j else ix_j
                ix_w0 = ix_j if lane.w_is_j else ix_i
                rel_x = step.ix_i if lane.w_is_j else step.ix_j
                orig_of_x = dict(zip(rel_x, ix_x0))
                prod = produced_by.get(x_tid)
                if prod is not None and prod not in requests:
                    cands = _layout_request_candidates(
                        tuple(ix_x0), tuple(ix_w0), tuple(iy), dims,
                        fresh_of.get(x_tid, ()),
                        [orig_of_x[lab] for lab in lane.px])
                    if cands:
                        requests[prod] = cands
        bond_order[id(v)] = iy
        steps.append(step)
        sm, bg = (ix_j, ix_i) if size_i >= size_j else (ix_i, ix_j)
        fresh_of[i] = tuple(b for b in iy
                            if b in set(sm) and b not in set(bg))
        produced_by[i] = t
        if v is ctree.root:
            output_bonds = iy
    if lane_schedule:
        prune_lane_plans(steps)
    return steps, list(output_bonds), requests
