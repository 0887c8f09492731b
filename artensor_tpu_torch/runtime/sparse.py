"""Sparse-state (big-batch) scheme: thousands of bitstring amplitudes in one
contraction.

Port of ``artensor_tpu/runtime/sparse.py``.  An amplitude batch axis is threaded
through the contraction tree: every final-qubit tensor starts with a 2-row
batch (its output leg's two values), and each merge combines batch
metadata.  Three merge regimes:

  cross    both operands batched, and either every combination is needed or
           the cross product fits the memory budget: separate batch labels,
           reshape to one batch axis (left-major), optionally select the
           needed rows afterwards.
  aligned  both operands batched, cross product too big: per-target gather
           index arrays pick matching rows from each side and the product
           carries ONE shared batch label (the GGK / RGRow / RGFlat
           kernels, or chunked gather + dot where no kernel form fits).
  pass     at most one operand batched: the batch label rides along.

Everything the executor needs — index arrays, chunk boundaries, reshapes,
kernel plans — is computed here on the host with numpy.  Layouts are
time-ordered (every output's legs sorted by the step that contracts them),
and kernels are selected per step in the JAX order: gather-K, the lane
kernel (head orientation), the both-big pair kernel, the pre-permuted
gather-K form, and last the "retail" second chance: for a big step that
none of them took, the lane scheduler (``lanes.schedule_step``, both
orientations) chooses the step's output order and its kernel.  At the end
``prune_lane_plans`` caps the number of kernel steps.

``contraction_scheme_sparse`` runs the JAX flow with the JAX defaults: the
gate-block fusion pass (``fuse.py``) rewrites the contraction order, each
rewrite kept only if the compiled scheme's wall estimate drops
(``metrics.py``, the H100 model); then producer-order negotiation
(``negotiate.py``) searches the layout requests that ``_compile_sparse``
collects.  ``fuse=False, negotiate=False`` compiles the time-ordered
scheme alone.  Where the JAX compiler picks by an estimate (an aligned
step's target order, fusion, negotiation), this module asks the H100
model, so its choices may differ from the JAX package's; given the same
order and overrides, the steps are the JAX compiler's.
"""

from dataclasses import dataclass, field as dc_field
from math import ceil, log2

import numpy as np
import torch

from . import gatherk, lanes, tracing
# imported with this module, not at the first compile: fuse binds
# gatherk's size gate when it is imported
from .fuse import fuse_by_estimate
from .gatherk import (GGKPlan, GKPlan, apply_ggk_step, apply_gk_step,
                      plan_ggk_step, plan_gk_step, plan_gk_step_pre)
from .lanes import (LanePlan, PairPlan, apply_lane_step, apply_pair_step,
                    plan_lane_step, plan_pair_step, prune_lane_plans,
                    schedule_step)
from .lowering import apply_lowered, lower_step

# The retail second chance runs on steps whose larger operand (times its
# batch rows) has at least this many elements.
RETAIL_MIN_ELEMS = 1 << 20


@dataclass(frozen=True)
class SparseStep:
    i: int
    j: int
    ix_i: tuple          # int labels for buffer i (batch label first if batched)
    ix_j: tuple
    iy: tuple
    gathers: tuple | None    # aligned: ((gi, gj), ...) chunked index arrays
    reshape: tuple | None    # cross: physical (B_total, rest) after batch merge
    post_select: object      # cross: row-index array or None
    lowered: object          # Lowered (non-chunked) or None
    lowered_chunks: tuple | None  # aligned: one Lowered per chunk
    lane: object = None      # GKPlan / GGKPlan / LanePlan / PairPlan when a
                             # kernel runs
    note: str = None         # diagnostics: why no kernel plan was attached
    # device copies of the index arrays (``step_tables``), per device
    _dev: dict = dc_field(default_factory=dict, init=False, repr=False,
                          compare=False)


def _prod_dims(dim_of, bonds):
    return _prod(dim_of[b] for b in bonds)


def _prod(xs):
    p = 1
    for d in xs:
        p *= int(d)
    return p


def _bits_to_ints(bits):
    """(B, w) uint8 rows -> ints, MSB first. w may be 0 (-> zeros)."""
    if bits.shape[1] == 0:
        return np.zeros(bits.shape[0], dtype=np.int64)
    weights = 1 << np.arange(bits.shape[1] - 1, -1, -1, dtype=np.int64)
    return bits.astype(np.int64) @ weights


def _ints_to_bits(vals, width):
    vals = np.asarray(vals, dtype=np.int64)
    shifts = np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((vals[:, None] >> shifts) & 1).astype(np.uint8)


def _lookup_positions(haystack, needles):
    """Position of each needle in haystack (values unique in haystack)."""
    order = np.argsort(haystack, kind="stable")
    pos = np.searchsorted(haystack[order], needles)
    return order[pos]


def _relabel(*index_lists):
    lab = {}
    for ix in index_lists:
        for b in ix:
            lab.setdefault(b, len(lab))
    return tuple(tuple(lab[b] for b in ix) for ix in index_lists)


def _bond_contract_times(order, tensor_bonds):
    """For each bond, the step index at which it is contracted away (open
    legs are absent)."""
    bonds = {t: list(bs) for t, bs in tensor_bonds.items()}
    time_of = {}
    for t, (i, j) in enumerate(order):
        common = set(bonds[i]) & set(bonds[j])
        still = {
            b for b in common
            if any(b in bonds[t2] for t2 in bonds
                   if t2 not in (i, j) and bonds[t2])
        }
        for b in common - still:
            time_of[b] = t
        new_bonds = [b for b in bonds[i] if b not in common or b in still]
        new_bonds += [b for b in bonds[j]
                      if (b not in common or b in still)
                      and b not in new_bonds]
        bonds[i], bonds[j] = new_bonds, []
    return time_of


def _time_sorted_output(bond_i, bond_j, new_bonds, time_of, big_is_i,
                        full_sort=False, fresh_first=False):
    """Output order by time-to-contraction (soonest first, open legs last).

    ``full_sort`` (small tensors, or huge unbatched both-big merges, which
    the retail second chance then gives the pair kernel's (rows_i, rows_j)
    order): sort every leg.  Large tensors instead PRESERVE the big operand's surviving
    leg order and insert the small side's fresh bonds as one contiguous
    block at their earliest member's time position — which keeps each
    consumer's trailing free run an exact contiguous suffix of its X's
    storage, the shape the gather-K kernel wants.  ``fresh_first``
    (both-batched cross steps): fresh legs directly after the batch axes,
    survivors fully sorted.
    """
    INF = 1 << 60

    def tkey(b):
        return (time_of.get(b, INF), str(b))

    if full_sort:
        return sorted(new_bonds, key=tkey)
    xb = bond_i if big_is_i else bond_j
    wb = bond_j if big_is_i else bond_i
    nset = set(new_bonds)
    xset = set(xb)
    fresh = sorted((b for b in wb if b in nset and b not in xset), key=tkey)
    fset = set(fresh)
    others = [b for b in xb if b in nset and b not in fset]
    others += [b for b in new_bonds if b not in fset and b not in set(others)]
    if not fresh:
        return others
    if fresh_first:
        return fresh + sorted(others, key=tkey)
    fkey = min(tkey(b) for b in fresh)
    k = 0
    while k < len(others) and tkey(others[k]) < fkey:
        k += 1
    # never split the trailing minor run (~2^10 elements): an insertion
    # there would break this output's own f run for its consumer
    prod = 1
    kmin = len(others)
    while kmin > 0 and prod < (1 << 10):
        kmin -= 1
        prod *= 2
    k = min(k, kmin)
    return others[:k] + fresh + others[k:]


def contraction_scheme_sparse(ctree, bitstrings, sc_target=31,
                              lane_schedule=True, negotiate=True,
                              lane_max_steps=None, fuse=True):
    """Compile the big-batch scheme.

    Parameters
    ----------
    ctree : ContractionTree over the (sliced) sparse network; its
        ``tn.final_qubits`` holds, per qubit, the tensor id carrying that
        qubit's batch axis.
    bitstrings : list[str]
        Target amplitudes as '0'/'1' strings over all final qubits.
    sc_target : float
        log2 memory budget steering cross-vs-aligned and chunking decisions.
    lane_schedule : bool
        Time-ordered layouts and kernel plans (default).  False compiles
        the plain dot lowering only, in the reference's leg orders.
    negotiate : bool
        Producer-order negotiation (``runtime/negotiate.py``): pass 1
        compiles with time-ordered layouts and collects layout requests
        (a GK ``pre`` reorder, an RGRow's canonical rows, a pair or GK
        step's own blocking output order); pass 2 searches override sets
        and keeps the cheapest scheme by the wall estimate
        (``runtime/metrics.py``).
    lane_max_steps : int, optional
        Scheme-size cutoff above which kernel scheduling is skipped
        (default ``LANE_SCHEDULE_MAX_STEPS``).
    fuse : bool
        Gate-block fusion (``runtime/fuse.py``): reassociate small-operand
        chains so the big carrier is swept once per combined gate block;
        every candidate rewrite is kept only if the compiled scheme's wall
        estimate drops.

    Returns (steps, output_bonds, bitstrings_sorted).  The compile runs
    in a ``scheme.compile`` span, the two passes in ``scheme.fuse`` and
    ``scheme.negotiate`` spans under it (``scheme.compile_stats``).
    """
    with tracing.span("scheme.compile", kind="sparse"):
        order = None
        base_order = ctree.to_order_dfs()
        if fuse and lane_schedule and len(base_order) <= (
                lane_max_steps or LANE_SCHEDULE_MAX_STEPS):
            from .metrics import scheme_wall_estimate

            tn = ctree.tn
            targets = np.array([[int(c) for c in s] for s in bitstrings],
                               dtype=np.uint8)

            def estimate(o):
                s, *_ = _compile_sparse(ctree, bitstrings, sc_target,
                                        lane_schedule, None, lane_max_steps,
                                        _order=o)
                return scheme_wall_estimate(s, 0)[0]

            order = fuse_by_estimate(
                base_order, tn.tensor_bonds, tn.bond_dims, estimate,
                targets=targets,
                qubit_of_tensor={tid: (q,) for q, tid
                                 in enumerate(tn.final_qubits)})
        if not lane_schedule or not negotiate:
            steps1, ob1, bits1, _ = _compile_sparse(
                ctree, bitstrings, sc_target, lane_schedule, None,
                lane_max_steps, _order=order)
            return steps1, ob1, bits1
        from . import negotiate as _neg

        memo = {}

        def compile_fn(overrides):
            steps, ob, bits, req = _compile_sparse(
                ctree, bitstrings, sc_target, lane_schedule, overrides,
                lane_max_steps, _memo=memo, _order=order)
            return (steps, ob, bits), steps, req

        return _neg.negotiate(compile_fn)


_BATCH_LABELS = {"batch", "batch_i", "batch_j"}


def _layout_request_candidates(ix_x0, ix_w0, iy0, dim_of, h_block,
                               px_named):
    """Candidate output orders to request from X's producer, friendliest
    first.

    The minimal-hoist candidates keep X's stored order and move only the
    consumer-contract legs found inside the trailing suffix window (the
    part the consumer needs as a free run) to just before it, so an
    in-place GK producer keeps its f run, its grid legs and its H block
    (``h_block``; the insertion point steps before it rather than split
    it).  The full pre-permuted form ``px_named`` (every contract leg
    hoisted, tail in consumer-iy order) goes last: it suits the consumer
    but may cost the producer its own kernel."""
    x_named = [b for b in ix_x0 if b not in _BATCH_LABELS]
    if len(x_named) != len(ix_x0) - (1 if ix_x0 and ix_x0[0]
                                     in _BATCH_LABELS else 0):
        return ()               # batch label in a non-leading slot
    w_set = set(ix_w0)
    out_set = set(iy0)
    cset = {b for b in x_named if b in w_set and b not in out_set}
    hset = set(h_block)
    cands = []
    for target in (1 << 15, 1 << 12):
        F = 1
        k = len(x_named)
        while k > 0 and F < target:
            lab = x_named[k - 1]
            if lab not in cset:
                F *= dim_of.get(lab, 2)
            k -= 1
        hoisted = [lab for lab in x_named[k:] if lab in cset]
        if not hoisted or F < 128:
            continue
        # never split the producer's H block: if the window boundary
        # lands inside it, insert the hoisted legs before the whole block
        p = k
        hpos = [n for n, lab in enumerate(x_named) if lab in hset]
        if hpos and hpos[0] < k <= hpos[-1]:
            p = hpos[0]
        hset_h = set(hoisted)
        cand = (tuple(x_named[:p]) + tuple(hoisted)
                + tuple(lab for lab in x_named[p:] if lab not in hset_h))
        if len(cand) == len(x_named) and cand != tuple(x_named) \
                and cand not in cands:
            cands.append(cand)
    if px_named and px_named[0] in _BATCH_LABELS:
        px_named = px_named[1:]
    px = tuple(px_named)
    if px and not any(b in _BATCH_LABELS for b in px) and px not in cands:
        cands.append(px)
    return tuple(cands)


LANE_SCHEDULE_MAX_STEPS = 300


def _compile_sparse(ctree, bitstrings, sc_target, lane_schedule,
                    _overrides, lane_max_steps=None, _memo=None,
                    _order=None):
    """One compile of the scheme in the contraction order ``_order``
    (default the tree's DFS order), with the output orders of the steps
    in ``_overrides`` (step index -> bond order) replaced.  ``_memo``
    caches the batch metadata of both-batched steps by step index across
    negotiation trials.  Returns ``(steps, output_bonds,
    bitstrings_sorted, requests)``: ``requests`` maps a producer step's
    index to its candidate output orders (friendliest first)."""
    from .metrics import plan_seconds

    order = _order if _order is not None else ctree.to_order_dfs()
    if len(order) > (lane_max_steps or LANE_SCHEDULE_MAX_STEPS):
        lane_schedule = False
    tn = ctree.tn
    dim_of = {b: int(d) for b, d in tn.bond_dims.items()}
    bonds = {t: list(bs) for t, bs in tn.tensor_bonds.items()}
    # tn.final_qubits is qubit-indexed: final_qubits[q] = tensor id of
    # qubit q's batch axis.  Do NOT sort — sorting permutes the amplitudes.
    final_qubits = list(tn.final_qubits)
    qubit_of_tensor = {tid: q for q, tid in enumerate(final_qubits)}
    n_qubits = len(final_qubits)
    targets = np.array(
        [[int(c) for c in s] for s in bitstrings], dtype=np.uint8)
    if targets.shape[1] != n_qubits:
        raise ValueError("bitstring length differs from the qubit count")

    # per-tensor batch metadata: (sorted qubit ids, int-encoded partial reps)
    info = {}
    for tid in bonds:
        if tid in qubit_of_tensor:
            info[tid] = ([qubit_of_tensor[tid]],
                         np.array([0, 1], dtype=np.int64))
        else:
            info[tid] = ([], np.array([-1], dtype=np.int64))

    time_of = _bond_contract_times(order, tn.tensor_bonds) \
        if lane_schedule else {}
    steps = []
    last = None
    produced_by = {}     # tensor id -> index of the step that wrote it
    fresh_of = {}        # tensor id -> legs its producing step took from
                         # its small (W) operand: the producer kernel's H
                         # block, which any layout request keeps contiguous
    requests = {}        # producer step index -> candidate output orders
    overrides = _overrides or {}
    for t, (i, j) in enumerate(order):
        bond_i, bond_j = bonds[i], bonds[j]
        common = sorted(set(bond_i) & set(bond_j), key=str)
        still_used = {
            b for b in common
            if any(b in bonds[t2] for t2 in bonds
                   if t2 not in (i, j) and bonds[t2])
        }
        contracted = [b for b in common if b not in still_used]
        new_bonds = [b for b in bond_i if b not in contracted]
        new_bonds += [b for b in bond_j
                      if b not in contracted and b not in new_bonds]

        q_i, rep_i = info[i]
        q_j, rep_j = info[j]
        lane = None
        note = None
        if lane_schedule and new_bonds and bond_i and bond_j:
            size_i = len(rep_i) * _prod_dims(dim_of, bond_i) \
                if q_i else _prod_dims(dim_of, bond_i)
            size_j = len(rep_j) * _prod_dims(dim_of, bond_j) \
                if q_j else _prod_dims(dim_of, bond_j)
            new_bonds = _time_sorted_output(
                bond_i, bond_j, new_bonds, time_of,
                size_i >= size_j,
                full_sort=(max(size_i, size_j) < gatherk.MIN_X_ELEMS
                           or (not q_i and not q_j
                               and min(size_i, size_j) > gatherk.HK_CAP)),
                fresh_first=bool(q_i and q_j))
        if t in overrides and set(overrides[t]) == set(new_bonds):
            new_bonds = list(overrides[t])
        bonds[i], bonds[j] = new_bonds, []
        merged_q = sorted(q_i + q_j)
        gathers = reshape = None
        post_select = None
        batched_i, batched_j = len(q_i) > 0, len(q_j) > 0

        dims_bi = [dim_of[b] for b in bond_i]
        dims_bj = [dim_of[b] for b in bond_j]
        if not batched_i and not batched_j:
            rep = np.array([-1], dtype=np.int64)
            ix_i, ix_j, iy = tuple(bond_i), tuple(bond_j), tuple(new_bonds)
            dims_i, dims_j = tuple(dims_bi), tuple(dims_bj)
        elif batched_i != batched_j:
            rep = rep_i if batched_i else rep_j
            B = "batch"
            ix_i = (B, *bond_i) if batched_i else tuple(bond_i)
            ix_j = (B, *bond_j) if batched_j else tuple(bond_j)
            iy = (B, *new_bonds)
            dims_i = (len(rep_i), *dims_bi) if batched_i else tuple(dims_bi)
            dims_j = (len(rep_j), *dims_bj) if batched_j else tuple(dims_bj)
        else:
            # the batch-merge products depend only on the order's sets,
            # never on bond order: memoized by step index across
            # negotiation trials
            if _memo is not None and t in _memo:
                regime, rep, post_select, gathers = _memo[t]
            else:
                loc_i = [merged_q.index(q) for q in q_i]
                loc_j = [merged_q.index(q) for q in q_j]
                # unique required partial bitstrings over the merged
                # qubits, sorted lexicographically
                sub = np.unique(targets[:, merged_q], axis=0)
                need = _bits_to_ints(sub)
                full_cross = len(need) == 2 ** len(merged_q)
                cheap = len(merged_q) + len(new_bonds) <= sc_target
                if full_cross or cheap:
                    # ---- cross regime ---------------------------------
                    regime = "cross"
                    xb = _ints_to_bits(rep_i, len(q_i))
                    yb = _ints_to_bits(rep_j, len(q_j))
                    cross = np.zeros(
                        (len(rep_i), len(rep_j), len(merged_q)),
                        dtype=np.uint8)
                    cross[:, :, loc_i] = xb[:, None, :]
                    cross[:, :, loc_j] = yb[None, :, :]
                    rep = _bits_to_ints(cross.reshape(-1, len(merged_q)))
                    if len(need) != len(rep):
                        keep = np.sort(_lookup_positions(rep, need))
                        rep = rep[keep]
                        post_select = keep
                else:
                    # ---- aligned-gather regime ------------------------
                    regime = "aligned"
                    part_i = _bits_to_ints(sub[:, loc_i])
                    part_j = _bits_to_ints(sub[:, loc_j])
                    gi = _lookup_positions(rep_i, part_i)
                    gj = _lookup_positions(rep_j, part_j)
                    # target row order is free (downstream metadata
                    # matches by rep value): plan a kernel form under both
                    # lexsort orders and keep the cheaper estimate (gi-
                    # major on a tie); with no kernel form, sort by the
                    # larger-batch side's gather index
                    sort_idx = None
                    if lane_schedule:
                        best = None
                        for cand in (np.lexsort((gj, gi)),
                                     np.lexsort((gi, gj))):
                            p = plan_ggk_step(
                                tuple(bond_i), tuple(bond_j),
                                tuple(new_bonds), tuple(dims_bi),
                                tuple(dims_bj), gi[cand], gj[cand],
                                len(rep_i), len(rep_j))
                            if p is None:
                                continue
                            est = plan_seconds(p)
                            if best is None or est < best:
                                best, sort_idx = est, cand
                    if sort_idx is None:
                        major = gi if len(rep_i) >= len(rep_j) else gj
                        sort_idx = np.argsort(major, kind="stable")
                    gi, gj, rep = gi[sort_idx], gj[sort_idx], need[sort_idx]
                    B = len(rep)
                    overshoot = log2(B) + max(len(bond_i), len(bond_j)) \
                        - (sc_target - 2)
                    n_chunks = min(2 ** ceil(max(0.0, overshoot)), B)
                    if n_chunks > 1:
                        # ceil-based chunking covers ALL B rows
                        L = -(-B // n_chunks)
                        n_chunks = -(-B // L)
                        gathers = tuple(
                            (gi[c * L:(c + 1) * L], gj[c * L:(c + 1) * L])
                            for c in range(n_chunks))
                    else:
                        gathers = ((gi, gj),)
                if _memo is not None:
                    _memo[t] = (regime, rep, post_select, gathers)
            if regime == "cross":
                BI, BJ = "batch_i", "batch_j"
                ix_i, ix_j = (BI, *bond_i), (BJ, *bond_j)
                iy = (BI, BJ, *new_bonds)
                dims_i = (len(rep_i), *dims_bi)
                dims_j = (len(rep_j), *dims_bj)
                rest = _prod_dims(dim_of, new_bonds)
                # physical 2-D target merging the two batch axes (left-major)
                reshape = ((len(rep_i) * len(rep_j), rest)
                           if new_bonds else (len(rep_i) * len(rep_j),))
            else:
                Bl = "batch"
                ix_i, ix_j = (Bl, *bond_i), (Bl, *bond_j)
                iy = (Bl, *new_bonds)
                dims_i = dims_j = None  # chunked: dims vary per chunk

        iy0 = tuple(iy)
        ix_i0, ix_j0 = tuple(ix_i), tuple(ix_j)
        ix_i, ix_j, iy = _relabel(ix_i, ix_j, iy)
        if gathers is not None:
            lowered = None
            lowered_chunks = tuple(
                lower_step(ix_i, ix_j, iy,
                           (len(gi), *dims_bi), (len(gi), *dims_bj))
                for gi, gj in gathers)
            if lane_schedule:
                # the whole aligned merge as one kernel reading its rows
                # by index: no gathered copies, no chunks (the chunked
                # lowering stays as the fallback)
                gatherk.LAST_REJECT = None
                lane = plan_ggk_step(
                    tuple(bond_i), tuple(bond_j), tuple(new_bonds),
                    tuple(dims_bi), tuple(dims_bj),
                    np.concatenate([g[0] for g in gathers]),
                    np.concatenate([g[1] for g in gathers]),
                    len(rep_i), len(rep_j))
                if lane is None:
                    note = str(gatherk.LAST_REJECT)
                elif isinstance(lane.row, gatherk.RGRow):
                    # ask X's producer for the canonical rows (frees in
                    # iy order, contract in W's stored digit order), the
                    # JAX kernel's operand layout; the port's RGRow reads
                    # rows in stored order, so the estimate decides
                    rrow = lane.row
                    x_tid = i if lane.w_is_j else j
                    xb, wb = (bond_i, bond_j) if lane.w_is_j \
                        else (bond_j, bond_i)
                    cset = (set(xb) & set(wb)) - set(new_bonds)
                    frees = [lab for lab in new_bonds if lab in set(xb)]
                    cand_w = tuple(frees) + tuple(
                        lab for lab in wb if lab in cset)
                    cands = (cand_w,)
                    if rrow.px is not None and tuple(rrow.px) != cand_w:
                        cands += (tuple(rrow.px),)
                    cands = tuple(c for c in cands if c != tuple(xb))
                    prod = produced_by.get(x_tid)
                    if cands and prod is not None \
                            and prod not in requests \
                            and prod not in overrides:
                        requests[prod] = cands
        else:
            lowered = lower_step(ix_i, ix_j, iy, dims_i, dims_j)
            lowered_chunks = None
            if lane_schedule:
                # kernel selection against the (time-ordered) output order:
                # gather-K first (covers cross merges too — the two batch
                # axes are ordinary grid/H legs to it), then the lane
                # kernel, then the both-big pair kernel, then the
                # pre-permuted gather-K form
                gatherk.LAST_REJECT = None
                lane = plan_gk_step(ix_i, ix_j, iy, dims_i, dims_j)
                note = f"gk:{gatherk.LAST_REJECT}"
                if lane is None:
                    lanes.LAST_REJECT = None
                    lane = plan_lane_step(ix_i, ix_j, iy, dims_i, dims_j)
                    note += f"/v1:{lanes.LAST_REJECT}"
                if lane is None:
                    lane = plan_pair_step(ix_i, ix_j, iy, dims_i, dims_j)
                    note += f"/pair:{lanes.LAST_REJECT}"
                if lane is None:
                    gatherk.LAST_REJECT = None
                    lane = plan_gk_step_pre(ix_i, ix_j, iy, dims_i, dims_j)
                    note += f"/pregk:{gatherk.LAST_REJECT or 'no-form'}" \
                        if lane is None else "/pregk:ok"
                if lane is None and reshape is None and max(
                        _prod(dims_i), _prod(dims_j)) >= RETAIL_MIN_ELEMS:
                    # retail second chance: the lane scheduler chooses the
                    # output order, both orientations.  A batched big
                    # operand keeps its batch axis leading (pin); a batch
                    # label must stay the output's first axis.
                    big_i = _prod(dims_i) >= _prod(dims_j)
                    batch_rel = None
                    if batched_i or batched_j:
                        batch_rel = ix_i[0] if batched_i else ix_j[0]
                    pin = int(batch_rel is not None
                              and (batched_i if big_i else batched_j))
                    iy2, lane2 = schedule_step(
                        ix_i, ix_j, set(iy), dims_i, dims_j, pin=pin,
                        orientations=lanes.RETAIL)
                    if lane2 is not None and (batch_rel is None
                                              or iy2[0] == batch_rel):
                        lane = lane2
                        orig_of = dict(zip(iy, iy0))
                        new_bonds = [orig_of[lab] for lab in iy2
                                     if not str(orig_of[lab]).startswith(
                                         "batch")]
                        bonds[i] = new_bonds
                        iy = tuple(iy2)
                        lowered = lower_step(ix_i, ix_j, iy, dims_i, dims_j)
                        note += "/retail:ok"
                if (lane is None and "/pair:pair-iy" in note
                        and t not in overrides and t not in requests):
                    # the step's own output order blocks the pair kernel
                    # (iy interleaves the two operands' rows): request the
                    # grouped orders, each group time-sorted as before
                    set_bi = set(bond_i)
                    gi_ = [lab for lab in new_bonds if lab in set_bi]
                    gj_ = [lab for lab in new_bonds if lab not in set_bi]
                    if gi_ and gj_:
                        cands = tuple(
                            c for c in ((*gi_, *gj_), (*gj_, *gi_))
                            if c != tuple(new_bonds))
                        if cands:
                            requests[t] = cands
                if (lane is None and "h-contig" in note
                        and t not in overrides and t not in requests):
                    # time sorting scattered the small operand's fresh
                    # legs (the GK H block must be contiguous in iy):
                    # request this step's order with them grouped at their
                    # first occurrence
                    big_i = _prod_dims(dim_of, bond_i) * (
                        len(rep_i) if batched_i else 1) >= \
                        _prod_dims(dim_of, bond_j) * (
                        len(rep_j) if batched_j else 1)
                    wb = (set(bond_j) - set(bond_i)) if big_i \
                        else (set(bond_i) - set(bond_j))
                    hs = [lab for lab in new_bonds if lab in wb]
                    if 0 < len(hs) < len(new_bonds):
                        rest = [lab for lab in new_bonds if lab not in wb]
                        if batched_i != batched_j:
                            # iy leads with the batch axis, which counts
                            # as a fresh W leg too: the bond H legs must
                            # sit directly after it
                            pos = 0
                        else:
                            pos = sum(1 for lab in new_bonds[
                                :new_bonds.index(hs[0])] if lab not in wb)
                        cand = tuple(rest[:pos] + hs + rest[pos:])
                        if cand != tuple(new_bonds):
                            requests[t] = (cand,)
        if (isinstance(lane, GKPlan)
                and lane.pre is not None and lane.px is not None
                and produced_by.get(i if lane.w_is_j else j)
                not in overrides):
            # ask X's producer to emit a GK-friendly order directly
            x_tid = i if lane.w_is_j else j
            ix_x0 = ix_i0 if lane.w_is_j else ix_j0
            orig_of_x = dict(zip(ix_i if lane.w_is_j else ix_j, ix_x0))
            prod = produced_by.get(x_tid)
            if prod is not None and prod not in requests:
                cands = _layout_request_candidates(
                    ix_x0, ix_j0 if lane.w_is_j else ix_i0, iy0,
                    dim_of, fresh_of.get(x_tid, ()),
                    [orig_of_x[lab] for lab in lane.px])
                if cands:
                    requests[prod] = cands
        steps.append(SparseStep(i, j, ix_i, ix_j, iy,
                                gathers, reshape, post_select,
                                lowered, lowered_chunks, lane, note))
        info[i] = (merged_q, rep)
        produced_by[i] = t
        small_j = _prod_dims(dim_of, bond_i) >= _prod_dims(dim_of, bond_j)
        sm, bg = (bond_j, bond_i) if small_j else (bond_i, bond_j)
        fresh_of[i] = tuple(b for b in new_bonds
                            if b in set(sm) and b not in set(bg))
        last = i

    out_reps = info[last][1]
    bitstrings_sorted = ["".join(map(str, row))
                         for row in _ints_to_bits(out_reps, n_qubits)]
    if lane_schedule:
        prune_lane_plans(steps)
    return steps, bonds[last], bitstrings_sorted, requests


def kernel_kind(step):
    """'gk', 'ggk', 'rgrow', 'rgflat', 'lane', 'pair' or None: which
    kernel runs ``step``."""
    lane = step.lane
    if isinstance(lane, GKPlan):
        return "gk"
    if isinstance(lane, LanePlan):
        return "lane"
    if isinstance(lane, PairPlan):
        return "pair"
    if isinstance(lane, GGKPlan):
        return {gatherk.RGRow: "rgrow",
                gatherk.RGFlat: "rgflat"}.get(type(lane.row), "ggk")
    return None


def step_span(index, s, field):
    """The ``step`` span of the ``index``-th step ``s`` of a run, while
    tracing is enabled (else ``tracing.NULL``): attributes ``index`` and
    ``kind``, the kernel that runs it (``kernel_kind``) or "dot" for the
    dot fallback; a GK or GGK step's wrapper adds its ``form``."""
    if not tracing.ENABLED:
        return tracing.NULL
    kind = kernel_kind(s) if s.lane is not None and field.supports_lanes \
        else None
    return tracing.hot("step", index=index, kind=kind or "dot")


def step_tables(s, device):
    """The step's index arrays as int64 tensors on ``device``: the aligned
    chunks' ``(gi, gj)`` and the cross merge's ``post_select``, uploaded
    on the step's first run on that device and kept with the step."""
    key = str(device)
    if key not in s._dev:
        to = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                       dtype=torch.long).to(device)
        s._dev[key] = dict(
            gathers=None if s.gathers is None
            else tuple((to(gi), to(gj)) for gi, gj in s.gathers),
            post_select=None if s.post_select is None
            else to(s.post_select))
    return s._dev[key]


def apply_sparse_step(field, x, y, s, bx=False, by=False):
    """One sparse step on flat-stored field tensors.  ``bx`` / ``by``: the
    operand carries a leading slice-width axis (so does the result, if
    either does).  The step's kernel runs only where the field supports
    the kernels (split, float32 storage of complex64); any other field
    runs its lowered form (``s.lowered`` / ``s.lowered_chunks``), as the
    JAX package does."""
    lead = bx or by
    kernels_ok = s.lane is not None and field.supports_lanes
    if s.gathers is not None:
        if kernels_ok:
            return apply_ggk_step(field, x, y, s.lane, bx, by)
        gathers = step_tables(s, field.device(x))["gathers"]
        parts = [
            apply_lowered(field, field.take(x, gi, axis=int(bx)),
                          field.take(y, gj, axis=int(by)), low, bx, by)
            for (gi, gj), low in zip(gathers, s.lowered_chunks)
        ]
        return parts[0] if len(parts) == 1 \
            else field.concat(parts, axis=int(lead))
    if kernels_ok and isinstance(s.lane, GKPlan):
        out = apply_gk_step(field, x, y, s.lane, bx, by)
    elif kernels_ok and isinstance(s.lane, LanePlan):
        out = apply_lane_step(field, x, y, s.lane, bx, by)
    elif kernels_ok:
        out = apply_pair_step(field, x, y, s.lane, bx, by)
    else:
        out = apply_lowered(field, x, y, s.lowered, bx, by)
    if s.reshape is not None:
        w = (field.leading(out),) if lead else ()
        out = field.reshape(out, w + s.reshape)
    if s.post_select is not None:
        out = field.take(out,
                         step_tables(s, field.device(out))["post_select"],
                         axis=int(lead))
    return out


def execute_sparse(tensors, steps, field, batched=()):
    """Run a sparse scheme over staged (flat) field tensors.  ``batched``:
    ids of the buffers that carry a leading slice-width axis.  Returns
    ``(result, result_is_batched)``.  Each step runs in a ``step`` span
    while tracing is enabled (``step_span``)."""
    bufs = list(tensors)
    bat = set(batched)
    last = 0
    for n, s in enumerate(steps):
        bi, bj = s.i in bat, s.j in bat
        with step_span(n, s, field):
            bufs[s.i] = apply_sparse_step(field, bufs[s.i], bufs[s.j], s,
                                          bi, bj)
        bufs[s.j] = None
        if bj:
            bat.add(s.i)
        last = s.i
    return bufs[last], last in bat


def tensor_contraction_sparse(tensors, steps, field=None, device="cuda"):
    """Contract numpy ``tensors`` by sparse ``steps`` on ``device``
    (nothing sliced); returns the result as numpy, flat physical."""
    from ..ops.field import make_field
    from ..simulation import require_device

    field = field or make_field()
    dev = require_device(device)
    staged = [field.wrap(t, dev) for t in tensors]
    out, _ = execute_sparse(staged, steps, field)
    return field.unwrap(out)


def scheme_digest(steps):
    """SHA-1 over every step's operand pair, output order and kernel kind:
    two compiles with equal digests made the same scheme decisions."""
    import hashlib
    import json

    rows = [[s.i, s.j, [str(lab) for lab in s.iy], kernel_kind(s)]
            for s in steps]
    return hashlib.sha1(json.dumps(rows).encode()).hexdigest()
