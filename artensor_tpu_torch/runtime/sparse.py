"""Sparse-state (big-batch) scheme: thousands of bitstring amplitudes in one
contraction.

Port of ``artensor_tpu/runtime/sparse.py`` in its ``fuse=False,
negotiate=False`` configuration.  An amplitude batch axis is threaded
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

Not ported yet (a later slice): the gate-block fusion pass (``fuse.py``),
producer-order negotiation (``negotiate.py``) and the layout requests that
feed it, and the calibrated ``metrics.py``.  Where the JAX compiler picks
by an estimate — the lexsort of an aligned step's targets — this module
takes a fixed rule (see ``_compile_sparse``).
"""

from dataclasses import dataclass
from math import ceil, log2

import numpy as np

from . import gatherk, lanes
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
                              lane_schedule=True):
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

    Returns (steps, output_bonds, bitstrings_sorted).
    """
    return _compile_sparse(ctree, bitstrings, sc_target, lane_schedule)


def _compile_sparse(ctree, bitstrings, sc_target, lane_schedule):
    order = ctree.to_order_dfs()
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
    for i, j in order:
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
        bonds[i], bonds[j] = new_bonds, []
        merged_q = sorted(q_i + q_j)
        gathers = reshape = None
        post_select = None
        ggk = None
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
            loc_i = [merged_q.index(q) for q in q_i]
            loc_j = [merged_q.index(q) for q in q_j]
            # unique required partial bitstrings over the merged qubits,
            # sorted lexicographically
            sub = np.unique(targets[:, merged_q], axis=0)
            need = _bits_to_ints(sub)
            full_cross = len(need) == 2 ** len(merged_q)
            cheap = len(merged_q) + len(new_bonds) <= sc_target
            if full_cross or cheap:
                # ---- cross regime ---------------------------------------
                xb = _ints_to_bits(rep_i, len(q_i))
                yb = _ints_to_bits(rep_j, len(q_j))
                cross = np.zeros((len(rep_i), len(rep_j), len(merged_q)),
                                 dtype=np.uint8)
                cross[:, :, loc_i] = xb[:, None, :]
                cross[:, :, loc_j] = yb[None, :, :]
                rep = _bits_to_ints(cross.reshape(-1, len(merged_q)))
                if len(need) != len(rep):
                    keep = np.sort(_lookup_positions(rep, need))
                    rep = rep[keep]
                    post_select = keep
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
                # ---- aligned-gather regime ------------------------------
                part_i = _bits_to_ints(sub[:, loc_i])
                part_j = _bits_to_ints(sub[:, loc_j])
                gi = _lookup_positions(rep_i, part_i)
                gj = _lookup_positions(rep_j, part_j)
                # target row order is free (downstream metadata matches by
                # rep VALUE).  Fixed rule in place of the JAX estimate
                # pick: when a kernel form plans (a GK row, RGRow or
                # RGFlat: plan_ggk_step tries all three), order the targets
                # gi-major (lexsort by (gi, gj)) so consecutive rows share
                # the big side's gathered row in cache; else sort by the
                # larger-batch side's gather index (the JAX fallback)
                sort_idx = None
                if lane_schedule:
                    cand = np.lexsort((gj, gi))
                    gatherk.LAST_REJECT = None
                    ggk = plan_ggk_step(
                        tuple(bond_i), tuple(bond_j), tuple(new_bonds),
                        tuple(dims_bi), tuple(dims_bj), gi[cand], gj[cand],
                        len(rep_i), len(rep_j))
                    if ggk is not None:
                        sort_idx = cand
                    else:
                        note = str(gatherk.LAST_REJECT)
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
                Bl = "batch"
                ix_i, ix_j = (Bl, *bond_i), (Bl, *bond_j)
                iy = (Bl, *new_bonds)

        iy0 = tuple(iy)
        ix_i, ix_j, iy = _relabel(ix_i, ix_j, iy)
        if gathers is not None:
            lowered = None
            lowered_chunks = tuple(
                lower_step(ix_i, ix_j, iy,
                           (len(gi), *dims_bi), (len(gi), *dims_bj))
                for gi, gj in gathers)
            lane = ggk
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
                        new_bonds = [orig_of[l] for l in iy2
                                     if not str(orig_of[l]).startswith(
                                         "batch")]
                        bonds[i] = new_bonds
                        iy = tuple(iy2)
                        lowered = lower_step(ix_i, ix_j, iy, dims_i, dims_j)
                        note += "/retail:ok"
        steps.append(SparseStep(i, j, ix_i, ix_j, iy,
                                gathers, reshape, post_select,
                                lowered, lowered_chunks, lane, note))
        info[i] = (merged_q, rep)
        last = i

    out_reps = info[last][1]
    bitstrings_sorted = ["".join(map(str, row))
                         for row in _ints_to_bits(out_reps, n_qubits)]
    if lane_schedule:
        prune_lane_plans(steps)
    return steps, bonds[last], bitstrings_sorted


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


def apply_sparse_step(field, x, y, s, bx=False, by=False):
    """One sparse step on flat-stored field tensors.  ``bx`` / ``by``: the
    operand carries a leading slice-width axis (so does the result, if
    either does)."""
    lead = bx or by
    kernels_ok = s.lane is not None and field.supports_lanes
    if s.gathers is not None:
        if kernels_ok:
            return apply_ggk_step(field, x, y, s.lane, bx, by)
        parts = [
            apply_lowered(field, field.take(x, gi, axis=int(bx)),
                          field.take(y, gj, axis=int(by)), low, bx, by)
            for (gi, gj), low in zip(s.gathers, s.lowered_chunks)
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
        w = (out[0].shape[0],) if lead else ()
        out = field.reshape(out, w + s.reshape)
    if s.post_select is not None:
        out = field.take(out, s.post_select, axis=int(lead))
    return out


def execute_sparse(tensors, steps, field, batched=()):
    """Run a sparse scheme over staged (flat) field tensors.  ``batched``:
    ids of the buffers that carry a leading slice-width axis.  Returns
    ``(result, result_is_batched)``."""
    bufs = list(tensors)
    bat = set(batched)
    last = 0
    for s in steps:
        bi, bj = s.i in bat, s.j in bat
        bufs[s.i] = apply_sparse_step(field, bufs[s.i], bufs[s.j], s, bi, bj)
        bufs[s.j] = None
        if bj:
            bat.add(s.i)
        last = s.i
    return bufs[last], last in bat
