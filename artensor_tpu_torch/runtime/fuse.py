"""Small-operand reassociation: ((X.W1).W2) -> (X.(W1.W2)).

Port of ``artensor_tpu/runtime/fuse.py``.  The sparse scheme's hot steps
are gather-K merges of a big carrier X against small gate-block tensors W,
and chains of them re-write and re-read the carrier once per step.  A
contraction tree consumes every intermediate exactly once, so two
consecutive merges onto the same carrier can be reassociated: contract the
two small tensors first (a tiny step) and sweep the carrier once with the
combined gate block.  Flops grow (the combined W has more fresh legs) but
one carrier read + write pass goes, a win while the merged step stays
bound by its bytes.

Batched (final-qubit) tensors fuse too: the batch cross-products are
associative, and the scheme compiler re-derives all batch metadata from the
rewritten order.  Sizes are rep-aware through ``rep_count`` (unique needed
partial bitstrings over a tensor's qubit set).

The pass rewrites the planner order before scheme compilation and is
deterministic.  The rewrite search (``_Sim``, ``_try_rewrite``,
``reassociate_small_chains``) is the JAX logic unchanged; the candidate
model ``_sweep_cost`` reads the card's rates (``HBM_BYTES_PER_S``,
``FLOPS_PER_S``, ``K_FULL``), and every candidate is arbitrated by the
caller: ``fuse_by_estimate`` keeps a rewrite only if the compiled
scheme's wall estimate drops, for the dense and the sparse compile alike.
"""

from functools import reduce
from operator import mul

from .. import kernels
from . import tracing
from .gatherk import HK_CAP as W_CAP, MIN_X_ELEMS

COMPUTE_SLACK = 1.3      # merged step must stay (nearly) traffic-bound
MAX_REWRITES = 64
# the card's rates for the candidate model: the memory rate, and the GK
# mma form's design rate (3xTF32: three TF32 products a float32 one)
HBM_BYTES_PER_S = kernels.H100_HBM_BYTES_PER_S
FLOPS_PER_S = kernels.H100_TF32_FLOP_PER_S / 3
# contraction width at which the product unit runs full: the tensor cores
# take K in steps of 8 (mma m16n8k8), so K >= 8 (and the model's floor of
# 16) never discounts the rate; a systolic unit 128 wide would
K_FULL = 16


def _prod(xs):
    return reduce(mul, xs, 1)


def _sweep_cost(x_elems, y_elems, w_elems, K, H):
    """Rough gather-K step model: device bytes against product time.  The
    product rate is discounted by ``min(1, qbK / K_FULL)`` with the
    effective width floored at 2*K (re/im doubling) and 16."""
    traffic = 8.0 * (x_elems + y_elems + w_elems) / HBM_BYTES_PER_S
    qbK = min(128, max(2 * K, 16))
    compute = 8.0 * x_elems * H / (FLOPS_PER_S * min(1.0, qbK / K_FULL))
    return max(traffic, compute), traffic, compute


class _Sim:
    """Symbolic executor state: per-tensor bond lists + qubit sets, with
    rep-aware effective sizes."""

    def __init__(self, tensor_bonds, dim_of, qubits_of, rep_count):
        self.bonds = {t: list(bs) for t, bs in tensor_bonds.items()}
        self.dim_of = dim_of
        self.qubits = {t: frozenset(qubits_of.get(t, ()))
                       for t in tensor_bonds}
        self.rep_count = rep_count

    def copy(self):
        s = _Sim({}, self.dim_of, {}, self.rep_count)
        s.bonds = {t: list(bs) for t, bs in self.bonds.items()}
        s.qubits = dict(self.qubits)
        return s

    def size(self, tid):
        base = _prod(self.dim_of[b] for b in self.bonds[tid])
        return base * self.rep_count(self.qubits[tid])

    def result_bonds(self, i, j):
        bi, bj = self.bonds[i], self.bonds[j]
        common = set(bi) & set(bj)
        still = {b for b in common
                 if any(b in self.bonds[t2] for t2 in self.bonds
                        if t2 not in (i, j) and self.bonds[t2])}
        keep = [b for b in bi if b not in common or b in still]
        keep += [b for b in bj if (b not in common or b in still)
                 and b not in keep]
        return keep

    def apply(self, i, j):
        out = self.result_bonds(i, j)
        self.bonds[i] = out
        self.bonds[j] = []
        self.qubits[i] = self.qubits[i] | self.qubits[j]
        self.qubits[j] = frozenset()
        return out


def _try_rewrite(order, t, sim):
    """Evaluate reassociating step ``t``'s small operand W1 into a LATER
    sweep of the same carrier.  ``sim`` is the state BEFORE step t.

    Sweeps whose gate blocks share no legs commute, so W1 may defer past
    any number of disjoint sweeps and merge with the first DOWNSTREAM
    block it overlaps (or any disjoint one whose combined block still
    fits) — the walk stops at the first block sharing a leg with W1
    (beyond it the rewritten intermediate sweeps would leave that shared
    bond dangling) and at the step where the carrier's id moves.

    Returns the new order or None."""
    dim_of = sim.dim_of
    a1, b1 = order[t]
    sz_a, sz_b = sim.size(a1), sim.size(b1)
    xid, w1 = (a1, b1) if sz_a >= sz_b else (b1, a1)
    x_el, w1_el = max(sz_a, sz_b), min(sz_a, sz_b)
    if x_el < MIN_X_ELEMS or not 0 < w1_el <= W_CAP:
        return None
    r1 = a1
    w1_bonds = list(sim.bonds[w1])
    w1_q = sim.qubits[w1]
    set_w1 = set(w1_bonds)

    # cost of the sweep being deferred (for the est gate)
    x_bonds = list(sim.bonds[xid])
    set_x = set(x_bonds)
    y1 = sim.result_bonds(a1, b1)
    y1_el = _prod(dim_of[x] for x in y1) \
        * sim.rep_count(sim.qubits[a1] | sim.qubits[b1])
    k1 = _prod(dim_of[x] for x in (set_x & set_w1) - set(y1))
    h1 = max(w1_el // max(k1, 1), 1)
    sweep1 = _sweep_cost(x_el, y1_el, w1_el, k1, h1)[0]

    # forward walk in the DEFERRED order (step t dropped, W1 unapplied):
    # every consumer of r1 is a merge candidate; the walk MUST stop when
    # (a) the consumer's other operand shares a leg with W1 (past it the
    # deferred intermediate sweep would leave that bond dangling),
    # (b) the consumer stores its result somewhere other than r1 (the
    # carrier id the later steps reference), or (c) r1 is the SMALL
    # operand's id (r1 != xid: the carrier data would not live at the id
    # the intermediate steps reference) — then only the first consumer
    # is a valid candidate.
    # deferring W1 rescales every intermediate sweep's carrier by
    # 1/growth (growth = y1/x): a growing W1 (h1 > k1) makes deferred
    # intermediates CHEAPER, a shrinking one dearer — credit the
    # difference to the est gate
    growth = y1_el / max(x_el, 1)
    inter_bonus = 0.0
    fwd = sim.copy()
    for u in range(t + 1, len(order)):
        if r1 not in order[u]:
            fwd.apply(*order[u])
            continue
        a2, b2 = order[u]
        w2 = b2 if a2 == r1 else a2
        last = (order[u][0] != r1 or r1 != xid
                or bool(set(fwd.bonds[w2]) & set_w1))
        ok = w2 != w1 and (fwd.bonds[w2] or fwd.qubits[w2])
        if ok:
            w2_bonds = list(fwd.bonds[w2])
            w2_el = fwd.size(w2)
            ok = 0 < w2_el <= W_CAP
        if ok:
            set_w2 = set(w2_bonds)
            # deferred carrier size at u (the merged sweep's true input);
            # the ORIGINAL sweep at u read it with W1 already applied,
            # i.e. scaled by W1's growth factor
            x_def = fwd.size(r1) if r1 == xid else x_el
            orig2_in = max(x_def * growth, y1_el)
            common_w = set_w1 & set_w2
            # a bond held by w1, w2 AND a third live tensor (the carrier
            # included — hyper-bonds) stays open at the wmerge
            still_w = {bo for bo in common_w
                       if any(bo in fwd.bonds[t3] for t3 in fwd.bonds
                              if t3 not in (w1, w2)
                              and fwd.bonds[t3])}
            wm = [bo for bo in w1_bonds
                  if bo not in common_w or bo in still_w]
            wm += [bo for bo in w2_bonds
                   if (bo not in common_w or bo in still_w)
                   and bo not in wm]
            wm_q = w1_q | fwd.qubits[w2]
            wm_el = _prod(dim_of[x] for x in wm) * fwd.rep_count(wm_q)
            # the merged sweep's TRUE output: materialize W' on w2's
            # slot, then apply the pair merge rule — the deferred-state
            # output would keep W1's carrier-contract legs open and
            # misclassify them as fresh (64x overcounted compute)
            tmp = fwd.copy()
            tmp.bonds[w2] = list(wm)
            tmp.qubits[w2] = wm_q
            tmp.bonds[w1] = []          # absorbed into W' — its legs
            tmp.qubits[w1] = frozenset()  # must not read as still-used
            y2m = tmp.result_bonds(a2, b2)
            y2_q = tmp.qubits[a2] | tmp.qubits[b2]
            y2_el = _prod(dim_of[x] for x in y2m) * fwd.rep_count(y2_q)
            cid = b2 if w2 == a2 else a2
            km = _prod(dim_of[x] for x in
                       (set(wm) & set(tmp.bonds[cid])) - set(y2m))
            # the original sweep at u has the same output legs (both
            # orders finish with identical tensors)
            k2 = _prod(dim_of[x] for x in
                       ((set(fwd.bonds[r1]) | set(y1)) & set_w2)
                       - set(y2m))
            h2 = max(w2_el // max(k2, 1), 1)
            if wm_el <= W_CAP and km > 1:
                hm = max(wm_el // km, 1)
                before = sweep1 + _sweep_cost(orig2_in, y2_el, w2_el,
                                              k2, h2)[0] + inter_bonus
                est_m, traf_m, comp_m = _sweep_cost(x_def, y2_el,
                                                    wm_el, km, hm)
                if est_m < before and comp_m <= COMPUTE_SLACK * traf_m:
                    # rewrite: drop t; insert [wmerge, final] at u.
                    # Result ids preserved: final produces at u[0].
                    if r1 == xid:
                        wmerge = (w2, w1)   # W' at w2, a member of u
                        final = (a2, b2)
                    else:       # r1 == w1: u = {w1, w2}, X untouched
                        r2 = a2
                        other = w1 if r2 == w2 else w2
                        wmerge = (r2, other)
                        final = (r2, xid)
                    return order[:t] + order[t + 1:u] \
                        + [wmerge, final] + order[u + 1:]
        if last:
            return None
        # this sweep stays intermediate: credit/charge the carrier-size
        # difference vs the original order (deferred = original/growth)
        in_def = fwd.size(r1)
        fwd.apply(*order[u])
        out_def = fwd.size(r1)
        inter_bonus += 8.0 * (in_def + out_def) * (growth - 1.0) \
            / HBM_BYTES_PER_S
    return None


def reassociate_small_chains(order, tensor_bonds, bond_dims,
                             batched_tensors=(), targets=None,
                             qubit_of_tensor=None, accept=None):
    """Return a rewritten order with est-winning reassociations applied.

    ``batched_tensors``: qubit-indexed iterable of tensor ids carrying
    an amplitude-batch axis (``tn.final_qubits`` in sparse mode).
    ``targets``: the (n_bitstrings, n_qubits) uint8 target matrix; with
    it, effective sizes are rep-aware (unique needed partial bitstrings
    over each tensor's qubit set) and batched gate blocks fuse too.
    Without it, batched tensors are counted at rep multiplicity 1 —
    fine for the dense path where no batch exists.
    ``accept``: optional arbiter called with each candidate order; the
    rewrite is kept only if it returns True.  The caller typically
    compiles the candidate and compares the real wall estimate — the
    internal traffic model generates candidates but cannot see kernel
    eligibility or layout effects.
    """
    order = [tuple(p) for p in order]
    dim_of = {b: int(d) for b, d in bond_dims.items()}
    if qubit_of_tensor is None:
        qubit_of_tensor = {tid: (q,)
                           for q, tid in enumerate(batched_tensors)}
    rep_cache = {}

    def rep_count(qset):
        if not qset:
            return 1
        if targets is None:
            return 2 ** min(len(qset), 30)   # unknown: worst-case cross
        key = qset
        if key not in rep_cache:
            import numpy as np
            cols = sorted(qset)
            rep_cache[key] = int(
                len(np.unique(targets[:, cols], axis=0)))
        return rep_cache[key]

    rejected = set()
    for _ in range(MAX_REWRITES):
        sim = _Sim(tensor_bonds, dim_of, qubit_of_tensor, rep_count)
        new_order = None
        for t in range(len(order)):
            cand = _try_rewrite(order, t, sim)
            if cand is not None:
                key = tuple(cand)
                if key not in rejected:
                    if accept is None or accept(cand):
                        new_order = cand
                        break
                    rejected.add(key)
            sim.apply(*order[t])
        if new_order is None:
            return order
        order = new_order
    return order


def fuse_by_estimate(order, tensor_bonds, bond_dims, estimate, **kwargs):
    """``reassociate_small_chains(order, tensor_bonds, bond_dims,
    **kwargs)`` with each candidate rewrite kept only if ``estimate`` of
    it drops: ``estimate(candidate_order)`` compiles the candidate and
    returns its wall estimate, ``estimate(None)`` the scheme of ``order``
    (made lazily: no candidate, no compile).  Runs in a ``scheme.fuse``
    span whose attributes ``compiles`` and ``rewrites`` count the trial
    compiles and the rewrites kept."""
    with tracing.span("scheme.fuse", compiles=0, rewrites=0) as sp:
        best = []

        def est(o):
            sp.attrs["compiles"] += 1
            return estimate(o)

        def accept(cand):
            if not best:
                best.append(est(None))
            e = est(cand)
            if e < best[0]:
                best[0] = e
                sp.attrs["rewrites"] += 1
                return True
            return False

        return reassociate_small_chains(order, tensor_bonds, bond_dims,
                                        accept=accept, **kwargs)
