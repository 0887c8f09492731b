"""Producer-layout negotiation: a bounded best-first search over sets of
output-order overrides.

Port of ``artensor_tpu/runtime/negotiate.py``, the search unchanged, over
the port's wall estimate (``runtime/metrics.py``).  Pass 1 compiles with
time-ordered layouts and collects layout requests: wherever the
pre-permuted gather-K form fired (a reorder of X before the kernel), X's
producer is asked to emit that order directly; a step whose own output
order blocks the pair kernel or scatters the gather-K H block asks for a
grouped order; an RGRow step asks X's producer for its canonical rows.

Moves: a strict win (the estimate drops) and a wash (the copy relocates
onto the producer, estimate about equal), explored because the relocated
copy raises a new request one link up the chain.  A candidate that
unlocks a kernel on a hot dot fallback step often regresses the estimate
at its first hop, so a bounded greedy chain is seeded from each such
candidate (phase 2).  Hard guard everywhere: no step that had a kernel in
pass 1 may lose it.  Only a strictly better final state is committed.
"""

from . import tracing

HOT_SHARE = 0.02     # a pass-1 dot fallback step is chain-seed-worthy
                     # when its modeled time exceeds this share of the
                     # scheme


def negotiate(compile_fn, max_trials=40, chain_budget=100,
              time_budget_s=90.0):
    """Run the override search.

    ``compile_fn(overrides_or_None)`` must return
    ``(result, steps, requests)`` where ``result`` is whatever the
    caller wants back, ``steps`` carry ``.lane`` attributes, and
    ``requests`` maps producer step index -> tuple of candidate output
    bond orders (friendliest first).  Returns the best ``result`` by
    the calibrated wall estimate.

    ``time_budget_s`` bounds the whole search by wall clock (a trial
    compile grows with the bitstring count), so the result may depend on
    the host's speed when a search reaches it.  Phase 0 (the
    highest-value accumulation) runs first and each later phase checks
    the clock.  The search runs in a ``scheme.negotiate`` span whose
    attribute ``compiles`` counts the calls of ``compile_fn``.
    """
    with tracing.span("scheme.negotiate", compiles=0) as sp:
        def counted(overrides):
            sp.attrs["compiles"] += 1
            return compile_fn(overrides)

        return _search(counted, max_trials, chain_budget, time_budget_s)


def _search(compile_fn, max_trials, chain_budget, time_budget_s):
    import time as _time

    from .metrics import scheme_wall_components, scheme_wall_estimate

    res1, steps1, requests = compile_fn(None)
    if not requests:
        return res1
    t_start = _time.monotonic()

    def _over_budget():
        return _time.monotonic() - t_start > time_budget_s

    est1 = scheme_wall_estimate(steps1, 0)[0]
    eps = est1 * 1e-6
    # exploration-only tolerance for washes: a relocated pre-transpose
    # lands on a DIFFERENT buffer, so its cost is near-equal, not equal.
    # Commits still require a strictly better estimate.
    wash_tol = est1 * 1e-3
    kern1 = [s.lane is not None for s in steps1]
    state = {"best": res1, "best_est": est1, "compiles": 0}
    cache = {}

    def _eval(trial):
        """Returns (res, steps, req, est, lost, compiled) — ``compiled``
        False on a cache hit, so budgets only count real work."""
        key = frozenset(trial.items())
        if key in cache:
            return cache[key] + (False,)
        res2, steps2, req2 = compile_fn(trial)
        state["compiles"] += 1
        lost = any(k and s.lane is None for k, s in zip(kern1, steps2))
        est2 = scheme_wall_estimate(steps2, 0)[0]
        out = (res2, steps2, req2, est2, lost)
        cache[key] = out
        if not lost and est2 < state["best_est"] - eps:
            state["best"], state["best_est"] = res2, est2
        return out + (True,)

    # ---- phase 0: greedy union of independently-winning single moves -----
    # Schemes often carry MANY independent pre-transpose removals (the
    # dense block scheme: 17 requests, 8+ disjoint single-move wins);
    # best-first alone burns its trial budget scanning one node's
    # candidates.  Evaluate each request's best single candidate, then
    # accumulate the winners in ascending-estimate order, keeping each
    # addition only if the combined scheme still improves.
    singles = []
    for t_req, cands in requests.items():
        if _over_budget():
            break
        best_c = None
        for want in cands:
            if _over_budget():
                break
            _res2, _s2, _r2, est2, lost, _c = _eval({t_req: want})
            if not lost and est2 < est1 - eps and (
                    best_c is None or est2 < best_c[1]):
                best_c = (want, est2)
        if best_c is not None:
            singles.append((best_c[1], t_req, best_c[0]))
    singles.sort(key=lambda s: s[0])
    acc0, est0, req0 = {}, est1, requests
    for _e, t_req, want in singles:
        if _over_budget():
            break
        trial = dict(acc0)
        trial[t_req] = want
        _res2, _s2, req2, est2, lost, _c = _eval(trial)
        if not lost and est2 < est0 - eps:
            acc0, est0 = trial, est2
            req0 = dict(requests)
            req0.update(req2)

    # ---- phase 1: best-first over strict wins and washes -----------------
    # both the accumulated phase-0 state AND the bare root stay on the
    # frontier: a phase-0 single win through a step must not shadow a
    # different candidate of the same step whose chain resolves better
    seen = {frozenset(), frozenset(acc0.items())}
    frontier = [(est0, 0, acc0, req0)]
    if acc0:
        frontier.append((est1, 0, {}, requests))
    trials = 0
    stop = False
    while frontier and not stop:
        frontier.sort(key=lambda f: (f[0], f[1], len(f[2])))
        est, _, acc, pend = frontier.pop(0)
        for t_req, cands in pend.items():
            if t_req in acc:
                continue
            if stop:
                break
            for want in cands:
                if trials >= max_trials or _over_budget():
                    stop = True
                    break
                trial = dict(acc)
                trial[t_req] = want
                key = frozenset(trial.items())
                if key in seen:
                    continue
                seen.add(key)
                _res2, steps2, req2, est2, lost, compiled = _eval(trial)
                if compiled:
                    trials += 1
                if lost or est2 > est + wash_tol:
                    continue
                merged = dict(pend)
                merged.update(req2)
                frontier.append((est2, trials, trial, merged))
                if est2 < est - eps:
                    break       # strict win at this node: stop scanning
                                # weaker candidates (washes stay queued)

    # ---- phase 2: kernel-unlocking chains on hot dot steps ---------------
    def _step_est(s):
        k_s, x_s, _b, _n = scheme_wall_components([s])
        return k_s + x_s

    per_slice = sum(_step_est(s) for s in steps1) or 1.0
    seeds = [t for t in requests
             if t < len(steps1) and steps1[t].lane is None
             and _step_est(steps1[t]) >= HOT_SHARE * per_slice]
    budget = chain_budget
    for t0 in seeds:
        for want0 in requests[t0]:
            if budget <= 0 or _over_budget():
                break
            _r, steps2, req2, est2, lost, compiled = _eval({t0: want0})
            if compiled:
                budget -= 1
            if lost or steps2[t0].lane is None or est2 > est1 * 1.05:
                continue        # the seed must actually unlock the kernel
            # chain on TOP of phase 0's accumulated wins (independent
            # wins and the chain compose; the seed alone rarely beats
            # the accumulated state)
            trial0 = dict(acc0)
            trial0[t0] = want0
            _r, steps2, req2b, est2b, lost2b, compiled = _eval(trial0)
            if compiled:
                budget -= 1
            if not lost2b and steps2[t0].lane is not None \
                    and est2b <= est2 + eps:
                acc, pend, est = trial0, dict(req0), est2b
                pend.update(req2b)
            else:
                acc, pend, est = {t0: want0}, req2, est2
            washes = 0
            for _hop in range(8):
                move = None
                for t2, cands in pend.items():
                    if t2 in acc:
                        continue
                    for w2 in cands:
                        if budget <= 0 or _over_budget():
                            break
                        trial = dict(acc)
                        trial[t2] = w2
                        _r3, _s3, req3, est3, lost3, compiled = \
                            _eval(trial)
                        if compiled:
                            budget -= 1
                        if lost3:
                            continue
                        if move is None or est3 < move[2]:
                            move = (trial, req3, est3)
                if move is None or budget <= 0:
                    break
                if move[2] < est - eps:
                    washes = 0
                elif move[2] <= est + wash_tol and washes < 2:
                    # allow a bounded run of washes: relocated
                    # pre-transposes often resolve one link further up
                    washes += 1
                else:
                    break
                acc, pend, est = move
    return state["best"]
