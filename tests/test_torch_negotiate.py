"""The port's producer-order negotiation and the layout requests that feed
it, against the JAX package: the same search under one deterministic
compile function and estimate, the JAX invariants under the port's H100
model, and the same scheme and requests from the port's compiler given
the fusion order and overrides that the JAX package's default run settles
on."""

import json
import os
from dataclasses import dataclass

import numpy as np
import pytest

import artensor_tpu.runtime.sparse as jsparse
from artensor_tpu import plan_io as jplan_io
from artensor_tpu.runtime import gatherk as jgk
from artensor_tpu.runtime import lanes as jlanes
from artensor_tpu.runtime import metrics as jmt
from artensor_tpu.runtime import negotiate as jneg
from artensor_tpu_torch.plan_io import plan_from_dict
from artensor_tpu_torch.runtime import metrics as pmt
from artensor_tpu_torch.runtime import negotiate as pneg
from artensor_tpu_torch.runtime import sparse as psparse
from artensor_tpu_torch.runtime import tracing
from artensor_tpu_torch.runtime.sparse import kernel_kind

ROOT = os.path.join(os.path.dirname(__file__), "..")
PLAN_SC22 = os.path.join(ROOT, "plans", "n30_m14_sparse_sc22.json")
DATA = os.path.join(ROOT, "artensor_tpu_torch", "data")
PLAN_1K = os.path.join(DATA, "rcs_n30_m14_s0_sparse_sc24.json")


def _jax_kind(step):
    lane = step.lane
    if isinstance(lane, jgk.GGKPlan):
        return {jgk.RGRow: "rgrow", jgk.RGFlat: "rgflat"}.get(
            type(lane.row), "ggk")
    return {jgk.GKPlan: "gk", jlanes.PairPlan: "pair",
            jlanes.LanePlan: "lane"}.get(type(lane), None)


# -- the search alone ----------------------------------------------------------

@dataclass(frozen=True)
class _Step:
    lane: object
    cost: float


def _toy(seed, n_steps=14):
    """A deterministic compile function over override sets: each request
    has two or three candidates with a random gain or loss, pairs of moves
    interact, some moves cost a step its kernel, and following a request
    raises a new one a link up the chain (as a relocated copy does)."""
    rng = np.random.default_rng(seed)
    cands = {t: tuple(f"c{t}.{k}" for k in range(int(rng.integers(2, 4))))
             for t in range(1, n_steps)}
    gain = {c: float(rng.normal(0, 0.05)) for cs in cands.values()
            for c in cs}
    lose = {c for c in gain if rng.random() < 0.15}
    kern = [bool(rng.random() < 0.5) for _ in range(n_steps)]
    base = [float(rng.uniform(0.05, 0.2)) for _ in range(n_steps)]
    root = {t: cands[t] for t in range(1, n_steps)
            if rng.random() < 0.4} or {1: cands[1]}

    def compile_fn(overrides):
        ov = dict(overrides or {})
        cost = list(base)
        for t, c in ov.items():
            cost[t] = max(0.0, cost[t] - gain[c])
            if t > 1 and t - 1 in ov:
                cost[t - 1] += 0.01 * ((hash(c) + hash(ov[t - 1])) % 3 - 1)
        steps = [_Step(object() if kern[t] and not any(
            c in lose for tt, c in ov.items() if tt == t) else None,
            cost[t]) for t in range(n_steps)]
        req = {t - 1: cands[t - 1] for t in ov if t > 1}
        req = req or dict(root)
        return ("result", tuple(sorted(ov.items()))), steps, req

    return compile_fn


def _toy_estimate(steps, k_sliced, *a, **k):
    return sum(s.cost for s in steps), 1, 0.0


def _toy_components(steps, *a, **k):
    return sum(s.cost for s in steps), 0.0, 0.0, len(steps)


@pytest.mark.parametrize("seed", range(12))
def test_search_matches_jax_on_one_compile_function(seed, monkeypatch):
    """Driven by one deterministic compile function and estimate, the
    port's search makes JAX's trials in JAX's order and returns JAX's
    result."""
    for mt in (pmt, jmt):
        monkeypatch.setattr(mt, "scheme_wall_estimate", _toy_estimate)
        monkeypatch.setattr(mt, "scheme_wall_components", _toy_components)
    calls = {}
    for name, neg in (("port", pneg), ("jax", jneg)):
        fn = _toy(seed)
        seen = calls[name] = []

        def logged(ov, fn=fn, seen=seen):
            seen.append(None if ov is None else tuple(sorted(ov.items())))
            return fn(ov)

        calls[name + "_result"] = neg.negotiate(logged, time_budget_s=1e9)
    assert calls["port"] == calls["jax"]
    assert calls["port_result"] == calls["jax_result"]
    assert tracing.last("scheme.negotiate").attrs["compiles"] == \
        len(calls["port"])


# -- the JAX invariants under the port's model ---------------------------------

@pytest.mark.skipif(not os.path.exists(PLAN_SC22), reason="plan absent")
def test_negotiation_invariants_on_sc22_plan():
    """tests/test_sparse.py's invariants on the port: negotiation never
    loses a pass-1 kernel, never worsens the wall estimate (the H100
    model), and leaves the step pairing, the output bond set and the
    bitstring batch as they were."""
    with open(PLAN_SC22) as f:
        _, _, ctree = plan_from_dict(json.load(f))
    bits = [np.binary_repr(i, 30) for i in range(256)]
    steps1, ob1, bs1, req = psparse._compile_sparse(ctree, bits, 22, True,
                                                    None)
    assert req, "the plan should raise layout requests"
    steps0, ob0, bs0 = psparse.contraction_scheme_sparse(
        ctree, bits, sc_target=22, negotiate=False)
    steps2, ob2, bs2 = psparse.contraction_scheme_sparse(ctree, bits,
                                                         sc_target=22)
    est1 = pmt.scheme_wall_estimate(steps1, 0)[0]
    est0 = pmt.scheme_wall_estimate(steps0, 0)[0]
    est2 = pmt.scheme_wall_estimate(steps2, 0)[0]
    assert est2 <= min(est0, est1) * (1 + 1e-9)
    assert len(steps0) == len(steps2)
    for a, b in zip(steps0, steps2):
        assert (a.i, a.j) == (b.i, b.j)
        if a.lane is not None:
            assert b.lane is not None
    assert set(ob0) == set(ob2) == set(ob1)
    assert bs0 == bs2 == bs1


# -- same decisions, same scheme ----------------------------------------------

def _capture_jax_default(plan, bits, sc_target, monkeypatch):
    """JAX's default compile (fusion and negotiation on, its own TPU
    model), with its ``_compile_sparse`` wrapped to record the contraction
    order and overrides of every trial; returns the scheme and the order
    and overrides of the trial it settled on."""
    real = jsparse._compile_sparse
    trials = []

    def wrapped(*a, **k):
        out = real(*a, **k)
        ov = a[4] if len(a) > 4 else k.get("_overrides")
        trials.append((out[0], dict(ov) if ov else None, k.get("_order")))
        return out

    monkeypatch.setattr(jsparse, "_compile_sparse", wrapped)
    _, _, ctree = jplan_io.plan_from_dict(plan)
    steps, _, _ = jsparse.contraction_scheme_sparse(ctree, bits,
                                                    sc_target=sc_target)
    monkeypatch.setattr(jsparse, "_compile_sparse", real)
    (hit,) = [t for t in trials if t[0] is steps]
    return ctree, hit[1], hit[2]


def _x_producer(steps, t):
    """Index of the step that wrote step ``t``'s X operand (its GK plan's
    big side)."""
    s = steps[t]
    x = s.i if s.lane.w_is_j else s.j
    return max(n for n in range(t) if steps[n].i == x)


# (plan, bitstrings, sc_target, gate steps): steps that the port's
# pre-permuted GK form takes and JAX's refuses by its TPU estimate
# ("pregk:pre-not-better"; the port dropped that gate)
REPLAYS = {
    "sc22": (PLAN_SC22, [np.binary_repr(i, 30) for i in range(256)], 22,
             (126, 133, 148)),
    "1k": (PLAN_1K, None, 24, ()),
}


@pytest.mark.parametrize("name", sorted(REPLAYS))
def test_same_decisions_give_jax_scheme_and_requests(name, monkeypatch):
    """Given the fusion order and the overrides that JAX's default run
    settles on, the port's compiler gives JAX's steps (pairs, output
    order, kernel kind) and JAX's layout requests, except at the listed
    gate steps: there the port runs the pre-permuted GK form and asks X's
    producer for its order, where JAX runs the dot fallback."""
    path, bits, sc, gates = REPLAYS[name]
    if bits is None:
        with open(os.path.join(DATA, "rcs_n30_m14_s0_amps1000.txt")) as f:
            bits = [ln.split()[0] for ln in f if ln.strip()]
    with open(path) as f:
        plan = json.load(f)
    jctree, overrides, order = _capture_jax_default(plan, bits, sc,
                                                    monkeypatch)
    assert order is not None            # fusion rewrote the order
    jsteps, _, jbits, jreq = jsparse._compile_sparse(
        jctree, bits, sc, True, overrides, _order=order)
    _, _, pctree = plan_from_dict(plan)
    psteps, _, pbits, preq = psparse._compile_sparse(
        pctree, bits, sc, True, overrides, _order=order)
    assert len(psteps) == len(jsteps) and pbits == jbits
    differ = []
    for t, (p, j) in enumerate(zip(psteps, jsteps)):
        assert (p.i, p.j, p.iy) == (j.i, j.j, j.iy), t
        if kernel_kind(p) != _jax_kind(j):
            differ.append(t)
            assert kernel_kind(p) == "gk" and p.lane.pre is not None
            assert _jax_kind(j) is None
            assert j.note.endswith("/pregk:pre-not-better")
            assert p.note == j.note.replace("pre-not-better", "ok")
    assert tuple(differ) == gates
    extra = {_x_producer(psteps, t) for t in gates}
    assert {t: c for t, c in preq.items() if t not in extra} == jreq
    assert extra <= set(preq)


def test_layout_request_candidates_match_jax():
    """The candidate orders offered to a producer, on synthetic legs: the
    minimal hoists at both window sizes, the H block kept whole, batch
    labels, and the full pre-permuted order last."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(3, 14))
        legs = [f"l{k}" for k in range(n)]
        dims = {lab: int(rng.choice([2, 2, 2, 4])) for lab in legs}
        x = list(rng.permutation(legs))
        if rng.random() < 0.3:
            x = ["batch"] + x
        cset = [lab for lab in x if lab != "batch" and rng.random() < 0.3]
        w = cset + ["w0", "w1"]
        iy = [lab for lab in x if lab not in cset] + ["w0"]
        named = [lab for lab in x if lab != "batch"]
        h_block = tuple(named[int(rng.integers(0, len(named))):][:2])
        px = [lab for lab in named if lab not in cset] + cset \
            if rng.random() < 0.5 else []
        if px and rng.random() < 0.2:
            px = ["batch"] + px
        args = (tuple(x), tuple(w), tuple(iy), dims, h_block, px)
        assert psparse._layout_request_candidates(*args) == \
            jsparse._layout_request_candidates(*args)
