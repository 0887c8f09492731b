"""The port's dense scheme compiler (``runtime/scheme.py``) against the JAX
package's: the off form step for step on a small plan and on the three
committed Sycamore dense plans, the default form given the fusion order
and overrides that JAX's default run settles on, and the census of the
port's committed n30 dense plan.

The port's GK planner keeps the JAX step-form logic but drops the TPU's
Mosaic limits (``runtime/gatherk.py``).  On the Sycamore plans one of
them binds: ``VIEW_RANK_CAP``, the rank of the X view a Pallas GK block
may take.  Where JAX's planner refuses a GK step for that reason alone
(``LAST_REJECT == "rank"``), the port's would run its kernel; the tests
replay JAX's refusal on the port (``_rank_gate``) and count the steps it
changes, and everything else is the JAX compiler's."""

import json
import os
from collections import Counter

import numpy as np
import pytest

import artensor_tpu.runtime.scheme as jsch
from artensor_tpu import plan_io as jplan_io
from artensor_tpu.circuits import TensorNetworkCircuit as JaxCircuit
from artensor_tpu.circuits.random_circuits import random_circuit
from artensor_tpu.network import NumericalTensorNetwork as JaxNTN
from artensor_tpu.planner import find_order
from artensor_tpu.runtime import gatherk as jgk
from artensor_tpu.runtime import lanes as jlanes
from artensor_tpu_torch import TensorNetworkSimulation
from artensor_tpu_torch.plan_io import plan_from_dict
from artensor_tpu_torch.planner import ContractionTree
from artensor_tpu_torch.runtime import executor as pex
from artensor_tpu_torch.runtime import gatherk as pgk
from artensor_tpu_torch.runtime import lanes as planes
from artensor_tpu_torch.runtime import scheme as psch
from artensor_tpu_torch.runtime.sparse import kernel_kind

ROOT = os.path.join(os.path.dirname(__file__), "..")
PLANS = os.path.join(ROOT, "plans")
DENSE_PLAN = os.path.join(ROOT, "artensor_tpu_torch", "data",
                          "rcs_n30_m14_s0_dense_sc30.json")
# the committed Sycamore dense plans, and the GK steps of each form that
# JAX's planner refuses for the view rank alone (off, default)
SYCAMORE = {
    "sc30": ("n30_m14_dense_sc30.json", 2, 2),
    "sc26": ("n30_m14_dense_sc26.json", 1, 1),
    "blocks64_sc26": ("n30_m14_dense_blocks64_sc26.json", 0, 0),
}
# the port's n30 dense plan compiled on the CPU (PERF.md section 4): the
# steps left on the device after the static folds, by kernel kind, and
# the pre-permuted GK steps among them
DENSE_CENSUS = {
    "off": ({"gk": 14, "dot": 23}, 1),
    "default": ({"gk": 14, "dot": 17}, 0),
}
# the device peak model of each form at width 1 (PERF.md section 4): the
# live set (16 GiB: two 2^30-element states), both float32 components'
# copy of the 2^30-element operand of a dot step (8 GiB: its product runs
# on the complex matmul kernel, which reads them at once) and the GK tables
DENSE_DEVICE_PEAK_GIB = {"off": 24.0234, "default": 24.0148}


def _jax_kind(step):
    return {jgk.GKPlan: "gk", jlanes.PairPlan: "pair",
            jlanes.LanePlan: "lane"}.get(type(step.lane), None)


def _fields(s):
    return (s.i, s.j, s.ix_i, s.ix_j, s.iy, s.dims_i, s.dims_j)


def _assert_same_steps(psteps, jsteps):
    assert len(psteps) == len(jsteps)
    for t, (p, j) in enumerate(zip(psteps, jsteps)):
        assert _fields(p) == _fields(j), t
        assert kernel_kind(p) == _jax_kind(j), t
        if kernel_kind(p) == "gk":
            assert (p.lane.pre is None) == (j.lane.pre is None), t
            assert (p.lane.K, p.lane.H, p.lane.w_is_j, p.lane.dims_y) == \
                (j.lane.K, j.lane.H, j.lane.w_is_j, j.lane.dims_y), t


def _rank_gate(monkeypatch):
    """Refuse a GK step on the port wherever JAX's planner refuses it for
    the view rank alone; returns the list of refusals made."""
    real = psch.plan_gk_step
    hits = []

    def gated(*a, **k):
        plan = real(*a, **k)
        if plan is not None:
            jgk.LAST_REJECT = None
            if jgk.plan_gk_step(*a, **k) is None \
                    and jgk.LAST_REJECT == "rank":
                hits.append(a)
                return None
        return plan

    monkeypatch.setattr(psch, "plan_gk_step", gated)
    return hits


def _load(path):
    with open(path) as f:
        return json.load(f)


# -- a small plan ----------------------------------------------------------------

@pytest.fixture(scope="module")
def small_plan():
    """random_circuit(3, 4, 8, seed=13), dense, a JAX plan at sc_target 10
    (one sliced bond)."""
    circ = JaxCircuit(random_circuit(3, 4, 8, seed=13))
    ntn = JaxNTN(*circ.to_numerical_tn())
    tb2, fq2 = ntn.simplify("normal")
    _, sliced, ctree = find_order(
        tb2, ntn.bond_dims, fq2, sc_target=10, trials=2, iters=6,
        betas=np.linspace(3, 21, 12), slicing_repeat=1, parallel=False)
    assert len(sliced) >= 1
    return jplan_io.plan_to_dict(ctree, meta={"sc_target": 10})


@pytest.mark.parametrize("gates", ["default", "lowered"])
def test_small_plan_off_form_matches_jax(small_plan, monkeypatch, gates):
    """The off form equals JAX's step for step; with the size gates
    lowered on both packages (so that kernel plans appear at this size)
    the kernel kinds agree too."""
    if gates == "lowered":
        for mod in (jgk, pgk, jlanes, planes):
            monkeypatch.setattr(mod, "MIN_X_ELEMS", 1 << 8)
        monkeypatch.setattr(jgk, "SLACK", 1e9)
    jsteps, job = jsch.contraction_scheme(
        jplan_io.plan_from_dict(small_plan)[2], fuse=False, negotiate=False)
    psteps, pob = psch.contraction_scheme(
        plan_from_dict(small_plan)[2], fuse=False, negotiate=False)
    _assert_same_steps(psteps, jsteps)
    assert pob == job
    kinds = Counter(kernel_kind(s) for s in psteps)
    assert (kinds["gk"] > 0) == (gates == "lowered")


def test_small_plan_plain_lowering_matches_jax(small_plan):
    """``lane_schedule=False``: no kernel plans, transpose-free orders."""
    jsteps, job = jsch.contraction_scheme(
        jplan_io.plan_from_dict(small_plan)[2], lane_schedule=False)
    psteps, pob = psch.contraction_scheme(
        plan_from_dict(small_plan)[2], lane_schedule=False)
    _assert_same_steps(psteps, jsteps)
    assert all(s.lane is None for s in psteps) and pob == job


# -- the committed Sycamore dense plans ----------------------------------------

@pytest.mark.parametrize("name", sorted(SYCAMORE))
def test_sycamore_off_form_matches_jax(name, monkeypatch):
    """The Sycamore plans load without their circuit; the port's off form
    is JAX's step for step once JAX's view-rank refusals are replayed,
    and those are the only refusals the replay makes."""
    fname, n_rank, _ = SYCAMORE[name]
    plan = _load(os.path.join(PLANS, fname))
    hits = _rank_gate(monkeypatch)
    jsteps, job = jsch.contraction_scheme(
        jplan_io.plan_from_dict(plan)[2], fuse=False, negotiate=False)
    psteps, pob = psch.contraction_scheme(
        plan_from_dict(plan)[2], fuse=False, negotiate=False)
    _assert_same_steps(psteps, jsteps)
    assert pob == job
    assert len(hits) == n_rank


def _capture_jax_default(plan, monkeypatch):
    """JAX's default compile (fusion and negotiation on, its TPU model),
    with its ``_compile_dense`` wrapped to record every trial; returns the
    scheme, its requests, and the contraction order and overrides of the
    trial it settled on."""
    real = jsch._compile_dense
    trials = []

    def wrapped(ctree, lane_schedule, overrides):
        out = real(ctree, lane_schedule, overrides)
        trials.append((out[0], out[2], list(ctree.order),
                       dict(overrides) if overrides else None))
        return out

    monkeypatch.setattr(jsch, "_compile_dense", wrapped)
    steps, _ = jsch.contraction_scheme(jplan_io.plan_from_dict(plan)[2])
    monkeypatch.setattr(jsch, "_compile_dense", real)
    (hit,) = [t for t in trials if t[0] is steps]
    return hit


@pytest.mark.parametrize("name", sorted(SYCAMORE) + ["port_n30"])
def test_default_form_given_jax_decisions(name, monkeypatch):
    """Given the fusion order and the overrides that JAX's default run
    settles on, the port's compiler gives JAX's steps and JAX's layout
    requests (view-rank refusals replayed)."""
    if name == "port_n30":
        plan, n_rank = _load(DENSE_PLAN), 0
    else:
        fname, _, n_rank = SYCAMORE[name]
        plan = _load(os.path.join(PLANS, fname))
    jsteps, jreq, order, overrides = _capture_jax_default(plan, monkeypatch)
    assert overrides                    # negotiation moved some order
    hits = _rank_gate(monkeypatch)
    pct = plan_from_dict(plan)[2]
    psteps, _, preq = psch._compile_dense(
        ContractionTree(pct.tn, order), True, overrides)
    _assert_same_steps(psteps, jsteps)
    assert preq == jreq
    assert len(hits) == n_rank


# -- the port's committed n30 dense plan ----------------------------------------

def test_port_dense_plan_is_jax_planned_for_the_circuit():
    """The committed plan covers the generated circuit's simplify('normal')
    network, slices nothing (the whole state fits one card) and keeps
    the stored complexity."""
    from artensor_tpu_torch import random_circuit as prc

    sim = TensorNetworkSimulation.from_circuit(prc(5, 6, 14, seed=0))
    plan = _load(DENSE_PLAN)
    assert plan["meta"]["sc_target"] == 30 and plan["max_bitstring"] == 1
    assert {int(t): list(b) for t, b in plan["tensor_bonds"].items()} \
        == {t: list(b) for t, b in sim.tensor_bonds.items()}
    _, sliced, ctree = plan_from_dict(plan)
    assert sliced == []
    tc, sc, mc = ctree.complexity()
    assert sc == 30.0
    assert abs(tc - 12.083852508058504) < 1e-9


@pytest.mark.parametrize("form", sorted(DENSE_CENSUS))
def test_port_dense_plan_census(form):
    """The committed plan compiles on the CPU to the census of PERF.md
    section 4: steps left on the device after the static folds."""
    from artensor_tpu_torch import random_circuit as prc

    sim = TensorNetworkSimulation.from_circuit(prc(5, 6, 14, seed=0))
    sim.load_plan(DENSE_PLAN)
    if form == "off":
        sim._set_scheme(*psch.contraction_scheme(sim.ctree, fuse=False,
                                                 negotiate=False))
    run_steps, _ = pex.precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)
    kinds, n_pre = DENSE_CENSUS[form]
    assert dict(Counter(kernel_kind(s) or "dot" for s in run_steps)) == kinds
    assert sum(kernel_kind(s) == "gk" and s.lane.pre is not None
               for s in run_steps) == n_pre
    assert len(sim.output_bonds) == 30 and sim.bitstrings_sorted is None
    from artensor_tpu_torch.runtime import metrics

    live = metrics.scheme_peak_bytes_at_width(run_steps, 1, sim.slicing_axes)
    dev = metrics.scheme_device_peak_bytes(run_steps, 1, sim.slicing_axes)
    tables = metrics.kernel_table_bytes(run_steps)
    assert 16 * 2 ** 30 <= live < 16.001 * 2 ** 30
    assert live + 2 ** 33 + tables <= dev < live + 2 ** 33 + tables + 2 ** 20
    assert abs(dev / 2 ** 30 - DENSE_DEVICE_PEAK_GIB[form]) < 1e-4
