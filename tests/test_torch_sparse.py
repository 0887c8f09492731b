"""The port's sparse slice as a whole: scheme compile, staging, slice
selection and the sliced runner against the JAX package and the exact
state vector; and the kernel census of the committed n30 plans."""

import os
from collections import Counter

import numpy as np
import pytest
import torch

from artensor_tpu.circuits import TensorNetworkCircuit as JaxCircuit
from artensor_tpu.circuits.random_circuits import random_circuit
from artensor_tpu.network import NumericalTensorNetwork as JaxNTN
from artensor_tpu.ops.field import make_field as jax_make_field
from artensor_tpu.planner import find_order
from artensor_tpu.plan_io import plan_to_dict
from artensor_tpu.runtime import executor as jex
from artensor_tpu.runtime import gatherk as jgk
from artensor_tpu.runtime import lanes as jlanes
from artensor_tpu_torch import TensorNetworkSimulation
from artensor_tpu_torch.ops.field import SplitField
from artensor_tpu_torch.runtime import executor as pex
from artensor_tpu_torch.runtime import gatherk as pgk
from artensor_tpu_torch.runtime.sparse import kernel_kind

DATA = os.path.join(os.path.dirname(__file__), "..", "artensor_tpu_torch",
                    "data")
# the n30 plan's port scheme at 1000 bitstrings (recorded in PERF.md):
# kernel steps as compiled, and left after the static gate merges fold
N30_KERNEL_STEPS = {"gk": 18, "pair": 1, "ggk": 2, "rgrow": 1}
N30_KERNEL_STEPS_RUN = N30_KERNEL_STEPS
# the 10k plan's port scheme at its 10000 fixture bitstrings (PERF.md):
# 187 steps compiled, 79 left per slice after the static merges fold
N30_10K_KERNEL_STEPS = {"gk": 21, "pair": 2, "ggk": 1, "rgflat": 1}
# the sc25 plan's port scheme at the 1000 fixture bitstrings (PERF.md)
N30_SC25_KERNEL_STEPS = {"gk": 11, "pair": 1, "lane": 1, "rgflat": 1}


@pytest.fixture(scope="module")
def rcs12():
    """random_circuit(3, 4, 8, seed=13), 48 bitstrings, a JAX plan at
    sc_target 10 — the scenario of tests/test_sparse.py:130-175."""
    n, layers = random_circuit(3, 4, 8, seed=13)
    circ = JaxCircuit((n, layers))
    ntn = JaxNTN(*circ.to_numerical_tn())
    tb2, fq2 = ntn.simplify("sparse")
    rng = np.random.default_rng(4)
    bits = [np.binary_repr(b, n)
            for b in rng.choice(2 ** n, 48, replace=False)]
    _, sliced, ctree = find_order(
        tb2, ntn.bond_dims, fq2, max_bitstrings=48, sc_target=10,
        trials=2, iters=6, betas=np.linspace(3, 21, 12), slicing_repeat=1,
        parallel=False)
    return dict(n=n, layers=layers, circ=circ, ntn=ntn, tb2=tb2, fq2=fq2,
                bits=bits, sliced=sliced, ctree=ctree,
                plan=plan_to_dict(ctree, meta={"sc_target": 10}))


@pytest.fixture(scope="module")
def jax_amps(rcs12):
    """The JAX sliced runner with GK forced (interpret-mode Pallas), keyed
    by bitstring."""
    from artensor_tpu.runtime.sparse import (contraction_scheme_sparse,
                                             execute_sparse)

    w = rcs12
    old = jgk.MIN_X_ELEMS, jgk.SLACK
    jgk.MIN_X_ELEMS, jgk.SLACK = 1 << 8, 1e9
    try:
        steps, _, bits_sorted = contraction_scheme_sparse(
            w["ctree"], w["bits"], sc_target=10)
    finally:
        jgk.MIN_X_ELEMS, jgk.SLACK = old
    assert any(isinstance(s.lane, jgk.GKPlan) for s in steps)
    field = jax_make_field(np.complex64, "highest", "split")
    staged = jex.stage_tensors(
        field, [w["ntn"].tensors[i] for i in range(len(w["ntn"].tensors))])
    axes = jex.build_slicing_axes(w["tb2"], w["sliced"],
                                  batched_tensors=w["fq2"])
    run = jex.make_sliced_runner(execute_sparse, steps, axes,
                                 len(w["sliced"]), (len(bits_sorted),), field)
    amps = field.unwrap(run(staged)).reshape(-1)
    return dict(zip(bits_sorted, amps))


@pytest.mark.parametrize("width", [1, 4])
def test_sliced_run_matches_jax_and_state_vec(rcs12, jax_amps, monkeypatch,
                                              width):
    monkeypatch.setattr(pgk, "MIN_X_ELEMS", 1 << 8)
    w = rcs12
    assert len(w["sliced"]) >= 2 and 2 ** len(w["sliced"]) % width == 0
    sim = TensorNetworkSimulation.from_circuit((w["n"], w["layers"]),
                                               w["bits"]).load_plan(w["plan"])
    assert sum(kernel_kind(s) == "gk" for s in sim.steps) >= 1
    amps = sim.contraction(slice_batch=width, device="cpu")
    exact = w["circ"].state_vec().reshape(-1)
    assert sorted(sim.bitstrings_sorted) == sorted(jax_amps)
    for a, b in zip(amps, sim.bitstrings_sorted):
        assert abs(a - exact[int(b, 2)]) < 2e-5, b
        assert abs(a - jax_amps[b]) < 2e-5, b


def test_widths_agree_with_kernels_off(rcs12):
    """The plain dot lowering (no kernel plans, reference leg orders) gives
    the same amplitudes as the kernel scheme."""
    w = rcs12
    sim = TensorNetworkSimulation.from_circuit((w["n"], w["layers"]),
                                               w["bits"]).load_plan(w["plan"])
    a1 = dict(zip(sim.bitstrings_sorted,
                  sim.contraction(slice_batch=2, device="cpu")))
    from artensor_tpu_torch.runtime.sparse import contraction_scheme_sparse
    sim.steps, sim.output_bonds, sim.bitstrings_sorted = \
        contraction_scheme_sparse(sim.ctree, w["bits"], 10,
                                  lane_schedule=False)
    assert all(kernel_kind(s) is None for s in sim.steps)
    a2 = sim.contraction(slice_batch=4, device="cpu")
    for a, b in zip(a2, sim.bitstrings_sorted):
        assert abs(a - a1[b]) < 2e-5


def test_stage_tensors_matches_jax(rcs12):
    """Both packages' precompute_static_steps + stage_tensors on the same
    network give the same buffers."""
    from artensor_tpu.runtime.sparse import contraction_scheme_sparse as jcs

    w = rcs12
    steps, _, _ = jcs(w["ctree"], w["bits"], sc_target=10,
                      lane_schedule=False)
    axes = jex.build_slicing_axes(w["tb2"], w["sliced"],
                                  batched_tensors=w["fq2"])
    arrays = [w["ntn"].tensors[i] for i in range(len(w["ntn"].tensors))]
    jsteps, jarr = jex.precompute_static_steps(steps, arrays, axes)
    psteps, parr = pex.precompute_static_steps(steps, arrays, axes)
    assert [(s.i, s.j) for s in psteps] == [(s.i, s.j) for s in jsteps]
    jf = jax_make_field(np.complex64, "highest", "split")
    jbufs = jex.stage_tensors(jf, jarr)
    pbufs = pex.stage_tensors(SplitField(), parr, "cpu")
    assert len(pbufs) == len(jbufs)
    for pb, jb in zip(pbufs, jbufs):
        for pc, jc in zip(pb, jb):
            assert tuple(pc.shape) == tuple(jc.shape)
            np.testing.assert_allclose(pc.numpy(), np.asarray(jc),
                                       rtol=1e-6, atol=1e-7)


def test_slice_select_matches_jax(rcs12):
    """One width-W selection equals JAX's per-slice slice_select for every
    id, MSB-first."""
    w = rcs12
    k = len(w["sliced"])
    axes = pex.build_slicing_axes(w["tb2"], w["sliced"],
                                  batched_tensors=w["fq2"])
    assert axes == jex.build_slicing_axes(w["tb2"], w["sliced"],
                                          batched_tensors=w["fq2"])
    arrays = [w["ntn"].tensors[i] for i in range(len(w["ntn"].tensors))]
    jf = jax_make_field(np.complex64, "highest", "split")
    pf = SplitField()
    jbufs = jex.stage_tensors(jf, arrays)
    pbufs = pex.stage_tensors(pf, arrays, "cpu")
    ids = torch.arange(2 ** k)
    got, batched = pex.slice_select(pbufs, axes, ids, k, pf)
    assert batched == {tid for e in axes for tid, *_ in e}
    for sid in range(2 ** k):
        want = jex.slice_select(jbufs, axes, sid, k, jf)
        for tid in batched:
            np.testing.assert_array_equal(got[tid][0][sid].numpy(),
                                          np.asarray(want[tid][0]))
            np.testing.assert_array_equal(got[tid][1][sid].numpy(),
                                          np.asarray(want[tid][1]))


RGF_PLAN = os.path.join(os.path.dirname(__file__), "data",
                        "torch_port_rcs15_rgflat_plan.json")


@pytest.fixture(scope="module")
def rcs15():
    """random_circuit(3, 5, 8, seed=13) — 15 qubits — with 128 bitstrings
    (``default_rng(4)``) and a committed JAX plan at sc_target 12: 3 sliced
    bonds, one aligned merge of the RGFlat form (B 118, H 4, K 32, F 4)
    once the size gates are lowered.  The plan is data because the JAX
    planner's output depends on the hash seed; it is
    ``find_order(tb2, bond_dims, fq2, max_bitstrings=128, sc_target=12,
    trials=2, iters=6, betas=np.linspace(3, 21, 12), slicing_repeat=1,
    parallel=False)`` under ``PYTHONHASHSEED=0``, saved with
    ``plan_to_dict(ctree, meta={"sc_target": 12})``.  The amplitudes of
    the JAX sliced runner (its kernels in Pallas interpret mode, RGFlat
    among them) are keyed by bitstring."""
    import json

    from artensor_tpu.plan_io import plan_from_dict
    from artensor_tpu.runtime.sparse import (contraction_scheme_sparse,
                                             execute_sparse)

    n, layers = random_circuit(3, 5, 8, seed=13)
    circ = JaxCircuit((n, layers))
    ntn = JaxNTN(*circ.to_numerical_tn())
    tb2, fq2 = ntn.simplify("sparse")
    rng = np.random.default_rng(4)
    bits = [np.binary_repr(b, n)
            for b in rng.choice(2 ** n, 128, replace=False)]
    with open(RGF_PLAN) as f:
        plan = json.load(f)
    _, sliced, ctree = plan_from_dict(plan)
    old = jgk.MIN_X_ELEMS, jgk.SLACK, jgk.GGK_MIN_WORK
    jgk.MIN_X_ELEMS, jgk.SLACK, jgk.GGK_MIN_WORK = 1 << 8, 1e9, 1 << 8
    try:
        steps, _, bits_sorted = contraction_scheme_sparse(
            ctree, bits, sc_target=12, negotiate=False, fuse=False)
    finally:
        jgk.MIN_X_ELEMS, jgk.SLACK, jgk.GGK_MIN_WORK = old
    assert sum(isinstance(s.lane, jgk.GGKPlan)
               and isinstance(s.lane.row, jgk.RGFlat) for s in steps) == 1
    field = jax_make_field(np.complex64, "highest", "split")
    staged = jex.stage_tensors(
        field, [ntn.tensors[i] for i in range(len(ntn.tensors))])
    axes = jex.build_slicing_axes(tb2, sliced, batched_tensors=fq2)
    run = jex.make_sliced_runner(execute_sparse, steps, axes, len(sliced),
                                 (len(bits_sorted),), field)
    amps = field.unwrap(run(staged)).reshape(-1)
    return dict(n=n, layers=layers, bits=bits, plan=plan,
                exact=circ.state_vec().reshape(-1),
                jax_amps=dict(zip(bits_sorted, amps)))


@pytest.mark.parametrize("width", [1, 4])
def test_rgflat_route_matches_jax_and_state_vec(rcs15, monkeypatch, width):
    """The RGFlat route end to end on the CPU: the port's scheme of the
    committed small plan runs its one RGFlat merge through
    ``rgflat_call`` (its plain version here) with W in its stored order
    (no ``_wk_rows`` transpose), and every amplitude matches the JAX run
    and the state vector."""
    monkeypatch.setattr(pgk, "MIN_X_ELEMS", 1 << 8)
    monkeypatch.setattr(pgk, "GGK_MIN_WORK", 1 << 8)
    w = rcs15
    sim = TensorNetworkSimulation.from_circuit(
        (w["n"], w["layers"]), w["bits"]).load_plan(w["plan"])
    kinds = Counter(kernel_kind(s) for s in sim.steps)
    assert kinds["rgflat"] == 1
    (row,) = [s.lane.row for s in sim.steps if kernel_kind(s) == "rgflat"]
    assert (row.H, row.K, row.F) == (4, 32, 4)
    calls = []
    real = pgk.rgflat_call
    monkeypatch.setattr(pgk, "rgflat_call",
                        lambda *a: calls.append(1) or real(*a))
    wk_rows = pgk._wk_rows

    def no_rgflat_transpose(w, row, *a):
        assert not isinstance(row, pgk.RGFlat), "RGFlat W transposed"
        return wk_rows(w, row, *a)

    monkeypatch.setattr(pgk, "_wk_rows", no_rgflat_transpose)
    amps = sim.contraction(slice_batch=width, device="cpu")
    assert len(calls) == 2 ** len(sim.slicing_bonds) // width
    assert sorted(sim.bitstrings_sorted) == sorted(w["jax_amps"])
    for a, b in zip(amps, sim.bitstrings_sorted):
        assert abs(a - w["exact"][int(b, 2)]) < 2e-5, b
        assert abs(a - w["jax_amps"][b]) < 2e-5, b


def test_runner_rejects_non_dividing_width(rcs12):
    with pytest.raises(ValueError, match="divide"):
        pex.make_sliced_runner(None, [], [], 3, (4,), SplitField(),
                               slice_batch=3)


def _off_form_sim(circuit, bits, plan):
    """A simulation of a plan (dict or path) with the scheme in the off
    form (time-ordered layouts, no fusion, no negotiation), compiled as
    the JAX package's tests compile it: ``contraction_scheme_sparse(...,
    fuse=False, negotiate=False)``."""
    import json

    from artensor_tpu_torch.plan_io import plan_from_dict
    from artensor_tpu_torch.runtime.sparse import contraction_scheme_sparse

    if not isinstance(plan, dict):
        with open(plan) as f:
            plan = json.load(f)
    sim = TensorNetworkSimulation.from_circuit(circuit, bits)
    sim.order, sim.slicing_bonds, sim.ctree = plan_from_dict(plan)
    sim.sc_target = float(plan["meta"]["sc_target"])
    sim._set_scheme(*contraction_scheme_sparse(
        sim.ctree, bits, sim.sc_target, fuse=False, negotiate=False))
    return sim


def _n30_sim():
    with open(os.path.join(DATA, "rcs_n30_m14_s0_amps1000.txt")) as f:
        bits = [ln.split()[0] for ln in f if ln.strip()]
    from artensor_tpu_torch import random_circuit as prc

    return _off_form_sim(prc(5, 6, 14, seed=0), bits,
                         os.path.join(DATA, "rcs_n30_m14_s0_sparse_sc24.json"))


def test_n30_plan_census_in_the_jax_order():
    """The port compiles huge unbatched both-big merges in the JAX order
    (the full time sort), and the time-sorted layout alone leaves that
    merge to no kernel: the retail second chance then finds the pair
    kernel with its own (rows_i, rows_j) order, as the JAX compiler does
    (step 78 of the committed plan)."""
    steps = _n30_sim().steps
    kinds = Counter(kernel_kind(s) for s in steps)
    kinds.pop(None, None)
    assert dict(kinds) == N30_KERNEL_STEPS
    (pair,) = [s for s in steps if kernel_kind(s) == "pair"]
    assert "/pair:pair-iy" in pair.note and pair.note.endswith("/retail:ok")


def _jax_kind(step):
    lane = step.lane
    if isinstance(lane, jgk.GGKPlan):
        return {jgk.RGRow: "rgrow", jgk.RGFlat: "rgflat"}.get(
            type(lane.row), "ggk")
    return {jgk.GKPlan: "gk", jlanes.PairPlan: "pair",
            jlanes.LanePlan: "lane"}.get(
        type(lane), None if lane is None else type(lane).__name__)


def _jax_kinds(plan, bits, sc_target=24):
    """Kernel kind of every step of the JAX scheme of a committed plan
    (lane_schedule on, fuse and negotiation off)."""
    jsteps, jbits = _jax_scheme(plan, bits, sc_target)
    return [_jax_kind(s) for s in jsteps], jbits


def _jax_scheme(plan, bits, sc_target=24):
    from artensor_tpu import plan_io
    from artensor_tpu.runtime.sparse import contraction_scheme_sparse as jcs

    _, _, ctree = plan_io.load_plan(plan)
    jsteps, _, jbits = jcs(ctree, bits, sc_target=sc_target,
                           negotiate=False, fuse=False)
    return jsteps, jbits


def test_n30_plan_kernel_census():
    """The committed n30 plan compiled by the port at the 1000 fixture
    bitstrings plans every ported kernel kind but RGFlat and Lane (numbers
    as in PERF.md), each kernel step at the same place and of the same
    kind as in the JAX scheme of the plan: both reach the pair step (step
    78) through the retail scheduler."""
    sim = _n30_sim()
    kinds = Counter(kernel_kind(s) for s in sim.steps)
    kinds.pop(None, None)
    assert dict(kinds) == N30_KERNEL_STEPS
    jkinds, _ = _jax_kinds(
        os.path.join(DATA, "rcs_n30_m14_s0_sparse_sc24.json"), sim.bitstrings)
    assert jkinds == [kernel_kind(s) for s in sim.steps]
    assert jkinds.index("pair") == 78
    run_steps, _ = pex.precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)
    kinds = Counter(kernel_kind(s) for s in run_steps)
    kinds.pop(None, None)
    assert dict(kinds) == N30_KERNEL_STEPS_RUN
    assert len(sim.slicing_bonds) == 6
    assert len(sim.bitstrings_sorted) == 1000


def _n30_10k():
    with open(os.path.join(DATA, "rcs_n30_m14_s0_amps10000.txt")) as f:
        bits = [ln.split()[0] for ln in f if ln.strip()]
    assert len(bits) == 10000
    return bits, os.path.join(DATA, "rcs_n30_m14_s0_sparse10k_sc24.json")


def test_n30_10k_plan_kernel_census():
    """The committed 10k plan compiled by the port at the 10000 fixture
    bitstrings: one RGFlat merge (B 9996 rows of 128 elements, H 2, K 16,
    F 8), and every kernel step at the same place and of the same kind
    as in the JAX scheme of the plan (lane_schedule on, fuse and
    negotiation off).  Both reach the two pair steps through the retail
    scheduler: steps 39 and 71 (K 256, M 8192, N 256; K 512, M 32768,
    N 256)."""
    from artensor_tpu_torch import random_circuit as prc

    bits, plan = _n30_10k()
    sim = _off_form_sim(prc(5, 6, 14, seed=0), bits, plan)
    kinds = [kernel_kind(s) for s in sim.steps]
    census = Counter(kinds)
    census.pop(None, None)
    assert dict(census) == N30_10K_KERNEL_STEPS
    assert len(sim.steps) == 187 and len(sim.slicing_bonds) == 7
    assert len(sim.bitstrings_sorted) == 10000
    (flat,) = [s.lane for s in sim.steps if kernel_kind(s) == "rgflat"]
    assert (flat.B, flat.row.xrow, flat.row.H, flat.row.K, flat.row.F) \
        == (9996, 128, 2, 16, 8)
    assert kinds.index("rgflat") == 173
    pairs = [(k, s.lane.K, s.lane.M, s.lane.N)
             for k, s in enumerate(sim.steps) if kernel_kind(s) == "pair"]
    assert pairs == [(39, 256, 8192, 256), (71, 512, 32768, 256)]
    run_steps, _ = pex.precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)
    run = Counter(kernel_kind(s) for s in run_steps)
    assert len(run_steps) == 79 and run.pop(None) == 54
    assert dict(run) == N30_10K_KERNEL_STEPS

    jkinds, jbits = _jax_kinds(plan, bits)
    assert jkinds == kinds
    assert sorted(jbits) == sorted(sim.bitstrings_sorted)


SC25_PLAN = os.path.join(DATA, "rcs_n30_m14_s0_sparse_sc25.json")
LANE_FIELDS = ("w_is_j", "orient", "view_x", "combo_axes", "x_axes",
               "y_axes", "block", "L", "H", "n_combos", "view_y", "dims_y",
               "est_s")


def assert_lane_plans_equal(p, j):
    """A port LanePlan equals the JAX one field by field (the JAX plan's
    fields; ``flops`` differs by design: the port counts the table form's
    work)."""
    for f in LANE_FIELDS:
        assert getattr(p, f) == getattr(j, f), f
    np.testing.assert_array_equal(p.wp_idx, j.wp_idx)
    np.testing.assert_array_equal(p.wp_sign, j.wp_sign)


def test_n30_sc25_plan_kernel_census():
    """The committed sc25 plan (the 1k bitstrings at memory budget 25: 5
    sliced bonds, complexity (10.4597, 25.0, 8.9744)) compiled by the port
    and by JAX (lane_schedule on, fuse and negotiation off): the same
    kernel kind at every one of the 187 steps.  Its one lane step (step
    110) is planned by the retail scheduler in the tail orientation, with
    the same plan and output order as JAX's; the pair step is step 76, the
    RGFlat row step 174."""
    from artensor_tpu_torch import load_plan, random_circuit as prc

    with open(os.path.join(DATA, "rcs_n30_m14_s0_amps1000.txt")) as f:
        bits = [ln.split()[0] for ln in f if ln.strip()]
    _, sliced, ctree = load_plan(SC25_PLAN)
    assert sliced == ["16-9", "18-8", "16-5", "14-10", "12-11"]
    np.testing.assert_allclose(ctree.complexity(),
                               (10.459710, 25.0, 8.974364), atol=1e-6)
    sim = _off_form_sim(prc(5, 6, 14, seed=0), bits, SC25_PLAN)
    assert sim.sc_target == 25 and len(sim.steps) == 187
    kinds = [kernel_kind(s) for s in sim.steps]
    census = Counter(kinds)
    census.pop(None, None)
    assert dict(census) == N30_SC25_KERNEL_STEPS
    assert (kinds.index("pair"), kinds.index("lane"),
            kinds.index("rgflat")) == (76, 110, 174)
    jsteps, jbits = _jax_scheme(SC25_PLAN, bits, sc_target=25)
    assert [_jax_kind(s) for s in jsteps] == kinds
    assert sorted(jbits) == sorted(sim.bitstrings_sorted)
    lane, jlane = sim.steps[110], jsteps[110]
    assert lane.note == jlane.note and lane.note.endswith("/retail:ok")
    assert lane.iy == jlane.iy and lane.ix_i == jlane.ix_i
    assert_lane_plans_equal(lane.lane, jlane.lane)
    p = lane.lane
    assert (p.orient, p.L, p.H, p.n_combos, p.block, p.view_x) == \
        ("tail", 128, 128, 1, 2048, (4, 65536, 128))
    # the address table: 8 terms per output (1/16 of the lane matrix)
    assert p.T == 8 and int((p.wp_sign != 0).sum()) * 16 == p.wp_sign.size


@pytest.mark.parametrize("width", [1, 4])
def test_lane_route_matches_jax_and_state_vec(rcs15, monkeypatch, width):
    """The lane route end to end on the CPU: with the size gates lowered
    (the retail threshold too) the port's scheme of the committed small
    plan sends steps through ``lane_call`` (its plain version here), from
    the chain and from the retail second chance, and every amplitude
    matches the JAX run and the state vector."""
    from artensor_tpu_torch.runtime import lanes as planes
    from artensor_tpu_torch.runtime import sparse as psparse

    monkeypatch.setattr(pgk, "MIN_X_ELEMS", 1 << 8)
    monkeypatch.setattr(pgk, "GGK_MIN_WORK", 1 << 8)
    monkeypatch.setattr(planes, "MIN_X_ELEMS", 1 << 6)
    monkeypatch.setattr(psparse, "RETAIL_MIN_ELEMS", 1 << 6)
    w = rcs15
    sim = TensorNetworkSimulation.from_circuit(
        (w["n"], w["layers"]), w["bits"]).load_plan(w["plan"])
    lane_steps = [s for s in sim.steps if kernel_kind(s) == "lane"]
    assert any(s.note.endswith("/retail:ok") for s in lane_steps)
    assert any("/retail" not in s.note for s in lane_steps)
    calls = []
    real = planes.lane_call
    monkeypatch.setattr(planes, "lane_call",
                        lambda *a: calls.append(1) or real(*a))
    amps = sim.contraction(slice_batch=width, device="cpu")
    assert len(calls) >= 2 ** len(sim.slicing_bonds) // width
    assert sorted(sim.bitstrings_sorted) == sorted(w["jax_amps"])
    for a, b in zip(amps, sim.bitstrings_sorted):
        assert abs(a - w["exact"][int(b, 2)]) < 2e-5, b
        assert abs(a - w["jax_amps"][b]) < 2e-5, b


def test_small_plan_lane_census_matches_jax(rcs15, monkeypatch):
    """With the size gates of both packages lowered alike, the port's
    scheme of the committed small plan has JAX's kernel kind at every step,
    its chain lane steps among them, each lane plan equal to JAX's."""
    from artensor_tpu.plan_io import plan_from_dict
    from artensor_tpu.runtime.sparse import contraction_scheme_sparse as jcs
    from artensor_tpu_torch.runtime import lanes as planes

    for mod, val in ((pgk, "MIN_X_ELEMS"), (pgk, "GGK_MIN_WORK"),
                     (planes, "MIN_X_ELEMS"), (jgk, "MIN_X_ELEMS"),
                     (jgk, "GGK_MIN_WORK"), (jlanes, "MIN_X_ELEMS")):
        monkeypatch.setattr(mod, val, 1 << 8)
    monkeypatch.setattr(jgk, "SLACK", 1e9)
    w = rcs15
    sim = _off_form_sim((w["n"], w["layers"]), w["bits"], w["plan"])
    _, _, ctree = plan_from_dict(w["plan"])
    jsteps, _, _ = jcs(ctree, w["bits"], sc_target=12, negotiate=False,
                       fuse=False)
    kinds = [kernel_kind(s) for s in sim.steps]
    assert kinds.count("lane") == 3
    assert [_jax_kind(s) for s in jsteps] == kinds
    for s, j in zip(sim.steps, jsteps):
        if kernel_kind(s) == "lane":
            assert s.iy == j.iy
            assert_lane_plans_equal(s.lane, j.lane)


@pytest.mark.parametrize("width", [1, 4])
def test_fused_order_runs_exact(rcs15, width, monkeypatch):
    """Gate-block fusion end to end on the CPU: with the size gates
    lowered, every rewrite of the candidate model taken (no arbiter), the
    port's scheme of the committed small plan's fused order runs through
    its kernels' plain versions and every amplitude matches the JAX run
    and the state vector.  (``rcs12``'s plan is planned in the process,
    and what the planner returns depends on the runs before it.)"""
    from artensor_tpu_torch.plan_io import plan_from_dict
    from artensor_tpu_torch.runtime import fuse as pfuse
    from artensor_tpu_torch.runtime import sparse as psparse

    for mod, name in ((pgk, "MIN_X_ELEMS"), (pgk, "GGK_MIN_WORK"),
                      (pfuse, "MIN_X_ELEMS")):
        monkeypatch.setattr(mod, name, 1 << 8)
    w = rcs15
    sc = w["plan"]["meta"]["sc_target"]
    sim = _off_form_sim((w["n"], w["layers"]), w["bits"], w["plan"])
    _, _, ctree = plan_from_dict(w["plan"])
    base = ctree.to_order_dfs()
    targets = np.array([[int(c) for c in b] for b in w["bits"]],
                       dtype=np.uint8)
    tn = ctree.tn
    order = pfuse.reassociate_small_chains(
        base, tn.tensor_bonds, tn.bond_dims, targets=targets,
        qubit_of_tensor={t: (q,) for q, t in enumerate(tn.final_qubits)})
    assert order != [tuple(p) for p in base]
    steps, ob, bits_sorted, _ = psparse._compile_sparse(
        ctree, w["bits"], sc, True, None, _order=order)
    assert [(s.i, s.j) for s in steps] == order
    assert any(kernel_kind(s) for s in steps)
    sim._set_scheme(steps, ob, bits_sorted)
    amps = sim.contraction(slice_batch=width, device="cpu")
    assert sorted(sim.bitstrings_sorted) == sorted(w["jax_amps"])
    for a, b in zip(amps, sim.bitstrings_sorted):
        assert abs(a - w["exact"][int(b, 2)]) < 2e-5, b
        assert abs(a - w["jax_amps"][b]) < 2e-5, b


DEFAULT_RECORD = os.path.join(os.path.dirname(__file__), "data",
                              "torch_port_default_schemes.json")


@pytest.mark.parametrize("name,plan,fixture", [
    ("1k", "rcs_n30_m14_s0_sparse_sc24.json", "rcs_n30_m14_s0_amps1000.txt"),
    ("1k-sc25", "rcs_n30_m14_s0_sparse_sc25.json",
     "rcs_n30_m14_s0_amps1000.txt")])
def test_n30_default_scheme_matches_record(name, plan, fixture):
    """The default form (fusion and negotiation under the committed H100
    calibration) of the 1k and 1k-sc25 plans is the scheme recorded by
    ``scripts/default_schemes_torch_port.py`` (census and digest), which
    the card tests also hold the card host's compile to (the 10k plan's
    default compile takes too long for this suite and is held there
    only).  Its passes ran: fusion kept rewrites and negotiation made
    trial compiles."""
    import json

    from artensor_tpu_torch import load_plan
    from artensor_tpu_torch.runtime import sparse as psparse

    with open(DEFAULT_RECORD) as f:
        want = json.load(f)[name]
    with open(os.path.join(DATA, fixture)) as f:
        bits = [ln.split()[0] for ln in f if ln.strip()]
    _, _, ctree = load_plan(os.path.join(DATA, plan))
    sc = 25 if name == "1k-sc25" else 24
    steps, _, _ = psparse.contraction_scheme_sparse(ctree, bits, sc)
    census = Counter(kernel_kind(s) or "dot" for s in steps)
    assert dict(census) == want["census"]
    assert psparse.scheme_digest(steps) == want["digest"]
    from artensor_tpu_torch.runtime import scheme as pscheme

    stats = pscheme.compile_stats()
    assert stats["rewrites"] > 0 and stats["negotiate_compiles"] > 1
