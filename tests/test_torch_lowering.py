"""Port apply_lowered / apply_reorder against the JAX package, step by step
over a scheme compiled for tests/data/circuit_n12_rcs.qsim."""

import os

import numpy as np
import pytest

from artensor_tpu.ops.field import make_field as jax_make_field
from artensor_tpu.planner import find_order
from artensor_tpu.plan_io import plan_to_dict
from artensor_tpu.runtime.lowering import (apply_lowered as jax_apply_lowered,
                                           apply_reorder as jax_apply_reorder,
                                           lower_step as jax_lower_step,
                                           plan_reorder as jax_plan_reorder)
from artensor_tpu_torch import TensorNetworkSimulation
from artensor_tpu_torch.ops.field import SplitField
from artensor_tpu_torch.runtime.lowering import (apply_lowered, apply_reorder,
                                                 physical_shape, plan_reorder)

QSIM_N12 = os.path.join(os.path.dirname(__file__), "data",
                        "circuit_n12_rcs.qsim")
TOL = dict(rtol=2e-4, atol=1e-5)


def _rand(shape, rng):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _pt(x):
    return x[0].numpy() + 1j * x[1].numpy()


@pytest.fixture(scope="module")
def n12_plan():
    from artensor_tpu.circuits import TensorNetworkCircuit
    from artensor_tpu.network import NumericalTensorNetwork

    ntn = NumericalTensorNetwork(
        *TensorNetworkCircuit(QSIM_N12).to_numerical_tn())
    tb, fq = ntn.simplify("sparse")
    rng = np.random.default_rng(2)
    bits = [np.binary_repr(int(b), 12)
            for b in rng.choice(2 ** 12, 24, replace=False)]
    _, sliced, ctree = find_order(tb, ntn.bond_dims, fq, max_bitstrings=24,
                                  sc_target=9, trials=2, iters=6,
                                  slicing_repeat=1, parallel=False)
    return plan_to_dict(ctree, meta={"sc_target": 9}), bits


def _walk(sim):
    """(step, dims_i, dims_j) per step, tracking logical buffer dims."""
    tn = sim.ctree.tn
    fq = set(tn.final_qubits)
    dims = {t: ((2,) if t in fq else ()) + tuple(
        int(tn.bond_dims[b]) for b in bs) for t, bs in tn.tensor_bonds.items()}
    out = []
    for s in sim.steps:
        di, dj = dims[s.i], dims[s.j]
        out.append((s, di, dj))
        if s.gathers is not None:
            rows = sum(len(gi) for gi, _ in s.gathers)
            dy = (rows,) + tuple(s.lowered_chunks[0].dims_y[1:])
        else:
            dy = tuple(s.lowered.dims_y)
            if s.reshape is not None:
                dy = (s.reshape[0],) + dy[2:]
            if s.post_select is not None:
                dy = (len(s.post_select),) + dy[1:]
        dims[s.i] = dy
    return out


@pytest.mark.parametrize("lane_schedule", [True, False],
                         ids=["time_ordered", "reference_orders"])
def test_lowered_steps_match_jax(n12_plan, lane_schedule):
    plan, bits = n12_plan
    sim = TensorNetworkSimulation.from_circuit(QSIM_N12, bits)
    sim.load_plan(plan)
    if not lane_schedule:
        from artensor_tpu_torch.runtime.sparse import contraction_scheme_sparse
        sim.steps, _, _ = contraction_scheme_sparse(
            sim.ctree, bits, sim.sc_target, lane_schedule=False)
    jf = jax_make_field(np.complex64, "highest", "split")
    pf = SplitField()
    rng = np.random.default_rng(0)
    checked = 0
    for s, di, dj in _walk(sim):
        chunks = ([(s.lowered, di, dj)] if s.gathers is None else
                  [(low, (len(gi),) + di[1:], (len(gi),) + dj[1:])
                   for (gi, _), low in zip(s.gathers, s.lowered_chunks)])
        for low, ci, cj in chunks:
            x, y = _rand(ci, rng), _rand(cj, rng)
            want = np.einsum(x, list(s.ix_i), y, list(s.ix_j), list(s.iy))
            jlow = jax_lower_step(s.ix_i, s.ix_j, s.iy, ci, cj)
            jx = jf.reshape(jf.wrap(x), physical_shape(ci))
            jy = jf.reshape(jf.wrap(y), physical_shape(cj))
            jout = jax_apply_lowered(jf, jx, jy, jlow)
            jout = (np.asarray(jout[0]) + 1j * np.asarray(jout[1]))
            px = pf.reshape(pf.wrap(x, "cpu"), physical_shape(ci))
            py = pf.reshape(pf.wrap(y, "cpu"), physical_shape(cj))
            pout = _pt(apply_lowered(pf, px, py, low))
            assert pout.shape == jout.shape == tuple(low.phys_y)
            np.testing.assert_allclose(pout, jout, **TOL)
            np.testing.assert_allclose(pout.reshape(want.shape), want, **TOL)
            checked += 1
    assert checked >= len(sim.steps)


@pytest.mark.parametrize("batched", ["x", "y", "both"])
def test_lowered_width_axis(n12_plan, batched):
    """A leading slice-width axis on one or both operands equals the
    per-instance unbatched products."""
    plan, bits = n12_plan
    sim = TensorNetworkSimulation.from_circuit(QSIM_N12, bits)
    sim.load_plan(plan)
    pf = SplitField()
    rng = np.random.default_rng(1)
    W = 3
    bx, by = batched in ("x", "both"), batched in ("y", "both")
    for s, di, dj in _walk(sim)[:12]:
        if s.gathers is not None:
            continue
        x = _rand(((W,) if bx else ()) + di, rng)
        y = _rand(((W,) if by else ()) + dj, rng)
        px = pf.reshape(pf.wrap(x, "cpu"),
                        ((W,) if bx else ()) + physical_shape(di))
        py = pf.reshape(pf.wrap(y, "cpu"),
                        ((W,) if by else ()) + physical_shape(dj))
        got = _pt(apply_lowered(pf, px, py, s.lowered, bx, by))
        assert got.shape == (W,) + tuple(s.lowered.phys_y)
        for w in range(W):
            xw = pf.reshape(pf.wrap(x[w] if bx else x, "cpu"),
                            physical_shape(di))
            yw = pf.reshape(pf.wrap(y[w] if by else y, "cpu"),
                            physical_shape(dj))
            want = _pt(apply_lowered(pf, xw, yw, s.lowered))
            np.testing.assert_allclose(got[w], want, **TOL)


@pytest.mark.parametrize("perm", [(2, 0, 3, 1), (1, 2, 3, 0), (3, 2, 1, 0)])
def test_reorder_matches_jax(perm):
    dims = (2, 3, 4, 5)
    x = _rand(dims, np.random.default_rng(5))
    final = physical_shape(tuple(dims[p] for p in perm))
    jf = jax_make_field(np.complex64, "highest", "split")
    pf = SplitField()
    jr = jax_plan_reorder(dims, perm, final)
    want = jax_apply_reorder(jf, jf.wrap(x.reshape(2, -1)), jr)
    want = np.asarray(want[0]) + 1j * np.asarray(want[1])
    got = _pt(apply_reorder(pf, pf.wrap(x.reshape(2, -1), "cpu"),
                            plan_reorder(dims, perm, final)))
    np.testing.assert_array_equal(got, want)
