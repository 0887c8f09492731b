"""The port's scientific-notation run (``runtime/rescaled.py``) against the
JAX package's: the rescaled runner on a sliced dense and a sliced sparse
scheme (both packages' off form of one JAX plan, so their steps and hence
their factors are the same), and ``contraction(scientific_notation=True)``
on both; amplitudes t * 10**f within 2e-5 of the largest |amplitude|,
keyed by bitstring, factors within 1e-5 in log10."""

import numpy as np
import pytest
import torch

from artensor_tpu import plan_io as jplan_io
from artensor_tpu.circuits import TensorNetworkCircuit as JaxCircuit
from artensor_tpu.circuits.random_circuits import random_circuit
from artensor_tpu.network import NumericalTensorNetwork as JaxNTN
from artensor_tpu.ops.field import make_field as jax_make_field
from artensor_tpu.planner import find_order
from artensor_tpu.simulation import PlannerConfig
from artensor_tpu.simulation import TensorNetworkSimulation as JaxSim
from artensor_tpu_torch import TensorNetworkSimulation
from artensor_tpu_torch.ops.field import SplitField
from artensor_tpu_torch.runtime import rescaled as presc

TOL = 2e-5          # of the largest |amplitude|: complex64 on both sides
FACTOR_TOL = 1e-5   # log10
PLAN_KW = dict(trials=2, iters=5, betas=np.linspace(3, 21, 10),
               slicing_repeat=1, parallel=False)


def _plan(n, layers, pattern, sc, bits=None):
    ntn = JaxNTN(*JaxCircuit((n, layers)).to_numerical_tn())
    tb2, fq2 = ntn.simplify(pattern)
    kw = dict(max_bitstrings=len(bits)) if bits else {}
    _, sliced, ctree = find_order(tb2, ntn.bond_dims, fq2, sc_target=sc,
                                  **kw, **PLAN_KW)
    assert len(sliced) >= 1
    return jplan_io.plan_to_dict(ctree, meta={"sc_target": sc})


def off_form_sims(n, layers, bits, plan):
    """The JAX and the port simulation of ``plan``, each with its scheme in
    the off form (no fusion, no negotiation): the two packages make the
    same steps there."""
    from artensor_tpu.runtime import executor as jex
    from artensor_tpu.runtime.scheme import contraction_scheme as jcs_dense
    from artensor_tpu.runtime.sparse import contraction_scheme_sparse as jcs
    from artensor_tpu.simulation import _bond_sort_key
    from artensor_tpu_torch.plan_io import plan_from_dict
    from artensor_tpu_torch.runtime.scheme import contraction_scheme
    from artensor_tpu_torch.runtime.sparse import contraction_scheme_sparse

    sc = plan["meta"]["sc_target"]
    js = JaxSim.from_circuit(JaxCircuit((n, layers)), bits)
    js.order, sliced, js.ctree = jplan_io.plan_from_dict(plan)
    js.slicing_bonds = list(sliced)
    js.config = PlannerConfig(sc_target=sc)
    if bits:
        js.steps, js.output_bonds, js.bitstrings_sorted = jcs(
            js.ctree, bits, sc, fuse=False, negotiate=False)
    else:
        js.steps, js.output_bonds = jcs_dense(js.ctree, fuse=False,
                                              negotiate=False)
        js.bitstrings_sorted = None
    js.slicing_axes = jex.build_slicing_axes(
        js.tensor_bonds, js.slicing_bonds,
        batched_tensors=js.final_qubits if bits else ())
    keys = [_bond_sort_key(b) for b in js.output_bonds]
    perm = tuple(sorted(range(len(keys)), key=keys.__getitem__))
    js.permute_dims = ((0,) + tuple(p + 1 for p in perm)) if bits else perm

    ps = TensorNetworkSimulation.from_circuit((n, layers), bits)
    ps.order, ps.slicing_bonds, ps.ctree = plan_from_dict(plan)
    ps.sc_target = float(sc)
    ps._set_scheme(*(contraction_scheme_sparse(ps.ctree, bits, sc,
                                               fuse=False, negotiate=False)
                     if bits else contraction_scheme(
                         ps.ctree, fuse=False, negotiate=False)))
    assert [(s.i, s.j) for s in ps.steps] == [(s.i, s.j) for s in js.steps]
    return js, ps


@pytest.fixture(scope="module")
def dense_case():
    """random_circuit(3, 3, 6, seed=11), the whole 2^9 state, a JAX plan
    at sc_target 4 (sliced)."""
    n, layers = random_circuit(3, 3, 6, seed=11)
    return dict(n=n, layers=layers, bits=[],
                plan=_plan(n, layers, "normal", 4),
                state=JaxCircuit((n, layers)).state_vec())


@pytest.fixture(scope="module")
def sparse_case():
    """random_circuit(3, 3, 6, seed=13), 60 bitstrings, a JAX plan at
    sc_target 6 (the scenario of tests/test_aux.py:219)."""
    n, layers = random_circuit(3, 3, 6, seed=13)
    rng = np.random.default_rng(5)
    bits = [np.binary_repr(b, n)
            for b in rng.choice(2 ** n, 60, replace=False)]
    return dict(n=n, layers=layers, bits=bits,
                plan=_plan(n, layers, "sparse", 6, bits),
                state=JaxCircuit((n, layers)).state_vec().reshape(-1))


def _runners(js, ps):
    """Both packages' rescaled runners over their folded, staged steps;
    returns ``(jax (t, f), port (t, f), port sim's out shape)``."""
    import jax

    from artensor_tpu.runtime import executor as jex
    from artensor_tpu.runtime.rescaled import make_rescaled_runner
    from artensor_tpu.runtime.segmented import apply_dense_step
    from artensor_tpu.runtime.sparse import apply_sparse_step

    field = jax_make_field(np.complex64, "highest", "split")
    run_steps, host = jex.precompute_static_steps(
        js.steps, [js.tensors[i] for i in range(len(js.tensors))],
        js.slicing_axes)
    staged = jex.stage_tensors(field, host)
    sparse = js.bitstrings_sorted is not None
    out_shape = ((len(js.bitstrings_sorted),) if sparse else ()) \
        + (2,) * len(js.output_bonds)
    step = apply_sparse_step if sparse else apply_dense_step
    jt, jf = jax.jit(make_rescaled_runner(
        step, run_steps, js.slicing_axes, len(js.slicing_bonds), out_shape,
        field))(staged)
    jt = field.unwrap(jt).reshape(out_shape)

    pfield, prun_steps, arrays, pshape, _, pstep = ps._staged(
        torch.device("cpu"))
    assert len(prun_steps) == len(run_steps)
    pt, pf = presc.make_rescaled_runner(
        pstep, prun_steps, ps.slicing_axes, len(ps.slicing_bonds), pshape,
        pfield)(arrays)
    pt = pfield.unwrap(pt).reshape(pshape)
    return (jt, float(jf)), (pt, float(pf))


def test_rescaled_dense_runner_matches_jax(dense_case):
    w = dense_case
    js, ps = off_form_sims(w["n"], w["layers"], [], w["plan"])
    (jt, jf), (pt, pf) = _runners(js, ps)
    assert abs(pf - jf) <= FACTOR_TOL
    # the mantissa stays O(1), the value is the state's
    assert np.abs(pt).max() < 10.0
    got = (pt * 10.0 ** pf).transpose(ps.permute_dims)
    want = (jt * 10.0 ** jf).transpose(js.permute_dims)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale
    assert np.abs(got - w["state"]).max() <= TOL * scale


def test_rescaled_sparse_runner_matches_jax(sparse_case):
    w = sparse_case
    js, ps = off_form_sims(w["n"], w["layers"], w["bits"], w["plan"])
    (jt, jf), (pt, pf) = _runners(js, ps)
    assert abs(pf - jf) <= FACTOR_TOL
    got = dict(zip(ps.bitstrings_sorted, pt.reshape(-1) * 10.0 ** pf))
    want = dict(zip(js.bitstrings_sorted, jt.reshape(-1) * 10.0 ** jf))
    assert sorted(got) == sorted(want)
    scale = max(abs(v) for v in want.values())
    for b, v in want.items():
        assert abs(got[b] - v) <= TOL * scale, b
        assert abs(got[b] - w["state"][int(b, 2)]) <= TOL * scale, b


@pytest.mark.parametrize("pattern", ["dense", "sparse"])
def test_contraction_scientific_notation_matches_jax(dense_case, sparse_case,
                                                     pattern):
    """``contraction(scientific_notation=True)`` of both packages on the
    same off-form scheme: equal factors and values."""
    w = dense_case if pattern == "dense" else sparse_case
    js, ps = off_form_sims(w["n"], w["layers"], w["bits"], w["plan"])
    ja, jf = js.contraction(scientific_notation=True)
    pa, pf = ps.contraction(scientific_notation=True, device="cpu")
    assert ps.run_stats["executor"] == "rescaled"
    assert ps.run_stats["slice_batch"] == 1
    assert abs(pf - jf) <= FACTOR_TOL
    got, want = pa * 10.0 ** pf, ja * 10.0 ** jf
    scale = np.abs(want).max()
    if pattern == "sparse":
        got = dict(zip(ps.bitstrings_sorted, got))
        want = dict(zip(js.bitstrings_sorted, want))
        assert all(abs(got[b] - v) <= TOL * scale for b, v in want.items())
    else:
        assert np.abs(got - want).max() <= TOL * scale


def test_rescaled_equals_the_plain_run(sparse_case):
    """On the port alone: the rescaled run's t * 10**f equals the sliced
    runner's plain sum, and the mantissa is O(1)."""
    w = sparse_case
    sim = TensorNetworkSimulation.from_circuit(
        (w["n"], w["layers"]), w["bits"]).load_plan(w["plan"])
    plain = sim.contraction(slice_batch=2, device="cpu")
    t, f = sim.contraction(scientific_notation=True, device="cpu")
    assert np.abs(t).max() < 10.0
    scale = np.abs(plain).max()
    assert np.abs(t * 10.0 ** f - plain).max() <= TOL * scale


def test_max_abs_matches_jax():
    from artensor_tpu.ops.field import make_field

    rng = np.random.default_rng(3)
    a = (rng.standard_normal((5, 7)) + 1j * rng.standard_normal((5, 7))
         ).astype(np.complex64)
    jf = make_field(np.complex64, "highest", "split")
    pf = SplitField()
    want = float(jf.max_abs(jf.wrap(a)))
    got = pf.max_abs(pf.wrap(a, "cpu"))
    assert got.dim() == 0 and float(got) == want


def test_combine_rescaled_keeps_the_larger_factor():
    """(t1, f1) + (t2, f2) in units of 10**max(f1, f2), and the runner's
    start value (0, -1e30) is neutral."""
    pf = SplitField()
    t1 = pf.wrap(np.array([1.0 + 2.0j, -0.5j], np.complex64), "cpu")
    t2 = pf.wrap(np.array([0.25, 1.0], np.complex64), "cpu")
    f1, f2 = torch.tensor(-3.0), torch.tensor(-1.0)
    t, m = presc.combine_rescaled((t1, f1), (t2, f2), pf)
    assert float(m) == -1.0
    want = np.array([1.0 + 2.0j, -0.5j]) * 1e-2 + np.array([0.25, 1.0])
    assert np.abs(pf.unwrap(t) - want).max() < 1e-6
    zero = (pf.zeros((2,), "cpu"), torch.tensor(-1e30))
    t, m = presc.combine_rescaled(zero, (t2, f2), pf)
    assert float(m) == -1.0
    assert np.array_equal(pf.unwrap(t), pf.unwrap(t2))
