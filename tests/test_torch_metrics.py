"""The port's scheme cost model (``runtime/metrics.py``) against the JAX
package's: the device-neutral numbers (flops, traffic, peak live bytes,
the width audit) agree on equal schemes; the H100 time model reads only the
card's rates and the port's calibration file."""

import json
import os

import numpy as np
import pytest

from artensor_tpu import plan_io as jplan_io
from artensor_tpu.circuits import TensorNetworkCircuit as JaxCircuit
from artensor_tpu.circuits.random_circuits import random_circuit
from artensor_tpu.network import NumericalTensorNetwork as JaxNTN
from artensor_tpu.planner import find_order
from artensor_tpu.plan_io import plan_to_dict
from artensor_tpu.runtime import executor as jex
from artensor_tpu.runtime import metrics as jmt
from artensor_tpu.runtime.sparse import contraction_scheme_sparse as jcs
from artensor_tpu_torch import TensorNetworkSimulation
from artensor_tpu_torch.plan_io import plan_from_dict
from artensor_tpu_torch.runtime import executor as pex
from artensor_tpu_torch.runtime import metrics as pmt
from artensor_tpu_torch.runtime.sparse import (contraction_scheme_sparse,
                                               kernel_kind)

DATA = os.path.join(os.path.dirname(__file__), "..", "artensor_tpu_torch",
                    "data")
RGF_PLAN = os.path.join(os.path.dirname(__file__), "data",
                        "torch_port_rcs15_rgflat_plan.json")
N30_PLAN = os.path.join(DATA, "rcs_n30_m14_s0_sparse_sc24.json")
WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128)


def _rcs12():
    """random_circuit(3, 4, 8, seed=13), 48 bitstrings, a JAX plan at
    sc_target 10 (as tests/test_torch_sparse.py's ``rcs12``)."""
    n, layers = random_circuit(3, 4, 8, seed=13)
    ntn = JaxNTN(*JaxCircuit((n, layers)).to_numerical_tn())
    tb2, fq2 = ntn.simplify("sparse")
    rng = np.random.default_rng(4)
    bits = [np.binary_repr(b, n)
            for b in rng.choice(2 ** n, 48, replace=False)]
    _, sliced, ctree = find_order(
        tb2, ntn.bond_dims, fq2, max_bitstrings=48, sc_target=10,
        trials=2, iters=6, betas=np.linspace(3, 21, 12), slicing_repeat=1,
        parallel=False)
    return (n, layers), bits, plan_to_dict(ctree, meta={"sc_target": 10})


def _rcs15():
    n, layers = random_circuit(3, 5, 8, seed=13)
    rng = np.random.default_rng(4)
    bits = [np.binary_repr(b, n)
            for b in rng.choice(2 ** n, 128, replace=False)]
    with open(RGF_PLAN) as f:
        return (n, layers), bits, json.load(f)


def _n30():
    from artensor_tpu_torch import random_circuit as prc

    with open(os.path.join(DATA, "rcs_n30_m14_s0_amps1000.txt")) as f:
        bits = [ln.split()[0] for ln in f if ln.strip()]
    with open(N30_PLAN) as f:
        return prc(5, 6, 14, seed=0), bits, json.load(f)


CASES = {"rcs12": _rcs12, "rcs15": _rcs15, "n30-1k": _n30}


@pytest.fixture(scope="module", params=sorted(CASES))
def schemes(request):
    """The off-form scheme (time-ordered layouts, no fusion, no
    negotiation) of one plan in both packages, compiled and after the
    static folds, with the slicing axes."""
    circuit, bits, plan = CASES[request.param]()
    sc = plan["meta"]["sc_target"]
    sim = TensorNetworkSimulation.from_circuit(circuit, bits)
    sim.order, sim.slicing_bonds, sim.ctree = plan_from_dict(plan)
    psteps, pob, pbits = contraction_scheme_sparse(
        sim.ctree, bits, sc, fuse=False, negotiate=False)
    sim._set_scheme(psteps, pob, pbits)
    _, _, jctree = jplan_io.plan_from_dict(plan)
    jsteps, _, jbits = jcs(jctree, bits, sc_target=sc, negotiate=False,
                           fuse=False)
    assert [kernel_kind(s) is None for s in psteps] == \
        [s.lane is None for s in jsteps]
    arrays = [sim.tensors[i] for i in range(len(sim.tensors))]
    axes = sim.slicing_axes
    jaxes = jex.build_slicing_axes(sim.tensor_bonds, sim.slicing_bonds,
                                   batched_tensors=sim.final_qubits)
    prun, _ = pex.precompute_static_steps(psteps, arrays, axes)
    jrun, _ = jex.precompute_static_steps(jsteps, arrays, jaxes)
    return dict(name=request.param, p=psteps, j=jsteps, prun=prun,
                jrun=jrun, axes=axes, jaxes=jaxes,
                k=len(sim.slicing_bonds))


def _lows(s):
    return [s.lowered] if s.lowered is not None else list(s.lowered_chunks)


def test_flops_and_traffic_match_jax(schemes):
    p, j = schemes["p"], schemes["j"]
    assert pmt.scheme_flops(p) == jmt.scheme_flops(j)
    assert pmt.scheme_flops(p, "karatsuba") == jmt.scheme_flops(
        j, "karatsuba")
    for ps, js in zip(p, j):
        assert [pmt.step_traffic_bytes(low) for low in _lows(ps)] == \
            [jmt.step_traffic_bytes(low) for low in _lows(js)]
        assert pmt.step_overhead_bytes(ps, _lows(ps)) == \
            jmt.step_overhead_bytes(js, _lows(js))
    assert pmt.reorder_census(p) == jmt.reorder_census(j)


def test_peak_bytes_match_jax(schemes):
    for pk, jk in (("p", "j"), ("prun", "jrun")):
        p, j = schemes[pk], schemes[jk]
        assert pmt.slice_dynamic_ids(p, schemes["axes"]) == \
            jmt.slice_dynamic_ids(j, schemes["jaxes"])
        assert pmt.scheme_peak_live_bytes(p) == \
            jmt.scheme_peak_live_bytes(j)
        assert pmt.scheme_peak_live_bytes(p, slicing_axes=schemes["axes"]) \
            == jmt.scheme_peak_live_bytes(j, slicing_axes=schemes["jaxes"])
        for w in WIDTHS:
            assert pmt.scheme_peak_bytes_at_width(p, w, schemes["axes"]) \
                == jmt.scheme_peak_bytes_at_width(j, w, schemes["jaxes"]), w


def test_width_audit_matches_jax_under_one_budget(schemes):
    p, j = schemes["prun"], schemes["jrun"]
    one = pmt.scheme_peak_bytes_at_width(p, 1, schemes["axes"])
    for budget in (one * 0.5, one * 3, one * 20, 1e12):
        for req in (1, 8, 128):
            assert pmt.max_safe_slice_batch(
                p, req, budget, schemes["axes"]) == \
                jmt.max_safe_slice_batch(j, req, budget, schemes["jaxes"])


def test_wall_estimate_uses_the_h100_model(schemes, tmp_path, monkeypatch):
    """The estimate is the card's model: kernel steps at their design
    bound (plans' TPU ``est_s`` never read), the dot fallback at the
    float32 rate, the host overhead over the widest width the budget
    allows; the factors come from the calibration path given."""
    from artensor_tpu_torch import kernels

    steps, axes, k = schemes["prun"], schemes["axes"], schemes["k"]
    ident = str(tmp_path / "absent.json")
    kern_s, dot_s, bytes_ps, n = pmt.scheme_wall_components(steps, ident)
    assert n == len(steps) and bytes_ps > 0
    want_kern = sum(sum(pmt.plan_design_bound(s.lane)[1:])
                    for s in steps if s.lane is not None)
    assert kern_s == pytest.approx(want_kern, rel=1e-12)
    # doubling the card's rates halves every term
    monkeypatch.setattr(kernels, "H100_HBM_BYTES_PER_S",
                        2 * kernels.H100_HBM_BYTES_PER_S)
    monkeypatch.setattr(kernels, "H100_FP32_FLOP_PER_S",
                        2 * kernels.H100_FP32_FLOP_PER_S)
    monkeypatch.setattr(kernels, "H100_TF32_FLOP_PER_S",
                        2 * kernels.H100_TF32_FLOP_PER_S)
    k2, d2, _, _ = pmt.scheme_wall_components(steps, ident)
    assert (k2, d2) == pytest.approx((kern_s / 2, dot_s / 2), rel=1e-12)
    monkeypatch.undo()
    # the calibration file scales the terms and sets the overhead
    cal = tmp_path / "cal.json"
    cal.write_text(json.dumps({
        "kern_factor": 2.0, "dot_factor": 3.0, "byte_factor": 0.5,
        "step_overhead_w1_s": 1e-4,
        "family_factors": {f: 1.0 for f in pmt.FAMILIES}}))
    budget = 1e15
    total, width, _ = pmt.scheme_wall_estimate(
        steps, k, hbm_budget_bytes=budget, slicing_axes=axes,
        calibration=str(cal))
    assert width == min(256, 2 ** k)
    per_slice = 2 * kern_s + 3 * dot_s + 0.5 * bytes_ps \
        / kernels.H100_HBM_BYTES_PER_S
    assert total == pytest.approx(
        2 ** k * (per_slice + n * 1e-4 / width), rel=1e-12)
    # identity factors without the file, the port's overhead constant
    from artensor_tpu_torch.planner.cost import STEP_OVERHEAD_W1_S
    total, width, _ = pmt.scheme_wall_estimate(
        steps, k, hbm_budget_bytes=budget, slicing_axes=axes,
        calibration=ident)
    assert total == pytest.approx(2 ** k * (
        kern_s + dot_s + n * STEP_OVERHEAD_W1_S / width), rel=1e-12)


def test_chosen_width_fits_the_budget_and_divides(schemes):
    steps, axes, k = schemes["prun"], schemes["axes"], schemes["k"]
    w = pmt.dividing_slice_width(steps, k, axes)
    assert (2 ** k) % w == 0 and w <= 128
    from artensor_tpu_torch.planner.cost import HBM_BUDGET_BYTES
    assert pmt.scheme_peak_bytes_at_width(steps, w, axes) <= HBM_BUDGET_BYTES
    assert w == min(128, 2 ** k,
                    pmt.max_safe_slice_batch(steps, 256, None, axes))
