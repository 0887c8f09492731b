"""Port host layers against the JAX package: circuits, to_numerical_tn,
simplify('sparse'), plan loading, the committed n30 workload data."""

import json
import os

import numpy as np
import pytest

from artensor_tpu import plan_io as jax_plan_io
from artensor_tpu.circuits import TensorNetworkCircuit as JaxCircuit
from artensor_tpu.circuits.random_circuits import random_circuit as jax_rc
from artensor_tpu.network import NumericalTensorNetwork as JaxNTN
from artensor_tpu.utils import log10sumexp2 as jax_l10, log2sumexp2 as jax_l2
from artensor_tpu_torch import plan_io, random_circuit
from artensor_tpu_torch.circuits import TensorNetworkCircuit
from artensor_tpu_torch.network import NumericalTensorNetwork
from artensor_tpu_torch.utils import log10sumexp2, log2sumexp2

HERE = os.path.dirname(__file__)
QSIM_N12 = os.path.join(HERE, "data", "circuit_n12_rcs.qsim")
DATA = os.path.join(HERE, "..", "artensor_tpu_torch", "data")
PLAN_N30 = os.path.join(DATA, "rcs_n30_m14_s0_sparse_sc24.json")
FIXTURE_N30 = os.path.join(DATA, "rcs_n30_m14_s0_amps1000.txt")

CIRCUITS = ("qsim_n12", "rcs_3x4_m8_s13")


def _both(name):
    if name == "qsim_n12":
        return JaxCircuit(QSIM_N12), TensorNetworkCircuit(QSIM_N12)
    args = (3, 4, 8)
    return (JaxCircuit(jax_rc(*args, seed=13)),
            TensorNetworkCircuit(random_circuit(*args, seed=13)))


def test_random_circuit_matches():
    assert random_circuit(5, 6, 14, seed=0) == jax_rc(5, 6, 14, seed=0)


@pytest.mark.parametrize("name", CIRCUITS)
def test_numerical_tn_matches(name):
    jc, pc = _both(name)
    jt, jtb, jbd, jfq = jc.to_numerical_tn()
    pt, ptb, pbd, pfq = pc.to_numerical_tn()
    assert ptb == jtb and pbd == jbd and list(pfq) == list(jfq)
    assert pt.keys() == jt.keys()
    for k in jt:
        np.testing.assert_array_equal(pt[k], jt[k])


@pytest.mark.parametrize("name", CIRCUITS)
def test_simplify_sparse_matches(name):
    jc, pc = _both(name)
    jn = JaxNTN(*jc.to_numerical_tn())
    pn = NumericalTensorNetwork(*pc.to_numerical_tn())
    jtb, jfq = jn.simplify("sparse")
    ptb, pfq = pn.simplify("sparse")
    assert ptb == jtb
    assert pfq == jfq                   # qubit-indexed, unsorted
    assert pn.bond_dims == jn.bond_dims
    for k in jn.tensors:
        np.testing.assert_allclose(pn.tensors[k], jn.tensors[k],
                                   rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", CIRCUITS)
def test_state_vec_matches(name):
    jc, pc = _both(name)
    np.testing.assert_allclose(pc.state_vec(), jc.state_vec(), atol=1e-12)


def test_logsumexp_matches():
    vals = [3.5, -2.0, 10.25, 0.0]
    assert log2sumexp2(vals) == pytest.approx(jax_l2(vals), abs=1e-12)
    assert log10sumexp2(vals) == pytest.approx(jax_l10(vals), abs=1e-12)
    assert log2sumexp2([]) == 0.0


def test_n30_plan_loads_with_stored_complexity():
    with open(PLAN_N30) as f:
        d = json.load(f)
    order, sliced, ctree = plan_io.load_plan(PLAN_N30)
    tc, sc, mc = ctree.complexity()
    assert tc == pytest.approx(d["complexity"]["tc"], abs=1e-9)
    assert sc == pytest.approx(d["complexity"]["sc"], abs=1e-9)
    assert mc == pytest.approx(d["complexity"]["mc"], abs=1e-9)
    assert sliced == d["slicing_bonds"] and len(sliced) == 6
    assert d["meta"]["sc_target"] == 24
    # the port's tree emits the JAX tree's scheme order
    _, _, jtree = jax_plan_io.load_plan(PLAN_N30)
    assert ctree.to_order_dfs() == jtree.to_order_dfs()


def test_n30_plan_is_for_the_generated_circuit():
    with open(PLAN_N30) as f:
        d = json.load(f)
    pn = NumericalTensorNetwork(*TensorNetworkCircuit(
        random_circuit(5, 6, 14, seed=0)).to_numerical_tn())
    tb, fq = pn.simplify("sparse")
    assert len(tb) == 188
    assert fq == d["final_qubits"]
    unsliced = {int(t): sorted(bs) for t, bs in d["tensor_bonds"].items()}
    assert unsliced == {t: sorted(bs) for t, bs in tb.items()}


def test_fixture_bitstrings_are_the_generator_s():
    want = [np.binary_repr(int(b), 30) for b in
            np.random.default_rng(0).choice(2 ** 30, 1000, replace=False)]
    with open(FIXTURE_N30) as f:
        rows = [ln.split() for ln in f if ln.strip()]
    assert [r[0] for r in rows] == want
    amps = np.array([float(r[1]) + 1j * float(r[2]) for r in rows])
    assert np.isfinite(amps).all()
    # Porter-Thomas: the mean of 2^n |a|^2 over random bitstrings is ~1
    assert 0.8 < (2 ** 30) * np.mean(np.abs(amps) ** 2) < 1.2
