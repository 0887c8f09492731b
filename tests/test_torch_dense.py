"""The port's dense full-amplitude path as a whole: ``from_circuit`` without
bitstrings, ``load_plan``, ``contraction`` and ``tensor_contraction``, and
the single-card output-block walk, against the JAX package and the exact
state vector; the restoring ``add_bond``; and the GK kernel's plain
version at a step of the committed n30 dense scheme against JAX's kernel
in interpret mode."""

import os
import random

import numpy as np
import pytest
import torch

from artensor_tpu import plan_io as jplan_io
from artensor_tpu.circuits import TensorNetworkCircuit as JaxCircuit
from artensor_tpu.circuits.random_circuits import random_circuit
from artensor_tpu.network import AbstractTensorNetwork as JaxATN
from artensor_tpu.network import NumericalTensorNetwork as JaxNTN
from artensor_tpu.ops.field import make_field as jax_make_field
from artensor_tpu.planner import ContractionTree as JaxTree
from artensor_tpu.planner import find_order
from artensor_tpu.runtime import executor as jex
from artensor_tpu.runtime import gatherk as jgk
from artensor_tpu.runtime import scheme as jsch
from artensor_tpu.simulation import TensorNetworkSimulation as JaxSim
from artensor_tpu_torch import TensorNetworkSimulation, tensor_contraction
from artensor_tpu_torch.network import AbstractTensorNetwork
from artensor_tpu_torch.ops.field import SplitField
from artensor_tpu_torch.planner import ContractionTree
from artensor_tpu_torch.runtime import gatherk as pgk
from artensor_tpu_torch.runtime import scheme as psch
from artensor_tpu_torch.runtime.sparse import kernel_kind

DENSE_PLAN = os.path.join(os.path.dirname(__file__), "..",
                          "artensor_tpu_torch", "data",
                          "rcs_n30_m14_s0_dense_sc30.json")
TOL = 2e-5
PLAN_KW = dict(trials=2, iters=6, betas=np.linspace(3, 21, 12),
               slicing_repeat=1, parallel=False)
LOW_X = 1 << 8     # GK's size gate on both packages, so kernels run here


@pytest.fixture(scope="module")
def rcs12():
    """random_circuit(3, 4, 8, seed=13), dense: a JAX plan at sc_target 10
    (one sliced bond) and one at 12 (none), and the exact state."""
    n, layers = random_circuit(3, 4, 8, seed=13)
    circ = JaxCircuit((n, layers))
    ntn = JaxNTN(*circ.to_numerical_tn())
    tb2, fq2 = ntn.simplify("normal")
    plans = {}
    for sc in (10, 12):
        _, sliced, ctree = find_order(tb2, ntn.bond_dims, fq2,
                                      sc_target=sc, **PLAN_KW)
        plans[sc] = jplan_io.plan_to_dict(ctree, meta={"sc_target": sc})
    assert len(plans[10]["slicing_bonds"]) >= 1
    assert plans[12]["slicing_bonds"] == []
    return dict(n=n, layers=layers, ntn=ntn, tb2=tb2, plans=plans,
                state=circ.state_vec())


@pytest.fixture
def low_gates(monkeypatch):
    monkeypatch.setattr(jgk, "MIN_X_ELEMS", LOW_X)
    monkeypatch.setattr(jgk, "SLACK", 1e9)
    monkeypatch.setattr(pgk, "MIN_X_ELEMS", LOW_X)


def _jax_sim(w, plan):
    """JAX's dense simulation on the same plan."""
    sim = JaxSim.from_circuit((w["n"], w["layers"]))
    sim.order, sim.slicing_bonds, sim.ctree = jplan_io.plan_from_dict(plan)
    sim.slicing_bonds = list(sim.slicing_bonds)
    sim._compile_scheme()
    return sim


def _port_sim(w, plan):
    return TensorNetworkSimulation.from_circuit(
        (w["n"], w["layers"])).load_plan(plan)


@pytest.mark.parametrize("width", [1, 2])
def test_contraction_matches_jax_and_state_vec(rcs12, low_gates, width):
    w = rcs12
    sim = _port_sim(w, w["plans"][10])
    assert sim.pattern == "normal" and sim.bitstrings_sorted is None
    assert sum(kernel_kind(s) == "gk" for s in sim.steps) >= 1
    got = sim.contraction(slice_batch=width, device="cpu")
    want = _jax_sim(w, w["plans"][10]).contraction(dtype=np.complex64)
    assert got.shape == (2,) * w["n"]
    assert np.abs(got - w["state"]).max() < TOL
    assert np.abs(got - want).max() < TOL


def test_dense_mode_is_fixed_by_the_bitstrings(rcs12):
    """No bitstrings: simplify('normal'), every qubit's open leg kept;
    ``load_plan`` needs no sc_target in dense mode."""
    w = rcs12
    sim = TensorNetworkSimulation.from_circuit((w["n"], w["layers"]))
    assert (sim.pattern, sim.max_bitstrings) == ("normal", 1)
    assert sim.tensor_bonds == w["tb2"]
    plan = dict(w["plans"][12], meta=None)
    sim.load_plan(plan)
    assert sorted(sim.permute_dims) == list(range(w["n"]))
    bits = TensorNetworkSimulation.from_circuit((w["n"], w["layers"]),
                                                ["0" * w["n"]])
    assert bits.pattern == "sparse"


def test_tensor_contraction_matches_jax(rcs12, low_gates):
    """The one-call executor on an unsliced scheme: the same logically
    shaped result as JAX's, and the state once in qubit order."""
    w = rcs12
    plan = w["plans"][12]
    arrays = [w["ntn"].tensors[i] for i in range(len(w["ntn"].tensors))]
    steps, ob = psch.contraction_scheme(
        TensorNetworkSimulation.from_circuit((w["n"], w["layers"]))
        .load_plan(plan).ctree)
    jsteps, job = jsch.contraction_scheme(jplan_io.plan_from_dict(plan)[2])
    assert ob == job
    got = tensor_contraction(arrays, steps, device="cpu")
    want = np.asarray(jex.tensor_contraction(
        arrays, jsteps, jax_make_field(np.complex64, "highest", "split")))
    assert got.shape == want.shape == (2,) * w["n"]
    assert np.abs(got - want).max() < TOL
    perm = sorted(range(len(ob)), key=lambda a: int(ob[a].split("-")[1]))
    assert np.abs(got.transpose(perm) - w["state"]).max() < TOL


@pytest.mark.parametrize("d_out", [2, 3])
def test_output_blocks_match_jax_and_state_vec(rcs12, low_gates, d_out):
    """The block walk yields JAX's (bits, qubits) in JAX's order, each
    block equal to JAX's, and the blocks reassemble the state."""
    w = rcs12
    n = w["n"]
    sim = _port_sim(w, w["plans"][10])
    jblocks = list(_jax_sim(w, w["plans"][10]).contraction_output_blocks(
        d_out, dtype=np.complex64))
    got = np.zeros((2,) * n, dtype=np.complex128)
    seen = 0
    for (bits, qubits, block), (jbits, jqubits, jblock) in zip(
            sim.contraction_output_blocks(d_out, device="cpu"), jblocks):
        assert (bits, qubits) == (jbits, jqubits)
        assert block.shape == (2,) * (n - d_out)
        assert np.abs(block - jblock).max() < TOL
        idx = [slice(None)] * n
        for q, b in zip(qubits, bits):
            idx[q] = int(b)
        got[tuple(idx)] = block
        seen += 1
    assert seen == len(jblocks) == 2 ** d_out
    assert np.abs(got - w["state"]).max() < TOL


def test_output_blocks_postprocess_reduces_on_the_device(rcs12, low_gates):
    """``postprocess`` sees each flat split block on the device and its
    result is yielded in place of the block: here each block's norm^2,
    which sum to the state's."""
    w = rcs12
    sim = _port_sim(w, w["plans"][10])
    seen = []

    def norm2(field, oid, value):
        assert isinstance(field, SplitField)
        assert all(isinstance(c, torch.Tensor) for c in value)
        seen.append(oid)
        s = (value[0] ** 2 + value[1] ** 2).sum().reshape(1)
        return s, torch.zeros_like(s)

    parts = {bits: complex(v[0]) for bits, _, v in
             sim.contraction_output_blocks(2, postprocess=norm2,
                                           device="cpu")}
    assert seen == [0, 1, 2, 3]
    qs = sorted(range(w["n"]))[:2]
    for bits, v in parts.items():
        idx = [slice(None)] * w["n"]
        for q, b in zip(qs, bits):
            idx[q] = int(b)
        want = float(np.sum(np.abs(w["state"][tuple(idx)]) ** 2))
        assert abs(v.real - want) < 1e-5 and v.imag == 0.0
    assert abs(sum(v.real for v in parts.values()) - 1.0) < 1e-4


def test_recompile_after_block_walk_gives_the_state(rcs12, low_gates):
    """The block walk slices open legs post hoc and restores them: a
    recompile of the scheme afterwards sees every leaf's bonds in their
    original order, so the whole state is still right (the JAX package's
    ``add_bond`` appends the restored legs, ROADMAP.md Queue C)."""
    w = rcs12
    sim = _port_sim(w, w["plans"][10])
    bonds0 = {t: list(b) for t, b in sim.ctree.tn.tensor_bonds.items()}
    for _ in sim.contraction_output_blocks(3, device="cpu"):
        pass
    assert sim.ctree.tn.tensor_bonds == bonds0
    sim._compile_scheme()
    got = sim.contraction(device="cpu")
    assert np.abs(got - w["state"]).max() < TOL


@pytest.mark.parametrize("seed", range(4))
def test_add_bond_restores_bond_lists_and_complexity(rcs12, seed):
    """``slicing`` then ``add_bond``, in any order of restores: every
    tensor's bond list comes back in its original order, and the tree's
    ``complexity()`` equals JAX's after each operation."""
    w = rcs12
    plan = w["plans"][12]
    order = [tuple(p) for p in plan["order"]]
    tb = {int(t): list(b) for t, b in plan["tensor_bonds"].items()}
    ptree = ContractionTree(AbstractTensorNetwork(tb, plan["bond_dims"]),
                            order)
    jtree = JaxTree(JaxATN(tb, plan["bond_dims"]), order)
    rng = random.Random(seed)
    bonds = sorted(ptree.tn.bond_dims)
    cut = rng.sample(bonds, 5)
    for b in cut:
        ptree.slicing(b)
        jtree.slicing(b)
        assert ptree.complexity() == pytest.approx(jtree.complexity())
        assert set(ptree.tn.slicing_bonds) == set(jtree.tn.slicing_bonds)
    rng.shuffle(cut)
    for b in cut:
        ptree.add_bond(b)
        jtree.add_bond(b)
        assert ptree.complexity() == pytest.approx(jtree.complexity())
    assert ptree.tn.tensor_bonds == tb
    assert ptree.tn.sliced == {}
    assert {t: sorted(b, key=str) for t, b in jtree.tn.tensor_bonds.items()} \
        == {t: sorted(b, key=str) for t, b in tb.items()}


def test_gk_plain_at_a_dense_step_matches_jax_interpret(monkeypatch):
    """The GK step of the committed n30 dense scheme with the smallest X
    (its first kernel step): the port's plain version against JAX's
    kernel in interpret mode on the same operands, width 1."""
    from artensor_tpu_torch import random_circuit as prc
    from artensor_tpu_torch.runtime import executor as pex

    sim = TensorNetworkSimulation.from_circuit(prc(5, 6, 14, seed=0))
    sim.load_plan(DENSE_PLAN)
    run_steps, _ = pex.precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)
    gk = [s for s in run_steps if kernel_kind(s) == "gk"]
    s = min(gk, key=lambda s: s.lane.x_elems * s.lane.H)
    args = (s.ix_i, s.ix_j, s.iy, s.dims_i, s.dims_j)
    jplan = jgk.plan_gk_step(*args)
    assert jplan is not None, jgk.LAST_REJECT
    assert s.lane.x_elems >= 1 << 16      # a dense-path size, no gate lowered
    rng = np.random.default_rng(9)
    xi, xj = [(rng.standard_normal(d) + 1j * rng.standard_normal(d))
              .astype(np.complex64).reshape(-1)
              for d in (s.dims_i, s.dims_j)]
    pf = SplitField()
    out = pgk.apply_gk_step(pf, pf.wrap(xi, "cpu"), pf.wrap(xj, "cpu"),
                            s.lane)
    got = out[0].numpy() + 1j * out[1].numpy()
    jf = jax_make_field(np.complex64, "highest", "split")
    pair = lambda a: (np.ascontiguousarray(a.real),
                      np.ascontiguousarray(a.imag))
    jout = jgk.apply_gk_step(jf, pair(xi), pair(xj), jplan, interpret=True)
    want = np.asarray(jout[0]) + 1j * np.asarray(jout[1])
    np.testing.assert_allclose(got.reshape(-1), want.reshape(-1),
                               rtol=2e-4, atol=1e-5)
    lab = {}
    ids = lambda ix: [lab.setdefault(b, len(lab)) for b in ix]
    exact = np.einsum(xi.reshape(s.dims_i), ids(s.ix_i),
                      xj.reshape(s.dims_j), ids(s.ix_j), ids(s.iy))
    np.testing.assert_allclose(got.reshape(-1), exact.reshape(-1),
                               rtol=2e-4, atol=1e-5)
