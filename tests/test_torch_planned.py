"""The port's entry points that plan, on ``device="cpu"``, against the JAX
package's and the exact state vector: ``prepare_contraction`` and
``contraction`` (sparse and dense), ``update_scheme`` with a second batch,
the one-shots ``quantum_circuit_simulation`` and
``tensor_network_contraction``, and ``prepare_output_sharded`` with its
planned block walk."""

import os

import numpy as np
import pytest

from artensor_tpu.circuits import TensorNetworkCircuit as JaxCircuit
from artensor_tpu.simulation import TensorNetworkSimulation as JaxSim
from artensor_tpu.simulation import \
    quantum_circuit_simulation as jax_quantum_circuit_simulation
from artensor_tpu.simulation import \
    tensor_network_contraction as jax_tensor_network_contraction
from artensor_tpu_torch import (PlannerConfig, TensorNetworkSimulation,
                                quantum_circuit_simulation,
                                tensor_network_contraction)
from artensor_tpu_torch.circuits import TensorNetworkCircuit, random_circuit
from artensor_tpu_torch.runtime.sparse import kernel_kind

QSIM = os.path.join(os.path.dirname(__file__), "data", "circuit_n12_rcs.qsim")
TOL = 2e-5
PLAN = dict(trials=2, iters=6, betas=tuple(np.linspace(3, 21, 12)),
            slicing_repeat=1, parallel=False)
SC = {"sparse": 10, "dense": 10}    # 4 and 2 sliced bonds on the n12 file
SHARD_PLAN = dict(trials=2, iters=5, betas=tuple(np.linspace(3, 21, 10)),
                  slicing_repeat=1, parallel=False)


@pytest.fixture(scope="module")
def n12():
    """The n12 qsim file's exact state and two disjoint batches of 64
    bitstrings."""
    picks = np.random.default_rng(7).choice(4096, 128, replace=False)
    bits = [np.binary_repr(int(p), 12) for p in picks]
    return dict(state=TensorNetworkCircuit(QSIM).state_vec().reshape(-1),
                batches=(bits[:64], bits[64:]))


def _by_bits(amps, bits):
    return dict(zip(bits, np.asarray(amps).reshape(-1)))


def _check_sparse(got, got_bits, want, want_bits, state):
    """Keyed by bitstring: the port's amplitudes against JAX's and the
    exact state."""
    assert sorted(got_bits) == sorted(want_bits)
    g, w = _by_bits(got, got_bits), _by_bits(want, want_bits)
    for b in got_bits:
        assert abs(g[b] - state[int(b, 2)]) < TOL, b
        assert abs(g[b] - w[b]) < TOL, b


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_prepare_contraction_matches_jax_and_state_vec(n12, mode):
    """The same plan as JAX's (both run the native search), sliced bonds
    and all; the amplitudes of JAX's run and of the exact state."""
    bits = n12["batches"][0] if mode == "sparse" else ()
    sim = TensorNetworkSimulation.from_circuit(QSIM, bits) \
        .prepare_contraction(sc_target=SC[mode], **PLAN)
    jsim = JaxSim.from_circuit(QSIM, bits).prepare_contraction(
        sc_target=SC[mode], **PLAN)
    assert (sim.order, sim.slicing_bonds) == (jsim.order, jsim.slicing_bonds)
    assert sim.slicing_bonds and sim.ctree.complexity() == \
        jsim.ctree.complexity()
    assert sim.plan_seconds > 0 and sim.compile_seconds > 0
    got = sim.contraction(slice_batch=2, device="cpu")
    want = np.asarray(jsim.contraction())
    if mode == "sparse":
        _check_sparse(got, sim.bitstrings_sorted, want,
                      jsim.bitstrings_sorted, n12["state"])
    else:
        assert got.shape == (2,) * 12
        assert np.abs(got.reshape(-1) - n12["state"]).max() < TOL
        assert np.abs(got - want).max() < TOL


def test_update_scheme_second_batch(n12):
    """A second batch recompiled on the same plan, as JAX's
    ``update_scheme``; the mode is fixed at construction."""
    first, second = n12["batches"]
    cfg = PlannerConfig(sc_target=SC["sparse"], **PLAN)
    sim = TensorNetworkSimulation.from_circuit(QSIM, first) \
        .prepare_contraction(cfg)
    jsim = JaxSim.from_circuit(QSIM, first).prepare_contraction(
        PlannerConfig(sc_target=SC["sparse"], **PLAN))
    order = sim.order
    sim.update_scheme(bitstrings=second)
    jsim.update_scheme(bitstrings=second)
    assert sim.order == order and sim.sc_target == SC["sparse"]
    _check_sparse(sim.contraction(device="cpu"), sim.bitstrings_sorted,
                  jsim.contraction(), jsim.bitstrings_sorted, n12["state"])
    sim.update_scheme(sc_target=SC["sparse"] + 1)
    assert sim.config.sc_target == sim.sc_target == SC["sparse"] + 1
    with pytest.raises(ValueError):
        sim.update_scheme(bitstrings=[])
    with pytest.raises(TypeError):
        sim.prepare_contraction(cfg, sc_target=9)


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_quantum_circuit_simulation_matches_jax_and_state_vec(n12, mode):
    bits = n12["batches"][1] if mode == "sparse" else ()
    kw = dict(sc_target=SC[mode], trial_num=2, iters=6, parallel=False)
    got, got_bits = quantum_circuit_simulation(QSIM, bits, device="cpu",
                                               **kw)
    want, want_bits = jax_quantum_circuit_simulation(QSIM, bits, **kw)
    if mode == "sparse":
        _check_sparse(got, got_bits, want, want_bits, n12["state"])
    else:
        assert got_bits == want_bits == []
        assert np.abs(got.reshape(-1) - n12["state"]).max() < TOL
        assert np.abs(got - np.asarray(want)).max() < TOL


def test_one_shot_takes_circuits_and_needs_a_card_unless_asked():
    """A ``TensorNetworkCircuit`` or an ``(n, layers)`` pair; without a
    card the default device raises before anything is planned."""
    n, layers = random_circuit(2, 2, 4, seed=3)
    state = TensorNetworkCircuit((n, layers)).state_vec()
    for circ in (TensorNetworkCircuit((n, layers)), (n, layers)):
        got, bits = quantum_circuit_simulation(circ, (), sc_target=8,
                                               trial_num=1, iters=3,
                                               device="cpu")
        assert bits == [] and np.abs(got - state).max() < TOL
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            quantum_circuit_simulation((n, layers), (), sc_target=8)


def test_tensor_network_contraction_integer_labels():
    """An open network with integer bond labels, and a chain that
    simplifies to one tensor, at complex128: the exact contraction and
    JAX's result."""
    rng = np.random.default_rng(0)
    ts = [rng.random((2, 2, 2)) + 1j * rng.random((2, 2, 2))
          for _ in range(3)]
    ms = [rng.random((2, 2)) + 1j * rng.random((2, 2)) for _ in range(3)]
    cases = [
        ({0: ts[0], 1: ts[1], 2: ts[2]},
         {0: [0, 1, 4], 1: [1, 2, 5], 2: [2, 3, 6]}, range(7),
         np.einsum("abe,bcf,cdg->adefg", *ts)),
        ({0: ms[0], 1: ms[1], 2: ms[2]}, {0: [0, 1], 1: [1, 2], 2: [2, 3]},
         range(4), np.einsum("ab,bc,cd->ad", *ms)),
    ]
    kw = dict(sc_target=30, trial_num=1, iters=3, parallel=False,
              dtype=np.complex128)
    for tensors, bonds, labels, want in cases:
        dims = {b: 2.0 for b in labels}
        got, bits = tensor_network_contraction(
            dict(tensors), {t: list(b) for t, b in bonds.items()}, dims, (),
            (), device="cpu", **kw)
        jgot, _ = jax_tensor_network_contraction(
            dict(tensors), {t: list(b) for t, b in bonds.items()}, dims, (),
            (), **kw)
        assert bits == []
        assert np.abs(got - want).max() < 1e-12
        assert np.abs(got - np.asarray(jgot)).max() < 1e-12


def _steps_key(steps):
    return [(s.i, s.j, s.ix_i, s.ix_j, s.iy, s.dims_i, s.dims_j,
             kernel_kind(s)) for s in steps]


@pytest.mark.parametrize("sc_target", [5, 3])
def test_prepare_output_sharded_blocks(sc_target):
    """``prepare_output_sharded(3)`` on a 6-qubit circuit: JAX's block
    plan and block scheme, sc within the budget (or the block's legs), and
    every planned block (the sum of its 2^k slices) within 1e-10 of the
    exact state at complex128; the walk is the planned one, and another
    ``d_out`` is refused."""
    n, layers = random_circuit(2, 3, 6, seed=33)
    state = JaxCircuit((n, layers)).state_vec()
    sim = TensorNetworkSimulation.from_circuit((n, layers))
    sim.prepare_output_sharded(3, sc_target=sc_target, **SHARD_PLAN)
    jsim = JaxSim.from_circuit((n, layers))
    jsim.prepare_output_sharded(3, sc_target=sc_target, **SHARD_PLAN)
    plan, jplan = sim._shard_plan, jsim._shard_plan
    for key in ("d_out", "chosen", "output_bonds", "k_sum"):
        assert plan[key] == jplan[key], key
    assert (sim.order, sim.slicing_bonds) == (jsim.order, jsim.slicing_bonds)
    assert _steps_key(plan["steps"]) == _steps_key(jplan["steps"])
    assert bool(sim.slicing_bonds) == (sc_target < 4)
    assert sim.ctree.complexity()[1] <= max(sc_target, n - 3)
    blocks = list(sim.contraction_output_blocks(3, dtype=np.complex128,
                                                device="cpu"))
    assert [b[0] for b in blocks] == [np.binary_repr(o, 3) for o in range(8)]
    for bits, qubits, block in blocks:
        assert qubits == [0, 1, 2]
        want = state[tuple(int(c) for c in bits)]
        assert np.abs(block - want).max() < 1e-10
    with pytest.raises(ValueError, match="d_out=3"):
        next(sim.contraction_output_blocks(2, device="cpu"))
