"""The plain reference against a dense unitary product and an einsum of
the circuit, on small circuits."""

import numpy as np
import pytest
import torch

from tnbench.circuits import random_circuit
from tnbench.reference.gates import gate_matrix
from tnbench.reference.statevector import (BLOCK, _blocks, amplitudes,
                                           state_vector)


def full_unitary(n, name, qubits, params):
    """The gate as a 2^n x 2^n matrix, qubit 0 the most significant."""
    m, nq = gate_matrix(name, params)
    m = m.reshape((2,) * (2 * nq))
    u = np.eye(2 ** n, dtype=np.complex128).reshape((2,) * (2 * n))
    # contract the gate's inputs with the identity's output legs
    letters = "abcdefghijklmnopqrstuvwxyz"
    out = list(letters[:n])
    ins = list(letters[n:2 * n])
    new = list(out)
    g_out = [letters[20 + i] for i in range(nq)]
    for i, q in enumerate(qubits):
        new[q] = g_out[i]
    spec = ("".join(g_out) + "".join(out[q] for q in qubits) + ","
            + "".join(out) + "".join(ins) + "->" + "".join(new)
            + "".join(ins))
    return np.einsum(spec, m, u).reshape(2 ** n, 2 ** n)


def dense_product(n, layers):
    psi = np.zeros(2 ** n, dtype=np.complex128)
    psi[0] = 1.0
    for layer in layers:
        for name, qubits, params in layer:
            psi = full_unitary(n, name, qubits, params) @ psi
    return psi


@pytest.mark.parametrize("shape", [(2, 3, 5, 1), (2, 4, 8, 7), (1, 7, 6, 3),
                                   (3, 2, 4, 2 ** 31 + 3)])
def test_state_vector_equals_dense_unitary_product(shape):
    rows, cols, cycles, seed = shape
    n, layers = random_circuit(rows, cols, cycles, seed=seed)
    want = dense_product(n, layers)
    got = state_vector(n, layers).numpy()
    assert np.abs(got - want).max() < 1e-13
    assert abs(np.linalg.norm(got) - 1) < 1e-12


def test_state_vector_equals_einsum_of_the_network():
    """One einsum over every gate tensor, legs wired by hand."""
    n, layers = random_circuit(2, 2, 3, seed=9)
    wire = list(range(n))
    nxt = n
    ops, terms = [], []
    for layer in layers:
        for name, qubits, params in layer:
            m, nq = gate_matrix(name, params)
            outs = list(range(nxt, nxt + nq))
            nxt += nq
            ops.append(m.reshape((2,) * (2 * nq)))
            terms.append(outs + [wire[q] for q in qubits])
            for q, o in zip(qubits, outs):
                wire[q] = o
    zero = np.array([1.0, 0.0], dtype=np.complex128)
    args = []
    for q in range(n):
        args += [zero, [q]]
    for op, t in zip(ops, terms):
        args += [op, t]
    want = np.einsum(*args, wire, optimize="greedy").reshape(-1)
    got = state_vector(n, layers).numpy()
    assert np.abs(got - want).max() < 1e-13


def test_blocks_cover_every_qubit_once():
    for n in (1, 4, BLOCK, BLOCK + 1, 30, 31):
        qs = [q for lo, hi in _blocks(n) for q in range(lo, hi)]
        assert sorted(qs) == list(range(n))
        assert all(hi - lo <= BLOCK for lo, hi in _blocks(n))


def test_amplitudes_index_qubit_zero_first():
    n, layers = random_circuit(2, 2, 3, seed=4)
    psi = state_vector(n, layers)
    bits = ["1000", "0001", "0110"]
    got = amplitudes(psi, bits)
    assert np.allclose(got, psi.numpy()[[8, 1, 6]])


def test_layers_must_take_distinct_qubits():
    with pytest.raises(ValueError):
        state_vector(2, [[("x_1_2", (0,), ()), ("fsim", (0, 1), (1.5, 0.5))]])


def test_reference_runs_in_lower_precision_when_asked():
    n, layers = random_circuit(2, 3, 6, seed=1)
    hi = state_vector(n, layers).numpy()
    lo = state_vector(n, layers, dtype=torch.complex64).numpy()
    err = np.abs(lo - hi).max() / np.sqrt(np.mean(np.abs(hi) ** 2))
    assert 1e-9 < err < 1e-5
