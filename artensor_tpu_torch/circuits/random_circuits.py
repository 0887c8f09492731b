"""Random-circuit-sampling (RCS) circuit generator, Sycamore style.

Port of ``artensor_tpu/circuits/random_circuits.py`` (a numpy copy).

Generates grid circuits in the structure of Google's quantum-supremacy
experiments: alternating layers of random single-qubit gates from
{sqrt(X), sqrt(Y), sqrt(W)} (never repeating on the same qubit in
consecutive cycles) and two-qubit fsim gates applied along one of the four
grid-coupler patterns A/B/C/D per cycle.  This gives the framework a
self-contained "model family" for tests and benchmarks without depending on
bundled circuit data files.
"""

import numpy as np

SQRT_GATES = ("x_1_2", "y_1_2", "hz_1_2")


def grid_qubits(rows, cols):
    return [(r, c) for r in range(rows) for c in range(cols)]


def _couplers(rows, cols, pattern):
    """Coupler set for one of the ABCD patterns (Sycamore supplementary).

    A/B: horizontal pairs with alternating parity per row;
    C/D: vertical pairs with alternating parity per column.
    """
    pairs = []
    if pattern in "AB":
        off = 0 if pattern == "A" else 1
        for r in range(rows):
            for c in range((off + r) % 2, cols - 1, 2):
                pairs.append(((r, c), (r, c + 1)))
    else:
        off = 0 if pattern == "C" else 1
        for c in range(cols):
            for r in range((off + c) % 2, rows - 1, 2):
                pairs.append(((r, c), (r + 1, c)))
    return pairs


def random_circuit(rows, cols, cycles, seed=0, sequence="ABCDCDAB",
                   theta=1.5, phi=0.5):
    """Generate an RCS circuit.

    Returns ``(n, layers)`` consumable by ``TensorNetworkCircuit``.  Each of
    the ``cycles`` cycles emits a single-qubit layer plus an fsim layer on
    the cycle's coupler pattern; a final single-qubit layer closes the
    circuit (so the last n tensors are one 1q gate per qubit — the
    convention the sparse big-batch mode relies on).
    """
    rng = np.random.default_rng(seed)
    qubits = grid_qubits(rows, cols)
    index = {q: i for i, q in enumerate(qubits)}
    n = len(qubits)
    prev = [None] * n
    layers = []

    def sq_layer():
        layer = []
        for q in range(n):
            choices = [g for g in SQRT_GATES if g != prev[q]]
            g = choices[rng.integers(len(choices))]
            prev[q] = g
            layer.append((g, (q,), ()))
        return layer

    for cyc in range(cycles):
        layers.append(sq_layer())
        pattern = sequence[cyc % len(sequence)]
        fsims = [
            ("fsim", (index[a], index[b]), (theta, phi))
            for a, b in _couplers(rows, cols, pattern)
        ]
        if fsims:
            layers.append(fsims)
    layers.append(sq_layer())
    return n, layers
