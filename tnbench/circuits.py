"""Random-circuit-sampling (RCS) circuits, Sycamore style: the
benchmark's circuit generator.

A frozen copy of ``artensor_tpu_torch/circuits/random_circuits.py`` at
commit 20f345e, kept here so that the yardstick does not move when the
program's copy changes.  Alternating layers of random single-qubit gates
from {sqrt(X), sqrt(Y), sqrt(W)} (never the same gate twice running on a
qubit) and fsim gates along one of the grid-coupler patterns A/B/C/D per
cycle, closed by a single-qubit layer.  The seed draws only the
single-qubit gates: the couplers, and so the network's shape, are the
same for every seed.  ``sites`` puts the qubits on any set of grid
positions: a coupler is kept only where both of its ends hold a qubit.
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


def site_qubits(rows, cols, sites):
    """The grid positions of the qubits: every site of the ``rows`` x
    ``cols`` grid, row by row, or the ``sites`` given (``[row, col]``
    pairs, qubit ``i`` on the ``i``-th)."""
    if sites is None:
        return grid_qubits(rows, cols)
    qubits = [(int(r), int(c)) for r, c in sites]
    if len(set(qubits)) != len(qubits) or not all(
            0 <= r < rows and 0 <= c < cols for r, c in qubits):
        raise ValueError(f"sites must be distinct positions of the {rows} x "
                         f"{cols} grid")
    return qubits


def random_circuit(rows, cols, cycles, seed=0, sequence="ABCDCDAB",
                   theta=1.5, phi=0.5, sites=None):
    """Generate an RCS circuit.

    Returns ``(n, layers)`` consumable by ``TensorNetworkCircuit``.  Each of
    the ``cycles`` cycles emits a single-qubit layer plus an fsim layer on
    the cycle's coupler pattern; a final single-qubit layer closes the
    circuit (so the last n tensors are one 1q gate per qubit — the
    convention the sparse big-batch mode relies on).  With ``sites``
    (see ``site_qubits``) the qubits sit on those positions alone, and
    each pattern keeps the couplers whose two ends both hold one.
    """
    rng = np.random.default_rng(seed)
    qubits = site_qubits(rows, cols, sites)
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
            if a in index and b in index
        ]
        if fsims:
            layers.append(fsims)
    layers.append(sq_layer())
    return n, layers
