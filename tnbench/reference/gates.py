"""Gate matrices of the benchmark's circuits, written out from their
definitions (qsim and Cirq conventions, as in Google's random-circuit
sampling experiments).

Single-qubit gates are 2 x 2; two-qubit gates are 4 x 4 with rows the
output pair (a, b) and columns the input pair, ``a`` the first qubit the
gate names and the more significant bit.
"""

from math import cos, pi, sin, sqrt

import numpy as np


def x_1_2():
    """sqrt(X) with the Sycamore phase: e^{i pi/4} on the diagonal and
    e^{-i pi/4} off it, over sqrt(2)."""
    a, b = np.exp(0.25j * pi), np.exp(-0.25j * pi)
    return np.array([[a, b], [b, a]], dtype=np.complex128) / sqrt(2.0)


def y_1_2():
    """sqrt(Y): e^{i pi/4} / sqrt(2) [[1, -1], [1, 1]]."""
    a = np.exp(0.25j * pi)
    return np.array([[a, -a], [a, a]], dtype=np.complex128) / sqrt(2.0)


def hz_1_2():
    """sqrt(W), W = (X + Y) / sqrt(2): [[e^{i pi/4}, -i], [1, e^{i pi/4}]]
    over sqrt(2)."""
    a = np.exp(0.25j * pi)
    return np.array([[a, -1j], [1, a]], dtype=np.complex128) / sqrt(2.0)


def fsim(theta, phi):
    """fSim(theta, phi): |01> and |10> mixed by theta, |11> phased by
    e^{-i phi}."""
    g = np.zeros((4, 4), dtype=np.complex128)
    g[0, 0] = 1.0
    g[1, 1] = g[2, 2] = cos(theta)
    g[1, 2] = g[2, 1] = -1j * sin(theta)
    g[3, 3] = np.exp(-1j * phi)
    return g


GATES = {"x_1_2": (x_1_2, 1), "y_1_2": (y_1_2, 1), "hz_1_2": (hz_1_2, 1),
         "fsim": (fsim, 2), "fs": (fsim, 2)}


def gate_matrix(name, params=()):
    """``(matrix, qubit count)`` of the gate ``name`` with ``params``."""
    if name not in GATES:
        raise ValueError(f"the reference has no gate {name!r}")
    fn, nq = GATES[name]
    return fn(*params), nq
