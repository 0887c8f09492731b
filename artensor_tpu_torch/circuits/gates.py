"""Quantum gate tensors as host numpy arrays (complex128).

Port of ``artensor_tpu/circuits/gates.py`` (a numpy copy: the port imports
nothing of the JAX package).  Matrices follow the qsim/Cirq conventions used
by Google's random-circuit sampling experiments.  Two-qubit gates are
returned reshaped to (2, 2, 2, 2) with axis order (out_a, out_b, in_a, in_b).

Host-side only: the runtime casts these to the execution dtype when staging
the network onto the device.
"""

from math import cos, pi, sin, sqrt

import numpy as np

_SQRT2 = sqrt(2.0)


def _mat(rows):
    return np.array(rows, dtype=np.complex128)


def h():
    """Hadamard."""
    return _mat([[1, 1], [1, -1]]) / _SQRT2


def t(phi):
    """Phase gate diag(1, e^{i phi}) (qsim 't' carries an explicit angle)."""
    return _mat([[1, 0], [0, np.exp(1j * phi)]])


def s():
    return _mat([[1, 0], [0, 1j]])


def rz(phi):
    """Z rotation diag(e^{-i phi/2}, e^{i phi/2})."""
    return _mat([[np.exp(-0.5j * phi), 0], [0, np.exp(0.5j * phi)]])


def x_1_2():
    """sqrt(X) with the Sycamore global-phase convention: e^{i pi/4} at the
    diagonal, e^{-i pi/4} off-diagonal, all over sqrt(2)."""
    a, b = np.exp(0.25j * pi), np.exp(-0.25j * pi)
    return _mat([[a, b], [b, a]]) / _SQRT2


def y_1_2():
    """sqrt(Y): e^{i pi/4}/sqrt(2) * [[1, -1], [1, 1]]."""
    a = np.exp(0.25j * pi)
    return _mat([[a, -a], [a, a]]) / _SQRT2


def hz_1_2():
    """sqrt(W) where W = (X+Y)/sqrt(2): 1/sqrt(2)*[[e^{i pi/4}, -i],[1, e^{i pi/4}]].

    Equals cirq.PhasedXPowGate(phase_exponent=0.25, exponent=0.5).
    """
    a = np.exp(0.25j * pi)
    return _mat([[a, -1j], [1, a]]) / _SQRT2


def u3(theta, phi, lam):
    """General single-qubit rotation (qsim convention: half-angle theta/4)."""
    c, sn = cos(theta / 4.0), sin(theta / 4.0)
    return _mat([
        [c, -np.exp(1j * lam) * sn],
        [np.exp(1j * phi) * sn, np.exp(1j * (lam + phi)) * c],
    ])


def cz():
    g = np.eye(4, dtype=np.complex128)
    g[3, 3] = -1
    return g.reshape(2, 2, 2, 2)


def cnot():
    g = np.zeros((4, 4), dtype=np.complex128)
    g[0, 0] = g[1, 1] = g[2, 3] = g[3, 2] = 1
    return g.reshape(2, 2, 2, 2)


def cu3(theta, phi, lam):
    g = np.eye(4, dtype=np.complex128)
    g[2:, 2:] = u3(theta, phi, lam)
    return g.reshape(2, 2, 2, 2)


def fsim(theta, phi):
    """Fermionic simulation gate: iSWAP-like mixing + controlled phase.

    [[1, 0, 0, 0],
     [0,  cos t, -i sin t, 0],
     [0, -i sin t,  cos t, 0],
     [0, 0, 0, e^{-i phi}]]
    """
    g = np.zeros((4, 4), dtype=np.complex128)
    g[0, 0] = 1
    g[1, 1] = g[2, 2] = cos(theta)
    g[1, 2] = g[2, 1] = -1j * sin(theta)
    g[3, 3] = np.exp(-1j * phi)
    return g.reshape(2, 2, 2, 2)


def zz(beta):
    pz = np.diag([1.0, -1.0]).astype(np.complex128)
    return (np.exp(-0.5j * beta) * np.kron(pz, pz)).reshape(2, 2, 2, 2)


def matrix_gate(U):
    """Generic gate from an explicit unitary matrix (gates outside the named
    vocabulary).  2^q x 2^q input, reshaped to the (out..., in...) tensor
    convention."""
    U = np.asarray(U, dtype=np.complex128)
    q = int(round(np.log2(U.shape[0])))
    assert U.shape == (2 ** q, 2 ** q), U.shape
    return U.reshape((2,) * (2 * q))


# qsim text-format gate names -> (builder, n_qubits)
QSIM_GATES = {
    # n_qubits None: derived from the op's qubit list
    "__matrix__": (matrix_gate, None),
    "h": (h, 1),
    "t": (t, 1),
    "s": (s, 1),
    "rz": (rz, 1),
    "x_1_2": (x_1_2, 1),
    "y_1_2": (y_1_2, 1),
    "hz_1_2": (hz_1_2, 1),
    "w_1_2": (hz_1_2, 1),
    "u3": (u3, 1),
    "cz": (cz, 2),
    "cnot": (cnot, 2),
    "cu3": (cu3, 2),
    "fs": (fsim, 2),
    "fsim": (fsim, 2),
    "zz": (zz, 2),
}
