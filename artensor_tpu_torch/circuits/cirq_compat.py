"""Load generated cirq circuit files without cirq.

Port of ``artensor_tpu/circuits/cirq_compat.py`` (a numpy copy).  Google's
generated Sycamore circuit files (``circuit_n{n}_m{m}_s{s}_e{e}_p{seq}.py``)
are Python that only ever uses: GridQubit, Moment, Circuit, X**0.5, Y**0.5,
PhasedXPowGate(phase_exponent=0.25, exponent=0.5), Rz(rads), FSimGate(theta,
phi).  This module executes such a file against a minimal shim namespace and
converts the result to the ``(n, layers)`` form of
:class:`artensor_tpu_torch.circuits.circuit.TensorNetworkCircuit`.

Gate-matrix equivalences (cirq's unitaries):
  X**0.5                      -> 'x_1_2'
  Y**0.5                      -> 'y_1_2'
  PhasedXPowGate(0.25, 0.5)   -> 'hz_1_2'   (the W^1/2 gate)
  Rz(r)                       -> 'rz' with phi = r
  FSimGate(theta, phi)        -> 'fsim'

Beyond the Sycamore vocabulary, standard cirq gates lower to their unitary
matrix: X/Y/Z/H at any exponent (principal-branch eigenvalue power, cirq's
convention), PhasedXPowGate at any (phase_exponent, exponent) = Z^a X^t
Z^-a, Rx/Ry/Rz, S, T, CZ/ISWAP (any exponent), CNOT/CX, emitted as the
'__matrix__' pseudo-gate carrying the matrix as its parameter.

SECURITY: the file is validated against a strict AST allowlist before being
executed: only module-level assignments of literal gate-constructor
expressions (the shape the generator emits) are admitted, so arbitrary
code in a malicious "circuit file" is rejected, not run.
"""

import ast
import math
import types

import numpy as np

# the complete AST vocabulary of Google's generated circuit files
_ALLOWED_NODES = (
    ast.Module, ast.Import, ast.Assign, ast.Expr, ast.Call, ast.Attribute,
    ast.Name, ast.Constant, ast.List, ast.Tuple, ast.BinOp, ast.UnaryOp,
    ast.Mult, ast.Div, ast.Add, ast.Sub, ast.Pow, ast.USub, ast.UAdd,
    ast.keyword, ast.alias, ast.Load, ast.Store,
)
_ALLOWED_IMPORTS = {"cirq", "numpy", "math"}
_ALLOWED_ATTRS = {
    "GridQubit", "Moment", "Circuit", "X", "Y", "Z", "PhasedXPowGate",
    "Rx", "Ry", "Rz", "FSimGate", "ISWAP", "CZ", "CNOT", "CX",
    "H", "S", "T", "pi", "e", "on",
}


def _validate_circuit_ast(src, path):
    """Reject anything beyond literal gate-constructor assignments."""
    tree = ast.parse(src, str(path))
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(
                f"{path}: disallowed syntax {type(node).__name__} — not a "
                "generated circuit file")
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] not in _ALLOWED_IMPORTS:
                    raise ValueError(f"{path}: disallowed import {alias.name}")
        if isinstance(node, ast.Attribute):
            # single-level attributes of module/gate names only; no dunders,
            # no chains (blocks np.ctypeslib..., obj.__class__..., etc.)
            if node.attr not in _ALLOWED_ATTRS:
                raise ValueError(f"{path}: disallowed attribute .{node.attr}")
            # bases: module/gate names, gate-expressions ((X**0.5).on,
            # FSimGate(...).on) — never arbitrary chained objects
            if not isinstance(node.value,
                              (ast.Name, ast.Attribute, ast.Call, ast.BinOp)):
                raise ValueError(f"{path}: disallowed attribute base")
    return tree


class _Qubit:
    def __init__(self, row, col):
        self.key = (row, col)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return self.key == other.key

    def __lt__(self, other):
        return self.key < other.key

    def __repr__(self):
        return f"GridQubit{self.key}"


class _Op:
    def __init__(self, name, params, qubits):
        self.name = name
        self.params = params
        self.qubits = qubits


class _Gate:
    def __init__(self, name, params=()):
        self.name = name
        self.params = tuple(params)

    def on(self, *qubits):
        return _Op(self.name, self.params, qubits)

    def __call__(self, *qubits):
        return self.on(*qubits)


def _pow_u(U, t):
    """Principal-branch matrix power — cirq's ``*PowGate`` convention
    (eigenvalue e^{i theta}, theta in (-pi, pi], raised as e^{i theta t}).

    np.linalg.eig does not return an orthonormal eigenbasis for degenerate
    eigenvalues of a general complex matrix, so the reconstruction uses the
    true inverse, not the conjugate transpose (which gives a non-unitary,
    wrong power on degenerate-spectrum unitaries).  A unitarity check
    guards the result."""
    U = np.asarray(U, dtype=np.complex128)
    vals, vecs = np.linalg.eig(U)
    P = (vecs * np.exp(t * np.log(vals))) @ np.linalg.inv(vecs)
    err = np.abs(P @ np.conj(P.T) - np.eye(len(P))).max()
    if err > 1e-9:
        raise ValueError(
            f"matrix power of a non-unitary (or ill-conditioned) gate: "
            f"|P P^dag - I| = {err:.2e}")
    return P


_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_Z = np.diag([1.0, -1.0]).astype(np.complex128)
_H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / math.sqrt(2)
_CZ = np.diag([1, 1, 1, -1]).astype(np.complex128)
_ISWAP = np.array([[1, 0, 0, 0], [0, 0, 1j, 0],
                   [0, 1j, 0, 0], [0, 0, 0, 1]], dtype=np.complex128)
_CNOT = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                  [0, 0, 0, 1], [0, 0, 1, 0]], dtype=np.complex128)


class _MatGate(_Gate):
    """Any gate outside the named Sycamore vocabulary, carried as its
    unitary matrix (what ``cirq.unitary`` gives)."""

    def __init__(self, U):
        U = np.asarray(U, dtype=np.complex128)
        super().__init__("__matrix__", (U,))
        self.U = U

    def __pow__(self, t):
        return _MatGate(_pow_u(self.U, t))


class _PowBase:
    """cirq.X / cirq.Y / cirq.Z / H / CZ / ISWAP: the Sycamore **0.5
    forms keep their named qsim lowering; any other exponent lowers to
    the principal-branch matrix power."""

    def __init__(self, name, U, named=None, named_exp=1.0):
        self.name = name
        self.U = np.asarray(U, dtype=np.complex128)
        self._named = named              # qsim name at named_exp, if any
        self._named_exp = named_exp

    def __pow__(self, exponent):
        if self._named is not None and exponent == self._named_exp:
            return _Gate(self._named)
        return _MatGate(_pow_u(self.U, exponent))

    # bare use (X.on(q) / X(q)) = exponent 1
    def on(self, *qubits):
        return (self ** 1.0).on(*qubits)

    def __call__(self, *qubits):
        return self.on(*qubits)


def _phased_x(phase_exponent=0.0, exponent=1.0):
    if (phase_exponent, exponent) == (0.25, 0.5):
        return _Gate("hz_1_2")
    # cirq: PhasedXPowGate(a, t) = Z^a X^t Z^-a (incl. XPow global phase)
    za = _pow_u(_Z, phase_exponent)
    return _MatGate(za @ _pow_u(_X, exponent) @ np.conj(za.T))


def _shim_namespace(collector):
    shim = types.ModuleType("cirq")
    shim.GridQubit = _Qubit
    shim.X = _PowBase("X", _X, named="x_1_2", named_exp=0.5)
    shim.Y = _PowBase("Y", _Y, named="y_1_2", named_exp=0.5)
    shim.Z = _PowBase("Z", _Z)
    shim.H = _PowBase("H", _H, named="h")
    shim.S = _MatGate(np.diag([1.0, 1j]))
    shim.T = _MatGate(np.diag([1.0, np.exp(0.25j * math.pi)]))
    shim.CZ = _PowBase("CZ", _CZ, named="cz")
    shim.ISWAP = _PowBase("ISWAP", _ISWAP)
    shim.CNOT = shim.CX = _PowBase("CNOT", _CNOT, named="cnot")
    shim.PhasedXPowGate = _phased_x
    shim.Rx = lambda rads: _MatGate(
        math.cos(rads / 2) * np.eye(2) - 1j * math.sin(rads / 2) * _X)
    shim.Ry = lambda rads: _MatGate(
        math.cos(rads / 2) * np.eye(2) - 1j * math.sin(rads / 2) * _Y)
    shim.Rz = lambda rads: _Gate("rz", (float(rads),))
    shim.FSimGate = lambda theta, phi: _Gate("fsim", (float(theta), float(phi)))
    shim.Moment = lambda operations: list(operations)
    shim.Circuit = lambda moments: collector(moments)
    return shim


def from_cirq(circuit, qubit_order=None):
    """Convert a LIVE in-memory ``cirq.Circuit`` to ``(n, layers)``.

    Each gate's unitary is taken through the ``_unitary_`` protocol that
    ``cirq.unitary(gate)`` consults, so it needs no cirq import itself:
    any object shaped like a cirq circuit works: iterating it yields
    moments, iterating a moment yields operations with ``.qubits`` and
    ``.gate``, and the gate (or the operation) exposes its matrix via
    ``_unitary_()``.  Every gate lowers to the
    ``'__matrix__'`` pseudo-gate (:func:`..gates.matrix_gate`).

    ``qubit_order``: explicit qubit sequence; defaults to the sorted
    ``circuit.all_qubits()`` (cirq's default ordering convention).
    """
    if qubit_order is None:
        qubit_order = sorted(circuit.all_qubits())
    index = {q: i for i, q in enumerate(qubit_order)}

    def _unitary_of(op):
        for obj in (op.gate, op):
            fn = getattr(obj, "_unitary_", None)
            if fn is not None:
                u = fn()
                if u is not None and u is not NotImplemented:
                    return np.asarray(u, dtype=np.complex128)
        raise ValueError(f"operation {op!r} has no unitary "
                         "(measurements/channels are not tensor-network ops)")

    layers = []
    for moment in circuit:
        layer = []
        for op in moment:
            U = _unitary_of(op)
            qubits = tuple(index[q] for q in op.qubits)
            if U.shape != (2 ** len(qubits),) * 2:
                raise ValueError(
                    f"unitary shape {U.shape} does not match "
                    f"{len(qubits)} qubits for {op!r}")
            layer.append(("__matrix__", qubits, (U,)))
        if layer:
            layers.append(layer)
    return len(qubit_order), layers


def load_cirq_circuit(path):
    """Parse a generated cirq circuit file.

    Returns ``(n, layers)``: qubit count and layers of
    ``(gate_name, qubit_indices, params)``, with qubits numbered by the
    file's QUBIT_ORDER (row-major grid order).
    """
    import sys

    captured = {}
    shim = _shim_namespace(lambda moments: captured.setdefault("moments", moments))
    with open(path) as f:
        src = f.read()
    tree = _validate_circuit_ast(src, path)

    def _restricted_import(name, *args, **kwargs):
        mod = {"cirq": shim, "numpy": np, "math": math}.get(name.split(".")[0])
        if mod is None:
            raise ImportError(f"import {name!r} not allowed in circuit files")
        return mod

    env = {"cirq": shim, "np": np, "math": math,
           "__builtins__": {"__import__": _restricted_import}}
    # the generated files 'import cirq' themselves; route that import to the
    # shim for the duration of the exec (restoring any real cirq afterwards)
    prev = sys.modules.get("cirq")
    sys.modules["cirq"] = shim
    try:
        exec(compile(tree, str(path), "exec"), env)
    finally:
        if prev is None:
            del sys.modules["cirq"]
        else:
            sys.modules["cirq"] = prev
    qubit_order = env.get("QUBIT_ORDER")
    moments = captured.get("moments")
    if moments is None:
        circ = env.get("CIRCUIT")
        moments = circ if isinstance(circ, list) else None
    if moments is None:
        raise ValueError(f"{path}: no cirq.Circuit found in file")
    index = {q: i for i, q in enumerate(qubit_order)}
    layers = []
    for moment in moments:
        layer = []
        for op in moment:
            layer.append((op.name, tuple(index[q] for q in op.qubits), op.params))
        layers.append(layer)
    return len(qubit_order), layers
