"""Circuit front end: qsim text format -> tensor network.

Port of ``artensor_tpu/circuits/circuit.py`` (a numpy copy of
``parse_qsim`` and ``TensorNetworkCircuit`` with ``to_numerical_tn``, the
one-shot einsum and MPS exports and the ``state_vec`` oracle).  A circuit
is held as ``(n, layers)`` where each layer is a list of ``(gate_name,
qubits, params)``.  Bond labels are wire coordinates ``'{step}-{qubit}'``
(step = how many gates have touched the qubit so far), identical to the
JAX package's, so plans saved by either package load in the other.
"""

import numpy as np

from .gates import QSIM_GATES

SINGLE_QUBIT = {name for name, (_, nq) in QSIM_GATES.items() if nq == 1}
TWO_QUBIT = {name for name, (_, nq) in QSIM_GATES.items() if nq == 2}


def parse_qsim(text):
    """Parse qsim circuit text: first line = n, then 'layer gate q [q2] [params...]'."""
    lines = [ln.split() for ln in text.strip().splitlines() if ln.split()]
    n = int(lines[0][0])
    layers = []
    for tok in lines[1:]:
        layer = int(tok[0])
        name = tok[1]
        if layer == len(layers):
            layers.append([])
        elif layer != len(layers) - 1:
            raise ValueError(f"non-contiguous layer index {layer}")
        if name in SINGLE_QUBIT:
            qubits = (int(tok[2]),)
            params = tuple(float(x) for x in tok[3:])
        elif name in TWO_QUBIT:
            qubits = (int(tok[2]), int(tok[3]))
            params = tuple(float(x) for x in tok[4:])
        else:
            raise ValueError(f"unknown gate {name!r}")
        layers[layer].append((name, qubits, params))
    return n, layers


def _basis_vec(bit):
    v = np.zeros(2, dtype=np.complex128)
    v[int(bit)] = 1.0
    return v


class TensorNetworkCircuit:
    """Quantum circuit lowered to a tensor network.

    Parameters
    ----------
    source : str | (int, layers)
        Path to a .qsim file, qsim text, or a pre-parsed ``(n, layers)``.
    init_state / final_state : str | None
        Bitstrings projecting the inputs/outputs; ``final_state=None`` leaves
        output legs open (full-amplitude / sparse modes).
    """

    def __init__(self, source, init_state=None, final_state=None):
        if isinstance(source, tuple):
            self.n, self.layers = source
        else:
            text = source
            if "\n" not in str(source):
                with open(source) as f:
                    text = f.read()
            self.n, self.layers = parse_qsim(text)
        self.init_state = init_state or "0" * self.n
        if len(self.init_state) != self.n:
            raise ValueError("init_state length differs from the qubit count")
        self.final_state = final_state
        if final_state is not None and len(final_state) != self.n:
            raise ValueError("final_state length differs from the qubit count")
        self._build()

    def _build(self):
        """Emit (array, bonds) pairs: init states, gates, optional projectors."""
        arrays, bonds = [], []
        for q, bit in enumerate(self.init_state):
            arrays.append(_basis_vec(bit))
            bonds.append([f"0-{q}"])
        wire = [0] * self.n
        last_sq = [False] * self.n   # wire ends on a single-qubit gate?
        for layer in self.layers:
            for name, qubits, params in layer:
                builder, nq = QSIM_GATES[name]
                arrays.append(builder(*params))
                out_legs = [f"{wire[q] + 1}-{q}" for q in qubits]
                in_legs = [f"{wire[q]}-{q}" for q in qubits]
                bonds.append(out_legs + in_legs)
                for q in qubits:
                    wire[q] += 1
                    last_sq[q] = len(qubits) == 1
        if self.final_state is not None:
            for q, bit in enumerate(self.final_state):
                arrays.append(_basis_vec(bit))
                bonds.append([f"{wire[q]}-{q}"])
        else:
            # open outputs: cap every qubit whose wire ends on a multi-qubit
            # gate (or on the bare init vector) with an identity, so each
            # output leg lives on its own rank-2 single-qubit tensor — the
            # invariant simplify's sparse-batch handling relies on
            for q in range(self.n):
                if not last_sq[q]:
                    arrays.append(np.eye(2, dtype=np.complex128))
                    bonds.append([f"{wire[q] + 1}-{q}", f"{wire[q]}-{q}"])
                    wire[q] += 1
        self.arrays = arrays
        self.bonds = bonds
        self._wire = wire

    # -- exports ----------------------------------------------------------

    def to_abstract_tn(self):
        tensor_bonds = {i: list(b) for i, b in enumerate(self.bonds)}
        bond_dims = {b: 2.0 for bs in self.bonds for b in bs}
        if self.final_state is not None:
            final_qubits = []
        else:
            # the final tensor for qubit q holds q's open out-leg
            # '{wire[q]}-{q}'; the result is qubit-indexed
            open_leg = {f"{self._wire[q]}-{q}": q for q in range(self.n)}
            by_qubit = {}
            for t, bs in enumerate(self.bonds):
                for b in bs:
                    if b in open_leg:
                        by_qubit[open_leg[b]] = t
            final_qubits = [by_qubit[q] for q in range(self.n)]
        return tensor_bonds, bond_dims, final_qubits

    def to_numerical_tn(self):
        tensors = {i: a for i, a in enumerate(self.arrays)}
        tensor_bonds, bond_dims, final_qubits = self.to_abstract_tn()
        return tensors, tensor_bonds, bond_dims, final_qubits

    def to_einsum(self, as_string=False):
        """One giant einsum for the whole circuit.

        Default: (tensors, operand index lists, output index list), integer
        sublists with no label cap.  ``as_string=True`` returns (tensors,
        eq) with a letter equation, only possible for <= 52 distinct
        bonds.
        """
        labels = {}
        for bs in self.bonds:
            for b in bs:
                labels.setdefault(b, len(labels))
        operands = [[labels[b] for b in bs] for bs in self.bonds]
        out_bonds = [f"{self._wire[q]}-{q}" for q in range(self.n)] \
            if self.final_state is None else []
        if as_string:
            from ..utils import einsum_eq_convert

            return self.arrays, einsum_eq_convert(self.bonds, out_bonds)
        return self.arrays, operands, [labels[b] for b in out_bonds]

    # -- oracles (testing) ------------------------------------------------

    def state_vec(self):
        """Exact Schrödinger evolution; O(2^n) memory — testing oracle only."""
        psi = np.zeros((2,) * self.n, dtype=np.complex128)
        psi[(0,) * self.n] = 1.0
        for q, bit in enumerate(self.init_state):
            if bit == "1":
                psi = np.roll(psi, 1, axis=q)
        for layer in self.layers:
            for name, qubits, params in layer:
                builder, nq = QSIM_GATES[name]
                g = builder(*params)
                if (nq or len(qubits)) == 1:
                    psi = np.moveaxis(
                        np.tensordot(g, psi, axes=([1], [qubits[0]])),
                        0, qubits[0])
                else:
                    a, b = qubits
                    psi = np.moveaxis(
                        np.tensordot(g, psi, axes=([2, 3], [a, b])),
                        [0, 1], [a, b])
        if self.final_state is not None:
            idx = tuple(int(c) for c in self.final_state)
            return psi[idx]
        return psi

    def to_mps(self):
        """Exact MPS of the final state via per-gate SVD splitting (oracle;
        nearest-neighbour two-qubit gates only)."""
        mps = [_basis_vec(bit).reshape(1, 2, 1) for bit in self.init_state]
        for layer in self.layers:
            for name, qubits, params in layer:
                builder, nq = QSIM_GATES[name]
                g = builder(*params)
                if (nq or len(qubits)) == 1:
                    q = qubits[0]
                    mps[q] = np.einsum("abc,db->adc", mps[q], g)
                else:
                    q1, q2 = qubits
                    if abs(q1 - q2) != 1:
                        raise ValueError("to_mps needs nearest-neighbour "
                                         f"gates, got qubits {qubits}")
                    u, s, vh = np.linalg.svd(
                        g.transpose(0, 2, 1, 3).reshape(4, 4))
                    rs = np.sqrt(s).astype(np.complex128)
                    m1 = (u * rs).reshape(2, 2, -1)
                    m2 = (rs[:, None] * vh).reshape(-1, 2, 2)
                    mps[q1] = np.einsum("abc,bde->adec", mps[q1], m1).reshape(
                        mps[q1].shape[0], 2, -1)
                    mps[q2] = np.einsum("abc,ebd->eadc", mps[q2], m2).reshape(
                        -1, 2, mps[q2].shape[2])
        return mps
