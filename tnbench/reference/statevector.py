"""The benchmark's plain reference: the state vector of a gate list.

``state_vector(n, layers)`` starts from |0...0> and applies every layer in
order, in complex128, with plain PyTorch operations on one device.  The
state is flat, qubit 0 the most significant bit of the index, so the
amplitude of the bitstring ``b`` (qubit 0 first) is ``psi[int(b, 2)]``.

A layer's gates act on distinct qubits.  Its single-qubit gates go in as
products over blocks of ``BLOCK`` qubits: the block's Kronecker product
(identity where a qubit has no gate) times the state's trailing block, one
matrix product that also moves that block to the front; walking the
blocks from the last qubit to the first leaves the qubits in their order.
A two-qubit gate is a sum over its nonzero entries of scaled quarter views
of the state.  At n = 30 the state is 16 GiB and a product or a gate needs
a second one beside it.
"""

import numpy as np
import torch

from .gates import gate_matrix

BLOCK = 5


def _blocks(n):
    """The qubit ranges of the single-qubit products, last qubits first."""
    out, hi = [], n
    while hi > 0:
        lo = max(0, hi - BLOCK)
        out.append((lo, hi))
        hi = lo
    return out


def _single_layer(psi, n, mats):
    """Apply ``mats`` (qubit -> 2 x 2) to the flat state ``psi``."""
    eye = np.eye(2, dtype=np.complex128)
    for lo, hi in _blocks(n):
        u = np.ones((1, 1), dtype=np.complex128)
        for q in range(lo, hi):
            u = np.kron(u, mats.get(q, eye))
        u = torch.as_tensor(u, dtype=psi.dtype, device=psi.device)
        x = psi.view(2 ** (n - (hi - lo)), 2 ** (hi - lo))
        psi = torch.matmul(u, x.t()).reshape(-1)
    return psi


def _two_qubit(psi, n, g, a, b):
    """Apply the 4 x 4 ``g`` on qubits ``a`` (its more significant bit)
    and ``b``."""
    g = g.reshape(2, 2, 2, 2)
    if a > b:
        a, b = b, a
        g = g.transpose(1, 0, 3, 2)
    v = psi.view(2 ** a, 2, 2 ** (b - a - 1), 2, 2 ** (n - b - 1))
    out = torch.empty_like(v)
    for i in range(2):
        for j in range(2):
            o = out[:, i, :, j, :]
            terms = [(complex(g[i, j, k, l]), v[:, k, :, l, :])
                     for k in range(2) for l in range(2) if g[i, j, k, l]]
            if not terms:
                o.zero_()
                continue
            c, src = terms[0]
            torch.mul(src, c, out=o)
            for c, src in terms[1:]:
                o.add_(src, alpha=c)
    return out.reshape(-1)


def state_vector(n, layers, device="cpu", dtype=torch.complex128):
    """The flat ``2**n`` state of the circuit ``(n, layers)``; each gate is
    ``(name, qubits, params)``."""
    psi = torch.zeros(2 ** n, dtype=dtype, device=device)
    psi[0] = 1.0
    for layer in layers:
        mats, pairs, seen = {}, [], set()
        for name, qubits, params in layer:
            m, nq = gate_matrix(name, params)
            if nq != len(qubits) or seen & set(qubits):
                raise ValueError(f"gate {name} on {qubits}: a layer's gates "
                                 "take distinct qubits, as many as they act on")
            seen |= set(qubits)
            if nq == 1:
                mats[qubits[0]] = m
            else:
                pairs.append((m, qubits))
        if mats:
            psi = _single_layer(psi, n, mats)
        for m, (a, b) in pairs:
            psi = _two_qubit(psi, n, m, a, b)
    return psi


def amplitudes(psi, bitstrings):
    """The amplitudes of ``bitstrings`` (qubit 0 first) in ``psi``, as a
    numpy complex128 array in their order."""
    idx = torch.as_tensor([int(b, 2) for b in bitstrings],
                          dtype=torch.int64, device=psi.device)
    return psi[idx].cpu().numpy().astype(np.complex128)
