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

``fixed`` projects wire segments onto a bit: segment ``(k, q)`` is qubit
``q`` after its ``k``-th gate (``k = 0``: the input), the bond the
circuit's tensor network labels ``"{k}-{q}"``.  ``share_state`` sums such
projected states over a range of slice ids of a plan's sliced bonds: the
part of every amplitude that those slices carry.
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


def _project(psi, n, fixed, step, qubits):
    """Zero the part of ``psi`` where a qubit of ``qubits`` at its
    ``step`` differs from the bit ``fixed`` holds for it (taken out)."""
    for q in qubits:
        bit = fixed.pop((step[q], q), None)
        if bit is not None:
            psi.view(2 ** q, 2, 2 ** (n - q - 1))[:, 1 - bit, :].zero_()


def state_vector(n, layers, device="cpu", dtype=torch.complex128,
                 fixed=None):
    """The flat ``2**n`` state of the circuit ``(n, layers)``; each gate is
    ``(name, qubits, params)``.  ``fixed``: ``{(k, q): bit}``, wire
    segments projected onto a bit (see the module's text)."""
    psi = torch.zeros(2 ** n, dtype=dtype, device=device)
    psi[0] = 1.0
    fixed, step = dict(fixed or {}), [0] * n
    _project(psi, n, fixed, step, range(n))
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
        if fixed:
            for q in seen:
                step[q] += 1
            _project(psi, n, fixed, step, seen)
    if fixed:
        raise ValueError(f"the circuit has no wire segments {sorted(fixed)}")
    return psi


def _aligned_blocks(lo, hi):
    """``[lo, hi)`` as ``(start, size)`` blocks, each size a power of two
    that divides its start."""
    out = []
    while lo < hi:
        size = lo & -lo if lo else 1 << (hi.bit_length() - 1)
        while lo + size > hi:
            size //= 2
        out.append((lo, size))
        lo += size
    return out


def share_state(n, layers, slicing_bonds, ids, device="cpu"):
    """The sum over the slice ids ``ids`` (a range) of the circuit's state
    with the wire segments ``slicing_bonds`` (labels ``"{k}-{q}"``) fixed
    to each id's bits, the first segment the most significant bit.  One
    projected state per aligned block of the range: a block fixes its
    leading bits and leaves the rest free."""
    k = len(slicing_bonds)
    segs = [tuple(int(x) for x in str(b).split("-")) for b in slicing_bonds]
    psi = None
    for lo, size in _aligned_blocks(ids.start, ids.stop):
        free = size.bit_length() - 1
        fixed = {segs[x]: (lo >> (k - 1 - x)) & 1 for x in range(k - free)}
        part = state_vector(n, layers, device=device, fixed=fixed)
        psi = part if psi is None else psi.add_(part)
        del part
    return psi


def amplitudes(psi, bitstrings):
    """The amplitudes of ``bitstrings`` (qubit 0 first) in ``psi``, as a
    numpy complex128 array in their order."""
    idx = torch.as_tensor([int(b, 2) for b in bitstrings],
                          dtype=torch.int64, device=psi.device)
    return psi[idx].cpu().numpy().astype(np.complex128)
