"""Truncated-MPS circuit simulator: an independent mid-size verifier.

Port of ``artensor_tpu/utils/mps.py`` (a numpy copy, on the host as
there).  The contraction stack is checked at small n by the exact
``TensorNetworkCircuit.state_vec`` and at n30 by committed amplitudes; in
between, a bond-truncated MPS run gives an independent approximate check
with a computable fidelity estimate: each SVD truncation discards a known
weight, and the product of kept weights estimates the state fidelity
(exact for a single truncation, a good estimate for many).

Non-adjacent two-qubit gates are routed with SWAP chains, so any
qsim/cirq-style circuit runs.  ``python -m artensor_tpu_torch verify``
holds the contraction's amplitudes to this oracle.
"""

import numpy as np

_SWAP = np.array([[1, 0, 0, 0],
                  [0, 0, 1, 0],
                  [0, 1, 0, 0],
                  [0, 0, 0, 1]], dtype=np.complex128).reshape(2, 2, 2, 2)


class MPS:
    """Matrix-product state over n qubits with bond cap ``chi``.

    Site tensors have shape (left, 2, right).  ``log_fidelity`` accumulates
    log(kept weight) over every truncation: ``fidelity_estimate`` ~ the
    squared overlap with the exact state (product approximation).
    """

    def __init__(self, n, chi=64, init_state=None, canonical=True):
        self.n = n
        self.chi = chi
        self.canonical = canonical
        self.log_fidelity = 0.0
        self.center = 0
        bits = init_state if init_state is not None else "0" * n
        self.sites = []
        for b in bits:
            v = np.zeros((1, 2, 1), dtype=np.complex128)
            v[0, int(b), 0] = 1.0
            self.sites.append(v)

    # -- canonical-form maintenance ---------------------------------------

    def _move_center_to(self, q):
        """QR sweeps moving the orthogonality center to site ``q``: sites
        left of the center stay left-isometric, right of it
        right-isometric, so the local SVD truncation in
        :meth:`_apply_2q_adjacent` is variationally optimal and the kept
        weight is the exact local fidelity factor."""
        while self.center < q:
            c = self.center
            a = self.sites[c]
            l, _, r = a.shape
            qm, rm = np.linalg.qr(a.reshape(l * 2, r))
            self.sites[c] = qm.reshape(l, 2, -1)
            self.sites[c + 1] = np.tensordot(rm, self.sites[c + 1],
                                             axes=(1, 0))
            self.center = c + 1
        while self.center > q:
            c = self.center
            a = self.sites[c]
            l, _, r = a.shape
            # m = R^T Q^T with Q^T rows orthonormal: right-isometric site
            qm, rm = np.linalg.qr(a.reshape(l, 2 * r).T)
            self.sites[c] = qm.T.reshape(-1, 2, r)
            self.sites[c - 1] = np.tensordot(self.sites[c - 1], rm.T,
                                             axes=(2, 0))
            self.center = c - 1

    # -- gates ------------------------------------------------------------

    def apply_1q(self, g, q):
        # unitary on the physical leg preserves both isometry directions
        self.sites[q] = np.einsum("ds,asb->adb", g, self.sites[q])

    def _apply_2q_adjacent(self, g, q):
        """g: (2,2,2,2) as out1,out2,in1,in2 on sites (q, q+1)."""
        if self.canonical and not (q <= self.center <= q + 1):
            self._move_center_to(q)
        a = self.sites[q]
        b = self.sites[q + 1]
        la, _, _ = a.shape
        _, _, rb = b.shape
        theta = np.einsum("asb,btc->astc", a, b)
        theta = np.einsum("uvst,astc->auvc", g, theta)
        m = theta.reshape(la * 2, 2 * rb)
        u, s, vh = np.linalg.svd(m, full_matrices=False)
        keep = min(self.chi, len(s))
        w = float(np.sum(s ** 2))
        kept = float(np.sum(s[:keep] ** 2))
        if w > 0 and kept < w:
            self.log_fidelity += float(np.log(kept / w))
        s = s[:keep]
        u = u[:, :keep]
        vh = vh[:keep]
        self.sites[q] = u.reshape(la, 2, keep)
        self.sites[q + 1] = (s[:, None] * vh).reshape(keep, 2, rb)
        if self.canonical:
            self.center = q + 1

    def apply_gate(self, name, qubits, params=()):
        from ..circuits.gates import QSIM_GATES

        builder, nq = QSIM_GATES[name]
        g = builder(*params)
        if (nq or len(qubits)) == 1:
            self.apply_1q(g, qubits[0])
        else:
            q1, q2 = qubits
            if abs(q1 - q2) == 1:
                if q1 < q2:
                    self._apply_2q_adjacent(g, q1)
                else:
                    self._apply_2q_adjacent(g.transpose(1, 0, 3, 2), q2)
            else:
                # route the logical qubit at ``lo`` next to ``hi`` with
                # swaps, apply, swap back; after routing, sites (hi-1, hi)
                # hold logical qubits (lo, hi)
                lo, hi = min(q1, q2), max(q1, q2)
                for q in range(lo, hi - 1):
                    self._apply_2q_adjacent(_SWAP, q)
                gg = g if q1 < q2 else g.transpose(1, 0, 3, 2)
                self._apply_2q_adjacent(gg, hi - 1)
                for q in range(hi - 2, lo - 1, -1):
                    self._apply_2q_adjacent(_SWAP, q)

    # -- readout ----------------------------------------------------------

    def amplitude(self, bitstring):
        acc = np.ones((1, 1), dtype=np.complex128)
        for q, c in enumerate(bitstring):
            acc = acc @ self.sites[q][:, int(c), :]
        return complex(acc[0, 0])

    def state_vec(self):
        """Dense state (small n only)."""
        acc = self.sites[0]
        for s in self.sites[1:]:
            acc = np.einsum("a...b,bsc->a...sc", acc, s)
        return acc.reshape(-1)

    def max_bond(self):
        return max(s.shape[2] for s in self.sites[:-1]) if self.n > 1 else 1

    @property
    def fidelity_estimate(self):
        return float(np.exp(self.log_fidelity))


def mps_simulate(circuit, chi=64, canonical=True):
    """Run a TensorNetworkCircuit / (n, layers) / qsim path through a
    truncated MPS.  Returns the MPS (query .amplitude / .fidelity_estimate).

    ``canonical`` (default) maintains the mixed-canonical center so every
    truncation is variationally optimal; False truncates without it (an
    estimate-grade fidelity, kept for comparison).
    """
    from ..circuits import TensorNetworkCircuit

    if not isinstance(circuit, TensorNetworkCircuit):
        circuit = TensorNetworkCircuit(circuit)
    mps = MPS(circuit.n, chi=chi, init_state=circuit.init_state,
              canonical=canonical)
    for layer in circuit.layers:
        for name, qubits, params in layer:
            mps.apply_gate(name, qubits, params)
    return mps
