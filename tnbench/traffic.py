"""The one generator of the benchmark's inputs, from a traffic file and
``--seed``.

A traffic file (``traffic/<name>.json``) sets:

- ``requests``: "amplitudes" (a batch is the amplitudes of a fixed set of
  bitstrings) or "state" (a batch is the whole state, kept on the device);
- ``bitstrings`` and ``bitstring_seed``: the set, the same for every seed
  of the cell: ``bitstrings`` distinct indices drawn by
  ``np.random.default_rng(bitstring_seed).choice(2**n, ...)``, written
  qubit 0 first;
- ``state_samples``: for "state", how many amplitudes of every batch's
  state are read back for the comparison (drawn from ``--seed``);
- ``plan``: the plan file the cell runs, beside its configuration;
- ``loop`` and ``callers``: "closed" with one caller, the only loop this
  harness drives: each batch starts when the last one is done.

The circuit is the configuration's ``random_circuit`` with ``--seed``: the
seed draws the single-qubit gates, and the shape of the network, hence
the plan and the scheme, is the same for every seed.
"""

import numpy as np

from tnbench.circuits import random_circuit


def circuit(config, seed):
    """``(n, layers)`` of the configuration's circuit for ``seed``."""
    c = config["circuit"]
    if c["generator"] != "random_circuit":
        raise ValueError(f"unknown circuit generator {c['generator']!r}")
    return random_circuit(c["rows"], c["cols"], c["cycles"], seed=seed,
                          sequence=c["sequence"], theta=c["theta"],
                          phi=c["phi"])


def bitstrings(traffic, n):
    """The traffic's bitstrings (qubit 0 first); none for "state"."""
    if traffic["requests"] == "state":
        return []
    if traffic.get("loop", "closed") != "closed" or \
            traffic.get("callers", 1) != 1:
        raise ValueError("the harness drives one caller in a closed loop")
    ids = np.random.default_rng(traffic["bitstring_seed"]).choice(
        2 ** n, traffic["bitstrings"], replace=False)
    return [np.binary_repr(int(b), n) for b in ids]


def state_sample(traffic, n, seed):
    """Flat indices (qubit 0 the most significant bit) of the amplitudes
    read back from every state batch, drawn from ``seed``."""
    rng = np.random.default_rng([seed, 1])
    return np.sort(rng.choice(2 ** n, traffic["state_samples"],
                              replace=False))


def axis_index(idx, axis_qubits, n):
    """The flat indices ``idx`` (qubit order; an int64 numpy array or
    tensor) in a state whose axes hold the qubits ``axis_qubits``, the
    first the most significant."""
    out = idx & 0
    for pos, q in enumerate(axis_qubits):
        out |= ((idx >> (n - 1 - q)) & 1) << (n - 1 - pos)
    return out
