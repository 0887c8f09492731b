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
  harness drives: each batch starts when the last one is done;
- ``share`` (optional): ``{"first": F, "slices": S}``, one card's share of
  the plan's 2^k slices: every batch sums slice ids ``[F, F + S)`` (ids
  MSB-first, the first sliced bond the most significant bit: the range
  one replica of the program's slice mesh takes) instead of all 2^k.

The network reference computes every bitstring of a batch, up to
``REFERENCE_SAMPLES`` of them; past that, a sample of that many drawn
from ``--seed``, at which every batch is compared.

The circuit is the configuration's ``random_circuit`` with ``--seed``: the
seed draws the single-qubit gates, and the shape of the network, hence
the plan and the scheme, is the same for every seed.  A configuration's
``circuit`` may add ``sites``, the ``[row, col]`` grid positions that hold
its qubits (``circuits.site_qubits``).
"""

import numpy as np

from tnbench.circuits import random_circuit

REFERENCE_SAMPLES = 1024


def circuit(config, seed):
    """``(n, layers)`` of the configuration's circuit for ``seed``."""
    c = config["circuit"]
    if c["generator"] != "random_circuit":
        raise ValueError(f"unknown circuit generator {c['generator']!r}")
    return random_circuit(c["rows"], c["cols"], c["cycles"], seed=seed,
                          sequence=c["sequence"], theta=c["theta"],
                          phi=c["phi"], sites=c.get("sites"))


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


def share(traffic, k):
    """The slice ids a batch sums, as a range, of a plan with ``k``
    sliced bonds; None (every slice) without a ``share``."""
    sh = traffic.get("share")
    if sh is None:
        return None
    first, count = int(sh["first"]), int(sh["slices"])
    if first < 0 or count < 1 or first + count > 2 ** k:
        raise ValueError(f"share [{first}, {first + count}) is not a range "
                         f"of the plan's {2 ** k} slices")
    return range(first, first + count)


def share_width(width, ids):
    """The slice width a batch runs at: the program's ``width`` for the
    whole plan, halved while it exceeds the share.  A share that it does
    not divide is refused: the runner would run its rest at a second
    width."""
    if ids is None:
        return width
    while width > len(ids):
        width //= 2
    if len(ids) % width:
        raise ValueError(f"a share of {len(ids)} slices is not a multiple "
                         f"of the slice width {width}")
    return width


def slices_run(k, ids):
    """How many slices a batch runs: all ``2**k``, or the share's."""
    return 2 ** k if ids is None else len(ids)


def amps_per_batch(n_amps, k, ids):
    """A batch's amplitudes of the whole task: its ``n_amps``, scaled by
    the share's part of the ``2**k`` slices, so that amplitudes per second
    stay amplitudes of the task per second of this card."""
    return n_amps if ids is None else n_amps * len(ids) / 2 ** k


def reference_sample(n_bits, seed):
    """Sorted positions, among a batch's ``n_bits`` bitstrings, of those
    the network reference computes: all of them, or past
    ``REFERENCE_SAMPLES`` that many drawn from ``seed``."""
    if n_bits <= REFERENCE_SAMPLES:
        return np.arange(n_bits)
    rng = np.random.default_rng([seed, 2])
    return np.sort(rng.choice(n_bits, REFERENCE_SAMPLES, replace=False))


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
