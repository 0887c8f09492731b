"""Whether what the timed path produced is right: the program's amplitudes
against the plain reference (``reference/statevector.py``, or
``reference/network.py`` where the configuration names it), which runs
after the program's state is freed.

Two numbers, each against the cell's limit (``workloads/<cell>.json``):

- ``err_l2``: ||a - r|| / ||r|| over the amplitudes compared;
- ``err_max``: max |a - r| / rms(r), the widest gap in units of the
  reference's root mean square amplitude.

Amplitude batches: every batch of the window is compared whole (against
the network reference, at its sample of the bitstrings), and each number
is the worst batch's.  State batches: the last state of the window
is compared whole (both numbers), and every batch's sampled amplitudes
add to ``err_max``.  A batch fails when a number it reads is above its
limit; ``correct`` needs every number within its limit and no batch
failed.
"""

import numpy as np
import torch

NAMES = ("err_l2", "err_max")
CHUNK = 2 ** 26


def batch_errors(a, r, rms=None):
    """``(err_l2, err_max)`` of the amplitudes ``a`` against ``r``; the
    widest gap over ``rms`` (default: the root mean square of ``r``)."""
    a = np.asarray(a, dtype=np.complex128)
    r = np.asarray(r, dtype=np.complex128)
    d = np.abs(a - r)
    norm = float(np.linalg.norm(r))
    rms = norm / np.sqrt(r.size) if rms is None else rms
    return float(np.linalg.norm(d) / norm), float(d.max() / rms)


def state_errors(re, im, psi, axis_qubits):
    """``(err_l2, err_max, rms)`` of the state ``re + i im`` (flat, on the
    device, its axes holding the qubits ``axis_qubits``) against the
    reference ``psi`` (flat, qubit order), in chunks."""
    from tnbench.traffic import axis_index

    n = len(axis_qubits)
    d2 = n2 = 0.0
    dmax = 0.0
    for lo in range(0, psi.numel(), CHUNK):
        r = psi[lo:lo + CHUNK]
        at = axis_index(torch.arange(lo, lo + r.numel(), device=psi.device),
                        axis_qubits, n)
        dr = re[at].double() - r.real
        di = im[at].double() - r.imag
        del at
        dd = dr * dr + di * di
        d2 += float(dd.sum())
        m = float(dd.max())
        dmax = dmax if m <= dmax else m     # a NaN stays
        n2 += float((r.real * r.real + r.imag * r.imag).sum())
    rms = np.sqrt(n2 / psi.numel())
    return float(np.sqrt(d2 / n2)), float(np.sqrt(dmax) / rms), float(rms)


def judge(numbers, failed, limits, attempted):
    """``(correct, compared)``: each number beside its limit."""
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in NAMES}
    ok = attempted > 0 and failed == 0 and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())
    return bool(ok), compared


def amplitude_batches(batches, ref, limits):
    """``(numbers, failed)`` of every batch's amplitudes against ``ref``."""
    worst = dict.fromkeys(NAMES, 0.0)
    failed = 0
    for a in batches:
        e = dict(zip(NAMES, batch_errors(a, ref)))
        failed += any(not e[k] <= limits[k] for k in NAMES)
        for k in NAMES:
            worst[k] = max(worst[k], e[k]) if np.isfinite(e[k]) else np.inf
    return worst, failed


def state_batches(last, axis_qubits, samples, psi, sample_idx, limits):
    """``(numbers, failed)``: the last state (``(re, im)``, its axes holding
    the qubits ``axis_qubits``) whole, and every batch's sampled
    amplitudes, against ``psi``."""
    l2, mx, rms = state_errors(last[0], last[1], psi, axis_qubits)
    idx = torch.as_tensor(sample_idx, device=psi.device)
    ref = psi[idx].cpu().numpy()
    failed = int(not (l2 <= limits["err_l2"] and mx <= limits["err_max"]))
    for a in samples:
        _, m = batch_errors(a, ref, rms)
        if not m <= limits["err_max"]:
            failed += 1
        mx = max(mx, m) if np.isfinite(m) else np.inf
    return {"err_l2": l2, "err_max": mx}, failed
