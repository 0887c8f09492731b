"""Cross-entropy benchmarking (XEB) and fidelity estimators.

Port of ``artensor_tpu/utils/xeb.py`` (a numpy copy, the same numbers):
the slicing-fidelity relation (summing one of 2^k slice configurations
gives a state of fidelity ~ 1/2^k) and the validation of sampled
amplitudes against a ground truth (the 5% relative-error criterion).
Host-side numpy only.
"""

import numpy as np


def state_fidelity(a, b):
    """|<a|b>|^2 / (<a|a><b|b>) for two (unnormalized) state vectors."""
    a = np.asarray(a).reshape(-1)
    b = np.asarray(b).reshape(-1)
    na = np.vdot(a, a).real
    nb = np.vdot(b, b).real
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(abs(np.vdot(a, b)) ** 2 / (na * nb))


def linear_xeb(amplitudes, num_qubits, sampled=True):
    """Linear cross-entropy fidelity estimate from a batch of amplitudes.

    ``amplitudes``: ideal-circuit amplitudes of a set of bitstrings.

    ``sampled=True``: the bitstrings were sampled from the experimental
    device (the XEB setting): F ~ 2^n <p(s)> - 1, where p(s) = |amp|^2.
    For a perfect device sampling the ideal Porter-Thomas distribution the
    estimator converges to 1; for uniformly random output it converges to 0.

    ``sampled=False``: the bitstrings are uniformly random (a self-check of
    a simulator's own output batch); then 2^n <p> - 1 estimates 0 for any
    state, so return the Porter-Thomas second-moment statistic
    2^{2n} <p^2> / 2 instead: ~1 for a typical random-circuit state
    (p ~ Exp(1/N), E[p^2] = 2/N^2) and 1/2 for the uniform state.
    """
    p = np.abs(np.asarray(amplitudes).reshape(-1)) ** 2
    if sampled:
        return float(2.0 ** num_qubits * p.mean() - 1.0)
    return float(2.0 ** (2 * num_qubits) * (p ** 2).mean() / 2.0)


def xeb_against_ground_truth(amplitudes, reference_amplitudes, rel_tol=0.05):
    """The share of amplitudes within ``rel_tol`` relative error of the
    ground truth, with the largest and the mean relative error."""
    a = np.asarray(amplitudes).reshape(-1)
    r = np.asarray(reference_amplitudes).reshape(-1)
    rel = np.abs(a - r) / np.abs(r)
    return {
        "correct_ratio": float((rel <= rel_tol).mean()),
        "max_rel_err": float(rel.max()),
        "mean_rel_err": float(rel.mean()),
    }


def sliced_fidelity_estimate(num_sliced_dropped):
    """Expected fidelity after keeping a single slice configuration out of
    2^k: ~ 1/2^k."""
    return 1.0 / (2.0 ** num_sliced_dropped)
