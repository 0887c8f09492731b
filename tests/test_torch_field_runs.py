"""The port's number-field options end to end against the JAX package's:
``contraction(dtype, precision, mode, algo)`` of both packages on the
same small circuits and the same JAX plans (both packages' off form, so
their steps are the same), for every (mode, algo) that
tests/test_aux.py:128-131 runs, at every precision, sparse and dense,
complex64 and complex128, at slice widths 1 and 4; each against JAX's
same run and the exact values.  On the CPU every precision computes in
full float32 / float64 (``ops/einsum.py``), as JAX's CPU backend does."""

import numpy as np
import pytest

from test_torch_checkpoint import cases  # noqa: F401  (module fixture)

MODES = [("split", "naive"), ("split", "karatsuba"), ("complex", "naive"),
         ("complex", "karatsuba"), ("fused", "naive")]
PRECISIONS = ["highest", "high", "default"]
# of the largest |amplitude|: complex64 as tests/test_torch_checkpoint.py,
# complex128 as tests/test_aux.py:139
TOL = {np.complex64: 2e-5, np.complex128: 1e-10}

_JAX = {}   # one jit compile a key, made once for the module


def keyed(sim, vals):
    """Values in a common order: the dense state as it is (qubit order),
    the sparse amplitudes sorted by bitstring."""
    if sim.bitstrings_sorted is None:
        return np.asarray(vals)
    return np.asarray(vals)[np.argsort(sim.bitstrings_sorted)]


def exact(w):
    if w["ps"].bitstrings_sorted is None:
        return w["state"]
    return keyed(w["ps"], w["state"])


def jax_run(w, case, mode, algo, precision, dtype=np.complex64):
    """JAX's ``contraction`` of ``case`` with these field options."""
    key = (case, mode, algo, precision, np.dtype(dtype).name)
    if key not in _JAX:
        _JAX[key] = keyed(w["js"], w["js"].contraction(
            dtype=dtype, precision=precision, mode=mode, algo=algo))
    return _JAX[key]


def held(got, w, case, mode, algo, precision, dtype=np.complex64):
    """``got`` (common order) against JAX's run and the exact values."""
    want = jax_run(w, case, mode, algo, precision, dtype)
    scale = np.abs(want).max()
    tol = TOL[dtype] * scale
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol
    assert np.abs(got - exact(w)).max() <= tol


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128],
                         ids=["c64", "c128"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mode,algo", MODES)
@pytest.mark.parametrize("case", ["dense4", "sparse"])
def test_whole_group_run(cases, case, mode, algo, precision, dtype):
    """``contraction()`` (the whole-group runner) at widths 1 and 4."""
    w = cases[case]
    ps = w["ps"]
    for width in (1, 4):
        got = ps.contraction(dtype=dtype, precision=precision, mode=mode,
                             algo=algo, slice_batch=width, device="cpu")
        assert ps.field.mode == mode
        assert ps.run_stats["executor"] == "eager"
        assert ps.run_stats["slice_batch"] == width
        held(keyed(ps, got), w, case, mode, algo, precision, dtype)


def test_report_counts_the_fields_products(cases):
    """The report's predicted flops count 3 real products a complex one
    under split karatsuba, 4 otherwise (complex and fused modes count
    naive), as the JAX package's report does."""
    from artensor_tpu_torch.runtime import metrics as mt

    ps = cases["sparse"]["ps"]
    flops = {}
    for mode, algo in MODES:
        rep = mt.ContractionReport()
        ps.contraction(mode=mode, algo=algo, report=rep, device="cpu")
        flops[mode, algo] = rep.predicted_flops
    naive = flops["split", "naive"]
    assert flops["split", "karatsuba"] == naive * 3 // 4
    assert flops["complex", "naive"] == flops["complex", "karatsuba"] \
        == flops["fused", "naive"] == naive
