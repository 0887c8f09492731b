"""The port's other single-card runners in every field mode, against the
JAX package's ``contraction(dtype, precision, mode, algo)``: the
segmented run (``runtime/segmented.run_segmented``, segments of a few
steps), scientific notation (``contraction(scientific_notation=True)``)
and the checkpointed run (``contraction(checkpoint_path=...)``), each on
the sparse and the dense case of tests/test_torch_checkpoint.py, for
every (mode, algo) of tests/test_aux.py:128-131 at every precision,
complex64 at 2e-5 of the largest |amplitude|, at slice widths 1 and 4
(scientific notation runs its slices one at a time, as in the JAX
package)."""

import os

import numpy as np
import pytest
import torch

from test_torch_checkpoint import cases  # noqa: F401  (module fixture)
from test_torch_field_runs import MODES, PRECISIONS, held, keyed


def _segmented(ps, mode, algo, precision, width):
    from artensor_tpu_torch.ops.field import make_field
    from artensor_tpu_torch.runtime import segmented

    field, run_steps, arrays, out_shape, _, step = ps._staged(
        torch.device("cpu"), make_field(np.complex64, precision, mode, algo))
    out = segmented.run_segmented(
        arrays, run_steps, ps.slicing_axes, len(ps.slicing_bonds),
        out_shape, field, step, segment_steps=4, slice_batch=width)
    assert segmented.LAST_RUN["width"] == width
    assert segmented.LAST_RUN["segments"] > 1
    vals = field.unwrap(out).reshape(out_shape).transpose(ps.permute_dims)
    return keyed(ps, vals)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mode,algo", MODES)
@pytest.mark.parametrize("case", ["dense4", "sparse"])
def test_segmented_run(cases, case, mode, algo, precision):
    w = cases[case]
    for width in (1, 4):
        got = _segmented(w["ps"], mode, algo, precision, width)
        held(got, w, case, mode, algo, precision)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mode,algo", MODES)
@pytest.mark.parametrize("case", ["dense4", "sparse"])
def test_rescaled_run(cases, case, mode, algo, precision):
    w = cases[case]
    ps = w["ps"]
    t, f = ps.contraction(precision=precision, mode=mode, algo=algo,
                          scientific_notation=True, device="cpu")
    assert ps.run_stats["executor"] == "rescaled"
    assert np.isfinite(f)
    held(keyed(ps, t * 10.0 ** f), w, case, mode, algo, precision)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mode,algo", MODES)
@pytest.mark.parametrize("case", ["dense4", "sparse"])
def test_checkpointed_run(cases, tmp_path, case, mode, algo, precision):
    w = cases[case]
    ps = w["ps"]
    for width in (1, 4):
        path = str(tmp_path / f"acc{width}.npz")
        got = ps.contraction(precision=precision, mode=mode, algo=algo,
                             checkpoint_path=path, slice_batch=width,
                             device="cpu")
        assert ps.run_stats["executor"] == "checkpointed"
        assert not os.path.exists(path)
        held(keyed(ps, got), w, case, mode, algo, precision)
