"""The port's checkpoint/resume (``runtime/checkpoint.py``) against the JAX
package's: a run interrupted after a chunk and resumed equals the
uninterrupted run and JAX's, a checkpoint that either package writes is
resumed by the other (in every field mode, at slice widths that do not
divide what is left of the run), a failed chunk is retried, and
``contraction(checkpoint_path=...)`` matches JAX's."""

import os

import numpy as np
import pytest
import torch

from artensor_tpu import plan_io as jplan_io
from artensor_tpu.circuits import TensorNetworkCircuit as JaxCircuit
from artensor_tpu.circuits.random_circuits import random_circuit
from artensor_tpu.network import NumericalTensorNetwork as JaxNTN
from artensor_tpu.ops.field import make_field as jax_make_field
from artensor_tpu.planner import find_order
from artensor_tpu_torch.runtime import executor as pex
from artensor_tpu_torch.runtime.checkpoint import run_sliced_checkpointed

from test_torch_rescaled import off_form_sims

TOL = 2e-5          # of the largest |amplitude|: complex64 on both sides
PLAN_KW = dict(trials=2, iters=5, betas=np.linspace(3, 21, 10),
               slicing_repeat=1, parallel=False)


class Interrupt(Exception):
    pass


def _jax_plan(n, layers, pattern, sc, bits=()):
    ntn = JaxNTN(*JaxCircuit((n, layers)).to_numerical_tn())
    tb2, fq2 = ntn.simplify(pattern)
    kw = dict(max_bitstrings=len(bits)) if bits else {}
    _, sliced, ctree = find_order(tb2, ntn.bond_dims, fq2, sc_target=sc,
                                  **kw, **PLAN_KW)
    return jplan_io.plan_to_dict(ctree, meta={"sc_target": sc}), sliced


@pytest.fixture(scope="module")
def cases():
    """``dense``: random_circuit(2, 3, 6, seed=3), the whole 2^6 state (a
    >= 3-leg output, the case of tests/test_aux.py:272), a JAX plan at
    sc_target 3 (one sliced bond).  ``sparse``: random_circuit(4, 3, 8,
    seed=3), three bitstrings (tests/test_aux.py:372), a JAX plan at
    sc_target 8 (at least three sliced bonds).  ``dense4``:
    random_circuit(2, 3, 10, seed=3), the whole 2^6 state, a JAX plan at
    sc_target 4 (at least two sliced bonds: widths 1, 2 and 4 divide its
    slices).  Each with both packages' off-form simulations and the exact
    values."""
    out = {}
    n, layers = random_circuit(2, 3, 10, seed=3)
    plan, sliced = _jax_plan(n, layers, "normal", 4)
    assert len(sliced) >= 2
    js, ps = off_form_sims(n, layers, [], plan)
    out["dense4"] = dict(js=js, ps=ps, plan=plan, n=n, layers=layers,
                         bits=[], state=JaxCircuit((n, layers)).state_vec())
    n, layers = random_circuit(2, 3, 6, seed=3)
    plan, sliced = _jax_plan(n, layers, "normal", 3)
    assert len(sliced) >= 1
    js, ps = off_form_sims(n, layers, [], plan)
    out["dense"] = dict(js=js, ps=ps, plan=plan, n=n, layers=layers,
                        bits=[], state=JaxCircuit((n, layers)).state_vec())
    n, layers = random_circuit(4, 3, 8, seed=3)
    bits = ["0" * n, "01" * (n // 2), "1" * n]
    plan, sliced = _jax_plan(n, layers, "sparse", 8, bits)
    assert len(sliced) >= 3
    js, ps = off_form_sims(n, layers, bits, plan)
    full = JaxCircuit((n, layers)).state_vec().reshape(-1)
    out["sparse"] = dict(js=js, ps=ps, plan=plan, n=n, layers=layers,
                         bits=bits,
                         state=np.array([full[int(b, 2)]
                                         for b in ps.bitstrings_sorted]))
    return out


def _port_run(ps, slice_batch=1, mode="split"):
    """The port's sliced runner over its staged tensors:
    ``(run, arrays, k, out_shape, field)``."""
    from artensor_tpu_torch.ops.field import make_field

    field, run_steps, arrays, out_shape, execute, _ = ps._staged(
        torch.device("cpu"), make_field(np.complex64, "highest", mode))
    k = len(ps.slicing_bonds)
    run = pex.make_sliced_runner(execute, run_steps, ps.slicing_axes, k,
                                 out_shape, field, slice_batch=slice_batch)
    return run, arrays, k, out_shape, field


def _jax_run(js, mode="split"):
    """The JAX package's jitted sliced runner over its staged tensors."""
    import jax

    from artensor_tpu.runtime import executor as jex
    from artensor_tpu.runtime.sparse import execute_sparse

    field = jax_make_field(np.complex64, "highest", mode)
    run_steps, host = jex.precompute_static_steps(
        js.steps, [js.tensors[i] for i in range(len(js.tensors))],
        js.slicing_axes)
    staged = jex.stage_tensors(field, host)
    sparse = js.bitstrings_sorted is not None
    out_shape = ((len(js.bitstrings_sorted),) if sparse else ()) \
        + (2,) * len(js.output_bonds)
    run = jax.jit(jex.make_sliced_runner(
        execute_sparse if sparse else jex.execute_dense, run_steps,
        js.slicing_axes, len(js.slicing_bonds), out_shape, field))
    return run, staged, len(js.slicing_bonds), out_shape, field


def _state(sim, field, acc, out_shape):
    """The run's values in a common order: the dense state in qubit
    order, or the sparse amplitudes in sorted bitstring order."""
    vals = field.unwrap(acc).reshape(out_shape).transpose(sim.permute_dims)
    if sim.bitstrings_sorted is None:
        return vals
    order = np.argsort(sim.bitstrings_sorted)
    return vals.reshape(-1)[order]


def _exact(w):
    """The exact values in ``_state``'s order."""
    if w["ps"].bitstrings_sorted is None:
        return w["state"]
    return w["state"][np.argsort(w["ps"].bitstrings_sorted)]


@pytest.mark.parametrize("case,chunk,width", [("dense", 1, 1),
                                              ("sparse", 1, 1),
                                              ("sparse", 4, 2)])
def test_interrupted_run_resumes(cases, tmp_path, case, chunk, width):
    """Interrupted after the first chunk, the file holds the next slice;
    the resumed run equals the uninterrupted one, JAX's and the exact
    values, and the file is gone."""
    w = cases[case]
    ps = w["ps"]
    run, arrays, k, out_shape, field = _port_run(ps, width)
    path = str(tmp_path / "acc.npz")
    calls = []

    def boom(done, total):
        calls.append(done)
        raise Interrupt

    with pytest.raises(Interrupt):
        run_sliced_checkpointed(run, arrays, k, out_shape, field, path,
                                chunk=chunk, progress=boom)
    assert calls == [chunk]
    saved = np.load(path)
    assert int(saved["next_slice"]) == chunk
    assert saved["acc_re"].shape == saved["acc_im"].shape
    acc = run_sliced_checkpointed(run, arrays, k, out_shape, field, path,
                                  chunk=chunk)
    assert not os.path.exists(path)
    got = _state(ps, field, acc, out_shape)
    plain = _state(ps, field, run(arrays), out_shape)
    assert np.abs(got - plain).max() <= 1e-6 * np.abs(plain).max()
    jrun, staged, _, jshape, jfield = _jax_run(w["js"])
    want = _state(w["js"], jfield, jrun(staged), jshape)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale
    assert np.abs(got - _exact(w)).max() <= TOL * scale


@pytest.mark.parametrize("case", ["dense", "sparse"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_packages(cases, tmp_path, writer, case):
    """A checkpoint one package writes after its first chunk (the flat
    physical accumulator under ``acc_re``, ``acc_im``, ``next_slice``) is
    resumed by the other to the full state."""
    from artensor_tpu.runtime.checkpoint import \
        run_sliced_checkpointed as jax_checkpointed

    w = cases[case]
    path = str(tmp_path / "acc.npz")
    jrun, staged, k, jshape, jfield = _jax_run(w["js"])
    prun, arrays, _, pshape, pfield = _port_run(w["ps"])

    def boom(done, total):
        raise Interrupt

    first, then = (jax_checkpointed, run_sliced_checkpointed)
    args = [(jrun, staged, k, jshape, jfield), (prun, arrays, k, pshape,
                                                pfield)]
    if writer == "port":
        first, then = then, first
        args.reverse()
    with pytest.raises(Interrupt):
        first(*args[0], path, chunk=1, progress=boom)
    assert int(np.load(path)["next_slice"]) == 1
    acc = then(*args[1], path, chunk=1)
    assert not os.path.exists(path)
    sim, field, shape = (w["ps"], pfield, pshape) if writer == "jax" \
        else (w["js"], jfield, jshape)
    got = _state(sim, field, acc, shape)
    exact = _exact(w)
    assert np.abs(got - exact).max() <= TOL * np.abs(exact).max()


def test_failed_chunk_is_retried(cases, tmp_path):
    """A chunk that fails is run again (and counted); a wrong call
    (TypeError) is not retried."""
    w = cases["dense"]
    run, arrays, k, out_shape, field = _port_run(w["ps"])
    fails = []

    def flaky(tensors, ids, init=None):
        if len(fails) < 2:
            fails.append(ids)
            raise RuntimeError("lost the device for a moment")
        return run(tensors, ids, init=init)

    acc = run_sliced_checkpointed(flaky, arrays, k, out_shape, field,
                                  str(tmp_path / "acc.npz"), chunk=1)
    assert len(fails) == 2 and fails[0] == fails[1] == range(0, 1)
    got = _state(w["ps"], field, acc, out_shape)
    assert np.abs(got - w["state"]).max() <= TOL * np.abs(w["state"]).max()

    def wrong(tensors, ids, init=None):
        fails.append(ids)
        raise TypeError("bad argument")

    with pytest.raises(TypeError):
        run_sliced_checkpointed(wrong, arrays, k, out_shape, field,
                                str(tmp_path / "b.npz"), chunk=1)
    assert len(fails) == 3


def test_contraction_checkpoint_path_matches_jax(cases, tmp_path):
    """``contraction(checkpoint_path=...)`` of both packages on the sparse
    case's off-form scheme: the same amplitudes, the files gone."""
    w = cases["sparse"]
    js, ps = w["js"], w["ps"]
    jp, pp = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    want = dict(zip(js.bitstrings_sorted, js.contraction(checkpoint_path=jp)))
    got = ps.contraction(checkpoint_path=pp, slice_batch=2, device="cpu")
    assert ps.run_stats["executor"] == "checkpointed"
    assert not os.path.exists(pp) and not os.path.exists(jp)
    scale = max(abs(v) for v in want.values())
    for b, a in zip(ps.bitstrings_sorted, got):
        assert abs(a - want[b]) <= TOL * scale, b


# a JAX run is one jit compile; each is made once for the module
_JAX_FULL = {}


def _jax_full(w, case, mode):
    """JAX's uninterrupted run of ``case`` in ``mode``, in ``_state``'s
    order."""
    if (case, mode) not in _JAX_FULL:
        jrun, staged, _, jshape, jfield = _jax_run(w["js"], mode)
        _JAX_FULL[case, mode] = _state(w["js"], jfield, jrun(staged),
                                       jshape)
    return _JAX_FULL[case, mode]


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("mode", ["split", "complex", "fused"])
@pytest.mark.parametrize("case", ["dense4", "sparse"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_at_any_width(cases, tmp_path, writer, case, mode, width):
    """A checkpoint written by either package in ``mode`` after a first
    chunk that leaves ``next_slice`` off the width's grid (JAX: chunk 1,
    next slice 1; the port at width 1: chunk 3, next slice 3) resumes in
    the port at ``width`` with chunks of ``width`` slices, whose last
    one runs its rest as a narrower group, to JAX's uninterrupted run
    and the exact values; the file names ``acc_re`` / ``acc_im`` for a
    split field and ``acc`` otherwise.  On a tree where the runner
    required its width to divide every chunk, the resumes that leave a
    rest (width 2 after next slice 3, width 4 after either) raised
    ``ValueError`` with the file left behind."""
    from artensor_tpu.runtime.checkpoint import \
        run_sliced_checkpointed as jax_checkpointed

    w = cases[case]
    path = str(tmp_path / "acc.npz")

    def boom(done, total):
        raise Interrupt

    if writer == "jax":
        jrun, staged, k, jshape, jfield = _jax_run(w["js"], mode)
        with pytest.raises(Interrupt):
            jax_checkpointed(jrun, staged, k, jshape, jfield, path, chunk=1,
                             progress=boom)
        first = 1
    else:
        run1, arrays1, k, shape1, field1 = _port_run(w["ps"], 1, mode)
        with pytest.raises(Interrupt):
            run_sliced_checkpointed(run1, arrays1, k, shape1, field1, path,
                                    chunk=3, progress=boom)
        first = 3
    saved = np.load(path)
    assert int(saved["next_slice"]) == first
    assert sorted(saved.files) == sorted(
        ["acc_re", "acc_im", "next_slice"] if mode == "split"
        else ["acc", "next_slice"])
    run, arrays, k, out_shape, field = _port_run(w["ps"], width, mode)
    acc = run_sliced_checkpointed(run, arrays, k, out_shape, field, path,
                                  chunk=width)
    assert not os.path.exists(path)
    got = _state(w["ps"], field, acc, out_shape)
    want = _jax_full(w, case, mode)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale
    assert np.abs(got - _exact(w)).max() <= TOL * scale


def test_contraction_resumes_a_jax_file_at_width_4(cases, tmp_path):
    """The fault as found: JAX's checkpointed run stopped after its first
    chunk (16 slices in chunks of 2: next slice 2), resumed by the port's
    ``contraction(checkpoint_path=..., slice_batch=4)`` (chunks of 4
    from slice 2: the last is 2 slices).  The parent tree raised
    ``slice_batch 4 must divide the 2 slices summed`` after three chunks;
    now the run ends with JAX's amplitudes and the file gone."""
    from artensor_tpu.runtime.checkpoint import \
        run_sliced_checkpointed as jax_checkpointed

    w = cases["sparse"]
    path = str(tmp_path / "acc.npz")
    jrun, staged, k, jshape, jfield = _jax_run(w["js"])

    def boom(done, total):
        raise Interrupt

    with pytest.raises(Interrupt):
        jax_checkpointed(jrun, staged, k, jshape, jfield, path,
                         progress=boom)
    assert int(np.load(path)["next_slice"]) == 2 ** k // 8 == 2
    got = w["ps"].contraction(checkpoint_path=path, slice_batch=4,
                              device="cpu")
    assert not os.path.exists(path)
    assert w["ps"].run_stats["executor"] == "checkpointed"
    order = np.argsort(w["ps"].bitstrings_sorted)
    want = _jax_full(w, "sparse", "split")
    assert np.abs(got[order] - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("n,width,want", [
    (16, 4, [(4, 4)]), (14, 4, [(4, 3), (2, 1)]), (3, 4, [(3, 1)]),
    (1, 1, [(1, 1)]), (7, 2, [(2, 3), (1, 1)])])
def test_group_widths(n, width, want):
    """A run of ``n`` slice ids at ``width``: full groups, then the rest
    as one group of its own width."""
    assert pex.group_widths(n, width) == want


def test_a_width_that_does_not_divide_the_slices_still_raises(cases):
    """A wrong call still raises: the width must divide the 2^k slices
    (the dense case has two), and a run of no slice ids is refused."""
    w = cases["dense"]
    with pytest.raises(ValueError, match="must divide"):
        _port_run(w["ps"], 4)
    run, arrays, *_ = _port_run(w["ps"], 1)
    with pytest.raises(ValueError, match="no slice ids"):
        run(arrays, range(1, 1))
