"""The port's segmented executor (``runtime/segmented.py``), the run report
(``runtime/metrics.py``) and ``contraction()``'s routing against the JAX
package: ``_segment_io`` equals JAX's on the same steps, the segmented run
equals the whole-group run, the audit refuses a width before any buffer is
made, the wall estimate, the out-of-memory classification, the
auto-segmented ``contraction()`` and its report against JAX's, a second
run of a prepared runner uploads nothing, the whole-group run halves its
width on a device out-of-memory error only, and the runner's ``init`` is
added to, never written."""

import logging
import os

import numpy as np
import pytest
import torch

from artensor_tpu import plan_io as jplan_io
from artensor_tpu.circuits import TensorNetworkCircuit as JaxCircuit
from artensor_tpu.circuits.random_circuits import random_circuit
from artensor_tpu.network import NumericalTensorNetwork as JaxNTN
from artensor_tpu.planner import find_order
from artensor_tpu_torch import TensorNetworkSimulation
from artensor_tpu_torch.runtime import executor as pex
from artensor_tpu_torch.runtime import gatherk as pgk
from artensor_tpu_torch.runtime import metrics as pmt
from artensor_tpu_torch.runtime import segmented as pseg

from test_torch_rescaled import off_form_sims

TOL = 2e-5          # of the largest |amplitude|: complex64 on both sides
RGF_PLAN = os.path.join(os.path.dirname(__file__), "data",
                        "torch_port_rcs15_rgflat_plan.json")
PLAN_KW = dict(trials=2, iters=5, betas=np.linspace(3, 21, 10),
               slicing_repeat=1, parallel=False)


@pytest.fixture(scope="module")
def case():
    """random_circuit(4, 3, 8, seed=3) with three bitstrings (the circuit
    of tests/test_aux.py:372), a JAX plan at sc_target 8 (at least three
    sliced bonds), both packages' off-form simulations and the exact
    amplitudes."""
    n, layers = random_circuit(4, 3, 8, seed=3)
    bits = ["0" * n, "01" * (n // 2), "1" * n]
    ntn = JaxNTN(*JaxCircuit((n, layers)).to_numerical_tn())
    tb2, fq2 = ntn.simplify("sparse")
    _, sliced, ctree = find_order(tb2, ntn.bond_dims, fq2, sc_target=8,
                                  max_bitstrings=3, **PLAN_KW)
    assert len(sliced) >= 3
    plan = jplan_io.plan_to_dict(ctree, meta={"sc_target": 8})
    js, ps = off_form_sims(n, layers, bits, plan)
    full = JaxCircuit((n, layers)).state_vec().reshape(-1)
    return dict(n=n, layers=layers, bits=bits, plan=plan, js=js, ps=ps,
                exact={b: full[int(b, 2)] for b in bits})


@pytest.fixture(scope="module")
def many_bits():
    """random_circuit(3, 5, 8, seed=13) with 128 bitstrings and its
    committed JAX plan at sc_target 12 (``tests/test_torch_sparse.py``'s
    ``rcs15``): aligned and cross merges, and with the size gates lowered
    GK, RGFlat, Lane and Pair steps."""
    import json

    n, layers = random_circuit(3, 5, 8, seed=13)
    rng = np.random.default_rng(4)
    bits = [np.binary_repr(b, n)
            for b in rng.choice(2 ** n, 128, replace=False)]
    with open(RGF_PLAN) as f:
        plan = json.load(f)
    return dict(n=n, layers=layers, bits=bits, plan=plan)


@pytest.fixture(scope="module")
def dense_case():
    """random_circuit(3, 3, 6, seed=11), the whole state, a JAX plan at
    sc_target 4 (one sliced bond): its port simulation (off form)."""
    n, layers = random_circuit(3, 3, 6, seed=11)
    ntn = JaxNTN(*JaxCircuit((n, layers)).to_numerical_tn())
    tb2, fq2 = ntn.simplify("normal")
    _, sliced, ctree = find_order(tb2, ntn.bond_dims, fq2, sc_target=4,
                                  **PLAN_KW)
    plan = jplan_io.plan_to_dict(ctree, meta={"sc_target": 4})
    _, ps = off_form_sims(n, layers, [], plan)
    return ps


def _staged(ps):
    field, run_steps, arrays, out_shape, execute, step = ps._staged(
        torch.device("cpu"))
    return field, run_steps, arrays, out_shape, execute, step


def _whole(ps, width=1):
    field, run_steps, arrays, out_shape, execute, _ = _staged(ps)
    run = pex.make_sliced_runner(execute, run_steps, ps.slicing_axes,
                                 len(ps.slicing_bonds), out_shape, field,
                                 slice_batch=width)
    return field.unwrap(run(arrays)).reshape(-1)


@pytest.mark.parametrize("segment_steps", [3, 7])
def test_segment_io_matches_jax(case, segment_steps):
    from artensor_tpu.runtime.segmented import _segment_io as jax_io

    cut = lambda st: [list(st[i:i + segment_steps])
                      for i in range(0, len(st), segment_steps)]
    js, ps = case["js"], case["ps"]
    assert len(ps.steps) > 2 * segment_steps
    assert pseg._segment_io(cut(ps.steps), None) == \
        jax_io(cut(js.steps), None)


@pytest.mark.parametrize("pattern,width", [("sparse", 1), ("sparse", 2),
                                           ("dense", 1), ("dense", 2)])
def test_segmented_equals_whole_group(case, dense_case, pattern, width):
    """``run_segmented`` at ``segment_steps=3`` equals the whole-group run
    at the same width (tests/test_aux.py:239, :394), and on the sparse
    case JAX's amplitudes."""
    ps = case["ps"] if pattern == "sparse" else dense_case
    field, run_steps, arrays, out_shape, _, step = _staged(ps)
    got = pseg.run_segmented(arrays, run_steps, ps.slicing_axes,
                             len(ps.slicing_bonds), out_shape, field, step,
                             segment_steps=3, slice_batch=width)
    assert pseg.LAST_RUN["width"] == width
    assert pseg.LAST_RUN["segments"] == -(-len(run_steps) // 3) > 2
    got = field.unwrap(got).reshape(-1)
    whole = _whole(ps, width)
    assert np.abs(got - whole).max() <= 1e-6 * np.abs(whole).max()
    if pattern == "sparse":
        want = dict(zip(case["js"].bitstrings_sorted,
                        case["js"].contraction()))
        scale = max(abs(v) for v in want.values())
        for b, a in zip(ps.bitstrings_sorted, got):
            assert abs(a - want[b]) <= TOL * scale, b
            assert abs(a - case["exact"][b]) <= TOL * scale, b


def test_tiny_budget_refused_before_any_buffer(case, monkeypatch, caplog):
    """A budget below every segment's modeled peak: the executor refuses
    the width before any buffer is made (tests/test_aux.py:420); the run
    halves it down to width 1, which is not audited, makes its buffers
    only there, and gives the whole-group result."""
    ps = case["ps"]
    field, run_steps, arrays, out_shape, _, step = _staged(ps)
    with pytest.raises(pseg.SegmentAuditExceeded) as e:
        pseg.make_segmented_executor(run_steps, step, field, 3, width=4,
                                     slicing_axes=ps.slicing_axes,
                                     hbm_budget_bytes=1)
    assert e.value.segment == 0 and e.value.peak_bytes > 1
    widths = []
    real = pseg.slice_select

    def select(tensors, axes, ids, k, f):
        widths.append(len(ids))
        return real(tensors, axes, ids, k, f)

    monkeypatch.setattr(pseg, "slice_select", select)
    monkeypatch.setattr(pseg.cost, "HBM_BUDGET_BYTES", 1)
    with caplog.at_level(logging.WARNING, logger=pseg.__name__):
        got = pseg.run_segmented(arrays, run_steps, ps.slicing_axes,
                                 len(ps.slicing_bonds), out_shape, field,
                                 step, segment_steps=3, slice_batch=4)
    assert pseg.LAST_RUN["width"] == 1 and set(widths) == {1}
    assert sum("width rejected" in r.message for r in caplog.records) == 2
    whole = _whole(ps)
    got = field.unwrap(got).reshape(-1)
    assert np.abs(got - whole).max() <= 1e-6 * np.abs(whole).max()


def test_segment_peak_is_the_device_model(case):
    """One segment: its audited peak is the whole scheme's device peak
    model at that width; cut in segments, none is above it by more than
    what the model counts for the buffers held across."""
    ps = case["ps"]
    _, run_steps, _, _, _, _ = _staged(ps)
    for width in (1, 4):
        whole = pmt.scheme_device_peak_bytes(run_steps, width,
                                             ps.slicing_axes)
        one = pseg.segment_peak_bytes([run_steps], width, ps.slicing_axes)
        assert one == [whole]
        cut = [run_steps[i:i + 3] for i in range(0, len(run_steps), 3)]
        peaks = pseg.segment_peak_bytes(cut, width, ps.slicing_axes)
        assert len(peaks) == len(cut) and min(peaks) > 0


def test_segmented_wall_estimate(case):
    """Positive, more segments cost more at a fixed width, and the device
    term is the per-slice model of ``scheme_wall_components``
    (tests/test_aux.py:464)."""
    _, run_steps, _, _, _, _ = _staged(case["ps"])
    t64, dev, n64 = pmt.segmented_wall_estimate(run_steps, n_slices=8,
                                                width=2, segment_steps=64)
    t4, dev4, n4 = pmt.segmented_wall_estimate(run_steps, n_slices=8,
                                               width=2, segment_steps=4)
    assert t64 > 0 and dev > 0 and n4 > n64 >= 1
    assert dev4 == dev
    assert t4 > t64
    assert t4 - t64 == pytest.approx(4 * (n4 - n64) * pmt.SEGMENT_REPLAY_S)


def test_is_device_oom_classification():
    """Only genuine device memory exhaustion takes the width-halving path
    (tests/test_aux.py:869)."""
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 16.00 GiB")
    assert pseg._is_device_oom(oom)
    assert pseg._is_device_oom(RuntimeError("CUDA error: out of memory"))
    assert pseg._is_device_oom(RuntimeError(
        "CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate"))
    try:
        try:
            raise oom
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError("capture failed") from e
    except RuntimeError as e:
        assert pseg._is_device_oom(e)
    assert not pseg._is_device_oom(ValueError(
        "operand memory layout does not match the expected tiling"))
    assert not pseg._is_device_oom(TypeError("resource handle is not hashable"))
    assert not pseg._is_device_oom(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))


def test_auto_segmented_contraction_matches_jax(case, monkeypatch):
    """Above ``SEGMENT_AUTO_THRESHOLD`` device steps ``contraction()``
    runs segmented; with the threshold at 2 the port's run equals its
    whole-group run and JAX's (tests/test_aux.py:372)."""
    from artensor_tpu_torch import simulation as psim

    ps = TensorNetworkSimulation.from_circuit(
        (case["n"], case["layers"]), case["bits"]).load_plan(case["plan"])
    whole = ps.contraction(slice_batch=2, device="cpu")
    assert ps.run_stats["executor"] == "eager"
    monkeypatch.setattr(psim, "SEGMENT_AUTO_THRESHOLD", 2)
    seg = ps.contraction(slice_batch=2, device="cpu")
    assert ps.run_stats["executor"] == "segmented"
    assert ps.run_stats["slice_batch"] == 2
    assert np.abs(seg - whole).max() <= 1e-6 * np.abs(whole).max()
    js = case["js"]
    want = dict(zip(js.bitstrings_sorted, js.contraction()))
    scale = max(abs(v) for v in want.values())
    for b, a in zip(ps.bitstrings_sorted, seg):
        assert abs(a - want[b]) <= TOL * scale, b


def test_report_fields_match_jax(case):
    """``contraction(report=...)`` fills the fields of JAX's report with
    JAX's values on the same scheme (tests/test_aux.py:109)."""
    from artensor_tpu.runtime.metrics import ContractionReport as JaxReport

    js, ps = case["js"], case["ps"]
    jr, pr = JaxReport(), pmt.ContractionReport()
    js.contraction(report=jr)
    ps.contraction(report=pr, slice_batch=2, device="cpu")
    for key in ("num_steps", "num_slices", "reorders"):
        assert getattr(pr, key) == getattr(jr, key), key
    for key in ("predicted_flops", "tc", "sc"):
        assert getattr(pr, key) == pytest.approx(getattr(jr, key)), key
    assert pr.wall_s > 0 and pr.executor == "eager" and pr.slice_batch == 2
    assert "steps x" in pr.summary() and "eager at width 2" in pr.summary()


@pytest.fixture
def low_gates(monkeypatch):
    """Size gates lowered so that the small scheme has kernel steps (as
    ``tests/test_torch_sparse.py::test_lane_route_matches_jax_and_state_vec``
    lowers them)."""
    from artensor_tpu_torch.runtime import lanes as planes
    from artensor_tpu_torch.runtime import sparse as psparse

    monkeypatch.setattr(pgk, "MIN_X_ELEMS", 1 << 8)
    monkeypatch.setattr(pgk, "GGK_MIN_WORK", 1 << 8)
    monkeypatch.setattr(planes, "MIN_X_ELEMS", 1 << 6)
    monkeypatch.setattr(psparse, "RETAIL_MIN_ELEMS", 1 << 6)


@pytest.mark.parametrize("gates", ["default", "low"])
@pytest.mark.parametrize("mode", ["whole", "rescaled"])
def test_second_run_uploads_nothing(many_bits, monkeypatch, request, gates,
                                    mode):
    """Every index array a step takes is on the device after the first
    run: a second run of the same runner makes no tensor from host data
    (``torch.as_tensor``, ``torch.from_numpy``) and gives the same
    result."""
    from artensor_tpu_torch.runtime.rescaled import make_rescaled_runner
    from artensor_tpu_torch.runtime.sparse import kernel_kind

    if gates == "low":
        request.getfixturevalue("low_gates")
    w = many_bits
    ps = TensorNetworkSimulation.from_circuit(
        (w["n"], w["layers"]), w["bits"]).load_plan(w["plan"])
    field, run_steps, arrays, out_shape, execute, step = _staged(ps)
    if gates == "low":
        assert {"gk", "rgflat", "lane"} <= {kernel_kind(s)
                                            for s in run_steps}
    assert any(s.gathers is not None or s.post_select is not None
               for s in run_steps)
    k = len(ps.slicing_bonds)
    if mode == "whole":
        run = pex.make_sliced_runner(execute, run_steps, ps.slicing_axes, k,
                                     out_shape, field, slice_batch=2 ** k)
    else:
        run = make_rescaled_runner(step, run_steps, ps.slicing_axes, k,
                                   out_shape, field)
    first = run(arrays)

    def refuse(*a, **kw):
        raise AssertionError("a tensor made from host data during a run")

    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "from_numpy", refuse)
    second = run(arrays)
    monkeypatch.undo()
    a = first if mode == "whole" else first[0]
    b = second if mode == "whole" else second[0]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _oom_chained():
    """An error raised on top of a ``torch.cuda.OutOfMemoryError`` (its
    ``__context__``), as the end of a failed capture raises one."""
    try:
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB")
    except torch.cuda.OutOfMemoryError:
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")


def _oom_bare():
    raise torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")


def _not_oom():
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


@pytest.mark.parametrize("fail,halves", [(_oom_chained, True),
                                         (_oom_bare, True),
                                         (_not_oom, False)])
def test_whole_group_halves_only_on_device_oom(case, monkeypatch, caplog,
                                               fail, halves):
    """``contraction()``'s whole-group run halves its width when a
    ``torch.cuda.OutOfMemoryError`` is on the error's chain (bare, or
    under the error a failed capture raises on top of it), logs it, and
    completes at the smaller width; any other error propagates."""
    from artensor_tpu_torch import simulation as psim

    ps = TensorNetworkSimulation.from_circuit(
        (case["n"], case["layers"]), case["bits"]).load_plan(case["plan"])
    want = ps.contraction(slice_batch=1, device="cpu")
    real, widths = pex.make_sliced_runner, []

    def runner(*args, slice_batch=1, **kw):
        run = real(*args, slice_batch=slice_batch, **kw)
        widths.append(slice_batch)
        if slice_batch == 1:
            return run

        def failing(tensors, slice_ids=None, init=None):
            fail()
        failing.stats = run.stats
        return failing

    monkeypatch.setattr(pex, "make_sliced_runner", runner)
    if not halves:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            ps.contraction(slice_batch=2, device="cpu")
        assert widths == [2]
        return
    with caplog.at_level(logging.WARNING, logger=psim.__name__):
        got = ps.contraction(slice_batch=2, device="cpu")
    assert widths == [2, 1] and ps.run_stats["slice_batch"] == 1
    assert sum("out of device memory" in r.message
               and "slice_batch=1" in r.message
               for r in caplog.records) == 1
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_runner_adds_to_init_and_leaves_it(case):
    """The sliced runner's ``init`` (the checkpointed run's accumulator,
    which a retried chunk passes again) is added to, never written."""
    ps = case["ps"]
    field, run_steps, arrays, out_shape, execute, _ = _staged(ps)
    k = len(ps.slicing_bonds)
    run = pex.make_sliced_runner(execute, run_steps, ps.slicing_axes, k,
                                 out_shape, field, slice_batch=2)
    half = run(arrays, range(0, 2 ** k // 2))
    keep = tuple(c.clone() for c in half)
    got = run(arrays, range(2 ** k // 2, 2 ** k), init=half)
    assert all(torch.equal(a, b) for a, b in zip(half, keep))
    whole = field.unwrap(run(arrays)).reshape(-1)
    got = field.unwrap(got).reshape(-1)
    assert np.abs(got - whole).max() <= 1e-6 * np.abs(whole).max()
