"""The port's recorder (``runtime/tracing.py``) and the spans the program
takes with it: one ``step`` span a step of an eager run, the set-up spans
nested under ``load_plan`` and ``prepare``, nothing per batch or per step
with tracing off, the rings bounded, and the runner's ``stats`` read from
its spans."""

import json

import numpy as np
import pytest
import torch

from artensor_tpu_torch import (PlannerConfig, TensorNetworkSimulation,
                                random_circuit)
from artensor_tpu_torch.plan_io import plan_to_dict
from artensor_tpu_torch.runtime import executor, gatherk, scheme, tracing
from artensor_tpu_torch.runtime.sparse import kernel_kind

LOW_X = 1 << 8      # GK's size gate, so kernel steps run at this size
SC = {"sparse": 9, "dense": 10}
HOT = {"step", "runner.call", "runner.key", "runner.ids", "runner.reset",
       "runner.replay", "runner.group", "runner.clone", "runner.sync"}
SETUP = {"load_plan", "scheme.compile", "scheme.fuse", "scheme.negotiate",
         "prepare", "prepare.fold", "prepare.stage"}


@pytest.fixture(scope="module")
def plans():
    """random_circuit(3, 4, 8, seed=13) (12 qubits): the port's plan of 32
    amplitudes at sc_target 9 and of the whole state at 10, each slicing
    at least one bond."""
    n, layers = random_circuit(3, 4, 8, seed=13)
    rng = np.random.default_rng(4)
    bits = [np.binary_repr(b, n)
            for b in rng.choice(2 ** n, 32, replace=False)]
    out = {}
    for mode, b in (("sparse", bits), ("dense", [])):
        sim = TensorNetworkSimulation.from_circuit((n, layers), b)
        sim.prepare_contraction(PlannerConfig(sc_target=SC[mode], trials=1,
                                              iters=5, parallel=False))
        assert sim.slicing_bonds, mode
        out[mode] = (b, plan_to_dict(sim.ctree,
                                     meta={"sc_target": SC[mode]}))
    return (n, layers), out


@pytest.fixture
def recorder(monkeypatch):
    """A recorder with nothing kept, tracing off before and after; GK's
    size gate lowered."""
    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", LOW_X)
    prev = tracing.disable()
    tracing.reset()
    yield tracing
    tracing.enable(prev)
    tracing.reset()


def _sim(plans, mode):
    circuit, by_mode = plans
    bits, plan = by_mode[mode]
    return TensorNetworkSimulation.from_circuit(circuit, bits).load_plan(plan)


def _run_steps(sim):
    return executor.precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)[0]


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_one_step_span_a_step_in_scheme_order(plans, recorder, mode):
    sim = _sim(plans, mode)
    run_steps = _run_steps(sim)
    kinds = [kernel_kind(s) or "dot" for s in run_steps]
    assert set(kinds) - {"dot"}, "no kernel step at this size"
    width = 2
    groups = 2 ** len(sim.slicing_bonds) // width
    call = sim.prepare(slice_batch=width, device="cpu")
    tracing.enable()
    call()
    steps = tracing.spans("step")
    assert len(steps) == groups * len(run_steps)
    group_spans = tracing.spans("runner.group")
    (run_span,) = tracing.spans("runner.call")
    assert len(group_spans) == groups
    for g, grp in enumerate(group_spans):
        assert grp.parent == run_span.id
        mine = steps[g * len(run_steps):(g + 1) * len(run_steps)]
        assert [sp.attrs["index"] for sp in mine] == list(range(len(mine)))
        assert [sp.attrs["kind"] for sp in mine] == kinds
        assert all(sp.parent == grp.id for sp in mine)
        for sp, s in zip(mine, run_steps):
            if kernel_kind(s) in ("gk", "ggk"):
                assert sp.attrs["form"] in gatherk.GK_FORMS
            else:
                assert "form" not in sp.attrs


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_setup_spans_nest_under_load_plan_and_prepare(plans, recorder, mode):
    sim = _sim(plans, mode)
    sim.prepare(slice_batch=1, device="cpu")
    kept = tracing.spans()
    assert {sp.name for sp in kept} == SETUP
    (load,) = tracing.spans("load_plan")
    (comp,) = tracing.spans("scheme.compile")
    assert comp.parent == load.id and comp.attrs["kind"] == mode
    assert {sp.name for sp in tracing.children(comp)} == \
        {"scheme.fuse", "scheme.negotiate"}
    (prep,) = tracing.spans("prepare")
    assert [sp.name for sp in tracing.children(prep)] == \
        ["prepare.fold", "prepare.stage"]
    for sp in kept:
        assert sp.end >= sp.start
        assert tracing.self_seconds(sp) >= 0, sp
    stats = scheme.compile_stats()
    (fuse,) = tracing.spans("scheme.fuse")
    (neg,) = tracing.spans("scheme.negotiate")
    assert stats["fuse_s"] == fuse.seconds
    assert stats["fuse_compiles"] == fuse.attrs["compiles"] >= 0
    assert stats["negotiate_compiles"] == neg.attrs["compiles"] >= 1
    assert sim.compile_seconds == comp.seconds


def test_tracing_off_keeps_no_hot_span_and_enters_no_record_function(
        plans, recorder, monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for mode in ("sparse", "dense"):
        sim = _sim(plans, mode)
        call = sim.prepare(slice_batch=1, device="cpu")
        call()
        assert call.stats["run_s"] > 0
    names = {sp.name for sp in tracing.spans()}
    assert names == SETUP and not names & HOT
    tracing.enable()
    with pytest.raises(AssertionError, match="record_function"):
        with tracing.span("prepare"):
            pass


def test_rings_stay_bounded(recorder):
    tracing.enable()
    for _ in range(tracing.HOT_RING + 7):
        with tracing.hot("step", index=0, kind="dot"):
            pass
    for _ in range(tracing.SETUP_RING + 3):
        with tracing.span("prepare"):
            pass
    assert len(tracing.spans("step")) == tracing.HOT_RING
    assert len(tracing.spans("prepare")) == tracing.SETUP_RING
    tracing.disable()
    assert tracing.hot("step") is tracing.NULL
    with tracing.timed("runner.call") as sp:
        pass
    assert sp.seconds >= 0 and len(tracing.spans("runner.call")) == 0


def test_counters_and_notes(recorder):
    tracing.count("runner.recaptures")
    tracing.count("runner.recaptures", 2)
    assert tracing.counters() == {"runner.recaptures": 3}
    with tracing.span("prepare") as sp:
        tracing.note(form="mma")        # off: noted nowhere
    assert sp.attrs == {}
    tracing.enable()
    with tracing.hot("step") as sp:
        tracing.note(form="mma")
    assert sp.attrs == {"form": "mma"}
    tracing.reset()
    assert tracing.counters() == {} and tracing.spans() == []


@pytest.mark.parametrize("traced", [False, True])
def test_runner_stats_equal_their_spans(plans, recorder, traced):
    sim = _sim(plans, "sparse")
    call = sim.prepare(slice_batch=2, device="cpu")
    tracing.enable(traced)
    call()
    st = call.stats
    assert st["capture_s"] == sum(
        sp.seconds for sp in tracing.spans("runner.capture")) == 0.0
    runs = tracing.spans("runner.call")
    if traced:
        (run,) = runs
        assert st["run_s"] == run.seconds
        ids, groups = tracing.children(run, "runner.ids"), \
            tracing.children(run, "runner.group")
        assert len(ids) == 1 and len(groups) == 2 ** len(
            sim.slicing_bonds) // 2
    else:
        assert runs == [] and st["run_s"] > 0


def test_profiled_contraction_names_the_program_phases(plans, recorder,
                                                       tmp_path):
    sim = _sim(plans, "sparse")
    sim.contraction(slice_batch=2, device="cpu", profile_dir=str(tmp_path))
    assert not tracing.enabled()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"contraction", "runner.call", "runner.group", "step"} <= names
    (whole,) = tracing.spans("contraction")
    assert whole.seconds > 0


@pytest.mark.gpu
def test_capture_and_run_seconds_are_their_spans_on_the_card(plans,
                                                             recorder):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    sim = _sim(plans, "sparse")
    call = sim.prepare(slice_batch=2, device="cuda")
    tracing.enable()
    call()
    caps = tracing.spans("runner.capture")
    assert caps and call.stats["capture_s"] == sum(sp.seconds for sp in caps)
    assert {sp.name for sp in tracing.children(caps[0])} == \
        {"runner.warmup", "runner.graph"}
    (first,) = tracing.spans("runner.call")
    assert call.stats["run_s"] == pytest.approx(
        first.seconds - call.stats["capture_s"])
    tracing.reset()
    call()
    (run,) = tracing.spans("runner.call")
    assert call.stats["run_s"] == run.seconds
    groups = 2 ** len(sim.slicing_bonds) // 2
    assert [sp.name for sp in tracing.children(run)] == (
        ["runner.ids", "runner.key", "runner.reset"]
        + ["runner.ids", "runner.replay"] * groups
        + ["runner.clone", "runner.sync"])
    assert tracing.spans("step") == []      # no host code a step
