"""The step map and the attribution of replayed device operations
(``progtrace.py``) on synthetic event lists; the readers of the program's
spans; and, on a card, the pass over a small sliced circuit."""

from types import SimpleNamespace

import pytest

from tnbench import manifest, progtrace
from tnbench.progtrace import RUNNER, Dev, Host, Refused

PROGRAM = {"runner.call", "runner.key", "runner.ids", "runner.reset",
           "runner.group", "runner.replay", "runner.clone", "runner.sync",
           "step"}
STEPS = [{"index": 0, "kind": "dot"}, {"index": 1, "kind": "gk",
                                       "form": "mma"}]
GK = "void gk_wgmma_kernel<64, 3, true>(wg::Operands)"
# the group's operations in order: slice select, step 0 (a permute, a
# matrix product), step 1 (GK's reorder, the kernel), the accumulation
GROUP = ["index_kernel", "copy_kernel", "gemm_kernel", "copy_kernel", GK,
         "add_kernel"]


def eager_events():
    """One eager call: reset, one group of two steps, synchronize.  The GK
    kernel is launched by the step span itself (no operator around it)."""
    host = [Host(1, "runner.call", 0, 1000, 7),
            Host(2, "runner.reset", 10, 20, 7),
            Host(3, "aten::fill_", 11, 12, 7),
            Host(4, "runner.group", 30, 900, 7),
            Host(5, "aten::index", 31, 35, 7),
            Host(6, "step", 40, 200, 7),
            Host(7, "aten::copy_", 41, 50, 7),
            Host(8, "aten::mm", 60, 70, 7),
            Host(9, "step", 210, 400, 7),
            Host(10, "aten::copy_", 220, 230, 7),
            Host(11, "aten::add_", 500, 510, 7),
            Host(12, "runner.sync", 910, 990, 7),
            Host(12345, "aten::empty", 5, 6, 9)]   # another thread
    links = [3, 5, 7, 8, 10, 9, 11]
    names = ["fill_kernel"] + GROUP
    dev = [Dev(n, 1000 + 100 * i, 1090 + 100 * i, link)
           for i, (n, link) in enumerate(zip(names, links))]
    return host, dev


def replay_events(calls=2, names=None):
    """``calls`` graph calls, 1000 apart: reset (a fill), ids (a copy),
    the replay (the group's operations, all linked to the replay's range),
    the clone; an operation every 50 (100 after the ids), 18 long (GK's
    40), the host in runner.sync from 90 to 690 of each call."""
    host, dev, hid, t = [], [], 100, 0
    names = names or [GROUP] * calls
    for c in range(calls):
        base = hid
        spans = [("runner.call", 0, 700), ("runner.key", 5, 8),
                 ("runner.reset", 10, 20), ("runner.ids", 30, 40),
                 ("runner.replay", 50, 60), ("runner.clone", 70, 80),
                 ("runner.sync", 90, 690)]
        for k, (n, a, b) in enumerate(spans):
            host.append(Host(base + k, n, t + a, t + b, 7))
        host += [Host(base + 7, "aten::fill_", t + 11, t + 12, 7),
                 Host(base + 8, "aten::copy_", t + 31, t + 32, 7),
                 Host(base + 9, "aten::clone", t + 71, t + 72, 7)]
        ops = [("fill_kernel", base + 7), ("copy_kernel", base + 8)] + \
            [(n, base + 4) for n in names[c]] + [("copy_kernel", base + 9)]
        d0 = t + 100
        for i, (n, link) in enumerate(ops):
            start = d0 + 50 * i + (50 if i >= 2 else 0)
            dev.append(Dev(n, start, start + (40 if n == GK else 18), link))
        hid += 10
        t += 1000
    return host, dev


def test_step_map_puts_each_operation_to_its_step():
    host, dev = eager_events()
    smap = progtrace.step_map(host, dev, PROGRAM, STEPS)
    assert [n for n, _ in smap] == GROUP
    assert [o if o == RUNNER else o["index"] for _, o in smap] == \
        [RUNNER, 0, 0, 1, 1, RUNNER]
    assert smap[4][1] == STEPS[1]


def test_step_map_refuses_a_count_mismatch():
    host, dev = eager_events()
    with pytest.raises(Refused, match="step ranges"):
        progtrace.step_map(host, dev, PROGRAM, STEPS[:1])


def test_replays_assigned_kernel_for_kernel():
    smap = progtrace.step_map(*eager_events(), PROGRAM, STEPS)
    host, dev = replay_events()
    owned = progtrace.attribute(smap, host, dev, PROGRAM, 2)
    assert len(owned) == len(dev)
    graph = [(d.name, o) for d, o, w in owned if w == "runner.replay"]
    assert graph == smap * 2
    outside = {w for _, o, w in owned if w != "runner.replay"}
    assert outside == {"runner.reset", "runner.ids", "runner.clone"}
    out = progtrace.summarize(owned, host, PROGRAM, 2)
    assert out["coverage"] == 1.0 and out["steps"] == 2
    ms = 1e-6 * 18
    assert out["busy_ms"] == pytest.approx(1e-6 * (8 * 18 + 40))
    assert out["dot_copy_ms"] == pytest.approx(ms)
    assert out["kernel_copy_ms"] == pytest.approx(ms)
    assert out["runner_copy_ms"] == pytest.approx(2 * ms)   # ids, clone
    assert out["top_steps"][0]["index"] == 1
    assert out["top_steps"][0]["form"] == "mma"
    assert out["by_kind_ms"] == {"dot": pytest.approx(2 * ms),
                                 "gk mma": pytest.approx(1e-6 * 58)}


def test_a_name_mismatch_refuses_the_attribution():
    smap = progtrace.step_map(*eager_events(), PROGRAM, STEPS)
    other = list(GROUP)
    other[2] = "gemm_kernel_splitk"
    host, dev = replay_events(names=[GROUP, other])
    with pytest.raises(Refused, match="replay 1: .* first difference at 2"):
        progtrace.attribute(smap, host, dev, PROGRAM, 2)
    host, dev = replay_events(names=[GROUP, GROUP[:-1]])
    with pytest.raises(Refused, match="5 operations against the map's 6"):
        progtrace.attribute(smap, host, dev, PROGRAM, 2)


def test_graph_operations_linked_through_their_launch_call():
    """Operations linked to no host operation are found by the API call
    that launched them (a graph's kernels: the graph launch's call)."""
    smap = progtrace.step_map(*eager_events(), PROGRAM, STEPS)
    host, dev = replay_events()
    replay = {h.id: h for h in host if h.name == "runner.replay"}
    launches, ops = [], []
    for d in dev:
        h = replay.get(d.linked)
        if h is not None:     # one launch call an operation, for the test
            launches.append(Host(9000 + len(launches), "cudaGraphLaunch",
                                 h.start + 1, h.start + 2, 7))
            d = d._replace(linked=0, corr=launches[-1].id)
        ops.append(d)
    owned = progtrace.attribute(smap, host + launches, ops, PROGRAM, 2)
    graph = [(d.name, o) for d, o, w in owned if w == "runner.replay"]
    assert graph == smap * 2


def test_the_first_call_of_a_profile_is_dropped():
    host, dev = replay_events(calls=3)
    kept = progtrace.after_first_call(host, dev)
    assert kept == [d for d in dev if d.start >= 1000]
    assert len(kept) == 2 * len(dev) // 3
    with pytest.raises(Refused, match="1 runner calls"):
        progtrace.after_first_call(host[:10], dev)


def test_gaps_named_by_the_innermost_span():
    smap = progtrace.step_map(*eager_events(), PROGRAM, STEPS)
    host, dev = replay_events()
    owned = progtrace.attribute(smap, host, dev, PROGRAM, 2)
    ranges = progtrace.spans_of(host, PROGRAM)
    assert progtrace.innermost(ranges, 55) == ("runner.replay", 0)
    assert progtrace.innermost(ranges, 1055) == ("runner.replay", 1)
    assert progtrace.innermost(ranges, 500) == ("runner.sync", 0)
    assert progtrace.innermost(ranges, 695) == ("runner.call", 0)
    assert progtrace.innermost(ranges, 950) is None
    out = progtrace.summarize(owned, host, PROGRAM, 2)
    # inside a call every gap lies where the host waits in runner.sync:
    # 32 after each 18-long operation, 82 after the ids, 10 after GK; the
    # one between the calls lies outside them
    inside = 32 * 6 + 82 + 10
    between = 1000 + 100 - (100 + 50 * 8 + 50 + 18)   # the clone's end
    assert out["runner_idle_ms"] == pytest.approx(1e-6 * inside)
    assert out["idle_ms"] == {
        "runner.sync": pytest.approx(1e-6 * inside),
        "host (unmarked)": pytest.approx(1e-6 * between / 2)}
    assert out["idle_gaps"][0] == ["host (unmarked)",
                                   pytest.approx(1e-6 * between)]


def test_counts_by_slot():
    dev = [Dev("void ggk_stream_kernel<4, true, 1>(...)", 0, 1, 0),
           Dev("void gk_stream_kernel<8, false>(...)", 2, 3, 0),
           Dev(GK, 4, 5, 0), Dev("copy_kernel", 6, 7, 0)]
    assert progtrace.counts_by_slot(dev) == {("ggk", "stream"): 1,
                                             ("gk", "stream"): 1,
                                             ("gk", "mma"): 1}


def test_set_up_readers_read_the_programs_spans():
    from artensor_tpu_torch.runtime import tracing

    tracing.reset()
    try:
        with tracing.span("load_plan"):
            with tracing.span("scheme.compile"):
                with tracing.span("scheme.fuse") as fuse:
                    pass
                with tracing.span("scheme.negotiate") as neg:
                    pass
        with tracing.span("load_plan"):   # a later compile: not read
            with tracing.span("scheme.compile"):
                with tracing.span("scheme.fuse"):
                    pass
        with tracing.span("prepare"):
            with tracing.span("prepare.fold") as fold:
                pass
            with tracing.span("prepare.stage") as stage:
                pass
        card = SimpleNamespace(device="cuda")
        got = {m: manifest.reader(m)(card)
               for m in ("fuse_s", "negotiate_s", "stage_s")}
        assert got == {"fuse_s": fuse.seconds, "negotiate_s": neg.seconds,
                       "stage_s": fold.seconds + stage.seconds}
        assert got["fuse_s"] + got["negotiate_s"] <= sum(
            s.seconds for s in tracing.spans("load_plan")[:1])
        cpu = SimpleNamespace(device="cpu")
        assert manifest.reader("fuse_s")(cpu) is None
    finally:
        tracing.reset()


def test_readers_return_none_without_the_recorder(monkeypatch, capsys):
    monkeypatch.setattr(progtrace, "_tracing", lambda: None)
    card = SimpleNamespace(device="cuda", trace={"batches": 1})
    for m in ("fuse_s", "negotiate_s", "stage_s", "runner_idle_ms",
              "kernel_copy_ms", "dot_copy_ms"):
        assert manifest.reader(m)(card) is None
    assert "no span recorder" in capsys.readouterr().err


def test_a_refused_pass_reads_none_and_says_why(monkeypatch, capsys):
    def refuse(run, tracing):
        raise Refused("replay 0: names differ")

    monkeypatch.setattr(progtrace, "run_pass", refuse)
    card = SimpleNamespace(device="cuda", trace={"batches": 1})
    assert manifest.reader("kernel_copy_ms")(card) is None
    assert manifest.reader("dot_copy_ms")(card) is None    # made once
    err = capsys.readouterr().err
    assert err.count("attribution refused: replay 0: names differ") == 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["small-sparse", "small-dense"])
def test_attribution_covers_a_replay_on_the_card(mini, card, monkeypatch,
                                                 name):
    """With GK's size gate lowered the small circuits run kernel steps;
    the pass holds the kernels' own launch counts by form to the trace's
    (else it refuses) and puts at least 99% of the device time down to a
    step or to the runner."""
    from artensor_tpu_torch.runtime import gatherk
    from tnbench.session import Run

    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1 << 8)
    cell = manifest.cell(name, root=str(mini), here=str(mini / "tnbench"))
    r = Run(cell, 2 ** 31 + 17, "cuda")
    r.setup()
    r.window(0.5, trace=True)
    n = len(r.outputs)
    out = progtrace.of(r)
    assert out is not None
    assert out["coverage"] >= 0.99
    assert out["steps"] >= 1 and out["map_ops"] >= out["steps"]
    assert len(r.outputs) == n and r.call is None
    r.release()
    assert r.check(cell.limits)[0] is True
