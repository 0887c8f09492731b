"""Device time put down to the program's compiled steps under graph replay.

Under CUDA-graph replay no host code runs a step, so the profiled window
sees the steps' kernels and not the steps.  The program names its phases
itself (``artensor_tpu_torch.runtime.tracing``): with its tracing
enabled every span enters ``torch.profiler.record_function``, and the
profiler links each device operation to the innermost host range open
where it was launched.  This pass, made once after a traced window:

1. frees the harness's runner (``run.call``) and runs eager calls of one
   group at the cell's width (``run.make_call(eager=True)``: the Python
   code the graphs captured; over a share, the share's ids) under the
   profiler: the step map, the second call's device operations in order,
   each put down to the ``step`` span that launched it (its index, kind
   and form) or else to the runner (slice selection, width reduction,
   accumulation);
2. frees that runner, builds a graph runner of the same width and
   profiles ``CALLS`` calls of it, after one more that is dropped (the
   first call of a profile may lose an operation): the operations
   launched from a ``runner.replay`` span are the graph's, and the i-th
   of each replay is put down to the i-th of the map, where the names
   agree operation for operation (else the attribution is refused); the
   others belong to the runner's host path (ids, reset, clone).  The
   kernels' own launch counts by form (``kernels.device_runs``) over the
   calls must equal the trace's, and each idle gap is named by the
   innermost program span around its middle.

``of(run)`` makes the pass for a ``session.Run`` whose window was traced
on a card, keeps its result on the run (``run.progtrace``) and prints its
breakdown on standard error; it returns None, with the reason printed,
where the program has no recorder or the attribution is refused.  It adds
no batch to ``run.outputs`` and leaves ``run.last`` alone, so the
comparison reads the window's outputs only.  ``setup_seconds`` reads the
program's set-up spans.
"""

import gc
import json
import re
import sys
import time
from bisect import bisect_right
from collections import defaultdict, namedtuple

from tnbench.devtrace import COPIES, family, gaps, union_seconds

CALLS = 3           # graph calls profiled; a cell's call is one group
TOP = 10
RUNNER = "runner"
# kernel-name substrings -> ``kernels.RUN_SLOTS`` slot, first match wins
# ("gk_stream_kernel" lies inside "ggk_stream_kernel")
SLOTS = (("ggk_stream_kernel", ("ggk", "stream")),
         ("ggk_wgmma_kernel", ("ggk", "mma")),
         ("gk_stream_kernel", ("gk", "stream")),
         ("gk_wgmma_kernel", ("gk", "mma")),
         ("pair_wgmma_kernel", ("pair", None)),
         ("cmm_wgmma_kernel", ("complex_mm", None)),
         ("rgrow_kernel", ("rgrow", None)),
         ("rgflat_kernel", ("rgflat", None)),
         ("lane_kernel", ("lane", None)))

API = re.compile(r"^cu(da)?[A-Z]")     # cudaLaunchKernel, cuLaunchKernel, ...
Host = namedtuple("Host", "id name start end thread")
Dev = namedtuple("Dev", "name start end linked corr", defaults=(0,))


class Refused(Exception):
    """The attribution does not hold; the message says why."""


def slot(name):
    for key, s in SLOTS:
        if key in name:
            return s
    return None


# -- reading a profile ---------------------------------------------------------

def profile_events(prof, program):
    """``(host, dev)`` of a finished ``torch.profiler``: every host event
    (``Host``, times in ns: the host's operations and annotations, keyed
    by their ids, and the CUDA API calls, keyed by CUPTI's
    correlation ids) and every device operation (``Dev``: ``corr`` is the
    API call that launched it, ``linked`` the host operation or
    annotation open around that call).  A device range that mirrors a
    host annotation (a name in ``program``) is no operation."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        else:
            a = 1000 * e.start_us()
            b = a + 1000 * e.duration_us()
        if e.device_type() == cuda:
            ann = getattr(e, "is_user_annotation", lambda: False)()
            if not ann and e.name() not in program and b > a:
                dev.append(Dev(e.name(), a, b, e.linked_correlation_id(),
                               e.correlation_id()))
        else:
            host.append(Host(e.correlation_id(), e.name(), a, b,
                             e.start_thread_id()))
    return host, dev


def program_stacks(host, program):
    """``stack(d)``: the program spans open on the host where the device
    operation ``d`` was launched, outermost first, each ``(name, n)`` (the
    n-th span of that name, in start order), or None where the profile
    does not link it.  The launching API call (by CUPTI's
    correlation id) is read first; else the host operation or annotation
    the profiler linked (a graph's kernels carry the graph launch's
    call)."""
    order = sorted(host, key=lambda h: (h.start, -h.end))
    seen, by_id, by_api, open_ = defaultdict(int), {}, {}, defaultdict(list)
    for h in order:
        stack = open_[h.thread]
        while stack and stack[-1][1] < h.start:
            stack.pop()
        if h.name in program:
            stack.append(((h.name, seen[h.name]), h.end))
            seen[h.name] += 1
        (by_api if API.match(h.name) else by_id)[h.id] = \
            tuple(s for s, _ in stack)

    def stack(d):
        st = by_api.get(d.corr) if d.corr else None
        return by_id.get(d.linked) if st is None else st
    return stack


def spans_of(host, program):
    """The program's host ranges ``[(start, end, name, n)]``."""
    seen, out = defaultdict(int), []
    for h in sorted(host, key=lambda h: (h.start, -h.end)):
        if h.name in program:
            out.append((h.start, h.end, h.name, seen[h.name]))
            seen[h.name] += 1
    return out


def innermost(ranges, t):
    """The innermost ``(name, n)`` of ``spans_of``'s ranges around ``t``,
    or None."""
    best = None
    for a, b, name, n in ranges[:bisect_right(ranges, (t, float("inf")))]:
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, (name, n))
    return None if best is None else best[1]


def ops_in(dev, stack, span):
    """The device operations launched under the program span ``span``
    (``(name, n)``), in device order, each with its stack."""
    out = []
    for d in dev:
        st = stack(d)
        if st is not None and span in st:
            out.append((d, st))
    out.sort(key=lambda t: t[0].start)
    return out


# -- the attribution ------------------------------------------------------------

def step_map(host, dev, program, steps, group=0):
    """The device operations ``[(name, owner)]`` of the ``group``-th eager
    group of the profile: owner is the ``steps[n]`` attributes of the n-th
    ``step`` span it was launched under, else ``RUNNER``.  ``steps``: the
    recorder's step spans of the profiled calls, in start order (one
    ``step`` range each in ``host``)."""
    stack = program_stacks(host, program)
    n_steps = sum(1 for h in host if h.name == "step")
    if n_steps != len(steps):
        raise Refused(f"{n_steps} step ranges in the profile, "
                      f"{len(steps)} step spans recorded")
    out = []
    for d, st in ops_in(dev, stack, ("runner.group", group)):
        inner = st[-1]
        out.append((d.name, dict(steps[inner[1]]) if inner[0] == "step"
                    else RUNNER))
    if not out:
        raise Refused("the eager group launched nothing the profile links "
                      "to it")
    return out


def attribute(smap, host, dev, program, calls):
    """Every device operation of the profiled calls put down to an owner:
    ``[(Dev, owner, where)]`` in device order, owner a step's attributes,
    ``RUNNER`` (the graph's own work outside the steps, or the call's host
    path) or None (launched outside the runner's call); ``where``: the
    runner's span it was launched under.  Raises ``Refused`` where a
    replay's operations differ from the map."""
    stack = program_stacks(host, program)
    names = [n for n, _ in smap]
    replays = sorted({s for d in dev for s in (stack(d) or ())
                      if s[0] == "runner.replay"})
    if len(replays) < calls:
        raise Refused(f"{len(replays)} replays linked in the profile of "
                      f"{calls} calls")
    out, placed = [], set()
    for r in replays:
        ops = ops_in(dev, stack, r)
        got = [d.name for d, _ in ops]
        if got != names:
            i = next((i for i, (a, b) in enumerate(zip(got, names))
                      if a != b), min(len(got), len(names)))
            raise Refused(
                f"replay {r[1]}: {len(got)} operations against the map's "
                f"{len(names)}; first difference at {i}: "
                f"{got[i][:80] if i < len(got) else None!r} against "
                f"{names[i][:80] if i < len(names) else None!r}")
        for (d, _), (_, owner) in zip(ops, smap):
            out.append((d, owner, "runner.replay"))
            placed.add(id(d))
    for d in dev:
        if id(d) in placed:
            continue
        st = stack(d) or ()
        runner = [s for s in st if s[0].startswith("runner.")]
        out.append((d, RUNNER if runner else None,
                    runner[-1][0] if runner else None))
    out.sort(key=lambda t: t[0].start)
    return out


def after_first_call(host, dev):
    """The device operations that start after the host entered the
    profile's second ``runner.call``: the first call of a profile is run
    and dropped, since the profiler may lose an operation of it."""
    calls = sorted(h.start for h in host if h.name == "runner.call")
    if len(calls) < 2:
        raise Refused(f"{len(calls)} runner calls in the profile")
    return [d for d in dev if d.start >= calls[1]]


def counts_by_slot(dev):
    out = defaultdict(int)
    for d in dev:
        s = slot(d.name)
        if s is not None:
            out[s] += 1
    return dict(out)


def summarize(owned, host, program, calls):
    """The per-batch breakdown of ``attribute``'s result over ``calls``
    calls (one batch each)."""
    ms = lambda ns: 1e-6 * ns / calls
    total = sum(d.end - d.start for d, _, _ in owned)
    covered = sum(d.end - d.start for d, o, _ in owned if o is not None)
    steps, copies = {}, defaultdict(float)
    runner_ops = defaultdict(float)
    for d, owner, where in owned:
        dt = d.end - d.start
        copy = family(d.name) in COPIES
        if isinstance(owner, dict):
            key = owner["index"]
            s = steps.setdefault(key, dict(index=key, kind=owner["kind"],
                                           form=owner.get("form"),
                                           ms=0.0, copy_ms=0.0))
            s["ms"] += ms(dt)
            if copy:
                s["copy_ms"] += ms(dt)
                copies["dot" if owner["kind"] == "dot" else "kernel"] += \
                    ms(dt)
        elif owner == RUNNER:
            runner_ops[where if where != "runner.replay"
                       else "in the graph"] += ms(dt)
            if copy:
                copies["runner"] += ms(dt)
    ranges = spans_of(host, program)
    idle = []
    for a, b in gaps([(d.start, d.end) for d, _, _ in owned]):
        inner = innermost(ranges, 0.5 * (a + b))
        idle.append((inner[0] if inner else "host (unmarked)",
                     inner is not None and any(
                         r[2] == "runner.call" and r[0] <= 0.5 * (a + b)
                         <= r[1] for r in ranges), b - a))
    by_kind = defaultdict(float)
    for s in steps.values():
        by_kind[s["kind"] + (f" {s['form']}" if s["form"] else "")] += \
            s["ms"]
    idle_by = defaultdict(float)
    for name, _, dt in idle:
        idle_by[name] += ms(dt)
    return dict(
        calls=calls, busy_ms=ms(union_seconds(
            [(d.start, d.end) for d, _, _ in owned])),
        coverage=covered / total if total else 0.0,
        steps=len(steps),
        top_steps=sorted(steps.values(), key=lambda s: -s["ms"])[:TOP],
        by_kind_ms=dict(by_kind), runner_ms=dict(runner_ops),
        kernel_copy_ms=copies["kernel"], dot_copy_ms=copies["dot"],
        runner_copy_ms=copies["runner"],
        runner_idle_ms=sum(ms(dt) for _, inside, dt in idle if inside),
        idle_ms=dict(idle_by),
        idle_gaps=[[n, 1e-6 * dt] for n, _, dt in
                   sorted(idle, key=lambda g: -g[2])[:TOP]])


# -- the pass on a card ---------------------------------------------------------

def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    return prof


def _names(tracing, mark):
    return {s.name for s in tracing.spans() if s.start >= mark}


def run_pass(run, tracing, calls=CALLS):
    """The pass on ``run``'s simulation (see the module's text); returns
    ``summarize``'s breakdown, with the check of the launch counts."""
    import torch

    from artensor_tpu_torch import kernels

    run.call = None          # the harness's runner and its graphs go first
    gc.collect()
    torch.cuda.empty_cache()
    prev = tracing.enable()
    try:
        eager = run.make_call(eager=True)
        eager()                                  # warm: handles, tables
        torch.cuda.synchronize()
        mark = time.perf_counter_ns()
        prof = _profiled(lambda: (eager(), eager()))
        steps = [s.attrs for s in tracing.spans("step") if s.start >= mark]
        program = _names(tracing, mark)
        host, dev = profile_events(prof, program)
        groups = sum(h.name == "runner.group" for h in host)
        # the map: the second call's first group (see after_first_call)
        smap = step_map(host, dev, program, steps, group=groups // 2)
        del eager, prof
        gc.collect()
        torch.cuda.empty_cache()

        tracing.disable()
        graph = run.make_call()
        graph()                                  # captures
        graph()
        torch.cuda.synchronize()
        tracing.enable()
        mark = time.perf_counter_ns()
        counted = []

        def replays():
            graph()                 # dropped (after_first_call)
            counted.append(kernels.device_runs())
            for _ in range(calls):
                graph()
        prof = _profiled(replays)
        after = kernels.device_runs()
        before = counted[0]
        program = _names(tracing, mark)
        host, dev = profile_events(prof, program)
        dev = after_first_call(host, dev)
        del graph, prof
    finally:
        tracing.enable(prev)
        gc.collect()
        torch.cuda.empty_cache()
    owned = attribute(smap, host, dev, program, calls)
    runs = {s: after[s] - before[s] for s in after if after[s] != before[s]}
    traced = counts_by_slot(dev)
    if runs != traced:
        raise Refused(f"launches by form: the kernels counted {runs}, the "
                      f"trace holds {traced}")
    out = summarize(owned, host, program, calls)
    out["map_ops"] = len(smap)
    out["launches"] = {f"{k}.{f}" if f else k: n
                       for (k, f), n in sorted(runs.items(),
                                               key=lambda t: str(t[0]))}
    return out


def _tracing():
    try:
        from artensor_tpu_torch.runtime import tracing
    except ImportError:
        return None
    return tracing


def of(run):
    """The pass's result for ``run`` (made on the first call), or None."""
    if hasattr(run, "progtrace"):
        return run.progtrace
    run.progtrace = None
    if run.device != "cuda" or run.trace is None:
        return None
    tracing = _tracing()
    if tracing is None:
        print("tnbench progtrace: the program has no span recorder",
              file=sys.stderr)
        return None
    t0 = time.perf_counter()
    try:
        out = run_pass(run, tracing)
    except Refused as e:
        print(f"tnbench progtrace: attribution refused: {e}",
              file=sys.stderr)
        return None
    out["pass_s"] = time.perf_counter() - t0
    print("tnbench progtrace " + json.dumps(out), file=sys.stderr,
          flush=True)
    run.progtrace = out
    return out


def read(run, key):
    out = of(run)
    return None if out is None else out[key]


def setup_seconds(run, root, names):
    """Seconds of the program's set-up spans ``names`` under the first
    ``root`` span of the process (the harness's), on a card; None where
    the program keeps no such span."""
    if run.device != "cuda":
        return None
    tracing = _tracing()
    if tracing is None:
        return None
    roots = tracing.spans(root)
    if not roots:
        return None
    total, todo = 0.0, [roots[0]]
    while todo:
        for sp in tracing.children(todo.pop()):
            if sp.name in names:
                total += sp.seconds
            todo.append(sp)
    return total
