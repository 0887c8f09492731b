"""Where the port's main path spends its time on the card.

Runs the n30 m14 sliced contraction of a committed plan (one of the
workloads of ``card_paths.py``, by ``--workload``: the sparse ``1k``,
``10k`` or ``1k-sc25``, or ``dense``, the whole 2^30-amplitude state; or
``1k-planned``, the 1k batch planned by the port as
``quantum_circuit_simulation(..., sc_target=24)`` plans it, under
``PYTHONHASHSEED=0`` (the planner's plans depend on the string hash
seed): the script re-executes itself so; its
scheme in ``--form``: "default", what ``load_plan`` compiles, or "off",
``contraction_scheme_sparse(..., fuse=False, negotiate=False)`` or
``scheme.contraction_scheme(..., fuse=False, negotiate=False)``) at
``--slice-batch`` (default: the width
``metrics.dividing_slice_width`` picks for the scheme) once to warm up,
then:

1. one eager run (every step from the host) under ``torch.profiler``
   with the program's tracing on: each device operation is put down to
   the ``step`` span it was launched under (``tnbench/progtrace.py``
   reads the profiler's links) and summed by the step's kind (``dot`` =
   the matmul fallback ``apply_lowered``) and form; a step's time
   includes its glue (reorders, W preparation, gathers), not the gaps
   between its kernels; the rest of the run is slice selection and
   accumulation;
2. the warm wall (median of 3) and one run under ``torch.profiler`` as
   ``contraction()`` runs on the card, one slice group captured as a CUDA
   graph and replayed (``--eager``: every step from the host, as the port
   ran before graph capture): device time by kernel family, and the
   device's busy share of the span from its first to its last kernel and
   the largest gaps between kernels (the host holding the card back).

With ``--ab-rgflat`` it instead times the whole run (warm wall, median of
3 after one warm-up) with and without the RGFlat row form of aligned
steps (without it they run gathered chunks + dot + concat), in the order
on, off, off, on, and checks that both give the same amplitudes;
``--no-rgflat`` profiles the run without it.

Usage, from the repo root on a machine with a CUDA card::

    python3 scripts/profile_torch_port.py [--slice-batch W] \
        [--workload 1k|10k|1k-sc25|dense|1k-planned] [--form off|default] \
        [--ab-rgflat | --no-rgflat] [--eager] [--root DIR]

``--root`` imports ``artensor_tpu_torch`` from another checkout (for
example the parent commit unpacked by ``git archive`` into a git-ignored
directory), to profile it with this script's families.
"""

import argparse
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
DATA = os.path.join(ROOT, "artensor_tpu_torch", "data")
WORKLOADS = {   # name: (plan, amplitude fixture)
    "1k": ("rcs_n30_m14_s0_sparse_sc24.json", "rcs_n30_m14_s0_amps1000.txt"),
    "10k": ("rcs_n30_m14_s0_sparse10k_sc24.json",
            "rcs_n30_m14_s0_amps10000.txt"),
    "1k-sc25": ("rcs_n30_m14_s0_sparse_sc25.json",
                "rcs_n30_m14_s0_amps1000.txt"),
    "dense": ("rcs_n30_m14_s0_dense_sc30.json", None),
    "1k-planned": (None, "rcs_n30_m14_s0_amps1000.txt"),
}
PLANNED_SC = 24          # the planned 1k path's sc_target
PLAN_HASH_SEED = "0"     # the hash seed the 1k batch is planned under

FAMILIES = (   # (family, substrings of the kernel name), first match wins
    ("gatherk.cu (GGK stream)", ("ggk_stream_kernel",)),
    # GGK's mma form: on wgmma, or (a checkout before it, --root) on
    # mma.sync
    ("gatherk.cu (GGK mma)", ("ggk_wgmma_kernel", "ggk_mma_kernel")),
    ("gatherk.cu (GK stream)", ("gk_stream_kernel",)),
    # GK's mma form and Pair: on wgmma, or (an older checkout's, --root)
    # on mma.sync
    ("gatherk.cu (GK mma)", ("gk_wgmma_kernel", "gk_mma_kernel")),
    ("pair.cu (Pair)", ("pair_wgmma_kernel", "pair_mma_kernel<false")),
    ("pair.cu (complex matmul)", ("cmm_wgmma_kernel", "cmm_kernel",
                                  "pair_mma_kernel<true")),
    ("rgrow.cu (RGRow)", ("rgrow_kernel",)),
    ("rgflat.cu (RGFlat)", ("rgflat_kernel",)),
    ("lane.cu (Lane)", ("lane_kernel",)),
    ("cuBLAS/CUTLASS matmul (dot fallback)",
     ("gemm", "cutlass", "cublas", "Kernel2")),
    ("PyTorch copies/permutes", ("copy", "Copy")),
    ("PyTorch index/gather", ("index", "gather", "Index")),
    ("PyTorch elementwise", ("elementwise", "vectorized")),
    ("PyTorch reductions", ("reduce", "Reduce")),
    ("memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")),
)


def family(name):
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def describe(s):
    """Short shape summary of a step's kernel plan or dot lowering."""
    lane = s.lane
    if lane is None:
        low = s.lowered if s.lowered is not None else s.lowered_chunks[0]
        gathers = getattr(s, "gathers", None)
        return f"dot {low.shape_l} x {low.shape_r}" + (
            f" ({len(gathers)} gathered chunks)" if gathers else "")
    if hasattr(lane, "M"):
        return f"K {lane.K} M {lane.M} N {lane.N}"
    if hasattr(lane, "orient"):
        return (f"{lane.orient} L {lane.L} H {lane.H} T {lane.T} "
                f"F {lane.F} G {len(lane.xoff)}")
    row = getattr(lane, "row", lane)
    extra = f" B {lane.B}" if row is not lane else ""
    return f"K {row.K} H {row.H} F {row.F}{extra}"


def workload(name, form="default"):
    """The workload's simulation, its scheme compiled in ``form``."""
    import json

    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.plan_io import plan_from_dict
    from artensor_tpu_torch.runtime.scheme import contraction_scheme
    from artensor_tpu_torch.runtime.sparse import contraction_scheme_sparse

    plan, fixture = WORKLOADS[name]
    bits = ()
    if fixture:
        with open(os.path.join(DATA, fixture)) as f:
            bits = [ln.split()[0] for ln in f if ln.strip()]
    if plan is None:
        return planned(bits, form)
    sim = TensorNetworkSimulation.from_circuit(
        random_circuit(5, 6, 14, seed=0), bits)
    if form == "default":
        return sim.load_plan(os.path.join(DATA, plan))
    with open(os.path.join(DATA, plan)) as f:
        pd = json.load(f)
    sim.order, sim.slicing_bonds, sim.ctree = plan_from_dict(pd)
    if not fixture:
        sim._set_scheme(*contraction_scheme(sim.ctree, fuse=False,
                                            negotiate=False))
        return sim
    sim.sc_target = float(pd["meta"]["sc_target"])
    sim._set_scheme(*contraction_scheme_sparse(
        sim.ctree, bits, sim.sc_target, fuse=False, negotiate=False))
    return sim


def planned(bits, form):
    """The 1k batch planned and compiled as ``quantum_circuit_simulation``
    does (``tensor_network_contraction``: simplify, ``PlannerConfig`` with
    ``trials`` 8, ``iters`` 50, ``alpha`` 0 at ``PLANNED_SC``), without
    its run."""
    from artensor_tpu_torch import (PlannerConfig, TensorNetworkCircuit,
                                    TensorNetworkSimulation, random_circuit)
    from artensor_tpu_torch.simulation import (NumericalTensorNetwork,
                                               check_bitstrings)

    if form != "default":
        raise SystemExit("1k-planned: only the default form")
    circ = TensorNetworkCircuit(random_circuit(5, 6, 14, seed=0))
    tensors, tensor_bonds, bond_dims, final_qubits = circ.to_numerical_tn()
    pattern, max_bitstrings = check_bitstrings(bits)
    ntn = NumericalTensorNetwork(tensors, tensor_bonds, bond_dims,
                                 final_qubits)
    bonds, final_ids = ntn.simplify(pattern)
    sim = TensorNetworkSimulation(dict(ntn.tensors), bonds, ntn.bond_dims,
                                  final_ids, bits, pattern, max_bitstrings)
    sim.prepare_contraction(PlannerConfig(sc_target=PLANNED_SC, trials=8,
                                          iters=50, alpha=0.0))
    return sim


def model_width(sim):
    """The slice width the wall estimate picks for ``sim``'s scheme."""
    from artensor_tpu_torch.runtime import executor, metrics

    run_steps, _ = executor.precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)
    return metrics.dividing_slice_width(run_steps, len(sim.slicing_bonds),
                                        sim.slicing_axes)


@contextmanager
def rgflat(on):
    """Compile with or without the RGFlat row form of aligned steps (off:
    those steps run gathered chunks, a dot each, and a concat)."""
    from artensor_tpu_torch.runtime import gatherk

    saved = gatherk.plan_rg_flat
    if not on:
        gatherk.plan_rg_flat = lambda *a: gatherk._rej("rgf:off")
    try:
        yield
    finally:
        gatherk.plan_rg_flat = saved


def ab(slice_batch, name, form):
    """Warm wall of the whole run with the RGFlat form on and off, in the
    order on, off, off, on; both sides must give the same amplitudes."""
    import numpy as np
    import torch

    from artensor_tpu_torch.runtime import sparse

    walls, amps = {True: [], False: []}, {}
    for on in (True, False, False, True):
        with rgflat(on):
            sim = workload(name, form)
        slice_batch = slice_batch or model_width(sim)
        kinds = [sparse.kernel_kind(s) or "dot" for s in sim.steps]
        run = sim.prepare(slice_batch=slice_batch, device="cuda")
        run()
        torch.cuda.synchronize()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = run()
            out[0].sum().item()
            ts.append(time.perf_counter() - t0)
        walls[on].append(sorted(ts)[1])
        a = sim.contraction(slice_batch=slice_batch, device="cuda")
        amps[on] = dict(zip(sim.bitstrings_sorted, a))
        census = {k: kinds.count(k) for k in sorted(set(kinds))}
        print(f"rgflat {'on ' if on else 'off'}: steps {census}; warm wall "
              f"median of 3 {1e3 * walls[on][-1]:.2f} ms "
              f"({['%.2f' % (1e3 * t) for t in ts]})", flush=True)
        del run, sim
        torch.cuda.empty_cache()
    ref = np.array(list(amps[False].values()))
    got = np.array([amps[True][b] for b in amps[False]])
    d = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"rgflat A/B: on {['%.2f' % (1e3 * t) for t in walls[True]]} ms,"
          f" off {['%.2f' % (1e3 * t) for t in walls[False]]} ms; amplitudes"
          f" agree to {d:.2e} of max|a|")
    if not d < 1e-4:
        raise SystemExit("rgflat A/B: the two sides disagree")


def step_times(sim, run, tracing):
    """Part 1: the eager run ``run`` profiled with tracing on, its device
    time put down to the steps of ``sim``'s run (by kind, the costliest,
    the aligned ones) and to the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from artensor_tpu_torch.runtime import executor
    from tnbench import progtrace

    run_steps, _ = executor.precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)
    prev = tracing.enable()
    try:
        mark = time.perf_counter_ns()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tracing.enable(prev)
    steps = [s for s in tracing.spans("step") if s.start >= mark]
    program = {s.name for s in tracing.spans() if s.start >= mark}
    host, dev = progtrace.profile_events(prof, program)
    stack = progtrace.program_stacks(host, program)
    by_kind, n_kind, by_step = defaultdict(float), defaultdict(int), \
        defaultdict(float)
    for sp in steps:
        n_kind[sp.attrs["kind"]] += 1
    total = rest = 0.0
    for d in dev:
        ms = 1e-6 * (d.end - d.start)
        total += ms
        inner = [s for s in stack(d) or () if s[0] == "step"]
        if not inner:
            rest += ms
            continue
        a = steps[inner[-1][1]].attrs
        kind = a["kind"] + (f" {a['form']}" if "form" in a else "")
        by_kind[kind] += ms
        by_step[(a["index"], kind)] += ms
    print(f"eager run: {total:.2f} ms of device operations, "
          f"{1e3 * wall:.2f} ms host wall (profiled, tracing on)")
    print("by step kind (device operations under each step's span):")
    for kind, ms in sorted(by_kind.items(), key=lambda t: -t[1]):
        print(f"  {kind:11s} {ms:9.3f} ms  {100 * ms / total:5.1f}%  "
              f"({n_kind[kind.split()[0]]} step runs of the kind)")
    print(f"  {'rest':11s} {rest:9.3f} ms  {100 * rest / total:5.1f}%  "
          "(slice selection, accumulation)")
    print("top steps (all groups of the run):")
    for (i, kind), ms in sorted(by_step.items(), key=lambda t: -t[1])[:12]:
        print(f"  {ms:9.3f} ms  step {i:3d} {kind:11s} "
              f"{describe(run_steps[i])}")
    print("aligned (gathered) steps (all groups of the run):")
    for (i, kind), ms in sorted(by_step.items()):
        desc = describe(run_steps[i])
        if kind.split()[0] in ("ggk", "rgrow", "rgflat") or "gathered" in desc:
            print(f"  {ms:9.3f} ms  step {i:3d} {kind:11s} {desc}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slice-batch", type=int, default=0,
                    help="slices per group (default: the model's width)")
    ap.add_argument("--workload", default="1k", choices=list(WORKLOADS),
                    help="the workload of card_paths.py to profile")
    ap.add_argument("--form", default="default", choices=("off", "default"),
                    help="the scheme's form")
    ap.add_argument("--ab-rgflat", action="store_true",
                    help="time the run with and without the RGFlat form")
    ap.add_argument("--no-rgflat", action="store_true",
                    help="profile the run without the RGFlat form")
    ap.add_argument("--eager", action="store_true",
                    help="profile the eager run (no CUDA graph)")
    ap.add_argument("--root", help="import the port from this checkout")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    if args.workload == "1k-planned" and \
            os.environ.get("PYTHONHASHSEED") != PLAN_HASH_SEED:
        # the planner's plans depend on the string hash seed
        os.execve(sys.executable, [sys.executable, os.path.abspath(__file__),
                                   *sys.argv[1:]],
                  dict(os.environ, PYTHONHASHSEED=PLAN_HASH_SEED))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    from artensor_tpu_torch.runtime import sparse

    if args.ab_rgflat:
        print(f"card: {torch.cuda.get_device_name(0)}; workload "
              f"{args.workload}, form {args.form}", flush=True)
        ab(args.slice_batch, args.workload, args.form)
        return 0
    t0 = time.perf_counter()
    with rgflat(not args.no_rgflat):
        sim = workload(args.workload, args.form)
    compile_s = time.perf_counter() - t0
    args.slice_batch = args.slice_batch or model_width(sim)
    kinds = [sparse.kernel_kind(s) or "dot" for s in sim.steps]
    print(f"card: {torch.cuda.get_device_name(0)}; workload {args.workload},"
          f" form {args.form} (load and compile {compile_s:.2f} s; kernel "
          f"steps {dict((k, kinds.count(k)) for k in sorted(set(kinds)))}),"
          f" slice_batch {args.slice_batch}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    run = sim.prepare(slice_batch=args.slice_batch, device="cuda",
                      eager=True)
    run()
    torch.cuda.synchronize()
    print(f"peak device memory of an eager run: "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)

    # -- 1. per step kind, from the program's step spans ---------------------
    try:
        from artensor_tpu_torch.runtime import tracing
    except ImportError:
        tracing = None
        print("the port has no span recorder: step times not measured")
    if tracing is not None:
        step_times(sim, run, tracing)

    # -- 2. the run as profiled: warm wall, then torch.profiler -------------
    del run
    torch.cuda.empty_cache()
    run = sim.prepare(slice_batch=args.slice_batch, device="cuda",
                      eager=args.eager)
    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()[0].reshape(-1)[0].item()
        walls.append(time.perf_counter() - t0)
    mode = "eager" if args.eager else "graph replay"
    print(f"{mode}: warm wall {sorted(walls)[1]:.4f} s of "
          f"{['%.4f' % w for w in walls]}; runner {run.stats}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        print("profiler: no device events recorded (CUPTI unavailable)")
        return 0
    fam_us = defaultdict(float)
    fam_n = defaultdict(int)
    for e in kern:
        fam_us[family(e.name)] += e.time_range.elapsed_us()
        fam_n[family(e.name)] += 1
    busy = sum(fam_us.values())
    span = max(e.time_range.end for e in kern) \
        - min(e.time_range.start for e in kern)
    print(f"profiler ({mode}): {len(kern)} device events, busy "
          f"{busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms span: idle share "
          f"{100 * (1 - busy / span):.1f}%")
    ranges = sorted((e.time_range.start, e.time_range.end) for e in kern)
    gaps, end = [], ranges[0][1]
    for a, b in ranges[1:]:
        if a > end:
            gaps.append(a - end)
        end = max(end, b)
    gaps.sort(reverse=True)
    print(f"  gaps between kernels: {len(gaps)}, summing "
          f"{sum(gaps) / 1e3:.3f} ms; largest (us) "
          f"{[round(g, 1) for g in gaps[:8]]}")
    for fam, us in sorted(fam_us.items(), key=lambda t: -t[1]):
        print(f"  {fam:38s} {us / 1e3:9.3f} ms  {100 * us / busy:5.1f}% "
              f"of busy  ({fam_n[fam]} launches)")
    others = sorted({e.name for e in kern if family(e.name) == "other"})
    if others:
        print("  other kernels: " + "; ".join(n[:60] for n in others[:12]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
