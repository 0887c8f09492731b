"""Command-line interface: ``python -m artensor_tpu_torch <command>``.

Port of ``artensor_tpu/__main__.py``: the same commands, flags, defaults,
output formats and exit codes, plus ``--device`` on the commands that
contract (default ``cuda``; without a card they raise, as every entry
point of the port does, unless ``--device cpu`` is given).  Commands:

  simulate  amplitudes of a circuit (qsim file or generated-cirq .py)
  plan      run the planner and save the plan as JSON
  info      inspect a circuit or saved plan
  bench     time a planned contraction (repeat runs, sustained TFLOP/s)
  verify    cross-check sparse amplitudes against the truncated-MPS oracle

``simulate --plan`` and ``bench`` load the plan and compile the default
scheme as ``TensorNetworkSimulation.load_plan`` does: at ``--sc-target``
when given, else at the plan's own ``meta.sc_target`` (the JAX CLI
compiles at ``--sc-target``'s default 30 there); without a plan the
default stays 30.  ``bench`` times the port's sliced runner (CUDA-graph
replay of a slice group on the card; segmented above
``simulation.SEGMENT_AUTO_THRESHOLD`` device steps) at ``--slice-batch``;
its ``compile_s`` is the first call (staging, the warm-up group, the
capture), ``roofline_s`` the floor ``metrics.scheme_roofline_seconds``
puts under the run, ``roofline_achieved`` that floor over the warm wall.
Every command first sets the build caches (``cache.enable_compile_cache``).
"""

import argparse
import json
import sys
import time

import numpy as np

DEFAULT_SC_TARGET = 30.0


def _load_circuit(path):
    from .circuits import TensorNetworkCircuit, load_cirq_circuit

    if str(path).endswith(".py"):
        return TensorNetworkCircuit(load_cirq_circuit(path))
    return TensorNetworkCircuit(path)


def _read_bitstrings(arg):
    if arg is None:
        return []
    if arg.startswith("@"):
        with open(arg[1:]) as f:
            return [ln.split()[0] for ln in f if ln.strip()]
    return arg.split(",")


def _load_plan(sim, path, sc_target):
    """Load the plan at ``path`` into ``sim`` and compile its default
    scheme at ``sc_target``, else at the plan's own, else at 30."""
    with open(path) as f:
        plan = json.load(f)
    if sc_target is None:
        sc_target = (plan.get("meta") or {}).get("sc_target",
                                                 DEFAULT_SC_TARGET)
    sim.load_plan(plan, sc_target=sc_target)


def cmd_simulate(args):
    from .runtime.metrics import ContractionReport
    from .simulation import (PlannerConfig, TensorNetworkSimulation,
                             require_device)

    device = require_device(args.device)
    circ = _load_circuit(args.circuit)
    bitstrings = _read_bitstrings(args.bitstrings)
    sim = TensorNetworkSimulation.from_circuit(circ, bitstrings)
    cfg = PlannerConfig(
        sc_target=DEFAULT_SC_TARGET if args.sc_target is None
        else args.sc_target, trials=args.trials, iters=args.iters,
        parallel=not args.serial)
    if args.plan:
        sim.config = cfg
        _load_plan(sim, args.plan, args.sc_target)
    else:
        sim.prepare_contraction(cfg)
    report = ContractionReport()
    result = sim.contraction(
        dtype=np.complex64 if args.dtype == "complex64" else np.complex128,
        precision=args.precision, report=report,
        scientific_notation=args.scientific_notation,
        checkpoint_path=args.checkpoint, device=device)
    if args.scientific_notation:
        result, factor = result
        print(f"# log10 factor: {factor}", file=sys.stderr)
    print(f"# {report.summary()}", file=sys.stderr)
    if sim.pattern == "sparse":
        for bs, amp in zip(sim.bitstrings_sorted, np.asarray(result)):
            print(f"{bs} {amp.real:.10e} {amp.imag:.10e}")
    else:
        amps = np.asarray(result).reshape(-1)
        if args.out:
            np.save(args.out, amps)
            print(f"# full state ({amps.shape[0]} amplitudes) -> {args.out}",
                  file=sys.stderr)
        else:
            for idx in range(min(len(amps), args.head)):
                bs = np.binary_repr(idx, circ.n)
                print(f"{bs} {amps[idx].real:.10e} {amps[idx].imag:.10e}")


def cmd_plan(args):
    from . import plan_io
    from .network import NumericalTensorNetwork
    from .planner import find_order
    from .simulation import check_bitstrings

    circ = _load_circuit(args.circuit)
    bitstrings = _read_bitstrings(args.bitstrings)
    pattern, max_bitstrings = check_bitstrings(bitstrings)
    tensors, tb, bd, fq = circ.to_numerical_tn()
    ntn = NumericalTensorNetwork(tensors, tb, bd, fq)
    tb2, fq2 = ntn.simplify(pattern)
    order, sliced, ctree = find_order(
        tb2, ntn.bond_dims, fq2, max_bitstrings=max_bitstrings,
        sc_target=args.sc_target, trials=args.trials, iters=args.iters,
        betas=np.linspace(3.0, 21.0, 61), slicing_repeat=4,
        parallel=not args.serial)
    plan_io.save_plan(args.out, ctree,
                      meta={"circuit": str(args.circuit), "pattern": pattern,
                            "sc_target": args.sc_target})
    tc, sc, mc = ctree.complexity()
    print(json.dumps({"plan": args.out, "tc": tc, "sc": sc, "mc": mc,
                      "sliced_bonds": len(sliced),
                      "slices": 2 ** len(sliced)}))


def cmd_info(args):
    if str(args.target).endswith(".json"):
        from . import plan_io

        order, sliced, ctree = plan_io.load_plan(args.target)
        tc, sc, mc = ctree.complexity()
        print(json.dumps({
            "type": "plan", "steps": len(order), "sliced_bonds": len(sliced),
            "slices": 2 ** len(sliced), "tc": tc, "sc": sc, "mc": mc,
            "est_flops_per_slice": 8 * 10 ** tc,
            "max_intermediate_bytes": 8 * 2 ** sc,
        }))
    else:
        circ = _load_circuit(args.target)
        tb, bd, fq = circ.to_abstract_tn()
        gates = sum(len(layer) for layer in circ.layers)
        print(json.dumps({
            "type": "circuit", "qubits": circ.n, "layers": len(circ.layers),
            "gates": gates, "tensors": len(tb), "bonds": len(bd),
        }))


def cmd_bench(args):
    import torch

    from .ops.field import make_field
    from .runtime import executor as ex
    from .runtime import metrics as mt
    from .runtime.segmented import run_segmented
    from .simulation import (SEGMENT_AUTO_THRESHOLD, TensorNetworkSimulation,
                             require_device)

    device = require_device(args.device)
    circ = _load_circuit(args.circuit)
    bitstrings = _read_bitstrings(args.bitstrings)
    sim = TensorNetworkSimulation.from_circuit(circ, bitstrings)
    _load_plan(sim, args.plan, args.sc_target)
    k = len(sim.slicing_bonds)
    field = make_field(np.complex64, args.precision, "split")

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    def first():
        """Staging (static folds, host to device) and the first run."""
        nonlocal run, run_steps
        _, run_steps, arrays, out_shape, execute, apply_step = sim._staged(
            device, field)
        if len(run_steps) > SEGMENT_AUTO_THRESHOLD:
            run = lambda: run_segmented(    # noqa: E731
                arrays, run_steps, sim.slicing_axes, k, out_shape, field,
                apply_step, slice_batch=args.slice_batch)
        else:
            runner = ex.make_sliced_runner(
                execute, run_steps, sim.slicing_axes, k, out_shape, field,
                slice_batch=args.slice_batch)
            run = lambda: runner(arrays)    # noqa: E731
        run()

    run = run_steps = None
    compile_s = timed(first)
    walls = sorted(timed(run) for _ in range(args.repeats))
    wall = walls[len(walls) // 2]
    flops = (2 ** k) * mt.scheme_flops(run_steps)
    roofline = (2 ** k) * mt.scheme_roofline_seconds(run_steps)
    print(json.dumps({
        "wall_s": wall, "compile_s": compile_s,
        "slices": 2 ** k, "steps": len(run_steps),
        "sustained_tflops": flops / wall / 1e12,
        "roofline_s": roofline,
        "roofline_achieved": roofline / wall,
    }))


def cmd_verify(args):
    from .simulation import quantum_circuit_simulation, require_device
    from .utils.mps import mps_simulate

    device = require_device(args.device)
    circ = _load_circuit(args.circuit)
    bitstrings = _read_bitstrings(args.bitstrings)
    if not bitstrings:
        rng = np.random.default_rng(0)
        picks = rng.choice(2 ** circ.n, min(16, 2 ** circ.n), replace=False)
        bitstrings = [np.binary_repr(b, circ.n) for b in picks]
    amps, bs = quantum_circuit_simulation(
        circ, bitstrings, args.sc_target, trial_num=args.trials,
        iters=args.iters, parallel=not args.serial, device=device)
    amap = dict(zip(bs, np.asarray(amps)))
    mps = mps_simulate(circ, chi=args.chi)
    worst = 0.0
    for b in bitstrings:
        ref = mps.amplitude(b)
        err = abs(amap[b] - ref)
        worst = max(worst, err)
        print(f"{b} tn={amap[b]:.8f} mps={ref:.8f} |diff|={err:.2e}")
    # the tolerance scales with the typical amplitude magnitude 2^(-n/2):
    # a fixed absolute one would pass order-unity relative errors on larger
    # circuits (amplitudes shrink as the state spreads)
    threshold = args.tol * 2.0 ** (-circ.n / 2)
    print(json.dumps({"max_abs_diff": float(worst),
                      "threshold": threshold,
                      "mps_fidelity_estimate": mps.fidelity_estimate,
                      "mps_max_bond": mps.max_bond()}), file=sys.stderr)
    if mps.fidelity_estimate <= 0.999:
        # a truncated oracle proves nothing: exit 2 ("could not verify"),
        # apart from 1 ("verified mismatch")
        print("# ERROR: MPS fidelity estimate "
              f"{mps.fidelity_estimate:.6f} <= 0.999 — oracle too "
              "truncated to verify; raise --chi", file=sys.stderr)
        sys.exit(2)
    if worst > threshold:
        sys.exit(1)


def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to contract on (default cuda; 'cpu' "
                   "runs the kernels' plain versions)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="artensor_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("simulate", help="compute amplitudes of a circuit")
    ps.add_argument("circuit")
    ps.add_argument("--bitstrings", help="comma list or @file (sparse mode); "
                    "omit for full amplitudes")
    ps.add_argument("--plan", help="reuse a saved plan JSON")
    ps.add_argument("--sc-target", type=float, default=None,
                    help="memory target (default: the plan's, else 30)")
    ps.add_argument("--trials", type=int, default=6)
    ps.add_argument("--iters", type=int, default=20)
    ps.add_argument("--dtype", default="complex64",
                    choices=["complex64", "complex128"])
    ps.add_argument("--precision", default="highest",
                    choices=["default", "high", "highest"])
    ps.add_argument("--scientific-notation", action="store_true")
    ps.add_argument("--checkpoint", help="checkpoint file for resume")
    ps.add_argument("--serial", action="store_true",
                    help="disable planner process parallelism")
    ps.add_argument("--out", help="save full state vector to .npy")
    ps.add_argument("--head", type=int, default=16,
                    help="dense mode: print first N amplitudes")
    _device_arg(ps)
    ps.set_defaults(fn=cmd_simulate)

    pp = sub.add_parser("plan", help="plan a contraction and save it")
    pp.add_argument("circuit")
    pp.add_argument("--out", required=True)
    pp.add_argument("--bitstrings")
    pp.add_argument("--sc-target", type=float, default=DEFAULT_SC_TARGET)
    pp.add_argument("--trials", type=int, default=8)
    pp.add_argument("--iters", type=int, default=20)
    pp.add_argument("--serial", action="store_true")
    pp.set_defaults(fn=cmd_plan)

    pi = sub.add_parser("info", help="inspect a circuit or plan")
    pi.add_argument("target")
    pi.set_defaults(fn=cmd_info)

    pb = sub.add_parser("bench", help="time a planned contraction")
    pb.add_argument("circuit")
    pb.add_argument("--plan", required=True)
    pb.add_argument("--bitstrings")
    pb.add_argument("--sc-target", type=float, default=None,
                    help="memory target (default: the plan's, else 30)")
    pb.add_argument("--precision", default="highest")
    pb.add_argument("--slice-batch", type=int, default=1)
    pb.add_argument("--repeats", type=int, default=3)
    _device_arg(pb)
    pb.set_defaults(fn=cmd_bench)

    pv = sub.add_parser("verify",
                        help="cross-check amplitudes against the MPS oracle")
    pv.add_argument("circuit")
    pv.add_argument("--bitstrings")
    pv.add_argument("--sc-target", type=float, default=DEFAULT_SC_TARGET)
    pv.add_argument("--chi", type=int, default=256)
    pv.add_argument("--trials", type=int, default=4)
    pv.add_argument("--iters", type=int, default=12)
    pv.add_argument("--tol", type=float, default=1e-2,
                    help="max |diff| RELATIVE to the typical amplitude "
                    "magnitude 2^(-n/2)")
    pv.add_argument("--serial", action="store_true")
    _device_arg(pv)
    pv.set_defaults(fn=cmd_verify)

    args = p.parse_args(argv)
    from .cache import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
