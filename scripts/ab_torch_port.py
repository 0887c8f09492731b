"""Compare two checkouts of the port on one card: warm walls and the device
time of each kernel kind's steps, in turns A B B A.

    python3 scripts/ab_torch_port.py --a DIR [--b DIR] [--workload 1k ...]
        [--slice-batch W] [--form off|default [--form off|default]]

``--a`` and ``--b`` are repository roots (``--b`` defaults to this one),
for example a ``git archive`` of the parent commit unpacked into a
git-ignored directory.  ``--form`` picks the scheme each side compiles:
"default" (what ``load_plan`` compiles: fusion and negotiation on) or
"off" (``contraction_scheme_sparse(..., fuse=False, negotiate=False)``);
given once it holds for both sides, twice it is A's then B's, so
``--a . --form off --form default`` compares the two forms of this
checkout.  ``--slice-batch`` defaults to the width the side's own wall
estimate picks (``metrics.dividing_slice_width``), or 32 in a checkout
that has no estimate.  For each workload of ``chip_smoke.py`` (all three
unless ``--workload`` names some) it runs the turns A, B, B, A, each in a
fresh process that imports ``artensor_tpu_torch`` from that root only.  A
turn loads the committed plan, builds the kernels (outside the timing),
runs the sliced contraction once to warm up, then three times for the warm
wall (host clock around work that ends in a synchronize; the median is
reported), then once more with a CUDA-event pair around every step, summed
by the step's kernel kind (``dot`` = the matmul fallback; each step's time
includes its glue).  The amplitudes of every turn must agree with the
first turn's to 1e-4 of max|a|.  Each turn prints one JSON line (its
amplitudes, by bitstring, ride along and are dropped from the printed
record); the summary gives both sides' walls and kind times and the
spread of each side (max - min of its two turns).
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WORKLOADS = {   # name: (plan, amplitude fixture), as in chip_smoke.py
    "1k": ("rcs_n30_m14_s0_sparse_sc24.json", "rcs_n30_m14_s0_amps1000.txt"),
    "10k": ("rcs_n30_m14_s0_sparse10k_sc24.json",
            "rcs_n30_m14_s0_amps10000.txt"),
    "1k-sc25": ("rcs_n30_m14_s0_sparse_sc25.json",
                "rcs_n30_m14_s0_amps1000.txt"),
}


def turn(root, name, slice_batch, form):
    """One turn, in this process: ``root``'s package on workload ``name``,
    its scheme in ``form``.  Prints one JSON line."""
    sys.path.insert(0, root)
    import statistics
    import time
    from collections import defaultdict

    import numpy as np
    import torch

    from artensor_tpu_torch import TensorNetworkSimulation, kernels
    from artensor_tpu_torch import random_circuit
    from artensor_tpu_torch.runtime import sparse

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    plan, fixture = WORKLOADS[name]
    data = os.path.join(root, "artensor_tpu_torch", "data")
    with open(os.path.join(data, fixture)) as f:
        bits = [ln.split()[0] for ln in f if ln.strip()]
    sim = TensorNetworkSimulation.from_circuit(
        random_circuit(5, 6, 14, seed=0), bits)
    if form == "off":
        from artensor_tpu_torch.plan_io import plan_from_dict

        with open(os.path.join(data, plan)) as f:
            pd = json.load(f)
        sim.order, sim.slicing_bonds, sim.ctree = plan_from_dict(pd)
        sim.sc_target = float(pd["meta"]["sc_target"])
        sim._set_scheme(*sparse.contraction_scheme_sparse(
            sim.ctree, bits, sim.sc_target, fuse=False, negotiate=False))
    else:
        sim.load_plan(os.path.join(data, plan))
    if not slice_batch:
        try:
            from artensor_tpu_torch.runtime import executor, metrics
        except ImportError:
            metrics = None
        if metrics is None:
            slice_batch = 32
        else:
            run_steps, _ = executor.precompute_static_steps(
                sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
                sim.slicing_axes)
            slice_batch = metrics.dividing_slice_width(
                run_steps, len(sim.slicing_bonds), sim.slicing_axes)
    kinds = [sparse.kernel_kind(s) or "dot" for s in sim.steps]
    run = sim.prepare(slice_batch=slice_batch, device="cuda")
    out = run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = run()
        out[0].sum().item()
        walls.append(time.perf_counter() - t0)

    marks = []
    inner = sparse.apply_sparse_step

    def timed_step(field, x, y, s, bx=False, by=False):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = inner(field, x, y, s, bx, by)
        b.record()
        marks.append((sparse.kernel_kind(s) or "dot", a, b))
        return res

    sparse.apply_sparse_step = timed_step
    try:
        run()
        torch.cuda.synchronize()
    finally:
        sparse.apply_sparse_step = inner
    by_kind = defaultdict(float)
    for kind, a, b in marks:
        by_kind[kind] += a.elapsed_time(b)
    amps = sim.contraction(slice_batch=slice_batch, device="cuda")
    a = np.asarray(amps)[np.argsort(np.array(sim.bitstrings_sorted))]
    print(json.dumps({"root": root, "workload": name, "form": form,
                      "slice_batch": slice_batch,
                      "census": {k: kinds.count(k) for k in sorted(set(kinds))},
                      "warm_wall_s": statistics.median(walls),
                      "walls_s": walls, "ms_by_kind": dict(by_kind),
                      "card": torch.cuda.get_device_name(0),
                      "amps": [a.real.tolist(), a.imag.tolist()]}),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="root of checkout A")
    ap.add_argument("--b", default=ROOT, help="root of checkout B")
    ap.add_argument("--workload", action="append", choices=list(WORKLOADS))
    ap.add_argument("--slice-batch", type=int, default=0,
                    help="slices per group (default: the side's model)")
    ap.add_argument("--form", action="append", choices=("off", "default"),
                    help="scheme form: once for both sides, or A's then B's")
    ap.add_argument("--turn", nargs=3, metavar=("ROOT", "WORKLOAD", "FORM"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(os.path.abspath(args.turn[0]), args.turn[1], args.slice_batch,
             args.turn[2])
        return 0
    forms = args.form or ["default"]
    if len(forms) > 2:
        ap.error("--form is given at most twice")
    form_of = {"A": forms[0], "B": forms[-1]}

    import numpy as np

    sides = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    summary = {}
    for name in args.workload or list(WORKLOADS):
        got, first = {"A": [], "B": []}, None
        for side in "ABBA":
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--a",
                 args.a, "--slice-batch", str(args.slice_batch), "--turn",
                 sides[side], name, form_of[side]],
                capture_output=True, text=True, cwd=sides[side])
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                raise SystemExit(f"{name} turn {side} failed")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            re, im = rec.pop("amps")
            amps = np.array(re) + 1j * np.array(im)
            print(f"{name} {side}: {json.dumps(rec)}", flush=True)
            got[side].append(rec)
            if first is None:
                first = amps
            d = float(np.abs(amps - first).max() / np.abs(first).max())
            if not d < 1e-4:
                raise SystemExit(f"{name} turn {side}: amplitudes differ "
                                 f"from the first turn's by {d:.2e}")
        res = {}
        for side, recs in got.items():
            walls = [r["warm_wall_s"] for r in recs]
            kinds = sorted({k for r in recs for k in r["ms_by_kind"]})
            res[side] = {
                "form": form_of[side],
                "slice_batch": recs[0]["slice_batch"],
                "census": recs[0]["census"],
                "warm_wall_s": walls,
                "spread_s": max(walls) - min(walls),
                "ms_by_kind": {k: [r["ms_by_kind"].get(k, 0.0) for r in recs]
                               for k in kinds}}
        summary[name] = res
        print(f"{name} summary: {json.dumps(res)}", flush=True)
    print(json.dumps({"ab": summary, "a": sides["A"], "b": sides["B"],
                      "forms": form_of}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
