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
that has no estimate.  For each workload of ``chip_smoke.py`` (the three
sparse ones unless ``--workload`` names some; "dense" is the whole
2^30-amplitude state through ``prepare()`` at width 1, "dense-blocks" the
walk ``contraction_output_blocks(6)``, which always compiles the default
form) it runs the turns A, B, B, A, each in a
fresh process that imports ``artensor_tpu_torch`` from that root only.  A
turn loads the committed plan, builds the kernels (outside the timing),
runs the sliced contraction once to warm up, then three times for the warm
wall (host clock around work that ends in a synchronize; the median is
reported), then once more with a CUDA-event pair around every step, summed
by the step's kernel kind (``dot`` = the matmul fallback; each step's time
includes its glue).  The amplitudes of every turn must agree with the
first turn's to 1e-4 of max|a| (a dense turn's: the state at the 1000
fixture bitstrings).  A dense turn also gives its peak device memory over
the warm runs (``max_memory_allocated``) and the walk its seconds from the
generator's start to the last block less the scheme compile (timed apart),
and the blocks after the first, a block.  Each turn prints one JSON line (its
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
DENSE = {name: ("rcs_n30_m14_s0_dense_sc30.json",
                "rcs_n30_m14_s0_amps1000.txt")
         for name in ("dense", "dense-blocks")}
D_OUT = 6          # the walk's sliced output legs, as in chip_smoke.py


def dense_turn(root, name, form):
    """One dense turn, in this process (see the module docstring)."""
    sys.path.insert(0, root)
    import statistics
    import time
    from collections import defaultdict

    import numpy as np
    import torch

    from artensor_tpu_torch import TensorNetworkSimulation, kernels
    from artensor_tpu_torch import random_circuit
    from artensor_tpu_torch.runtime import executor, scheme
    from artensor_tpu_torch.runtime.sparse import kernel_kind

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    plan, fixture = DENSE[name]
    data = os.path.join(root, "artensor_tpu_torch", "data")
    with open(os.path.join(data, fixture)) as f:
        bits = [ln.split()[0] for ln in f if ln.strip()]
    digits = np.array([[int(c) for c in b] for b in bits], dtype=np.int64)
    qubit = lambda bond: int(str(bond).split("-")[1])
    sim = TensorNetworkSimulation.from_circuit(random_circuit(5, 6, 14,
                                                              seed=0))
    sim.load_plan(os.path.join(data, plan))
    if form == "off" and name == "dense":
        sim._set_scheme(*scheme.contraction_scheme(sim.ctree, fuse=False,
                                                   negotiate=False))
    rec = {"root": root, "workload": name, "form": form, "slice_batch": 1,
           "card": torch.cuda.get_device_name(0)}
    if name == "dense":
        kinds = [kernel_kind(s) or "dot" for s in sim.steps]
        run = sim.prepare(slice_batch=1, device="cuda")
        out = run()
        torch.cuda.synchronize()
        del out
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = run()
            out[0].sum().item()
            walls.append(time.perf_counter() - t0)
            del out
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        marks = []
        inner = executor.apply_dense_step

        def timed_step(field, x, y, s, bx=False, by=False):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            res = inner(field, x, y, s, bx, by)
            b.record()
            marks.append((kernel_kind(s) or "dot", a, b))
            return res

        executor.apply_dense_step = timed_step
        try:
            re, im = run()
            torch.cuda.synchronize()
        finally:
            executor.apply_dense_step = inner
        by_kind = defaultdict(float)
        for kind, a, b in marks:
            by_kind[kind] += a.elapsed_time(b)
        n = len(sim.output_bonds)
        idx = sum(digits[:, qubit(b)] << (n - 1 - p)
                  for p, b in enumerate(sim.output_bonds))
        idx = torch.as_tensor(idx, device="cuda")
        amps = re.reshape(-1)[idx].cpu().numpy() \
            + 1j * im.reshape(-1)[idx].cpu().numpy()
        rec.update(census={k: kinds.count(k) for k in sorted(set(kinds))},
                   warm_wall_s=statistics.median(walls), walls_s=walls,
                   ms_by_kind=dict(by_kind))
    else:
        touch = lambda field, oid, raw: tuple(c.reshape(-1)[:1] for c in raw)

        def walk():
            t0 = time.perf_counter()
            blocks = sim.contraction_output_blocks(D_OUT, postprocess=touch,
                                                   device="cuda")
            stamps = [time.perf_counter() for _ in blocks]
            st = scheme.compile_stats()
            comp = st["fuse_s"] + st["negotiate_s"]
            return (stamps[-1] - t0 - comp, comp,
                    (stamps[-1] - stamps[0]) / (len(stamps) - 1))

        walk()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [walk() for _ in range(3)]
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        amps = np.zeros(len(bits), dtype=np.complex64)
        for fixed, qubits, v in sim.contraction_output_blocks(
                D_OUT, device="cuda"):
            sel = np.nonzero(digits[:, qubits] @ (1 << np.arange(
                D_OUT - 1, -1, -1)) == int(fixed, 2))[0]
            rest = [q for q in range(digits.shape[1]) if q not in qubits]
            amps[sel] = v[tuple(digits[sel][:, rest].T)]
        walls = [r[0] for r in runs]
        rec.update(census={}, warm_wall_s=statistics.median(walls),
                   walls_s=walls, compile_s=[r[1] for r in runs],
                   s_per_block=statistics.median(r[2] for r in runs),
                   ms_by_kind={})
    rec["amps"] = [amps.real.tolist(), amps.imag.tolist()]
    print(json.dumps(rec), flush=True)


def turn(root, name, slice_batch, form):
    """One turn, in this process: ``root``'s package on workload ``name``,
    its scheme in ``form``.  Prints one JSON line."""
    if name in DENSE:
        return dense_turn(root, name, form)
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
    ap.add_argument("--workload", action="append",
                    choices=list(WORKLOADS) + list(DENSE))
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
                **{k: [r[k] for r in recs] for k in ("peak_gib",
                                                      "s_per_block")
                   if k in recs[0]},
                "ms_by_kind": {k: [r["ms_by_kind"].get(k, 0.0) for r in recs]
                               for k in kinds}}
        summary[name] = res
        print(f"{name} summary: {json.dumps(res)}", flush=True)
    print(json.dumps({"ab": summary, "a": sides["A"], "b": sides["B"],
                      "forms": form_of}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
