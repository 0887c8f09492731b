"""Readings for the cells' limits: the program as the configuration states
it and the control, over many seeds, in one process.

    python3 tnbench/control.py --workload <cell> --seeds 1,2,3 \
        [--precisions highest,default] [--seconds 3] [--fixture FILE]

For each seed: the cell's set-up (as ``run.py``'s), a short window in each
precision in turn (the first is the configuration's; "default" is the
program's one-pass TF32 path, the control), then the reference once and
the comparison of every precision's batches.  One JSON line a seed and
precision: ``err_l2``, ``err_max``, the batches compared and the seconds
of each phase.  ``--fixture``: a file of ``bitstring re im`` lines; the
reference at that seed is compared with it first (``fixture_err_l2``,
``fixture_err_max``).  Not part of a benchmark run.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fixture_errors(psi, path):
    import numpy as np

    from tnbench import compare
    from tnbench.reference.statevector import amplitudes

    bits, vals = [], []
    with open(path) as f:
        for line in f:
            if line.strip():
                b, re, im = line.split()
                bits.append(b)
                vals.append(float(re) + 1j * float(im))
    return compare.batch_errors(amplitudes(psi, bits), np.array(vals))


def main(argv=None, cell=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precisions", default="highest,default")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fixture")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tnbench import manifest
    from tnbench.run import cache_env
    from tnbench.session import Run

    cell = cell or manifest.cell(args.workload)
    cache_env(ROOT)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    precisions = args.precisions.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = Run(cell, seed, args.device, precision=precisions[0])
        run.setup()
        setup_s = time.perf_counter() - t0
        taken = {}
        for i, p in enumerate(precisions):
            if i:
                run.prepare(p)
            run.times = []
            run.window(args.seconds)
            last = run.last
            taken[p] = (run.outputs, last, len(run.times),
                        sorted(run.times)[len(run.times) // 2])
            run.outputs, run.last = [], None
        run.release()
        t1 = time.perf_counter()
        psi = run.reference()
        ref_s = time.perf_counter() - t1
        line = {"cell": cell.name, "seed": seed, "setup_s": setup_s,
                "reference_s": ref_s}
        if args.fixture:
            line["fixture_err_l2"], line["fixture_err_max"] = \
                fixture_errors(psi, args.fixture)
        for p, (outs, last, nb, med) in taken.items():
            (numbers, failed) = run.numbers(psi, cell.limits, outs, last)
            print(json.dumps(dict(line, precision=p, batches=nb,
                                  median_batch_s=med, failed=failed,
                                  **numbers)), flush=True)
        del psi, taken, run
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
