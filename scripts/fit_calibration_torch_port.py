#!/usr/bin/env python3
"""Fit the port's wall-estimate calibration on one CUDA card.

    python3 scripts/fit_calibration_torch_port.py [--out PATH]

Model (``artensor_tpu_torch/runtime/metrics.py``, ``scheme_wall_estimate``):

    wall = 2^k * ( kern_factor * kern_s + dot_factor * dot_s
                   + byte_factor * bytes_per_slice / 3.35 TB/s
                   + n_steps * step_overhead_w1_s / width )

where ``kern_s`` sums each kernel step's design bound times its family's
factor.  The script measures everything it fits, in one run on the card:

1. the three workloads of ``card_paths.py`` (1k, 10k, 1k-sc25), each in
   the off form and the default form, compiled under the calibration in
   force (``data/calibration_h100.json`` if present, else identity);
2. the family factors: for each kernel family, the summed device time of
   every kernel step of the six paths
   (``card_paths.measure_checked`` at slice width 32, checked against its
   plain version) over their summed design bounds;
3. the warm walls (``warm_walls``: median of 3 after one warm-up) of
   every path at
   every width from 8 up to the slice count that fits the memory budget
   (``metrics.max_safe_slice_batch``);
4. the four global factors by non-negative least squares over those
   walls, with each point's residual.

It writes the factors, the card's name and power limit, the command and
the points with their residuals to ``--out`` (default the port's
``data/calibration_h100.json``).
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import card_paths as cp  # noqa: E402

FIT_WIDTH = 32      # slice width of the kernel timings
MIN_WIDTH = 8


def family_factors(paths):
    """Per family: summed kernel ms over summed design-bound ms, every
    kernel step of every path at ``FIT_WIDTH`` (each held against its
    plain version at the card tests' tolerance)."""
    fam = {"gk": "gk", "ggk": "ggk", "rgrow": "rgrow", "rgflat": "rgflat",
           "lane": "lane", "pair": "pair"}
    ms, bound = {}, {}
    for p in paths:
        for n, (kind, cases) in enumerate(sorted(p["cases"].items())):
            for plan, bx, by in cases:
                r = cp.measure_checked(kind, plan, bx, by, FIT_WIDTH, seed=n)
                ms[fam[kind]] = ms.get(fam[kind], 0.0) + r["ms"]
                bound[fam[kind]] = bound.get(fam[kind], 0.0) \
                    + r["design_bound_ms"]
    out = {f: ms[f] / bound[f] for f in ms}
    for f in sorted(out):
        print(f"family {f}: kernel {ms[f]:.4f} ms against design bounds "
              f"{bound[f]:.4f} ms: factor {out[f]:.4f}", flush=True)
    return out, {f: dict(ms=ms[f], design_bound_ms=bound[f]) for f in ms}


def warm_walls(sim, W):
    """Warm wall times of three whole runs (graph replay) after one
    warm-up, each to its result's first value on the host, and the peak
    device memory over all four (from a fresh allocator: cached blocks and
    every stream's cuBLAS workspace freed)."""
    import torch

    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = sim.prepare(slice_batch=W, device="cuda")
    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()[0].reshape(-1)[0].item()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    del run
    torch.cuda.empty_cache()
    return walls, peak


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="file to write (default the port's "
                         "data/calibration_h100.json)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fit: no CUDA device is available", file=sys.stderr)
        return 2
    from artensor_tpu_torch import kernels
    from artensor_tpu_torch.runtime import metrics
    from artensor_tpu_torch.runtime.executor import precompute_static_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    out_path = args.out or metrics.CALIBRATION_PATH
    card = cp.card_line()
    print(f"card: {card}", flush=True)
    kernels.load()
    paths = [p for name in cp.PATHS
             for p in cp.compile_paths(name, FIT_WIDTH)]
    fams, fam_detail = family_factors(paths)

    tmp = os.path.join(os.path.dirname(os.path.abspath(out_path)),
                       ".fit_families.json")
    with open(tmp, "w") as f:
        json.dump({"family_factors": fams}, f)
    points = []
    for p in paths:
        sim = p["sim"]
        run_steps, _ = precompute_static_steps(
            sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
            sim.slicing_axes)
        k = len(sim.slicing_bonds)
        kern_s, dot_s, bytes_ps, n_steps = metrics.scheme_wall_components(
            run_steps, tmp)
        top = metrics.max_safe_slice_batch(run_steps, 2 ** k, None,
                                           sim.slicing_axes)
        w = MIN_WIDTH
        while w <= top:
            walls, peak = warm_walls(sim, w)
            wall = statistics.median(walls)
            points.append(dict(path=p["name"], width=w, wall_s=wall,
                               walls=walls, peak_gib=peak / 2 ** 30,
                               n_slices=2 ** k, kern_s=kern_s, dot_s=dot_s,
                               bytes_per_slice=bytes_ps, n_steps=n_steps))
            print(f"point {p['name']} width {w}: wall {wall:.4f} s of "
                  f"{['%.4f' % x for x in walls]}, peak "
                  f"{peak / 2 ** 30:.2f} GiB", flush=True)
            w *= 2
        p["sim"] = None
    os.remove(tmp)

    X = np.array([[q["n_slices"] * q["kern_s"], q["n_slices"] * q["dot_s"],
                   q["n_slices"] * q["bytes_per_slice"]
                   / kernels.H100_HBM_BYTES_PER_S,
                   q["n_slices"] * q["n_steps"] / q["width"]]
                  for q in points])
    y = np.array([q["wall_s"] for q in points])
    try:
        from scipy.optimize import nnls
        theta, _ = nnls(X, y)
    except ImportError:
        theta = np.maximum(np.linalg.lstsq(X, y, rcond=None)[0], 0.0)
    pred = X @ theta
    for q, pr in zip(points, pred):
        q["fit_s"] = float(pr)
        q["residual_s"] = float(pr - q["wall_s"])
        print(f"  {q['path']:<18} w{q['width']:<4} wall {q['wall_s']:.4f} s"
              f" fit {pr:.4f} s ({pr / q['wall_s']:.3f}x)", flush=True)
    rms = float(np.sqrt(np.mean((pred - y) ** 2)))
    cal = {"kern_factor": float(theta[0]), "dot_factor": float(theta[1]),
           "byte_factor": float(theta[2]),
           "step_overhead_w1_s": float(theta[3]),
           "family_factors": fams,
           "card": card,
           "command": "python3 scripts/fit_calibration_torch_port.py",
           "fitted_at_unix_s": int(time.time()),
           "rms_residual_s": rms,
           "families": fam_detail,
           "points": points}
    print(json.dumps({k: cal[k] for k in (
        "kern_factor", "dot_factor", "byte_factor", "step_overhead_w1_s",
        "family_factors", "rms_residual_s")}), flush=True)
    with open(out_path, "w") as f:
        json.dump(cal, f, indent=1)
    print(f"wrote {out_path} ({len(points)} points, rms residual "
          f"{rms:.4f} s)")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cp.CardCheckError as e:
        print(f"fit: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
