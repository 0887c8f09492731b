"""tnbench: the benchmark of ``artensor_tpu_torch`` on NVIDIA cards.

    python3 tnbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; ``--seed`` draws
the circuit's single-qubit gates.  The run sets up the program
(``session.Run.setup``: everything it builds, compiles, stages, captures
and warms counts as ``setup_s``), measures ``--seconds`` of batches back
to back, frees the program's state, computes the plain reference
(``reference/``) and compares (``compare.py``).  With ``--trace 0`` the
result line holds the cell's end-to-end metrics; with ``--trace 1`` the
window lasts at most ``session.TRACE_SECONDS`` under ``torch.profiler``
and the line holds the cell's per-layer metrics, the profiled window's
busy and window seconds and its breakdown.  Each metric comes from its
reader, ``metrics/<name>.py``.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``compared``: each number compared beside its limit);
the last lines of standard error give the same numbers.  Without as many
CUDA devices as the cell asks for, or with JAX or the JAX package loaded
once the window has closed, it prints no result and exits non-zero.
Build caches go to ``.tnbench_cache/`` inside the checkout.
"""

import time

T_START = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "artensor_tpu")
CACHE = ".tnbench_cache"


def forbidden_modules():
    """Top-level names of loaded modules that a run may not hold, each
    compared whole (``artensor_tpu_torch`` is not ``artensor_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_env(root):
    """Every build cache of the program and its libraries at a fixed path
    inside the checkout."""
    base = os.path.join(root, CACHE)
    for var, sub in (("ARTENSOR_TPU_CACHE", "build"),
                     ("ARTENSOR_TPU_TORCH_SCHEME_CACHE", "schemes"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metrics_of(run, entries):
    """``{name: {"value", "unit"}}`` of the readers that find a value."""
    from tnbench import manifest

    out = {}
    for m in entries:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(cell, seed, seconds, trace, device="cuda"):
    """Drive one run of ``cell`` on ``device``; returns the result line's
    object, or None where the process holds a module it may not."""
    from tnbench.session import Run

    run = Run(cell, seed % 2 ** 64, device)
    run.setup()
    run.setup_s = time.perf_counter() - T_START
    run.window(seconds, trace=bool(trace))
    metrics = metrics_of(run, cell.per_layer if trace else cell.end_to_end)
    dev = {"platform": "cpu", "kind": "cpu", "count": 1,
           "memory_peak_bytes": 0}
    if device == "cuda":
        import torch

        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell.chips,
               "memory_peak_bytes": int(run.peak_bytes)}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
    found = forbidden_modules()
    if found:
        print(f"tnbench: the run holds {', '.join(found)} after its window",
              file=sys.stderr)
        return None
    run.release()
    correct, compared, failed, ref_s = run.check(cell.limits)
    print(f"tnbench: {len(run.times)} batches in {run.window_s:.3f} s, "
          f"setup {run.setup_s:.3f} s, reference and comparison "
          f"{ref_s:.3f} s", flush=True)
    result = {"correct": correct, "attempted": len(run.times),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["compared"] = compared
    return result


def main(argv=None):
    args = parse(argv)
    from tnbench import manifest

    cell = manifest.cell(args.workload)
    cache_env(ROOT)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"tnbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, args.trace)
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    # the checkout's root, not this folder, heads the import path: the
    # harness is the package ``tnbench``, the program ``artensor_tpu_torch``
    sys.path[0] = ROOT
    sys.exit(main())
