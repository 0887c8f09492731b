#!/usr/bin/env python3
"""Compile the three n30 workloads' default-form schemes and record them.

    python3 scripts/default_schemes_torch_port.py [--write | --check]

For each workload of ``chip_smoke.py`` (1k, 10k, 1k-sc25) the default
form (``contraction_scheme_sparse`` with fusion and negotiation on, under
the committed H100 calibration) is compiled on this host; the script prints
its compile seconds (fusion and negotiation apart, with their trial
compiles), its kernel census and ``sparse.scheme_digest``.  ``--write``
saves census and digest to ``tests/data/torch_port_default_schemes.json``,
which the CPU and card tests hold later compiles to; ``--check`` compares
with that file and exits 1 on a difference.  Runs on the CPU (no card
needed).
"""

import argparse
import json
import os
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DATA = os.path.join(ROOT, "artensor_tpu_torch", "data")
RECORD = os.path.join(ROOT, "tests", "data",
                      "torch_port_default_schemes.json")
WORKLOADS = {   # name: (plan, amplitude fixture), as in chip_smoke.py
    "1k": ("rcs_n30_m14_s0_sparse_sc24.json", "rcs_n30_m14_s0_amps1000.txt"),
    "10k": ("rcs_n30_m14_s0_sparse10k_sc24.json",
            "rcs_n30_m14_s0_amps10000.txt"),
    "1k-sc25": ("rcs_n30_m14_s0_sparse_sc25.json",
                "rcs_n30_m14_s0_amps1000.txt"),
}


def default_scheme(name):
    """(steps, seconds, compile stats) of the workload's default form."""
    from artensor_tpu_torch.plan_io import load_plan
    from artensor_tpu_torch.runtime import scheme, sparse, tracing

    plan, fixture = WORKLOADS[name]
    with open(os.path.join(DATA, fixture)) as f:
        bits = [ln.split()[0] for ln in f if ln.strip()]
    with open(os.path.join(DATA, plan)) as f:
        sc = json.load(f)["meta"]["sc_target"]
    _, _, ctree = load_plan(os.path.join(DATA, plan))
    steps, _, _ = sparse.contraction_scheme_sparse(ctree, bits, sc)
    span = tracing.last("scheme.compile")
    return steps, span.seconds, scheme.compile_stats(span)


def record(steps):
    from artensor_tpu_torch.runtime.sparse import kernel_kind, scheme_digest

    census = Counter(kernel_kind(s) or "dot" for s in steps)
    return {"census": dict(sorted(census.items())),
            "digest": scheme_digest(steps)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--workload", action="append", choices=list(WORKLOADS))
    args = ap.parse_args()
    out, bad = {}, []
    want = {}
    if args.check:
        with open(RECORD) as f:
            want = json.load(f)
    for name in args.workload or list(WORKLOADS):
        steps, seconds, stats = default_scheme(name)
        out[name] = record(steps)
        print(f"{name}: compiled in {seconds:.2f} s ({json.dumps(stats)}); "
              f"{json.dumps(out[name])}", flush=True)
        if args.check and out[name] != want.get(name):
            bad.append(name)
    if args.write:
        with open(RECORD, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {RECORD}")
    if bad:
        print(f"differs from {RECORD}: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
