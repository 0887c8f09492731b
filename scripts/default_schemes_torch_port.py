#!/usr/bin/env python3
"""Compile the three n30 workloads' default-form schemes and record them.

    python3 scripts/default_schemes_torch_port.py [--write | --check]

For each workload of ``card_paths.py`` (1k, 10k, 1k-sc25) the default
form (``contraction_scheme_sparse`` with fusion and negotiation on, under
the committed H100 calibration, as ``load_plan`` compiles it) is compiled
on this host; the script prints its compile seconds (fusion and
negotiation apart, with their trial compiles), its kernel census,
``sparse.scheme_digest``, the slice width the wall estimate picks and the
kernel steps by kind the card runs there (``card_paths.step_cases``).
``--write`` saves them to ``tests/data/torch_port_default_schemes.json``,
which the CPU and card tests hold later compiles to and
``card_paths.KERNEL_STEPS`` takes the default forms' card cases from;
``--check`` compares with that file and exits 1 on a difference.  Runs on
the CPU (no card needed).
"""

import argparse
import json
import os
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import card_paths  # noqa: E402

RECORD = card_paths.DEFAULT_RECORD


def default_scheme(name):
    """(path, seconds, compile stats) of the workload's default form
    (``card_paths.compile_default_path``)."""
    from artensor_tpu_torch.runtime import scheme, tracing

    path = card_paths.compile_default_path(name)
    span = tracing.last("scheme.compile")
    return path, span.seconds, scheme.compile_stats(span)


def record(path):
    from artensor_tpu_torch.runtime.sparse import kernel_kind, scheme_digest

    steps = path["sim"].steps
    census = Counter(kernel_kind(s) or "dot" for s in steps)
    width, kernel_steps = card_paths.step_cases(path)
    return {"census": dict(sorted(census.items())),
            "digest": scheme_digest(steps), "width": width,
            "kernel_steps": kernel_steps}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--workload", action="append",
                    choices=list(card_paths.PATHS))
    args = ap.parse_args()
    out, bad = {}, []
    want = {}
    if args.check:
        with open(RECORD) as f:
            want = json.load(f)
    for name in args.workload or list(card_paths.PATHS):
        path, seconds, stats = default_scheme(name)
        out[name] = record(path)
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
