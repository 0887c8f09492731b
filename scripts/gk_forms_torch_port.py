"""Time every GK and GGK step of the three off-form paths of
``card_paths.py`` in each of the GK kernel's two forms (and the RGRow
steps in their one form), in one or more checkouts of the port, on one
card.

    python3 scripts/gk_forms_torch_port.py [--root DIR ...] \
        [--workload 1k|10k|1k-sc25 ...] [--kind gk|ggk|rgrow ...] \
        [--slice-batch 32]

``--root`` names repository roots (default: this one), for example
variants of ``csrc/`` unpacked from ``git archive`` into a git-ignored
directory.  The roots take turns in the order given and then reversed (A B
C C B A), each turn in a fresh process that imports ``artensor_tpu_torch``
from that root only (``card_paths`` and the timing from this checkout).
A turn builds the kernels, compiles each path's scheme and runs every GK
and GGK step at the path's slice width and operand batching, on random
inputs made from a seed, once in each form that takes it: "stream" (for
GK, where its W chunk fits that form's shared memory) and "mma" (for GGK,
where its f run is a multiple of the mma tile's width), with
``gatherk.gk_form`` overridden for the call; an RGRow step (``--kind
rgrow``) runs in its one form, "fma".
``card_paths.measure_checked`` times each call (CUDA
events, median of repeats) after its max|d| to the plain version is
checked at the card tests' tolerance.

Each turn prints one JSON line.  The summary gives, per step, the form
``gk_form`` picks, the step's byte and 3xTF32 bounds and each form's ms in
every turn; then per root, path and kind the summed ms (mean of the
root's turns) of the steps in the form ``gk_form`` picks, all in "mma"
(where every step takes it) and each in its faster form.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORKLOADS = ("1k", "10k", "1k-sc25")   # card_paths.PATHS


def turn(root, names, kinds, width):
    """One turn, in this process: every step of ``kinds`` ("gk", "ggk",
    "rgrow") of
    the paths ``names`` in each form, with ``root``'s package.  Prints one
    JSON line."""
    sys.path.insert(0, ROOT)
    import card_paths

    sys.path.insert(0, root)
    import torch

    from artensor_tpu_torch import kernels
    from artensor_tpu_torch.runtime import gatherk

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = kernels.load()
    ptxas = [ln.strip() for ln in lib.reports.get("gatherk", "").splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    choose = gatherk.gk_form
    steps = []
    for name in names:
        path = card_paths.compile_path(name, width)
        for kind, (i, (plan, bx, by)) in [
                (kind, c) for kind in kinds
                for c in enumerate(path["cases"].get(kind, []))]:
            xs, ws = (bx, by) if plan.w_is_j else (by, bx)
            rec = dict(path=name, kind=kind, step=i + 1,
                       shape=card_paths.describe(kind, plan),
                       chosen="fma" if kind == "rgrow"
                       else choose(plan, width, xs, ws))
            row = plan if kind == "gk" else plan.row
            forms = ("fma",) if kind == "rgrow" else gatherk.GK_FORMS
            for form in forms:
                if kind == "gk" and form == "stream" and \
                        gatherk.stream_hchunk(row.H) * row.K \
                        > gatherk.STREAM_W_CAP:
                    continue
                if kind == "ggk" and form == "mma" and \
                        row.F % gatherk.MMA_TILE_M:
                    continue
                if form == "fma":
                    r = card_paths.measure_checked(kind, plan, bx, by, width,
                                                    seed=i)
                    rec.update(fma_ms=r["ms"],
                               bytes_bound_ms=r["design_bound_ms"],
                               bound_3xtf32_ms=r["bound_3xtf32_ms"],
                               library_ms=r["library_ms"])
                    continue
                gatherk.gk_form = lambda *a, _f=form, **k: _f
                try:
                    r = card_paths.measure_checked(kind, plan, bx, by, width,
                                                    seed=i)
                finally:
                    gatherk.gk_form = choose
                rec[f"{form}_ms"] = r["ms"]
                if form == "stream":
                    rec["bytes_bound_ms"] = r["design_bound_ms"]
                rec["bound_3xtf32_ms"] = r["bound_3xtf32_ms"]
                rec["library_ms"] = r["library_ms"]
            steps.append(rec)
    print(json.dumps({"root": root, "card": card_paths.card_line(),
                      "ptxas": ptxas, "steps": steps}), flush=True)


def summarize(turns, roots):
    """Per step, each form's ms in every turn; per root, path and kind, the
    summed ms of gk_form's choice, of all-mma (None where a step does not
    take it) and of each step's faster form."""
    first = turns[0]["steps"]
    print("per step: path kind step shape | chosen | bytes bound, 3xTF32 "
          "bound | stream (or RGRow's fma) ms by turn | mma ms by turn")
    for n, s in enumerate(first):
        ms = {f: [t["steps"][n].get(f"{f}_ms") for t in turns]
              for f in ("stream", "mma", "fma")}
        if s["kind"] == "rgrow":
            ms["stream"] = ms["fma"]
        fmt = lambda v: "-" if v is None else f"{v:.4f}"
        print(f"  {s['path']} {s['kind']} {s['step']} {s['shape']} | "
              f"{s['chosen']} | "
              f"{s.get('bytes_bound_ms', float('nan')):.4f}, "
              f"{s['bound_3xtf32_ms']:.4f} | "
              f"{' '.join(fmt(v) for v in ms['stream'])} | "
              f"{' '.join(fmt(v) for v in ms['mma'])}")
    out = {}
    for root in roots:
        mine = [t for t in turns if t["root"] == root]
        res = {}
        for key in dict.fromkeys(f"{s['path']} {s['kind']}" for s in first):
            sums = dict(chosen=0.0, mma=0.0, best=0.0)
            for n, s in enumerate(first):
                if f"{s['path']} {s['kind']}" != key:
                    continue
                mean = {f: statistics.mean(t["steps"][n][f"{f}_ms"]
                                           for t in mine)
                        for f in ("stream", "mma", "fma")
                        if f"{f}_ms" in s}
                sums["chosen"] += mean[s["chosen"]]
                sums["mma"] = (None if sums["mma"] is None or "mma" not in mean
                               else sums["mma"] + mean["mma"])
                sums["best"] += min(mean.values())
            res[key] = sums
        out[root] = res
        print(f"summed ms a slice group, {root}: "
              f"{json.dumps(res)}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append",
                    help="root of a checkout (repeatable; default: this one)")
    ap.add_argument("--workload", action="append", choices=WORKLOADS)
    ap.add_argument("--kind", action="append", choices=("gk", "ggk", "rgrow"))
    ap.add_argument("--slice-batch", type=int, default=32)
    ap.add_argument("--turn", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    names = args.workload or list(WORKLOADS)
    kinds = args.kind or ["gk", "ggk"]
    if args.turn:
        turn(os.path.abspath(args.turn), names, kinds, args.slice_batch)
        return 0

    roots = [os.path.abspath(r) for r in args.root or [ROOT]]
    turns = []
    for root in roots + roots[::-1]:
        cmd = [sys.executable, os.path.abspath(__file__), "--turn", root,
               "--slice-batch", str(args.slice_batch)]
        for name in names:
            cmd += ["--workload", name]
        for kind in kinds:
            cmd += ["--kind", kind]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"turn {root} failed")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        turns.append(rec)
    print(json.dumps({"summary": summarize(turns, roots)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
