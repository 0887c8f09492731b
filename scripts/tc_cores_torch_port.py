"""Time the tensor-core kernels at the paths' shapes in two checkouts of
the port, in turns on one card.

    python3 scripts/tc_cores_torch_port.py --a DIR [--b DIR] [--only KIND]

``--a`` and ``--b`` are repository roots (``--b`` defaults to this one),
for example the parent commit unpacked by ``git archive`` into a
git-ignored directory: set against a checkout from before a kernel moved
onto the wgmma core, the A/B sets the two cores side by side.  The turns
run A, B, B, A, each in a process of its own that imports the port and
``chip_smoke`` from its root and builds that root's kernels.  The shapes
(``--only`` keeps one kind: pair, gk, ggk, complex_mm):

* Pair: the 1k path's step (K 1024 M 4096 N 4096) at width 1 with its
  operands unbatched and batched, and at width 32 batched, each in 3
  passes and in one;
* GK's mma form (``gatherk.gk_form`` set to "mma" for the call) at the 1k
  path's K 64 H 64 F 32768 G 8 (width 32, X batched), the dense path's K
  128 H 128 F 512 G 16384 (width 1) and the 1k-sc25 path's K 64 H 256 F
  64 G 256 (width 32);
* GGK: the 1k path's K 16 H 16 F 512 step (its first GGK step, B 894, X
  slice-invariant, W batched) at widths 32 and 64 in both forms and, in
  the mma form, in one pass at width 64; and ``chip_smoke.GGK_MMA_STEP``
  (K 32 H 32 F 512 B 2048, width 1) in the mma form;
* the complex matmul at ``chip_smoke.CMM_SHAPES``, in 3 passes and in one.

Inputs are random from a seed; each call is timed by the root's
``chip_smoke.time_ms`` (device time, median of 5).  After each shape a
turn prints the card's SM clock, power draw and temperature
(``nvidia-smi``): the tensor-core steps can hold the card at its power
limit.  Last line: one JSON object with every turn's ms by shape and the
card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def card_state():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def shapes(rnd, only=None):
    """name -> (call, arguments, passes, form): ``form`` the GK kernel's
    form the call is made in (None for Pair and the complex matmul)."""
    import numpy as np

    import chip_smoke
    from artensor_tpu_torch.ops import pallas_mm
    from artensor_tpu_torch.runtime import gatherk, lanes

    out = {}
    if only in (None, "pair"):
        K, M, N = 1024, 4096, 4096
        plan = lanes.plan_pair_step(("k", "m"), ("k", "n"), ("m", "n"),
                                    (K, M), (K, N))
        for W, b in ((1, False), (1, True), (32, True)):
            lead = (W,) if b else ()
            args = (plan, rnd(*lead, K * M), rnd(*lead, K * M),
                    rnd(*lead, K * N), rnd(*lead, K * N), b, b)
            for passes in (3, 1):
                out[f"pair K {K} M {M} N {N} width {W} batched {b} passes "
                    f"{passes}"] = (lanes.pair_call, args, passes, None)
    if only in (None, "gk"):
        min_x, gatherk.MIN_X_ELEMS = gatherk.MIN_X_ELEMS, 1
        for G, K, F, H, W in ((8, 64, 32768, 64, 32),
                              (16384, 128, 512, 128, 1),
                              (256, 64, 64, 256, 32)):
            plan = gatherk.plan_gk_step(("g1", "c1", "f1"), ("c1", "n1"),
                                        ("g1", "n1", "f1"), (G, K, F),
                                        (K, H))
            lead = (W,) if W > 1 else ()
            args = (plan, rnd(*lead, plan.x_elems), rnd(*lead, plan.x_elems),
                    rnd(H * K), rnd(H * K), W > 1, False)
            out[f"gk K {K} H {H} F {F} G {G} width {W}"] = (
                gatherk.gk_call, args, 3, "mma")
        gatherk.MIN_X_ELEMS = min_x    # the paths' schemes below
    if only in (None, "ggk"):
        for W in (32, 64):
            path = chip_smoke.compile_path("1k", W)
            plan, bx, by = next(
                c for c in path["cases"]["ggk"]
                if (c[0].row.K, c[0].row.H, c[0].row.F) == (16, 16, 512))
            args = chip_smoke.kernel_operands("ggk", plan, bx, by, W,
                                              seed=W)["args"]
            name = f"ggk 1k {chip_smoke.describe('ggk', plan)} width {W}"
            for form in gatherk.GK_FORMS:
                out[f"{name} {form}"] = (gatherk.ggk_call, args, 3, form)
            if W == 64:
                out[f"{name} mma passes 1"] = (gatherk.ggk_call, args, 1,
                                               "mma")
            del path
        *case, B, bi_rows, bj_rows = chip_smoke.GGK_MMA_STEP
        rng = np.random.default_rng(7)
        gi = np.sort(rng.integers(0, bi_rows, B))
        gj = rng.integers(0, bj_rows, B)
        gatherk.GGK_MIN_WORK = 1
        plan = gatherk.plan_ggk_step(*case, gi, gj, bi_rows, bj_rows)
        args = chip_smoke.kernel_operands("ggk", plan, False, False, 1,
                                          seed=300)["args"]
        out[f"ggk synthetic {chip_smoke.describe('ggk', plan)} width 1 mma"] \
            = (gatherk.ggk_call, args, 3, "mma")
    if only in (None, "complex_mm"):
        for B, M, K, N in chip_smoke.CMM_SHAPES:
            args = (tuple(rnd(B, M, K) for _ in "ri"),
                    tuple(rnd(B, K, N) for _ in "ri"))
            for passes in (3, 1):
                out[f"complex_mm B {B} M {M} K {K} N {N} passes {passes}"] = (
                    pallas_mm.complex_batched_matmul, args, passes, None)
    return out


def turn(root, only):
    """One turn in this process, the port imported from ``root``."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from artensor_tpu_torch import kernels
    from artensor_tpu_torch.runtime import gatherk

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    choose = gatherk.gk_form
    res = {}
    for name, (call, args, passes, form) in shapes(rnd, only).items():
        gatherk.gk_form = choose if form is None \
            else (lambda *a, _f=form, **k: _f)
        res[name] = chip_smoke.time_ms(lambda: call(*args, passes=passes), 5)
        print(f"{root}: {name}: {res[name]:.4f} ms; card {card_state()}",
              file=sys.stderr, flush=True)
    gatherk.gk_form = choose
    print(json.dumps(res))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="root of checkout A")
    ap.add_argument("--b", default=HERE, help="root of checkout B")
    ap.add_argument("--only", choices=("pair", "gk", "ggk", "complex_mm"))
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(args.turn, args.only)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    roots = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    res = {}
    for label in "ABBA":
        cmd = [sys.executable, os.path.abspath(__file__), "--a", roots["A"],
               "--turn", roots[label]]
        if args.only:
            cmd += ["--only", args.only]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                              cwd=roots[label])
        if proc.returncode != 0:
            raise SystemExit(f"turn {label} ({roots[label]}) failed")
        for name, ms in json.loads(proc.stdout.strip().splitlines()[-1]
                                   ).items():
            res.setdefault(name, {}).setdefault(label, []).append(ms)
    for name, by in res.items():
        print(f"{name}: A {by['A']} B {by['B']}", flush=True)
    sys.path.insert(0, HERE)
    import chip_smoke

    print(json.dumps({"roots": roots, "ms": res,
                      "card": chip_smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
