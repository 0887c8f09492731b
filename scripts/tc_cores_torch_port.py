"""Time Pair and GK's mma form at the paths' largest shapes in two
checkouts of the port, in turns on one card.

    python3 scripts/tc_cores_torch_port.py --a DIR [--b DIR]

``--a`` and ``--b`` are repository roots (``--b`` defaults to this one),
for example the parent commit unpacked by ``git archive`` into a
git-ignored directory: before the wgmma core both kernels ran on
``csrc/tc_core.cuh``'s mma.sync product, so that A/B sets the two cores
side by side.  The turns run A, B, B, A, each in a process of its own that
imports the port and ``chip_smoke`` from its root and builds that root's
kernels.  The shapes: the 1k path's Pair step (K 1024 M 4096 N 4096) at
width 1 with its operands unbatched and batched, and at width 32 batched,
each in 3 passes and in one; GK's mma form (``gatherk.gk_form`` set to
"mma" for the call) at the 1k path's K 64 H 64 F 32768 G 8 (width 32, X
batched), the dense path's K 128 H 128 F 512 G 16384 (width 1) and the
1k-sc25 path's K 64 H 256 F 64 G 256 (width 32).  Inputs are random from
a seed; each call is timed by the root's ``chip_smoke.time_ms`` (device
time, median of 5).  After each shape a turn prints the card's SM clock,
power draw and temperature (``nvidia-smi``): the tensor-core steps can
hold the card at its power limit.  Last line: one JSON object with every
turn's ms by shape and the card's name and power limit.
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


def shapes(rnd):
    """name -> (kind, arguments, passes)."""
    from artensor_tpu_torch.runtime import gatherk, lanes

    out = {}
    K, M, N = 1024, 4096, 4096
    plan = lanes.plan_pair_step(("k", "m"), ("k", "n"), ("m", "n"), (K, M),
                                (K, N))
    for W, b in ((1, False), (1, True), (32, True)):
        lead = (W,) if b else ()
        args = (plan, rnd(*lead, K * M), rnd(*lead, K * M), rnd(*lead, K * N),
                rnd(*lead, K * N), b, b)
        for passes in (3, 1):
            out[f"pair K {K} M {M} N {N} width {W} batched {b} passes "
                f"{passes}"] = ("pair", args, passes)
    gatherk.MIN_X_ELEMS = 1
    for G, K, F, H, W in ((8, 64, 32768, 64, 32), (16384, 128, 512, 128, 1),
                          (256, 64, 64, 256, 32)):
        plan = gatherk.plan_gk_step(("g1", "c1", "f1"), ("c1", "n1"),
                                    ("g1", "n1", "f1"), (G, K, F), (K, H))
        lead = (W,) if W > 1 else ()
        args = (plan, rnd(*lead, plan.x_elems), rnd(*lead, plan.x_elems),
                rnd(H * K), rnd(H * K), W > 1, False)
        out[f"gk K {K} H {H} F {F} G {G} width {W}"] = ("gk", args, 3)
    return out


def turn(root):
    """One turn in this process, the port imported from ``root``."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from artensor_tpu_torch import kernels
    from artensor_tpu_torch.runtime import gatherk, lanes

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    gatherk.gk_form = lambda *a, **k: "mma"
    res = {}
    for name, (kind, args, passes) in shapes(rnd).items():
        call = lanes.pair_call if kind == "pair" else gatherk.gk_call
        res[name] = chip_smoke.time_ms(lambda: call(*args, passes=passes), 5)
        print(f"{root}: {name}: {res[name]:.4f} ms; card {card_state()}",
              file=sys.stderr, flush=True)
    print(json.dumps(res))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="root of checkout A")
    ap.add_argument("--b", default=HERE, help="root of checkout B")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(args.turn)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    roots = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    res = {}
    for label in "ABBA":
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--a", roots["A"], "--turn", roots[label]],
                              stdout=subprocess.PIPE, text=True)
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
