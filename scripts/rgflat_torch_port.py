"""The RGFlat kernel at the two RGFlat steps of the port's paths (10k and
1k-sc25 of ``chip_smoke.py``), on one card.

    python3 scripts/rgflat_torch_port.py [--a DIR] [--sweep]

Each path's RGFlat step gets random inputs at slice width 32 (and 1), with
the operand batching of the path, and is timed as ``chip_smoke.py`` times a
kernel (``time_ms`` of this checkout: CUDA events around one call queued
behind a device spin, median of 30).

* ``--a DIR``: the kernel of checkout ``DIR`` (a repository root, e.g. a
  ``git archive`` of the parent unpacked into a git-ignored directory)
  against this one's, in turns A B B A, each in a fresh process that
  imports that root's package; the step through ``apply_ggk_step`` too
  where the checkout's ``chip_smoke.run_kernel`` reports it.
* ``--sweep``: this checkout's staged route over stage sizes
  (``gatherk.RGF_STAGE_ELEMS``) and stages a block (``RGF_STAGES``), every
  setting twice (the list forward, then backward), at width 32.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SWEEP = ((4096, 1), (4096, 2), (4096, 3), (4096, 4), (4096, 8), (2048, 2),
         (3072, 2), (6144, 2), (8192, 2), (8192, 4))


def _chip_smoke(root):
    spec = importlib.util.spec_from_file_location(
        f"chip_smoke_{abs(hash(root))}", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turn(root):
    """This process: ``root``'s RGFlat kernel on both path steps."""
    timer = _chip_smoke(ROOT).time_ms
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from artensor_tpu_torch import kernels

    cs.time_ms = timer
    kernels.load()
    for name in ("10k", "1k-sc25"):
        ((plan, bx, by),) = cs.compile_path(name, 32)["cases"]["rgflat"]
        for width in (32, 1):
            r = cs.run_kernel("rgflat", plan, bx, by, width, seed=3)
            glue = (f" step_ms {r['step_ms']:.4f} w_transpose_ms "
                    f"{r['w_transpose_ms']:.4f}" if "step_ms" in r else "")
            print(f"rgflat {root} {name} ({r['step']}) width {width}: ms "
                  f"{r['ms']:.4f} bound_ms {r['bound_ms']:.4f} plain_ms "
                  f"{r['plain_ms']:.4f} max_abs_err {r['max_abs_err']:.2e}"
                  f"{glue}", flush=True)


def sweep():
    """This checkout's staged route over ``SWEEP``, at width 32."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from artensor_tpu_torch import kernels
    from artensor_tpu_torch.runtime import gatherk

    kernels.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    ops = {}
    for name in ("10k", "1k-sc25"):
        ((plan, bx, by),) = cs.compile_path(name, 32)["cases"]["rgflat"]
        ws = by if plan.w_is_j else bx
        row = plan.row
        x_n, w_n = plan.bi_rows * row.xrow, plan.bj_rows * row.H * row.K
        wl = (32,) if ws else ()
        ops[name] = (plan, rnd(32, x_n), rnd(32, x_n), rnd(*wl, w_n),
                     rnd(*wl, w_n), True, ws)
    saved = gatherk.RGF_STAGE_ELEMS, gatherk.RGF_STAGES
    got = {}
    for setting in SWEEP + SWEEP[::-1]:
        gatherk.RGF_STAGE_ELEMS, gatherk.RGF_STAGES = setting
        for name, args in ops.items():
            plan = args[0]
            for key in [k for k in plan._dev if k[0] == "rgf_geometry"]:
                del plan._dev[key]
            ms = cs.time_ms(lambda: gatherk.rgflat_call(*args), 30)
            got.setdefault((name, setting), []).append(ms)
    gatherk.RGF_STAGE_ELEMS, gatherk.RGF_STAGES = saved
    for (name, (elems, stages)), ms in sorted(got.items()):
        print(f"sweep {name} stage {elems} elements, {stages} stages a "
              f"block: ms {' '.join('%.4f' % t for t in ms)}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="root of checkout A (against this one)")
    ap.add_argument("--sweep", action="store_true",
                    help="this checkout's stage sizes and stages a block")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("rgflat_torch_port: no CUDA device", file=sys.stderr)
        return 2
    if args.turn:
        turn(os.path.abspath(args.turn))
        return 0
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    if args.sweep:
        sweep()
    roots = ([os.path.abspath(args.a), ROOT, ROOT, os.path.abspath(args.a)]
             if args.a else [ROOT])
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn", root], capture_output=True,
                              text=True)
        sys.stdout.write("".join(ln + "\n" for ln in proc.stdout.splitlines()
                                 if ln.startswith("rgflat ")))
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"turn {root} failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
