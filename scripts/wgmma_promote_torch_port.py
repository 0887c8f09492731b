"""Choose the wgmma core's promotion interval on the card: the k8 slices
its tensor cores sum before the sum goes into float32
(``PROMOTE_3XTF32`` in ``csrc/wgmma_core.cuh``, ``kernels.wgmma_promote``).

    python3 scripts/wgmma_promote_torch_port.py [--promote 1,2,4,8] \\
        [--seeds 2]

For each interval P the kernels are built again from a copy of
``csrc/`` whose header sets ``PROMOTE_3XTF32 = P``, into a directory of
their own under the build cache (all intervals' builds at once), and
each build is measured in a process of its own: on
random inputs made from a seed, the Pair steps of the 1k path (K 1024 M 4096 N
4096) and the 10k path (K 512 M 32768 N 256) and the 1k path's largest
GK step (K 64 H 64 F 32768 G 8, width 32): the kernel's error against a
float64 product of the same inputs (max|d| / max|ref| over the first
slice instance), the plain version's (``torch.matmul`` in float32) on the
same inputs, their ratio, and the kernel's time (``chip_smoke.time_ms``).
The summary names the longest P whose ratio stays at or below 1 at both
Pair steps, and at those and the GK step (the header takes the second).
Prints one JSON line per build and a summary line.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

PAIR_STEPS = {"1k": (1024, 4096, 4096), "10k": (512, 32768, 256)}
GK_STEP = (8, 64, 32768, 64, 32)    # (G, K, F, H, width)


def use_variant(P):
    """Point ``kernels`` at a build with promotion interval ``P``: a copy
    of ``csrc/`` with the header's constant set to ``P``, and a build
    directory of its own (``kernels.load`` builds there)."""
    import re
    import shutil

    from artensor_tpu_torch import kernels
    from artensor_tpu_torch.cache import enable_compile_cache

    enable_compile_cache()
    root = kernels.BUILD_DIR / f"wg_promote_{P}"
    src = root / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC, src)
    header = src / "wgmma_core.cuh"
    text, n = re.subn(r"constexpr int PROMOTE_3XTF32 = \d+;",
                      f"constexpr int PROMOTE_3XTF32 = {P};",
                      header.read_text())
    assert n == 1, "PROMOTE_3XTF32 not found in wgmma_core.cuh"
    header.write_text(text)
    kernels.CSRC = src
    kernels.BUILD_DIR = root
    return kernels


def f64_ratio(call, plain, args, one):
    """(kernel error, plain error) against float64 over instance 0."""
    import torch

    kr, ki = call(*args)
    pr, pi = plain(*args)
    f64 = [one(t).double() if isinstance(t, torch.Tensor) else t
           for t in args]
    f64[5] = f64[6] = False
    er, ei = plain(*f64)
    ref = torch.complex(er, ei)
    scale = torch.abs(ref).max().item()
    d = lambda r, i: torch.abs(torch.complex(one(r).double(),
                                             one(i).double()) - ref).max()
    return d(kr, ki).item() / scale, d(pr, pi).item() / scale


def measure(P, seeds):
    import torch

    import chip_smoke
    from artensor_tpu_torch import kernels
    from artensor_tpu_torch.runtime import gatherk, lanes

    out = dict(promote=P, steps={})
    gen = torch.Generator(device="cuda")
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    for name, (K, M, N) in PAIR_STEPS.items():
        plan = lanes.plan_pair_step(("k", "m"), ("k", "n"), ("m", "n"),
                                    (K, M), (K, N))
        rows = []
        for seed in range(seeds):
            gen.manual_seed(seed)
            args = (plan, rnd(K * M), rnd(K * M), rnd(K * N), rnd(K * N),
                    False, False)
            rows.append(f64_ratio(lanes.pair_call, lanes.pair_plain, args,
                                  lambda t: t))
        ms = chip_smoke.time_ms(lambda: lanes.pair_call(*args), 10)
        k_err = max(r[0] for r in rows)
        p_err = max(r[1] for r in rows)
        out["steps"][f"pair {name}"] = dict(
            shape=f"K {K} M {M} N {N}", kernel_f64=k_err, plain_f64=p_err,
            ratio=k_err / p_err, ms=ms)
    G, K, F, H, W = GK_STEP
    gatherk.MIN_X_ELEMS = 1
    plan = gatherk.plan_gk_step(("g1", "c1", "f1"), ("c1", "n1"),
                                ("g1", "n1", "f1"), (G, K, F), (K, H))
    gen.manual_seed(0)
    args = (plan, rnd(W, plan.x_elems), rnd(W, plan.x_elems),
            rnd(H * K), rnd(H * K), True, False)
    assert gatherk.gk_form(plan, W, True, False) == "mma"
    k_err, p_err = f64_ratio(gatherk.gk_call, gatherk.gk_plain, args,
                             lambda t: t[0] if t.dim() > 1 else t)
    ms = chip_smoke.time_ms(lambda: gatherk.gk_call(*args), 10)
    out["steps"]["gk 1k"] = dict(
        shape=f"K {K} H {H} F {F} G {G} width {W}", kernel_f64=k_err,
        plain_f64=p_err, ratio=k_err / p_err, ms=ms)
    out["card"] = chip_smoke.card_line()
    out["header_promote"] = kernels.wgmma_promote()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--promote", default="1,2,4,8")
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--measure", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--build", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.build:
        # the compiler's notes on the wgmma kernels: registers, spills and
        # any wgmma it serialises
        _, reports = use_variant(args.build).build()
        notes = [ln.strip() for name in ("pair", "gatherk")
                 for ln in reports.get(name, "").splitlines()
                 if "C75" in ln or ("wgmma" in ln and "Compiling" in ln)
                 or "registers" in ln or "spill" in ln]
        print(json.dumps(notes))
        return 0
    if args.measure:
        use_variant(args.measure).load()
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(measure(args.measure, args.seeds)), flush=True)
        return 0
    ps = [int(p) for p in args.promote.split(",")]
    me = [sys.executable, os.path.abspath(__file__)]
    # every interval's build at once, each in a process of its own
    builds = [subprocess.Popen(me + ["--build", str(p)], cwd=ROOT,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for p in ps]
    notes = {}
    for p, proc in zip(ps, builds):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.stderr.write(log[-4000:])
            raise SystemExit(f"promotion interval {p}: build failed")
        notes[p] = json.loads(log.strip().splitlines()[-1])
    results = []
    for p in ps:
        proc = subprocess.run(me + ["--measure", str(p), "--seeds",
                                    str(args.seeds)], capture_output=True,
                              text=True, cwd=ROOT)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"promotion interval {p}: measurement failed")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["ptxas"] = notes[p]
        print(json.dumps(res), flush=True)
        results.append(res)
    longest = lambda names: max(
        [r["promote"] for r in results
         if all(r["steps"][n]["ratio"] <= 1 for n in names)], default=None)
    print(json.dumps({"summary": {
        "longest_at_or_below_plain_pair": longest(
            [f"pair {n}" for n in PAIR_STEPS]),
        "longest_at_or_below_plain_all": longest(
            [f"pair {n}" for n in PAIR_STEPS] + ["gk 1k"]),
        "ratios": {r["promote"]: {k: round(v["ratio"], 3)
                                  for k, v in r["steps"].items()}
                   for r in results},
        "ms": {r["promote"]: {k: round(v["ms"], 4)
                              for k, v in r["steps"].items()}
               for r in results}}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
