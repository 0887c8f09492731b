"""Time GGK's mma form (wgmma, ``csrc/wgmma_core.cuh``) at the 1k path's
K 16 H 16 F 512 step against variants of its shape, on one card.

    python3 scripts/ggk_wgmma_torch_port.py [--variant NAME ...] \\
        [--width 64 ...]

Each variant is this checkout's ``csrc/`` copied and edited, built into a
directory of its own under the build cache (all variants' builds at
once), and measured in a process of its own, in turns (the variants in
order, then reversed):

* ``as_is``: the kernel as committed: an N tile of 16 (H <= 16) and a K
  chunk of 16 (K <= 16) for this step, its finished tiles stored through
  shared memory in 16-byte stores (``Cfg::STAGE_Y``), X read once for all
  slice instances of an M tile (``Cfg::REUSE_X``); also timed in one pass;
* ``no_reuse``: X copied and its fragments read for every slice
  instance, tiles strided over the blocks (``Cfg::REUSE_X`` off);
* ``direct_store``: the tiles stored from the accumulator fragments, 4
  bytes a store at stride ``ldy`` a column (as the wider tiles do);
* ``no_stack``: re and im multiplied as the wider tiles do, 12 wgmma of
  n16 a k8 slice into two accumulators, where the committed kernel stacks
  [Vr | Vi] and [-Vi | Vr] into 32-wide planes, 6 wgmma of n32
  (``Cfg::STACK``);
* ``bk32``: the K chunk of 32 (half of it zeros at K 16);
* ``bn32``: the N tile of 32 (half of it zeros at H 16) with the K chunk
  of 32, the shape GK's mma form takes for H <= 32;
* ``no_store``: as committed, with the consumers' store of each finished
  tile skipped: what the epilogue costs;
* ``no_mma``: as committed, with no wgmma issued (fences, commits and
  waits kept): what the copies, the split and the store cost alone;
* ``no_mma_store``: neither: the copies, the split and the hand-overs.

The last three leave the output unwritten or wrong, so they are timed
without the check.

A turn compiles the 1k path's off-form scheme at each width
(``chip_smoke.compile_path``), takes its K 16 H 16 F 512 GGK step (B 894,
X slice-invariant, W batched) and times the mma form
(``gatherk.gk_form`` set to "mma"), 3 passes, with
``chip_smoke.time_ms`` (device time, median of 10), after checking it
against the plain version (all but the ``no_`` variants); the
``as_is`` turns also time the stream form.  Prints one JSON line a turn,
then a summary with each variant's ms by width (every turn's), the
step's byte bound and the card's name and power limit.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

STEP = (16, 16, 512)    # (K, H, F)

NO_STORE = ("wgmma_core.cuh", r"if \(kc == nks - 1\) \{\n(\s+)store<C>",
            r"if (kc == nks - 1) {\n\1if (acc[0] == -1.2345e-30f)"
            r"\n\1store<C>")
# variant -> [(file, pattern, replacement)]: the edits of csrc/
EDITS = {
    "as_is": [],
    "bk32": [("gatherk.cu", r"K <= 16 \? mma_tile<true, 16, 16>",
              "K <= 16 ? mma_tile<true, 16, 32>")],
    "bn32": [("gatherk.cu", r"if \(H <= 16\)\n", "if (H <= 0)\n")],
    "direct_store": [("wgmma_core.cuh",
                      r"bool STAGE_Y = GATHER && VEC && BN == 16;",
                      "bool STAGE_Y = false;")],
    "no_reuse": [("wgmma_core.cuh", r"bool REUSE_X = GATHER && BK == 16;",
                  "bool REUSE_X = false;")],
    "no_stack": [("wgmma_core.cuh", r"bool STACK = GATHER && BN == 16;",
                  "bool STACK = false;")],
    "no_mma": [("wgmma_core.cuh", r"    if constexpr \(BN == 16\) \{\n",
                "    if (acc != 12345) {\n    } else if constexpr (BN == 16) {\n")],
    "no_store": [NO_STORE],
}
EDITS["no_mma_store"] = EDITS["no_mma"] + [NO_STORE]


def use_variant(name):
    """Point ``kernels`` at variant ``name``'s copy of ``csrc/`` and its own
    build directory."""
    from artensor_tpu_torch import kernels
    from artensor_tpu_torch.cache import enable_compile_cache

    enable_compile_cache()
    root = kernels.BUILD_DIR / f"ggk_variant_{name}"
    src = root / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC, src)
    for fname, pat, rep in EDITS[name]:
        path = src / fname
        text, n = re.subn(pat, rep, path.read_text())
        assert n == 1, f"{name}: {pat!r} not found once in {fname}"
        path.write_text(text)
    kernels.CSRC = src
    kernels.BUILD_DIR = root
    return kernels


def measure(name, widths):
    import torch

    import chip_smoke
    from artensor_tpu_torch.runtime import gatherk

    choose = gatherk.gk_form
    out = dict(variant=name, ms={}, stream_ms={}, bound_ms={})
    for W in widths:
        path = chip_smoke.compile_path("1k", W)
        plan, bx, by = next(
            c for c in path["cases"]["ggk"]
            if (c[0].row.K, c[0].row.H, c[0].row.F) == STEP)
        forms = ("mma", "stream") if name == "as_is" else ("mma",)
        for form in forms:
            gatherk.gk_form = lambda *a, _f=form, **k: _f
            if name.startswith("no_"):
                args = chip_smoke.kernel_operands("ggk", plan, bx, by, W,
                                                  seed=W)["args"]
                ms = chip_smoke.time_ms(lambda: gatherk.ggk_call(*args), 10)
                bound = None
            else:
                r = chip_smoke.run_kernel("ggk", plan, bx, by, W, seed=W)
                ms, bound = r["ms"], r["design_bound_ms"]
                out["step"] = r["step"]
            if name == "as_is" and form == "mma":
                args = chip_smoke.kernel_operands("ggk", plan, bx, by, W,
                                                  seed=W)["args"]
                out.setdefault("one_pass_ms", {})[W] = chip_smoke.time_ms(
                    lambda: gatherk.ggk_call(*args, passes=1), 10)
                del args
            gatherk.gk_form = choose
            (out["ms"] if form == "mma" else out["stream_ms"])[W] = ms
            if bound is not None:
                out["bound_ms"][W] = bound
        del path
        torch.cuda.empty_cache()
    out["card"] = chip_smoke.card_line()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", choices=sorted(EDITS))
    ap.add_argument("--width", action="append", type=int)
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    args = ap.parse_args()
    widths = args.width or [64]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.build:
        _, reports = use_variant(args.build).build()
        # spills, and any wgmma ptxas serialises (warning C7515 and kin)
        print(json.dumps([ln.strip() for ln in
                          reports.get("gatherk", "").splitlines()
                          if ("spill" in ln and " 0 bytes spill" not in ln)
                          or "C75" in ln or "warning" in ln]))
        return 0
    if args.measure:
        use_variant(args.measure).load()
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(measure(args.measure, widths)), flush=True)
        return 0
    names = args.variant or ["as_is", "no_stack", "no_reuse", "direct_store",
                             "bk32", "bn32", "no_store", "no_mma",
                             "no_mma_store"]
    me = [sys.executable, os.path.abspath(__file__)]
    builds = [subprocess.Popen(me + ["--build", n], cwd=ROOT,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for n in names]
    for n, proc in zip(names, builds):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.stderr.write(log[-4000:])
            raise SystemExit(f"variant {n}: build failed")
        print(json.dumps({"variant": n, "ptxas": json.loads(
            log.strip().splitlines()[-1])}), flush=True)
    turns = []
    for n in names + names[::-1]:
        cmd = me + ["--measure", n]
        for W in widths:
            cmd += ["--width", str(W)]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"variant {n}: measurement failed")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        turns.append(rec)
    summary = {n: {str(W): [t["ms"][str(W)] for t in turns
                            if t["variant"] == n] for W in widths}
               for n in names}
    stream = {str(W): [t["stream_ms"][str(W)] for t in turns
                       if t["variant"] == "as_is"] for W in widths}
    first = next((t for t in turns if t["bound_ms"]), turns[0])
    one = {str(W): [t["one_pass_ms"][str(W)] for t in turns
                    if t["variant"] == "as_is"] for W in widths}
    print(json.dumps({"summary": {"mma_ms": summary, "as_is_stream_ms": stream,
                                  "as_is_one_pass_ms": one,
                                  "bound_ms": first["bound_ms"],
                                  "step": first.get("step"),
                                  "card": turns[0]["card"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
