#!/usr/bin/env python3
"""The port's check on one NVIDIA card: its kernels against their plain
versions and timed, its sparse paths end to end with their launches held
to their censuses, then the card tests of the full-size paths.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc; the
paths are ``card_paths.py``'s.  In order, any failure exiting non-zero
with no result line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; the kernels built from ``artensor_tpu_torch/csrc``
   (``kernels.load``), timed;
2. the kernel table of ``PERF.md`` section 6: each step kernel (GK, GGK,
   RGRow, RGFlat, Lane, Pair) alone at the largest step of its kind (by
   flops) on the first path of ``card_paths.KERNEL_STEPS`` that runs it,
   at that path's width and operand batching, on random operands; GK also
   at dense/default's largest step, GGK at 1k/default's width and its mma
   form at ``GGK_MMA_STEP``.  Each is held to its plain version at the
   card tests' tolerance, then timed (``card_paths.measure_checked``: the
   kernel's device ms, its form and core, its bound, its one-pass TF32
   form, its plain version and the library yardstick).  Then the complex
   matmul at ``CMM_SHAPES``' larger shape (yardstick ``torch.matmul`` of
   complex64) and ``CMM_DOT_SHAPES``' first, dense-state step 6
   (yardstick ``field._split_dot``: the dot fallback's cuBLAS products),
   each held to its plain version, and the permute-copy kernel at
   ``PERMUTE_STEPS``, bit for bit PyTorch's strided copy (its yardstick).
   One JSON line a row;
3. the six sparse paths ("<workload>/<form>": 1k, 10k and 1k-sc25, off
   and default) through ``contraction()`` as a user calls it (graph
   replay at the path's width), the launch counts zeroed just before:
   every amplitude against the JAX fixture, and the run's launches held
   to the census (``card_paths.run_counts``: the wrappers' launches, the
   kernels the card ran by their own counters, the permute-copy kernel's
   to a group's reorders, the complex matmul's to a group's routed dot
   products);
4. ``{"kernels": [...]}``: each kernel's table row with its launches and
   card runs in each path's run of step 3 and their sums, then the card
   line;
5. the card tests of the paths, ``tests/test_torch_card_paths.py``
   (pytest in a process of its own, ``-m gpu``): every kernel step of
   every path against its plain version, float64 and one-pass checks,
   each path's gates end to end, the execution and field modes, the
   planned paths, the command line and the multi-device layer.

Last, ``{"ok": true, "device": {...}}``.  The kernels' unit tests at
small and ragged shapes are ``python -m pytest --noconftest
tests/test_torch_cuda.py -q -m gpu``."""

import json
import subprocess
import sys
import time

import card_paths as cp

CARD_TESTS = "tests/test_torch_card_paths.py"
CARD_TESTS_TIMEOUT = 3000     # seconds for step 5


def complex_mm(B, M, K, N):
    """The complex matmul at (B, M, K, N) held to its plain version, then
    its ms, its one-pass form's, its plain version's and its yardstick's:
    ``torch.matmul`` of complex64 at ``CMM_SHAPES``, the dot fallback's
    cuBLAS products elsewhere."""
    import torch

    from artensor_tpu_torch.ops import field, pallas_mm
    from artensor_tpu_torch.runtime import metrics

    gen = torch.Generator(device=cp.DEVICE).manual_seed(200)
    a = tuple(torch.randn((B, M, K), generator=gen, device=cp.DEVICE)
              for _ in range(2))
    b = tuple(torch.randn((B, K, N), generator=gen, device=cp.DEVICE)
              for _ in range(2))
    kr, ki = pallas_mm.complex_batched_matmul(a, b)
    pr, pi = pallas_mm.complex_batched_matmul_plain(a, b)
    err = cp.max_modulus(kr, ki, pr, pi)
    tol = cp.KERNEL_RTOL * cp.max_modulus(pr, pi) + cp.KERNEL_ATOL
    cp.check(err <= tol, f"complex_mm B {B} M {M} K {K} N {N}: {err:.3e} "
             f"from the plain version, tol {tol:.3e}")
    del kr, ki, pr, pi
    flops = 8 * B * M * N * K
    nbytes = 8 * (B * M * K + B * K * N + B * M * N)
    reps = 5 if flops > 1e12 or nbytes > 1e9 else 20
    if (B, M, K, N) in cp.CMM_SHAPES:
        ac, bc = torch.complex(*a), torch.complex(*b)
        lib = lambda: torch.matmul(ac, bc)  # noqa: E731
    else:
        dn = (((2,), (1,)), ((0,), (0,)))
        lib = lambda: field._split_dot(a, b, dn)  # noqa: E731
    out = dict(step=f"B {B} M {M} K {K} N {N}", width=1, form="mma",
               core=cp.CORES[("pair", "mma")], max_abs_err=err, tol=tol,
               tile=pallas_mm.cmm_tile(B, M, K, N),
               ms=cp.time_ms(lambda: pallas_mm.complex_batched_matmul(a, b),
                             reps),
               one_pass_ms=cp.time_ms(lambda: pallas_mm.complex_batched_matmul(
                   a, b, passes=1), reps),
               plain_ms=cp.time_ms(
                   lambda: pallas_mm.complex_batched_matmul_plain(a, b), 3),
               library_ms=cp.time_ms(lib, reps),
               **metrics.bounds(nbytes, flops, "mma"), bytes=nbytes,
               flops=flops)
    del a, b, lib
    torch.cuda.empty_cache()
    return out


def permute_step(step):
    """The permute-copy kernel at one of ``PERMUTE_STEPS``, each component
    held bit for bit to PyTorch's strided copy of the same view, then its
    ms, its bound (each byte read once and written once at 3.35 TB/s) and
    that copy's ms."""
    import torch

    from artensor_tpu_torch import kernels
    from artensor_tpu_torch.ops import permute

    sizes, strides, ncomp = cp.PERMUTE_STEPS[step]
    n = 1 + sum((d - 1) * st for d, st in zip(sizes, strides))
    gen = torch.Generator(device=cp.DEVICE).manual_seed(300)
    src = [torch.randn(n, generator=gen, device=cp.DEVICE)
           for _ in range(ncomp)]
    views = tuple(x.as_strided(sizes, strides) for x in src)
    outs = tuple(torch.empty(sizes, device=cp.DEVICE) for _ in views)
    lib_out = torch.empty(sizes, device=cp.DEVICE)
    permute.copy(views, outs)
    for v, o in zip(views, outs):
        lib_out.copy_(v)
        cp.check(torch.equal(o.view(torch.int32), lib_out.view(torch.int32)),
                 f"permute {step}: not bit for bit PyTorch's copy")
    p = permute.plan(sizes, strides, 4)
    nbytes = 2 * 4 * ncomp * int(torch.Size(sizes).numel())
    ms = cp.time_ms(lambda: permute.copy(views, outs), 10)
    out = dict(step=step, mode=p.mode, unit=p.unit, components=ncomp, ms=ms,
               bytes=nbytes,
               bound_ms=1e3 * nbytes / kernels.H100_HBM_BYTES_PER_S,
               bound_by="bytes", tb_per_s=nbytes / ms / 1e9,
               library_ms=cp.time_ms(
                   lambda: [lib_out.copy_(v) for v in views], 10))
    del src, views, outs, lib_out
    torch.cuda.empty_cache()
    return out


def kernel_table(paths):
    """Step 2: the rows by kernel (a list each), printed as they come."""
    rows = {}

    def emit(name, **r):
        rows.setdefault(name, []).append(r)
        print(json.dumps(dict(name=name, **r)), flush=True)

    firsts = [(kind, next(lb for lb, (_, kinds) in cp.KERNEL_STEPS.items()
                          if kind in kinds)) for kind in cp.KERNELS]
    for kind, label in firsts + [("gk", "dense/default"),
                                 ("ggk", "1k/default")]:
        if label not in paths:
            paths[label] = cp.compile_label(label)
        path = paths[label]
        plan, bx, by = path["cases"][kind][cp.largest_step(path["cases"],
                                                            kind)]
        emit(kind, path=label, **cp.measure_checked(
            kind, plan, bx, by, path["W"], list(cp.KERNELS).index(kind)))
    emit("ggk", path="synthetic", **cp.measure_checked(
        "ggk", cp.plan_ggk_mma_step(), False, False, 1, 300))
    for shape in (cp.CMM_SHAPES[-1], cp.CMM_DOT_SHAPES[0]):
        emit("complex_mm", **complex_mm(*shape))
    for step in cp.PERMUTE_STEPS:
        emit("permute", **permute_step(step))
    return rows


def path_run(path, wraps):
    """Step 3 for one sparse path: its launch counts (``main_run``), every
    amplitude held to the fixture."""
    import numpy as np
    import torch

    ref = path["ref"]
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    amps, counts = cp.main_run(path, wraps)
    cp.check(len(amps) == len(ref), f"{path['name']}: {len(amps)} "
             f"amplitudes for {len(ref)} bitstrings")
    cp.amp_check(amps, np.array([ref[b] for b in path["sim"]
                                 .bitstrings_sorted]), path["name"])
    return counts


def kernels_line(rows, runs):
    """Step 4: each kernel's row (its largest step's) with its launches and
    card runs in each path's run and their sums."""
    line = []
    for name, (wrapper, source, replaces) in cp.KERNELS.items():
        by_path = {lb: dict(launches=r["launches"][name],
                            device_launches=r["device_launches"][name])
                   for lb, r in runs.items() if r["launches"][name]}
        big = max(rows[name], key=lambda r: r.get("flops", 0))
        line.append(dict(name=name, source=source, replaces=replaces,
                         **_sums(by_path), **big, paths=by_path,
                         steps=rows[name]))
    for name, key in (("complex_mm", "cmm"), ("permute", "permute")):
        by_path = {lb: {k: r[key][k] for k in ("per_group", "launches",
                                                "device_launches")}
                   for lb, r in runs.items()}
        big = max(rows[name], key=lambda r: r["bytes"])
        line.append(dict(name=name, **_sums(by_path), **big, paths=by_path,
                         steps=rows[name]))
    return line


def _sums(by_path):
    return dict(launches=sum(p["launches"] for p in by_path.values()),
                device_launches=sum(p["device_launches"]
                                    for p in by_path.values()))


def card_tests():
    """Step 5: the card tests of the paths in a process of their own; its
    exit code."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p",
           "no:cacheprovider", "-q", "-m", "gpu", CARD_TESTS]
    print(f"chip_smoke: {' '.join(cmd[1:])}", flush=True)
    return subprocess.run(cmd, cwd=cp.ROOT,
                          timeout=CARD_TESTS_TIMEOUT).returncode


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from artensor_tpu_torch import kernels

    card = cp.card_line()
    print(json.dumps(dict(card=card, torch=torch.__version__,
                          cuda=torch.version.cuda)), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.load()
    print(json.dumps(dict(build_s=time.perf_counter() - t0)), flush=True)
    paths = {}
    rows = kernel_table(paths)
    wraps = cp.wrappers()
    runs = {}
    for w in cp.PATHS:
        for form in ("off", "default"):
            label = f"{w}/{form}"
            if label not in paths:
                paths[label] = cp.compile_label(label)
            path = paths[label]
            runs[label] = path_run(path, wraps)
            print(json.dumps(dict(path=label, width=path["W"],
                                  **runs[label])), flush=True)
    print(json.dumps({"kernels": kernels_line(rows, runs)}), flush=True)
    print(card, flush=True)
    del paths, runs
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    rc = card_tests()
    if rc != 0:
        print(f"chip_smoke: {CARD_TESTS} exited {rc}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cp.CardCheckError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
