#!/usr/bin/env python3
"""Drive the port's sparse main paths on one NVIDIA card and hold each of
their CUDA kernels against its plain PyTorch version.

    python3 chip_smoke.py [--slice-batch 32]

Run from the repository root on a machine with a CUDA card and nvcc.  Three
workloads of the generated n30 m14 circuit, each with its committed plan
and JAX fixture: 1000 bitstrings ("1k", 64 slices), 10000 bitstrings
("10k", 128 slices) and the 1000 bitstrings at memory budget sc_target 25
("1k-sc25", 32 slices); the last two each have one RGFlat step.  Each
workload runs as two paths: its scheme in the "off" form (time-ordered
layouts, no fusion, no negotiation: ``contraction_scheme_sparse(...,
fuse=False, negotiate=False)``) at ``--slice-batch``, and in the
"default" form that ``TensorNetworkSimulation.load_plan`` compiles
(gate-block fusion and producer-order negotiation under the H100 wall
estimate) at the slice width ``runtime/metrics.dividing_slice_width``
picks.  The lane step is on the 1k-sc25 off path only (its default
scheme has none).  Phases, in order (any failure exits non-zero; no phase
is caught and passed over):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the kernel build from ``artensor_tpu_torch/csrc`` (nvcc, sm_90a, one
   compiler per source, all at once), timed; then the six schemes
   compiled, each default one with its compile seconds split into fusion
   and negotiation, its chosen width and its modeled peak bytes there;
3. per path and kernel (GK, GGK, RGRow, RGFlat, Lane, Pair), at every step
   of its kind in the path's scheme at the path's slice width, and at the
   largest step (by flops) also at width 1: the kernel against its plain
   version on the same inputs, the kernel time (CUDA events, median of
   repeats), its bound and the plain version's time; for GK, Lane and Pair
   (at widths up to ``LIBRARY_MAX_WIDTH``) also one PyTorch call of the
   same function as a yardstick
   (``torch.einsum`` over X in its logical shape, ``torch.matmul``; the
   port calls neither); at the largest GK, GGK, RGRow, RGFlat and Pair
   step both versions' errors against float64; every RGRow and RGFlat
   step also through ``apply_ggk_step`` with the copies it no longer
   makes timed alone;
4. the lane kernel on synthetic plans of the forms the path lacks (head
   orientation, combo legs, a pinned grid leg; X of 2^24 elements), and
   the complex batched matmul (``ops/pallas_mm.py``, on no path) at two
   shapes, each against its plain version, with the same numbers;
5. each path end to end: ``TensorNetworkSimulation`` with all its slices
   on the card; every amplitude against the fixture keyed by bitstring,
   the kernel launch counts of that run, the warm wall time (median of 3
   after one warm-up) and the peak device memory, held to the peak model
   (at most the modeled live set plus the staged operands and
   ``planner/cost.PEAK_RESERVE_BYTES``; the model at least
   ``PEAK_MODEL_SHARE`` of it); a default path also its
   wall estimate and modeled peak beside the measured ones, and the off
   form's warm wall at the default's width.

Then one JSON line with every kernel's numbers (for each kernel its
largest step on the first path that runs it, under ``costliest`` that
path's slowest step of the kind, and under ``paths`` every path's
("<workload>/<form>") launches and steps; the complex matmul's larger
shape, 0 launches), the card line, and last ``{"ok": true, "device":
{...}}``.
The bound of a kernel call (``runtime/metrics.bounds``, which the wall
estimate shares) is the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and its flops over 67 TFLOP/s, the
H100 SXM's float32 rate outside the tensor cores;
``bound_3xtf32_ms`` puts 3 x its flops over the 495 TFLOP/s TF32 tensor
core rate instead.  Each step is also held to the bound of the design it
runs (``form``): bytes for the "stream" form of GK and GGK, 3xTF32 for
the tensor-core kernels ("mma": their other form, Pair, the complex
matmul), FP32 FMA for the rest ("fma").  Per path the GK and GGK steps'
summed time is printed against their summed bounds, and at the largest
GK, GGK, RGRow, RGFlat and Pair step of each path the kernel's and the plain
version's errors against a float64 product of the same inputs, over two
slice instances (the kernel's may be at most ``F64_ERR_RATIO`` times the
plain version's, which runs in full float32 on cuBLAS).  Each RGRow and
RGFlat step is also run as the executor runs it (``apply_ggk_step``: the
kernel and any copy around it), beside the copies its stored-order reads
absorb (RGRow: the X reorder and the W transpose; RGFlat: the W
transpose; each timed alone).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "artensor_tpu_torch", "data")
PATHS = {   # name: (plan, JAX fixture), in the order they are driven
    "1k": (os.path.join(DATA, "rcs_n30_m14_s0_sparse_sc24.json"),
           os.path.join(DATA, "rcs_n30_m14_s0_amps1000.txt")),
    "10k": (os.path.join(DATA, "rcs_n30_m14_s0_sparse10k_sc24.json"),
            os.path.join(DATA, "rcs_n30_m14_s0_amps10000.txt")),
    "1k-sc25": (os.path.join(DATA, "rcs_n30_m14_s0_sparse_sc25.json"),
                os.path.join(DATA, "rcs_n30_m14_s0_amps1000.txt")),
}
CIRCUIT = dict(rows=5, cols=6, cycles=14, seed=0)   # random_circuit args
FORMS = ("off", "default")
DEVICE = "cuda"

F64_ERR_RATIO = 4             # kernel vs plain error against float64
F64_KINDS = ("gk", "ggk", "rgrow", "rgflat", "pair")   # ... at the largest
GLUE_KEYS = ("step_ms", "x_reorder_ms", "w_transpose_ms")   # RGRow, RGFlat
LIBRARY_MAX_WIDTH = 32        # widest call that also times the yardstick (its
                              # complex64 copies of a width-128 step would not
                              # fit beside the step's buffers)
PLAIN_CHUNK = 32              # slice instances a plain-version call covers
PEAK_MODEL_SHARE = 0.9        # the peak model's share of the measured peak
KERNEL_RTOL = 2e-4            # kernel vs plain: max|d| <= rtol*max|plain| + atol
KERNEL_ATOL = 1e-5            #   (float32 sums in another order)
AMP_RTOL = 1e-3               # amplitudes vs fixture:
AMP_RMS_TOL = 1e-6            #   |d| <= rtol*|ref| + rms_tol*rms(ref)

KERNELS = {   # name: (wrapper as module.attr, source, TPU kernel it replaces)
    "gk": ("runtime.gatherk.gk_call", "artensor_tpu_torch/csrc/gatherk.cu",
           "artensor_tpu/runtime/gatherk.py:1667"),
    "ggk": ("runtime.gatherk.ggk_call", "artensor_tpu_torch/csrc/gatherk.cu",
            "artensor_tpu/runtime/gatherk.py:1142"),
    "rgrow": ("runtime.gatherk.rgrow_call",
              "artensor_tpu_torch/csrc/rgrow.cu",
              "artensor_tpu/runtime/gatherk.py:1245"),
    "rgflat": ("runtime.gatherk.rgflat_call",
               "artensor_tpu_torch/csrc/rgflat.cu",
               "artensor_tpu/runtime/gatherk.py:1287"),
    "lane": ("runtime.lanes.lane_call", "artensor_tpu_torch/csrc/lane.cu",
             "artensor_tpu/runtime/lanes.py:586"),
    "pair": ("runtime.lanes.pair_call", "artensor_tpu_torch/csrc/pair.cu",
             "artensor_tpu/runtime/lanes.py:855"),
}
# on no path of the port (nor of the JAX package): checked in phase 4 only
OFF_PATH = {
    "complex_mm": ("ops.pallas_mm.complex_batched_matmul",
                   "artensor_tpu_torch/csrc/pair.cu",
                   "artensor_tpu/ops/pallas_mm.py:22"),
}
# synthetic lane steps of the forms the paths lack, from the index lists of
# tests/test_lanes.py at X = 2^24 elements: (ix_x, ix_w, iy, dims_x,
# dims_w, plan_lane_step arguments)
LANE_FORMS = {
    "head": (("a", "b", "c", "d"), ("a", "b", "n", "m"), ("n", "m", "c", "d"),
             (4, 32, 1024, 128), (4, 32, 4, 4),
             dict(lane_count=2, orient="head")),
    "combos": (("a", "b", "c", "g", "e", "d"), ("a", "e", "n"),
               ("g", "c", "b", "n", "d"), (64, 2, 256, 2, 2, 256), (64, 2, 8),
               dict(lane_count=2, orient="head")),
    "pinned": (("B", "a", "b", "c"), ("a", "b", "n"), ("B", "n", "c"),
               (8, 4, 32, 16384), (4, 32, 8),
               dict(lane_count=2, pin=1, orient="head")),
}
CMM_SHAPES = ((2, 256, 64, 256), (32, 1024, 256, 1024))   # (B, M, K, N)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


HOST_COVER_CYCLES = 2_000_000   # device spin before each timed call (~1 ms)


def time_ms(fn, reps):
    """Median of ``reps`` single-call CUDA-event timings after a warm-up:
    the device time of ``fn``'s work.  Each call is queued behind a device
    spin of ``HOST_COVER_CYCLES`` clocks (``torch.cuda._sleep``), so that
    the host's time to enqueue it (the wrapper's Python, the launch) falls
    inside the spin and not between the two events, as it does on the
    executor's busy stream; a call whose host work outlasts the spin (the
    plain versions' chains of small operations) still counts its gaps."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_COVER_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def operand_batching(steps, slicing_axes):
    """(x batched, y batched) per step, as the sliced runner sees them."""
    dyn = {tid for entries in slicing_axes for tid, *_ in entries}
    out = []
    for s in steps:
        out.append((s.i in dyn, s.j in dyn))
        if s.j in dyn:
            dyn.add(s.i)
    return out


def kernel_cases(run_steps, batching):
    """Every kernel step of the scheme, by kind, with the batching of its
    operands on the main path."""
    from artensor_tpu_torch.runtime.sparse import kernel_kind

    cases = {}
    for s, (bx, by) in zip(run_steps, batching):
        kind = kernel_kind(s)
        if kind:
            cases.setdefault(kind, []).append((s.lane, bx, by))
    return cases


def wrapper(spec):
    """The kernel wrapper named ``module.attr`` in the port's package."""
    import importlib

    mod, attr = spec.rsplit(".", 1)
    return getattr(importlib.import_module(f"artensor_tpu_torch.{mod}"), attr)


def describe(kind, plan):
    """Short shape summary of a kernel step."""
    if kind == "pair":
        return f"K {plan.K} M {plan.M} N {plan.N}"
    if kind == "lane":
        return (f"{plan.orient} L {plan.L} H {plan.H} T {plan.T} F {plan.F}"
                f" G {len(plan.xoff)} combos {plan.n_combos}")
    row = plan if kind == "gk" else plan.row
    out = f"K {row.K} H {row.H} F {row.F}"
    if kind == "gk":
        return out + f" G {len(plan.xoff)}"
    return out + f" B {plan.B} rows {plan.bi_rows}x{plan.bj_rows}"


def gk_library(plan, xr, xi, wr, wi, xs, ws):
    """One ``torch.einsum`` that computes the GK step: X in its logical
    shape (scattered contract legs and all) against W as (H, K digits).
    Returns the call and a function that views the GK output the same way
    (outer index, H, f run), for the check."""
    import string

    import torch

    letters = iter(string.ascii_letters)
    z = next(letters)
    xl = [next(letters) for _ in plan.x_dims]
    h = next(letters)
    k_l = [c for c, r in zip(xl, plan.x_roles) if r == "k"]
    k_d = [d for d, r in zip(plan.x_dims, plan.x_roles) if r == "k"]
    out = [c for c, r in zip(xl, plan.x_roles) if r == "g"] + [h] + \
        [c for c, r in zip(xl, plan.x_roles) if r == "f"]
    lead = z if (xs or ws) else ""
    spec = (f"{z if xs else ''}{''.join(xl)},{z if ws else ''}{h}"
            f"{''.join(k_l)}->{lead}{''.join(out)}")
    xc = torch.complex(xr, xi).reshape(xr.shape[:-1] + tuple(plan.x_dims))
    wc = torch.complex(wr, wi).reshape(wr.shape[:-1] + (plan.H,)
                                       + tuple(k_d))
    dev = xr.device
    yidx = (torch.as_tensor(plan.yoff, device=dev)[:, None, None]
            + plan.hstride * torch.arange(plan.H, device=dev)[None, :, None]
            + torch.arange(plan.F, device=dev)[None, None, :])
    call = lambda: torch.einsum(spec, xc, wc)
    shape = ((xr.shape[0] if xs else wr.shape[0],) if lead else ()) + \
        (len(plan.xoff), plan.H, plan.F)
    return call, lambda yr, yi: torch.complex(yr, yi)[..., yidx], shape


def f64_errors(kr, ki, pr, pi, plain, args, instances=2):
    """Max |d| / max |ref| of the kernel's and the plain version's output
    against the plain version run in float64 on the same inputs, over the
    first ``instances`` slice instances (one at a time: the float64 copies
    of a whole group need not fit beside the step's buffers)."""
    import torch

    plan, xr, xi, wr, wi, xs, ws = args
    lead = xs or ws
    d_k = d_p = scale = 0.0
    for s in range(min(kr.shape[0], instances) if lead else 1):
        pick = lambda t, b: (t[s] if b else t).double()
        rr, ri = plain(plan, pick(xr, xs), pick(xi, xs), pick(wr, ws),
                       pick(wi, ws), False, False)
        ref = torch.complex(rr, ri)
        at = lambda t: (t[s] if lead else t).double()
        scale = max(scale, torch.abs(ref).max().item())
        d_k = max(d_k, torch.abs(torch.complex(at(kr), at(ki)) - ref)
                  .max().item())
        d_p = max(d_p, torch.abs(torch.complex(at(pr), at(pi)) - ref)
                  .max().item())
        del rr, ri, ref
    return dict(f64_rel_err=d_k / scale, plain_f64_rel_err=d_p / scale)


def max_modulus(ar, ai, br=None, bi=None, chunk=1 << 26):
    """max |a - b| (or max |a| without ``b``) over split-complex pairs,
    a chunk of the flat buffers at a time: the complex copies of a whole
    width-128 step would not fit beside its buffers."""
    import torch

    flat = [t.reshape(-1) for t in (ar, ai, br, bi) if t is not None]
    out = 0.0
    for s in range(0, flat[0].numel(), chunk):
        c = [t[s:s + chunk] for t in flat]
        re, im = (c[0], c[1]) if len(c) == 2 else (c[0] - c[2], c[1] - c[3])
        out = max(out, torch.hypot(re, im).max().item())
    return out


def run_kernel(kind, plan, bx, by, width, seed, f64=False):
    """One kernel call against its plain version at slice width ``width``.
    Returns a dict of measurements; with ``f64`` also both versions'
    errors against the plain version run in float64."""
    import numpy as np
    import torch

    from artensor_tpu_torch.runtime import gatherk, lanes, metrics

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rnd = lambda shape: torch.randn(shape, generator=gen, device=DEVICE)
    if kind == "pair":
        K, M, N = plan.K, plan.M, plan.N
        xs, ws = bx, by
        x_n, w_n, y_n = K * M, K * N, M * N
        x_need, w_need = x_n, w_n
        call, plain = lanes.pair_call, lanes.pair_plain
    elif kind == "lane":
        xs, ws = (bx, by) if plan.w_is_j else (by, bx)
        x_n, w_n, y_n = plan.x_elems, plan.w_elems, plan.y_elems
        x_need, w_need = x_n, w_n
        call, plain = lanes.lane_call, lanes.lane_plain
    else:
        row = plan if kind == "gk" else plan.row
        xs, ws = (bx, by) if row.w_is_j else (by, bx)
        if kind == "gk":
            x_n, w_n, y_n = plan.x_elems, plan.H * plan.K, plan.y_elems
            x_need, w_need = x_n, w_n
            call, plain = gatherk.gk_call, gatherk.gk_plain
        else:
            xrow = row.x_elems if kind == "ggk" else row.F * row.K
            yrow = row.y_elems if kind == "ggk" else row.F * row.H
            x_n = plan.bi_rows * xrow
            w_n = plan.bj_rows * row.H * row.K
            y_n = plan.B * yrow
            # a gathered step needs only the rows its targets name
            x_need = len(np.unique(plan.gi)) * xrow
            w_need = len(np.unique(plan.gj)) * row.H * row.K
            call = getattr(gatherk, f"{kind}_call")
            plain = getattr(gatherk, f"{kind}_plain")
    wx = width if xs else 1
    ww = width if ws else 1
    wy = width if (xs or ws) else 1
    xr, xi = rnd(((width,) if xs else ()) + (x_n,)), \
        rnd(((width,) if xs else ()) + (x_n,))
    wr, wi = rnd(((width,) if ws else ()) + (w_n,)), \
        rnd(((width,) if ws else ()) + (w_n,))
    args = (plan, xr, xi, wr, wi, xs, ws)
    kr, ki = call(*args)
    lead = xs or ws
    chunk = PLAIN_CHUNK if lead else width

    def plain_chunks():
        """The plain version over the same inputs, ``chunk`` slice
        instances at a time (a whole width-128 call's temporaries would
        not fit beside the kernel's output)."""
        for c0 in range(0, width if lead else 1, chunk):
            sl = slice(c0, c0 + chunk)
            yield sl, plain(plan, xr[sl] if xs else xr, xi[sl] if xs else xi,
                            wr[sl] if ws else wr, wi[sl] if ws else wi,
                            xs, ws)

    err = scale = 0.0
    pr = pi = None
    for sl, (cr, ci) in plain_chunks():
        kc = (kr[sl], ki[sl]) if lead else (kr, ki)
        check(tuple(kc[0].shape) == tuple(cr.shape),
              f"{kind}: kernel shape {tuple(kc[0].shape)} != plain "
              f"{tuple(cr.shape)}")
        err = max(err, max_modulus(*kc, cr, ci))
        scale = max(scale, max_modulus(cr, ci))
        if pr is None:          # the first instances, for the float64 check
            pr, pi = cr, ci
        del cr, ci
    torch.cuda.synchronize()
    tol = KERNEL_RTOL * scale + KERNEL_ATOL
    check(np.isfinite(err) and err <= tol,
          f"{kind} at width {width}: kernel disagrees with its plain version:"
          f" max|d| {err:.3e} > tol {tol:.3e}")
    reps = 5 if plan.flops * wy > 1e12 else 20
    ms = time_ms(lambda: call(*args), reps)
    plain_ms = time_ms(lambda: [None for _ in plain_chunks()], 3)
    nbytes = 8 * (wx * x_need + ww * w_need + wy * y_n)
    flops = plan.flops * wy
    form = (gatherk.gk_form(plan, width, xs, ws) if kind in ("gk", "ggk")
            else "mma" if kind == "pair" else "fma")
    if kind in ("gk", "ggk"):    # the wrapper's own counting picks the form
        check(nbytes == gatherk.gk_bytes(plan, width, xs, ws),
              f"{kind}: byte count differs from gatherk.gk_bytes")
    out = dict(width=width, step=describe(kind, plan), form=form,
               max_abs_err=err, max_rel_err=err / scale, tol=tol, ms=ms,
               plain_ms=plain_ms, **metrics.bounds(nbytes, flops, form),
               library_ms=None, bytes=nbytes, flops=flops,
               x_batched=xs, w_batched=ws)
    if f64:
        out.update(f64_errors(kr, ki, pr, pi, plain, args))
    if kind in ("rgrow", "rgflat"):
        out.update(step_glue(kind, plan, args, (kr, ki), reps))
    lib = None
    if width > LIBRARY_MAX_WIDTH:
        pass
    elif kind == "pair":
        xc = torch.complex(xr, xi).reshape(
            ((width,) if xs else ()) + (plan.K, plan.M))
        vc = torch.complex(wr, wi).reshape(
            ((width,) if ws else ()) + (plan.K, plan.N))
        lib = lambda: torch.matmul(xc.transpose(-1, -2), vc)
        y = lib().reshape(kr.shape)
        ref = torch.complex(pr, pi)
    elif kind == "gk":
        lib, view, shape = gk_library(plan, xr, xi, wr, wi, xs, ws)
        y = lib().reshape(shape)
        ref = view(pr, pi)
    elif kind == "lane":
        # the step over X's and W's stored legs, output in iy order: the
        # lane kernel's output layout
        a, rest = plan.spec.split(",")
        b, c = rest.split("->")
        z = lambda on: "z" if on else ""
        spec = f"{z(xs)}{a},{z(ws)}{b}->{z(xs or ws)}{c}"
        xc = torch.complex(xr, xi).reshape(xr.shape[:-1] + plan.x_dims)
        wc = torch.complex(wr, wi).reshape(wr.shape[:-1] + plan.w_dims)
        lib = lambda: torch.einsum(spec, xc, wc)
        y = lib().reshape(kr.shape)
        ref = torch.complex(pr, pi)
    if lib is not None:
        lib_err = torch.abs(y - ref).max().item()
        check(lib_err <= tol, f"{kind} yardstick disagrees with the plain "
              f"version: {lib_err:.3e} > tol {tol:.3e}")
        del y, ref
        out["library_ms"] = time_ms(lib, reps)
    del xr, xi, wr, wi, kr, ki, pr, pi, lib
    torch.cuda.empty_cache()
    return out


def step_glue(kind, plan, args, want, reps):
    """An RGRow or RGFlat step through ``gatherk.apply_ggk_step`` as the
    executor runs it (the kernel and any copies around it; checked against
    the kernel's output), and, timed alone on the same operands, the
    copies that the kernel's stored-order reads absorb: the reorder of the
    whole X buffer to canonical (F, K) rows (RGRow's ``pre_perm``; an
    RGFlat row was always read as stored) and the transpose of the W rows
    to (H, K)."""
    import torch

    from artensor_tpu_torch.ops.field import SplitField
    from artensor_tpu_torch.runtime import gatherk, lowering

    _, xr, xi, wr, wi, xs, ws = args
    field, row = SplitField(), plan.row
    x, w = (xr, xi), (wr, wi)
    pi, pj, bi, bj = (x, w, xs, ws) if row.w_is_j else (w, x, ws, xs)
    step = lambda: gatherk.apply_ggk_step(field, pi, pj, plan, bi, bj)
    yr, yi = step()
    d = torch.abs(torch.complex(yr.reshape(want[0].shape) - want[0],
                                yi.reshape(want[1].shape) - want[1])).max()
    check(d.item() == 0.0, f"{kind}: the step's output differs from the "
          f"kernel's by {d.item():.3e}")
    del yr, yi
    xlead = (xr.shape[0],) if xs else ()
    wlead = (wr.shape[0],) if ws else ()
    out = dict(step_ms=time_ms(step, reps), x_reorder_ms=0.0)
    if getattr(row, "pre_perm", None) is not None:
        r = lowering.plan_reorder(
            (plan.bi_rows,) + row.row_dims,
            (0,) + tuple(p + 1 for p in row.pre_perm),
            (plan.bi_rows * row.F * row.K,))
        out["x_reorder_ms"] = time_ms(
            lambda: lowering.apply_reorder(field, x, r, xlead), reps)
    out["w_transpose_ms"] = time_ms(
        lambda: gatherk._wk_rows(w, row, plan.bj_rows, wlead), reps)
    return out


def load_fixture(path):
    ref = {}
    with open(path) as f:
        for ln in f:
            p = ln.split()
            if len(p) == 3:
                ref[p[0]] = complex(float(p[1]), float(p[2]))
    return ref


def compile_path(name, W):
    """Load a workload's fixture and plan and compile its scheme in the off
    form (``contraction_scheme_sparse(..., fuse=False, negotiate=False)``)
    at slice width ``W``.  Returns the path's state (``path_state``)."""
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.plan_io import plan_from_dict
    from artensor_tpu_torch.runtime import sparse

    plan, fixture = PATHS[name]
    ref = load_fixture(fixture)
    sim = TensorNetworkSimulation.from_circuit(random_circuit(**CIRCUIT),
                                               list(ref))
    with open(plan) as f:
        pd = json.load(f)
    t0 = time.perf_counter()
    sim.order, sim.slicing_bonds, sim.ctree = plan_from_dict(pd)
    sim.sc_target = float(pd["meta"]["sc_target"])
    sim._set_scheme(*sparse.contraction_scheme_sparse(
        sim.ctree, sim.bitstrings, sim.sc_target, fuse=False,
        negotiate=False))
    return path_state(name, "off", sim, ref, W, time.perf_counter() - t0, {})


def compile_paths(name, W):
    """Both forms of a workload's scheme: the off form at ``W``
    (``compile_path``), then the default form through ``load_plan`` at the
    width the wall estimate picks (timed, split into fusion and
    negotiation by ``sparse.LAST_COMPILE``).  Returns the two paths'
    states, off first."""
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.runtime import sparse

    off = compile_path(name, W)
    sim = TensorNetworkSimulation.from_circuit(random_circuit(**CIRCUIT),
                                               list(off["ref"]))
    t0 = time.perf_counter()
    sim.load_plan(PATHS[name][0])
    default_s = time.perf_counter() - t0
    return [off, path_state(name, "default", sim, off["ref"], None,
                            default_s, dict(sparse.LAST_COMPILE))]


def path_state(name, form, sim, ref, W, compile_s, stats):
    """One path's state; ``W`` None: the width the wall estimate picks."""
    from collections import Counter

    import numpy as np

    from artensor_tpu_torch.runtime import gatherk, metrics
    from artensor_tpu_torch.runtime.executor import precompute_static_steps
    from artensor_tpu_torch.runtime.sparse import kernel_kind

    label = f"{name}/{form}"
    n_slices = 2 ** len(sim.slicing_bonds)
    run_steps, host = precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)
    k = len(sim.slicing_bonds)
    if W is None:
        W = metrics.dividing_slice_width(run_steps, k, sim.slicing_axes)
    check(n_slices % W == 0, f"{label}: slice width {W} does not divide "
          f"the {n_slices} slices")
    census = Counter(kernel_kind(s) or "dot" for s in run_steps)
    est_s, est_w, _ = metrics.scheme_wall_estimate(
        run_steps, k, slicing_axes=sim.slicing_axes)
    model_peak = metrics.scheme_peak_bytes_at_width(run_steps, W,
                                                    sim.slicing_axes)
    # the staged operands, on the card for the whole run: the peak model
    # counts a sliced leaf's width copies, not the staged tensor itself
    staged = sum(8 * int(np.prod(np.shape(a))) for a in host)
    print(f"scheme {label}: {len(sim.steps)} steps compiled in "
          f"{compile_s:.2f} s (fusion {stats.get('fuse_s', 0.0):.2f} s, "
          f"{stats.get('fuse_compiles', 0)} compiles, "
          f"{stats.get('rewrites', 0)} rewrites kept; negotiation "
          f"{stats.get('negotiate_s', 0.0):.2f} s, "
          f"{stats.get('negotiate_compiles', 0)} compiles), "
          f"{len(run_steps)} on the device per slice: "
          f"{json.dumps(dict(sorted(census.items())))}; {n_slices} slices, "
          f"slice_batch {W} (estimate's width {est_w}); wall estimate "
          f"{est_s:.4f} s; modeled peak at width {W} "
          f"{model_peak / 2 ** 30:.3f} GiB, staged operands "
          f"{staged / 2 ** 30:.3f} GiB", flush=True)
    cases = kernel_cases(run_steps, operand_batching(run_steps,
                                                     sim.slicing_axes))
    forms = {}   # GK and GGK steps by the form gatherk.gk_form picks
    for kind in ("gk", "ggk"):
        forms[kind] = Counter()
        for plan, bx, by in cases.get(kind, []):
            xs, ws = (bx, by) if plan.w_is_j else (by, bx)
            forms[kind][gatherk.gk_form(plan, W, xs, ws)] += 1
    return dict(name=label, workload=name, form=form, sim=sim, ref=ref, W=W,
                compile_s=compile_s, compile_stats=stats, n_slices=n_slices,
                census=census, cases=cases, forms=forms, est_s=est_s,
                model_peak=model_peak, staged=staged)


def report(label, r):
    print(f"kernel {label} ({r['step']}) width {r['width']}: "
          f"max_abs_err {r['max_abs_err']:.3e} (rel {r['max_rel_err']:.2e}, "
          f"tol {r['tol']:.2e}) form {r['form']} ms {r['ms']:.4f} bound_ms "
          f"{r['bound_ms']:.4f} ({r['bound_by']}) bound_3xtf32_ms "
          f"{r['bound_3xtf32_ms']:.4f} design_bound_ms "
          f"{r['design_bound_ms']:.4f} plain_ms {r['plain_ms']:.4f} "
          f"library_ms {r['library_ms']} bytes {r['bytes']} flops "
          f"{r['flops']} x_batched {r['x_batched']} w_batched "
          f"{r['w_batched']}", flush=True)
    if "step_ms" in r:
        print(f"  step with glue ({r['step']}): step ms "
              f"{r['step_ms']:.4f} (kernel {r['ms']:.4f}); copies the kernel's"
              f" stored-order reads absorb, timed alone: X reorder "
              f"{r['x_reorder_ms']:.4f} ms, W transpose "
              f"{r['w_transpose_ms']:.4f} ms", flush=True)
    if "f64_rel_err" in r:
        ratio = r["f64_rel_err"] / max(r["plain_f64_rel_err"], 1e-30)
        print(f"  float64 check ({r['step']}): max|d|/max|ref| kernel "
              f"{r['f64_rel_err']:.3e}, plain {r['plain_f64_rel_err']:.3e}"
              f" (ratio {ratio:.2f}, limit {F64_ERR_RATIO})", flush=True)
        check(r["f64_rel_err"] <= F64_ERR_RATIO * r["plain_f64_rel_err"],
              f"{r['step']}: kernel error against float64 "
              f"{r['f64_rel_err']:.3e} above {F64_ERR_RATIO}x the plain "
              f"version's {r['plain_f64_rel_err']:.3e}")


def check_kernels(path):
    """Phase 3 for one path: every kernel step at the path's width, each
    kind's largest step also at width 1.  Returns, per kind, the largest
    step's result, the slowest step's, the kernel ms of one slice group
    (and the summed bounds of the design each step runs, and the steps'
    forms) and the largest error of any step.  The largest GK, GGK,
    RGRow, RGFlat and Pair steps are also held against float64."""
    W, cases, out = path["W"], path["cases"], {}
    for n, kind in enumerate(KERNELS):
        if kind not in cases:
            continue
        largest = max(range(len(cases[kind])),
                      key=lambda i: cases[kind][i][0].flops)
        res = dict(steps=len(cases[kind]), ms_per_group=0.0, max_err=0.0,
                   design_bound_ms_per_group=0.0, fp32_bound_ms_per_group=0.0,
                   forms={})
        for i, width in [(i, W) for i in range(len(cases[kind]))] + [
                (largest, 1)]:
            plan, bx, by = cases[kind][i]
            f64 = (kind in F64_KINDS and i == largest
                   and width == W)
            r = run_kernel(kind, plan, bx, by, width, seed=n, f64=f64)
            report(f"{path['name']} {kind} step {i + 1}/{len(cases[kind])}",
                   r)
            res["max_err"] = max(res["max_err"], r["max_abs_err"])
            if width != W:
                continue
            res["ms_per_group"] += r["ms"]
            res["design_bound_ms_per_group"] += r["design_bound_ms"]
            res["fp32_bound_ms_per_group"] += r["bound_ms"]
            res["forms"][r["form"]] = res["forms"].get(r["form"], 0) + 1
            if i == largest:
                res["largest"] = r
            if "costliest" not in res or r["ms"] > res["costliest"]["ms"]:
                res["costliest"] = r
        out[kind] = res
        if kind in ("gk", "ggk", "pair"):
            print(f"path {path['name']} {kind}: {res['steps']} steps "
                  f"{json.dumps(res['forms'])}, kernel {res['ms_per_group']:.4f}"
                  f" ms a slice group against summed design bounds "
                  f"{res['design_bound_ms_per_group']:.4f} ms (ratio "
                  f"{res['ms_per_group'] / res['design_bound_ms_per_group']:.2f})"
                  f" and FP32 bounds {res['fp32_bound_ms_per_group']:.4f} ms",
                  flush=True)
    return out


def check_lane_forms():
    """Phase 4a: the lane kernel on each synthetic form at width 1."""
    from artensor_tpu_torch.runtime import lanes

    out = {}
    for n, (name, (ix_x, ix_w, iy, dx, dw, kw)) in enumerate(
            LANE_FORMS.items()):
        plan = lanes.plan_lane_step(ix_x, ix_w, iy, dx, dw, **kw)
        check(plan is not None,
              f"lane form {name} does not plan: {lanes.LAST_REJECT}")
        r = run_kernel("lane", plan, False, False, 1, seed=100 + n)
        report(f"lane form {name}", r)
        out[name] = r
    return out


def check_complex_mm():
    """Phase 4b: the complex batched matmul against its plain version,
    with ``torch.matmul`` of complex64 as its yardstick."""
    import numpy as np
    import torch

    from artensor_tpu_torch.ops import pallas_mm
    from artensor_tpu_torch.runtime import metrics

    out = []
    gen = torch.Generator(device=DEVICE).manual_seed(200)
    for B, M, K, N in CMM_SHAPES:
        a = tuple(torch.randn((B, M, K), generator=gen, device=DEVICE)
                  for _ in range(2))
        b = tuple(torch.randn((B, K, N), generator=gen, device=DEVICE)
                  for _ in range(2))
        call = lambda: pallas_mm.complex_batched_matmul(a, b)
        plain = lambda: pallas_mm.complex_batched_matmul_plain(a, b)
        kr, ki = call()
        pr, pi = plain()
        torch.cuda.synchronize()
        ref = torch.complex(pr, pi)
        err = torch.abs(torch.complex(kr, ki) - ref).max().item()
        scale = torch.abs(ref).max().item()
        tol = KERNEL_RTOL * scale + KERNEL_ATOL
        step = f"B {B} M {M} K {K} N {N}"
        check(np.isfinite(err) and err <= tol,
              f"complex_mm {step}: kernel disagrees with its plain version:"
              f" max|d| {err:.3e} > tol {tol:.3e}")
        ac, bc = torch.complex(*a), torch.complex(*b)
        lib = lambda: torch.matmul(ac, bc)
        lib_err = torch.abs(lib() - ref).max().item()
        check(lib_err <= tol, f"complex_mm yardstick disagrees with the "
              f"plain version: {lib_err:.3e} > tol {tol:.3e}")
        flops = 8 * B * M * N * K
        reps = 5 if flops > 1e12 else 20
        nbytes = 8 * (B * M * K + B * K * N + B * M * N)
        r = dict(width=1, step=step, form="mma", max_abs_err=err,
                 max_rel_err=err / scale, tol=tol, ms=time_ms(call, reps),
                 plain_ms=time_ms(plain, 3),
                 **metrics.bounds(nbytes, flops, "mma"),
                 library_ms=time_ms(lib, reps), bytes=nbytes, flops=flops,
                 x_batched=True, w_batched=True)
        report("complex_mm", r)
        out.append(r)
        del a, b, kr, ki, pr, pi, ref, ac, bc
        torch.cuda.empty_cache()
    return out


def drive(path, wrappers):
    """Phases 4 and 5: the path end to end through the entry points, all
    slices on the card; the launch counts of that run, every amplitude
    against the fixture, then the warm wall and the peak memory."""
    import numpy as np
    import torch

    sim, ref, W, name = path["sim"], path["ref"], path["W"], path["name"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for f in wrappers.values():
        f.launches = 0
    for kind in ("gk", "ggk"):
        for form in wrappers[kind].forms:
            wrappers[kind].forms[form] = 0
    t0 = time.perf_counter()
    amps = sim.contraction(slice_batch=W, device=DEVICE)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in wrappers.items()}
    forms = {k: dict(wrappers[k].forms) for k in ("gk", "ggk")}
    print(f"path {name}: first run {first_s:.3f} s (staging included); "
          f"launches {json.dumps(launches)}; GK and GGK launches by form "
          f"{json.dumps(forms)}", flush=True)
    groups = path["n_slices"] // W
    for kind in wrappers:
        want = path["census"].get(kind, 0) * groups
        check(launches[kind] == want,
              f"{name} {kind}: {launches[kind]} launches, expected {want}")
    for kind, by_form in forms.items():
        for form, n in by_form.items():
            want = path["forms"][kind].get(form, 0) * groups
            check(n == want, f"{name} {kind}: {n} launches of the {form} "
                  f"form, expected {want} (gatherk.gk_form of its steps)")
    check(amps.shape == (len(ref),), f"{name}: amplitude shape {amps.shape}")
    check(bool(np.isfinite(amps).all()), f"{name}: non-finite amplitudes")
    r = np.array([ref[b] for b in sim.bitstrings_sorted])
    rms = float(np.sqrt(np.mean(np.abs(r) ** 2)))
    err = np.abs(amps - r)
    bound = AMP_RTOL * np.abs(r) + AMP_RMS_TOL * rms
    worst = int(np.argmax(err / bound))
    print(f"path {name} amplitudes: {len(amps)} vs fixture, max|d| "
          f"{err.max():.3e}, max rel {float((err / np.abs(r)).max()):.3e}, "
          f"worst |d|/bound {float(err[worst] / bound[worst]):.3e} at "
          f"{sim.bitstrings_sorted[worst]}; mean 2^30|a|^2 "
          f"{(2 ** 30) * float(np.mean(np.abs(amps) ** 2)):.4f}", flush=True)
    check(bool((err <= bound).all()),
          f"{name}: amplitudes disagree with the fixture beyond "
          "1e-3*|ref| + 1e-6*rms(ref)")

    walls, peak = warm_walls(sim, W)
    print(f"path {name} warm wall: median {statistics.median(walls):.4f} s "
          f"of {['%.4f' % w for w in walls]}; max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    out = dict(launches=launches, forms=forms, first_s=first_s,
               warm_s=statistics.median(walls), walls=walls,
               peak_gib=peak / 2 ** 30, compile_s=path["compile_s"],
               compile_stats=path["compile_stats"], slice_batch=W,
               slices=path["n_slices"], census=dict(path["census"]),
               est_s=path["est_s"], model_peak_gib=path["model_peak"] / 2 ** 30,
               staged_gib=path["staged"] / 2 ** 30,
               worst_over_bound=float(err[worst] / bound[worst]))
    from artensor_tpu_torch.planner.cost import PEAK_RESERVE_BYTES

    covered = path["model_peak"] + path["staged"] + PEAK_RESERVE_BYTES
    check(peak <= covered and path["model_peak"] >= PEAK_MODEL_SHARE * peak,
          f"{name}: measured peak {peak / 2 ** 30:.3f} GiB against the "
          f"modeled {path['model_peak'] / 2 ** 30:.3f} GiB (+ staged "
          f"operands and the runtime reserve: {covered / 2 ** 30:.3f} GiB)")
    if path["form"] == "default":
        off_walls, _ = warm_walls(path["off_sim"], W)
        out["off_warm_s_same_width"] = statistics.median(off_walls)
        print(f"path {name} at width {W}: warm wall {out['warm_s']:.4f} s "
              f"against the estimate {path['est_s']:.4f} s and the off "
              f"form's {out['off_warm_s_same_width']:.4f} s (of "
              f"{['%.4f' % w for w in off_walls]}); peak "
              f"{out['peak_gib']:.3f} GiB measured, modeled "
              f"{out['model_peak_gib']:.3f} GiB (+ staged operands "
              f"{out['staged_gib']:.3f} GiB)", flush=True)
    return out


def warm_walls(sim, W):
    """Warm wall times of three whole runs after one warm-up, and the peak
    device memory over them."""
    import torch

    run = sim.prepare(slice_batch=W, device=DEVICE)
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = run()
        out[0].sum().item()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    del run, out
    torch.cuda.empty_cache()
    return walls, peak


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slice-batch", type=int, default=32,
                    help="slices per group of the sliced runner")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from artensor_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)

    # -- 2. build, then the schemes -------------------------------------------
    t0 = time.perf_counter()
    lib = kernels.load()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(kernels.SOURCES)} (nvcc {lib.seconds:.2f} s)",
          flush=True)
    for name, log in sorted(lib.reports.items()):
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {name}: {ln.strip()}")
    paths = [p for name in PATHS for p in compile_paths(name,
                                                        args.slice_batch)]
    for off, dflt in zip(paths[::2], paths[1::2]):
        dflt["off_sim"] = off["sim"]
        dropped = sorted(set(off["census"]) - set(dflt["census"]))
        if dropped:
            print(f"scheme {dflt['name']}: no {', '.join(dropped)} step "
                  f"(held on {off['name']})", flush=True)
    labels = [p["name"] for p in paths]
    missing = [k for k in KERNELS if not any(k in p["cases"] for p in paths)]
    check(not missing, f"no path plans a step for {missing}")

    # -- 3. kernels against their plain versions ------------------------------
    checked = {p["name"]: check_kernels(p) for p in paths}

    # -- 4. lane forms the paths lack, the complex matmul (on no path) --------
    forms = check_lane_forms()
    cmm = check_complex_mm()

    # -- 5. the paths end to end ----------------------------------------------
    wrappers = {k: wrapper(v[0]) for k, v in {**KERNELS, **OFF_PATH}.items()}
    runs = {}
    for p in paths:
        runs[p["name"]] = drive(p, wrappers)
        p["sim"] = None
        if p["form"] == "default":
            p["off_sim"] = None
    print(f"paths: {json.dumps(runs)}", flush=True)

    line = []
    keys = ("step", "form", "ms", "bound_ms", "bound_by", "bound_3xtf32_ms",
            "design_bound_ms", "plain_ms", "library_ms", "max_abs_err")
    for kind, (_, source, replaces) in KERNELS.items():
        first = next(n for n in labels if kind in checked[n])
        res = checked[first][kind]
        big = res["largest"]
        line.append({
            "name": kind, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(runs[n]["launches"][kind] for n in labels),
            "max_abs_err": big["max_abs_err"], "ms": big["ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": big["library_ms"],
            "form": big["form"], "bound_3xtf32_ms": big["bound_3xtf32_ms"],
            "path": first, "step": big["step"], "steps": res["steps"],
            "kernel_ms_per_group": res["ms_per_group"],
            "costliest": {k: res["costliest"][k] for k in keys},
            "paths": {n: {"launches": runs[n]["launches"][kind],
                          "steps": checked[n][kind]["steps"],
                          "kernel_ms_per_group":
                              checked[n][kind]["ms_per_group"],
                          "design_bound_ms_per_group":
                              checked[n][kind]["design_bound_ms_per_group"],
                          "forms": checked[n][kind]["forms"],
                          "max_abs_err": checked[n][kind]["max_err"],
                          "largest": {k: checked[n][kind]["largest"][k]
                                      for k in keys},
                          "costliest": {k: checked[n][kind]["costliest"][k]
                                        for k in keys},
                          **{k: checked[n][kind]["largest"][k]
                             for k in ("f64_rel_err", "plain_f64_rel_err")
                             + GLUE_KEYS
                             if k in checked[n][kind]["largest"]}}
                      for n in labels if kind in checked[n]}})
        if kind == "lane":
            line[-1]["forms"] = {n: {k: r[k] for k in keys}
                                 for n, r in forms.items()}
        if kind in ("rgrow", "rgflat"):
            line[-1].update({k: big[k] for k in GLUE_KEYS})
    (_, source, replaces), big = OFF_PATH["complex_mm"], cmm[-1]
    line.append({
        "name": "complex_mm", "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(runs[n]["launches"]["complex_mm"] for n in labels),
        **{k: big[k] for k in keys}, "path": None,
        "shapes": [{k: r[k] for k in keys} for r in cmm]})
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
