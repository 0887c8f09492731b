#!/usr/bin/env python3
"""Drive the port's sparse and dense main paths on one NVIDIA card and hold
each of their CUDA kernels against its plain PyTorch version.

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
scheme has none).  Then the dense workload, the whole 2^30-amplitude
state of the same circuit (plan ``rcs_n30_m14_s0_dense_sc30.json``, no
sliced bond), as three paths: "dense/off" and "dense/default" (the state
at once, through ``prepare()``) and "dense-blocks"
(``contraction_output_blocks(6)``: 64 blocks of 2^24, the slice-invariant
steps run once); each is held to both fixtures' 11000 amplitudes (their
indices mapped through the output order on the card), its norm^2 (a
float64 sum on the card) to 1 within ``NORM_TOL``, and every block to the
same block of the default path's state within ``BLOCK_TOL`` x its rms.
A GK call already checked on another path (equal tables and sizes: the
block walk's slice-invariant steps) is not made twice.  Phases, in order
(any failure exits non-zero; no phase is caught and passed over):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the kernel build from ``artensor_tpu_torch/csrc`` (nvcc, sm_90a, one
   compiler per source, all at once), timed; then the nine schemes
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
   step both versions' errors against float64 (where the float64 copies
   fit: not at the dense paths' 2^30-element steps, ``F64_MAX_ELEMS``);
   every RGRow and RGFlat step also through ``apply_ggk_step`` with the
   copies it no longer makes timed alone;
4. the lane kernel on synthetic plans of the forms the path lacks (head
   orientation, combo legs, a pinned grid leg; X of 2^24 elements), and
   the complex batched matmul (``ops/pallas_mm.py``, on no path) at two
   shapes, each against its plain version, with the same numbers;
5. each path end to end: ``TensorNetworkSimulation`` with all its slices
   on the card, as ``contraction()`` runs it there (a slice group
   captured as a CUDA graph after one eager warm-up group, replayed for
   every group: ``runtime/executor.py``), at the width asked for (no
   out-of-memory halving); every amplitude against the fixture keyed by
   bitstring, the run's report (``report.summary()``) and the kernel
   launches of that run, counted two ways and each held to the census:
   by the wrappers (the launches they make: the warm-up group's; a
   capture records the kernels, a replay calls no wrapper) and by
   the kernels' own counters over the run (``kernels.device_runs``: the
   kernels the card ran, the warm-up group's and every replay's); then
   the same run
   eagerly and as graph replay on the same staged inputs: the max |d|
   between the two (held to the fixture's gate) and each one's error
   against the fixture, both warm walls (median of 3), the capture
   seconds, and the graph run's peak device memory (its warm-up and
   capture included, from a fresh allocator: cached blocks and every
   stream's cuBLAS workspace freed) held to the peak model (at most
   ``runtime/metrics.scheme_device_peak_bytes`` plus the staged operands
   and ``planner/cost.PEAK_RESERVE_BYTES``; the model at least
   ``PEAK_MODEL_SHARE`` of it; the kernel checks' device tables are
   dropped before each path); a default path also its wall estimates
   (eager, and as one graph a group: ``metrics.segmented_wall_estimate``)
   and modeled peak beside the measured ones, and the off form's warm
   wall at the default's width; a dense path its amplitudes, norm^2 and
   (the walk) blocks as above, its warm wall beside the estimate (the
   walk: the median of 3 walks after one, each from the generator's
   start to its last block less the scheme compile, timed apart; its
   blocks after the first, a block, beside the estimate's per block
   steps; against an eager walk block by block), and its peak, less the
   whole state it holds for the amplitude and block checks;
6. the other execution modes: the segmented executor
   (``runtime/segmented.run_segmented``, one graph a segment, one pool)
   on 1k/default and dense/default at ``SEGMENT_STEPS`` steps a segment
   against one segment, at the path's width and (1k) at
   ``SEGMENT_COST_WIDTH``: the per-segment replay cost, the result
   against the fixture, the peak against the model; scientific notation
   (``runtime/rescaled.py``) on 1k-sc25/default and dense/default, t *
   10^f against the fixture; a checkpointed run of 10k/default
   (``runtime/checkpoint.py``) stopped on purpose after chunk 3 of 8,
   resumed through ``contraction(checkpoint_path=...)``, held to the
   fixture, the file gone at the end;
7. the number-field modes (``ops/field.make_field``), after every main
   run: on 1k/default, 1k-sc25/default and dense/default at the path's
   width, split/naive/highest, then split/karatsuba, complex, fused and
   split at 'high' (held to the fixture gate, a dense state's norm^2 to 1;
   'high' equal to 'highest', max|d| 0), and split and complex at
   'default' and split with bf16 and f16 storage (their errors against
   the fixture printed, held only to finite values: bf16/f16 miss the
   gate, as the JAX package records); a sparse path's float32 modes
   through ``contraction()`` (its out-of-memory halving included), the
   rest through ``make_field`` and the sliced runner; each with its warm
   wall (median of 3, graph replay) beside split/naive's, its capture
   seconds, peak and width, and its kernel launches: the census in split
   float32 mode (one-pass launches exactly under 'default'), none in any
   other; a complex and a fused block walk (``contraction_output_blocks(
   D_OUT, mode=...)``), every block held to the default state's; the
   segmented run in the fused mode (1k/default), scientific notation in
   the complex mode (1k-sc25/default) and a complex checkpointed run
   (10k/default) stopped at width 16 and resumed at width 32, whose last
   chunk runs its rest at a narrower width.  Phase 3 also holds the
   one-pass TF32 form (precision 'default') of the tensor-core kernels
   against their plain TF32 forms (operands rounded as the kernel rounds
   them, products in float32) at each path's largest GK and GGK "mma"
   and Pair step, phase 4 the complex matmul's at its two shapes and a
   synthetic GGK "mma" step's where no path has one; each with its time
   beside the 3-pass time;
8. the planned paths: the port's planner on the card's host (the native
   C++ search built from ``artensor_tpu_torch/native``, its build
   seconds; the run fails if it does not build: never the Python search
   unnoticed).  "dense-planned" (8b, after the post-hoc walk, held to the
   same default state): ``prepare_output_sharded(*PLANNED_WALK)`` under
   ``PlannerConfig``'s defaults, its planner and compile seconds, sliced
   bonds and complexity; its kernel steps as phase 3 checks a path's;
   ``contraction_output_blocks`` over the planned blocks (each the sum of
   its 2^k slices, one graph replayed a slice), every block within
   ``BLOCK_TOL`` x rms of the whole state, the fixtures' 11000 amplitudes
   and norm^2 from the blocks, its launches against the census, the warm
   walk (median of 3) and its seconds a block, and its peak (less the
   state held) held to the model and below the post-hoc walk's.
   "1k-planned" (8a, last): ``quantum_circuit_simulation(circuit, the 1k
   bitstrings, sc_target=PLANNED_SC)`` as a user calls it (planned,
   compiled and run at width 1 on the card), every amplitude against the
   1k fixture keyed by the bitstrings it returns, its planner seconds,
   sliced bonds, complexity and whether the plan is the committed sc24
   file, its compile and first-call seconds and its launches; then its
   simulation as phase 3 and 5 drive a path, at the model's width;
9. the command line on the 1k batch (``drive_cli``): the n30 circuit
   written as a qsim file and the 1k bitstrings as an ``@file``;
   ``python -m artensor_tpu_torch simulate <qsim> --bitstrings @<file>
   --plan <1k plan>`` as a subprocess (every printed amplitude against the
   fixture, its wall and its report line), the same command in this
   process (its scheme's digest equal to 1k/default's, its kernels
   counted on the card and held to the census at width 1), ``bench`` at
   ``CLI_BENCH_WIDTH`` (its JSON; the wall within ``CLI_BENCH_TOL`` of
   1k/default's phase-5 warm wall, ``roofline_achieved`` at most 1),
   ``verify`` on ``tests/data/circuit_n12_rcs.qsim`` (exit 0, fidelity
   estimate above 0.999), ``info`` and ``plan`` on the qsim file, and the
   scheme cache (``runtime/scheme_cache.py``) cold then warm on the 1k
   default scheme (the warm steps equal to the cold ones, a run from them
   held to the fixture).  Phase 5 also holds every sparse path's floor
   (``metrics.scheme_roofline_seconds`` x its slices) below its warm wall.

Then the paths' and the modes' numbers, the CLI's, one JSON line with every
kernel's numbers (for each kernel its largest step on the first path
that runs it, under ``costliest`` that path's slowest step of the kind,
and under ``paths`` every path's ("<workload>/<form>", the planned ones
included) launches, kernels
run on the card (``device_launches``), replays and steps; ``launches``
and ``device_launches`` summed over the paths; the complex matmul's
larger shape, 0 launches), the card line, and last ``{"ok": true,
"device": {...}}``.
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
DENSE_PLAN = os.path.join(DATA, "rcs_n30_m14_s0_dense_sc30.json")
DENSE_FIXTURES = (os.path.join(DATA, "rcs_n30_m14_s0_amps1000.txt"),
                  os.path.join(DATA, "rcs_n30_m14_s0_amps10000.txt"))
D_OUT = 6                     # the block walk's sliced output legs: 64
                              # blocks of 2^24 amplitudes
PLANNED_SC = 24               # the planned 1k path: the port plans the 1k
                              # fixture's batch at this sc_target through
                              # quantum_circuit_simulation (its defaults
                              # otherwise: trial_num 8, iters 50, alpha 0)
PLANNED_WALK = (4, 28)        # the planned walk: prepare_output_sharded(
                              # d_out, sc_target) under PlannerConfig's
                              # defaults, 16 blocks of 2^26 amplitudes
PLAN_HASH_SEED = "0"          # PYTHONHASHSEED the script runs under
T0 = None                     # the run's start (after the re-execution)
NORM_TOL = 1e-4               # |norm^2 - 1| of a dense state (float64 sum)
BLOCK_TOL = 1e-5              # block vs whole state: max|d| <= tol*rms
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
F64_MAX_ELEMS = 1 << 28       # largest step (X + Y elements of one slice
                              # instance) whose float64 check fits beside
                              # its buffers
PEAK_MODEL_SHARE = 0.9        # the peak model's share of the measured peak
KERNEL_RTOL = 2e-4            # kernel vs plain: max|d| <= rtol*max|plain| + atol
KERNEL_ATOL = 1e-5            #   (float32 sums in another order)
AMP_RTOL = 1e-3               # amplitudes vs fixture:
AMP_RMS_TOL = 1e-6            #   |d| <= rtol*|ref| + rms_tol*rms(ref)
SEGMENT_STEPS = 16            # steps a segment in the segmented phase
SEGMENT_COST_WIDTH = 8        # the per-segment replay cost also at this
                              # width (more groups: more extra replays)
CKPT_WIDTH = 16               # the checkpointed run's width (a chunk's)
ONE_PASS_KINDS = ("gk", "ggk", "pair")   # kernels with a tensor-core form
# the one-pass TF32 form (precision 'default') against the plain version's
# TF32 form: the same products of the same TF32 operands, each exact in
# float32, summed in another order -- the 3-pass form's tolerance
ONE_PASS_RTOL, ONE_PASS_ATOL = KERNEL_RTOL, KERNEL_ATOL

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
    Returns the call, a function ``view(yr, yi, o=slice(None))`` that
    views the GK output the same way (outer index, H, f run) over the
    outer indices ``o``, for the check, and the call's output shape."""
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
    yoff = torch.as_tensor(plan.yoff, device=dev)
    hf = (plan.hstride * torch.arange(plan.H, device=dev)[:, None]
          + torch.arange(plan.F, device=dev)[None, :])

    def view(yr, yi, o=slice(None)):
        idx = yoff[o, None, None] + hf[None]
        return torch.complex(yr[..., idx], yi[..., idx])

    call = lambda: torch.einsum(spec, xc, wc)
    shape = ((xr.shape[0] if xs else wr.shape[0],) if lead else ()) + \
        (len(plan.xoff), plan.H, plan.F)
    return call, view, shape


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


def kernel_operands(kind, plan, bx, by, width, seed):
    """A kernel step's random operands on the card at slice width
    ``width`` (made from ``seed``) and what its checks need: a dict of
    the wrapper, its plain version, the call's arguments, which operands
    carry the width (``xs``, ``ws``) and the element counts (``x_n``,
    ``w_n``, ``y_n``; ``x_need``, ``w_need``: the rows the step reads)."""
    import numpy as np
    import torch

    from artensor_tpu_torch.runtime import gatherk, lanes

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
    xr, xi = rnd(((width,) if xs else ()) + (x_n,)), \
        rnd(((width,) if xs else ()) + (x_n,))
    wr, wi = rnd(((width,) if ws else ()) + (w_n,)), \
        rnd(((width,) if ws else ()) + (w_n,))
    return dict(call=call, plain=plain, args=(plan, xr, xi, wr, wi, xs, ws),
                xs=xs, ws=ws, x_n=x_n, w_n=w_n, y_n=y_n, x_need=x_need,
                w_need=w_need)


def plain_chunks(plain, args, width, **kw):
    """The plain version over a call's inputs, ``PLAIN_CHUNK`` slice
    instances at a time (a whole width-128 call's temporaries would not
    fit beside the kernel's output): ``(instances, result)`` pairs."""
    plan, xr, xi, wr, wi, xs, ws = args
    lead = xs or ws
    chunk = PLAIN_CHUNK if lead else width
    for c0 in range(0, width if lead else 1, chunk):
        sl = slice(c0, c0 + chunk)
        yield sl, plain(plan, xr[sl] if xs else xr, xi[sl] if xs else xi,
                        wr[sl] if ws else wr, wi[sl] if ws else wi, xs, ws,
                        **kw)


def plain_error(kr, ki, chunks, lead):
    """``(max|kernel - plain|, max|plain|, the first chunk's plain
    result)`` over ``plain_chunks``; ``lead``: the output carries the
    width axis."""
    err = scale = 0.0
    first = None
    for sl, (cr, ci) in chunks:
        kc = (kr[sl], ki[sl]) if lead else (kr, ki)
        check(tuple(kc[0].shape) == tuple(cr.shape),
              f"kernel shape {tuple(kc[0].shape)} != plain "
              f"{tuple(cr.shape)}")
        err = max(err, max_modulus(*kc, cr, ci))
        scale = max(scale, max_modulus(cr, ci))
        if first is None:
            first = (cr, ci)
        del cr, ci
    return err, scale, first


def run_kernel(kind, plan, bx, by, width, seed, f64=False):
    """One kernel call against its plain version at slice width ``width``.
    Returns a dict of measurements; with ``f64`` also both versions'
    errors against the plain version run in float64."""
    import numpy as np
    import torch

    from artensor_tpu_torch.runtime import gatherk, metrics

    ops = kernel_operands(kind, plan, bx, by, width, seed)
    call, plain, args = ops["call"], ops["plain"], ops["args"]
    _, xr, xi, wr, wi, xs, ws = args
    x_n, w_n, y_n = ops["x_n"], ops["w_n"], ops["y_n"]
    x_need, w_need = ops["x_need"], ops["w_need"]
    wx = width if xs else 1
    ww = width if ws else 1
    wy = width if (xs or ws) else 1
    kr, ki = call(*args)
    # the float64 check takes double copies of a slice instance's operands
    # and output: only where they fit beside the step's buffers (not at
    # the dense path's 2^30-element steps)
    f64 = f64 and x_n + y_n <= F64_MAX_ELEMS
    err, scale, (pr, pi) = plain_error(
        kr, ki, plain_chunks(plain, args, width), xs or ws)
    torch.cuda.synchronize()
    tol = KERNEL_RTOL * scale + KERNEL_ATOL
    check(np.isfinite(err) and err <= tol,
          f"{kind} at width {width}: kernel disagrees with its plain version:"
          f" max|d| {err:.3e} > tol {tol:.3e}")
    reps = 5 if plan.flops * wy > 1e12 or 8 * (x_n + y_n) > 1 << 32 \
        else 20
    ms = time_ms(lambda: call(*args), reps)
    plain_ms = time_ms(lambda: [None for _ in plain_chunks(plain, args,
                                                           width)], 3)
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
    del kr, ki
    lib = None
    if width > LIBRARY_MAX_WIDTH:
        pass
    elif kind == "pair":
        xc = torch.complex(xr, xi).reshape(
            ((width,) if xs else ()) + (plan.K, plan.M))
        vc = torch.complex(wr, wi).reshape(
            ((width,) if ws else ()) + (plan.K, plan.N))
        lib = lambda: torch.matmul(xc.transpose(-1, -2), vc)
        lib_err = torch.abs(lib().reshape(pr.shape)
                            - torch.complex(pr, pi)).max().item()
    elif kind == "gk":
        lib, view, shape = gk_library(plan, xr, xi, wr, wi, xs, ws)
        y = lib().reshape(shape)
        # a block of outer indices at a time: the index of a whole
        # 2^30-element output would not fit beside it
        rows = max(1, (1 << 24) // (plan.H * plan.F))
        lib_err = max(
            torch.abs(y[..., o0:o0 + rows, :, :]
                      - view(pr, pi, slice(o0, o0 + rows))).max().item()
            for o0 in range(0, len(plan.xoff), rows))
        del y
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
        lib_err = torch.abs(lib().reshape(pr.shape)
                            - torch.complex(pr, pi)).max().item()
    if lib is not None:
        check(lib_err <= tol, f"{kind} yardstick disagrees with the plain "
              f"version: {lib_err:.3e} > tol {tol:.3e}")
        out["library_ms"] = time_ms(lib, reps)
    del xr, xi, wr, wi, pr, pi, lib
    torch.cuda.empty_cache()
    return out


def run_one_pass(kind, plan, bx, by, width, seed, ms3):
    """The kernel's one-pass TF32 form (``passes=1``: precision 'default')
    on the inputs of its 3-pass check (the same ``seed``) against the
    plain version's TF32 form (operands rounded as the kernel rounds
    them, products in float32), its time beside the 3-pass time ``ms3``,
    and what TF32 costs: its distance to the float32 plain version."""
    import numpy as np
    import torch

    ops = kernel_operands(kind, plan, bx, by, width, seed)
    call, plain, args = ops["call"], ops["plain"], ops["args"]
    lead = ops["xs"] or ops["ws"]
    before = call.one_pass
    kr, ki = call(*args, passes=1)
    torch.cuda.synchronize()
    check(call.one_pass == before + 1,
          f"{kind}: the one-pass launch was not counted as one")
    err, scale, _ = plain_error(kr, ki, plain_chunks(plain, args, width,
                                                     tf32=True), lead)
    tol = ONE_PASS_RTOL * scale + ONE_PASS_ATOL
    check(np.isfinite(err) and err <= tol,
          f"{kind} one-pass form at width {width}: disagrees with the plain "
          f"TF32 form: max|d| {err:.3e} > tol {tol:.3e}")
    fp32_err, _, _ = plain_error(kr, ki, plain_chunks(plain, args, width),
                                 lead)
    del kr, ki
    reps = 5 if plan.flops * width > 1e12 or ops["y_n"] > 1 << 28 else 20
    ms = time_ms(lambda: call(*args, passes=1), reps)
    out = dict(step=describe(kind, plan), width=width, one_pass_ms=ms,
               three_pass_ms=ms3, one_pass_max_abs_err=err,
               one_pass_tol=tol, tf32_vs_fp32_rel=fp32_err / scale)
    print(f"  one-pass TF32 form ({out['step']}) width {width}: ms "
          f"{ms:.4f} against the 3-pass {ms3:.4f} ({ms3 / ms:.2f}x); max|d| "
          f"to the plain TF32 form {err:.3e} (tol {tol:.2e}); to the "
          f"float32 plain {fp32_err / scale:.2e} of max|plain|", flush=True)
    del ops, args
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


def compile_dense_paths():
    """The dense workload's two whole-state paths: the off form
    (``scheme.contraction_scheme(..., fuse=False, negotiate=False)``) and
    the default form that ``load_plan`` compiles, each at width 1 (nothing
    is sliced).  The reference is both fixtures' 11000 amplitudes."""
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.plan_io import plan_from_dict
    from artensor_tpu_torch.runtime import scheme

    ref = {}
    for path in DENSE_FIXTURES:
        ref.update(load_fixture(path))
    with open(DENSE_PLAN) as f:
        pd = json.load(f)
    sim = TensorNetworkSimulation.from_circuit(random_circuit(**CIRCUIT))
    t0 = time.perf_counter()
    sim.order, sim.slicing_bonds, sim.ctree = plan_from_dict(pd)
    sim._set_scheme(*scheme.contraction_scheme(sim.ctree, fuse=False,
                                               negotiate=False))
    off = path_state("dense", "off", sim, ref, 1, time.perf_counter() - t0,
                     {})
    sim = TensorNetworkSimulation.from_circuit(random_circuit(**CIRCUIT))
    t0 = time.perf_counter()
    sim.load_plan(DENSE_PLAN)
    dflt = path_state("dense", "default", sim, ref, 1,
                      time.perf_counter() - t0, dict(scheme.LAST_COMPILE))
    return [off, dflt]


def compile_block_path(dense):
    """The block walk's scheme on the dense default path's simulation:
    ``D_OUT`` open legs sliced post hoc and the default form recompiled,
    as ``contraction_output_blocks`` does (the legs are restored at
    once); a slice instance of it is one block."""
    from artensor_tpu_torch.runtime import scheme
    from artensor_tpu_torch.simulation import _dense_shard_setup

    sim = dense["sim"]
    t0 = time.perf_counter()
    steps, axes, chosen, output_bonds, k, restore = \
        _dense_shard_setup(sim, D_OUT)
    restore()
    check(k == 0, f"the dense plan slices {k} bonds: a block has 2^{k} "
          "slices")
    return block_path(sim, "dense-blocks", "default", steps, axes, chosen,
                      k, D_OUT, dense["ref"], time.perf_counter() - t0,
                      dict(scheme.LAST_COMPILE), 2 ** len(output_bonds))


def block_path(sim, name, form, steps, axes, chosen, k, d_out, ref,
               compile_s, stats, out_elems, planned=False):
    """A block walk's state (``path_state`` at width 1: a slice instance
    of the block scheme ``steps`` is one slice of one block; 2^k slices a
    block), with the steps the walk runs once (slice-invariant:
    ``census_once``) apart from those it runs a slice (``census``)."""
    from collections import Counter
    from types import SimpleNamespace

    from artensor_tpu_torch.runtime import gatherk, metrics
    from artensor_tpu_torch.runtime.executor import (precompute_static_steps,
                                                     split_invariant_steps)
    from artensor_tpu_torch.runtime.sparse import kernel_kind

    view = SimpleNamespace(steps=steps, slicing_axes=axes,
                           slicing_bonds=chosen + list(sim.slicing_bonds),
                           tensors=sim.tensors)
    out = path_state(name, form, view, ref, 1, compile_s, stats, out_elems)
    # the walk runs the slice-invariant steps once, the rest per slice
    run_steps, _ = precompute_static_steps(
        steps, [sim.tensors[i] for i in range(len(sim.tensors))], axes)
    once, rest = split_invariant_steps(run_steps, axes)
    census = lambda st: Counter(kernel_kind(s) or "dot" for s in st)
    bat = dict(zip(map(id, run_steps), operand_batching(run_steps, axes)))

    def gk_forms(st):
        c = Counter()
        for s in st:
            if kernel_kind(s) == "gk":
                bx, by = bat[id(s)]
                xs, ws = (bx, by) if s.lane.w_is_j else (by, bx)
                c[gatherk.gk_form(s.lane, 1, xs, ws)] += 1
        return {"gk": c, "ggk": Counter()}

    est_once = metrics.scheme_wall_estimate(once, 0, slicing_axes=axes)[0]
    est_rest = metrics.scheme_wall_estimate(rest, d_out + k,
                                            slicing_axes=axes, width=1)[0]
    out.update(name=name, sim=sim, d_out=d_out, k=k, planned=planned,
               census=census(rest),
               census_once=census(once), forms=gk_forms(rest),
               forms_once=gk_forms(once), est_s=est_once + est_rest,
               est_block_s=est_rest / 2 ** d_out)
    print(f"scheme {name}: {len(once)} steps run once "
          f"{json.dumps(dict(sorted(out['census_once'].items())))}, "
          f"{len(rest)} per slice "
          f"{json.dumps(dict(sorted(out['census'].items())))}, 2^{k} "
          f"slices a block; wall estimate of the walk "
          f"{est_once + est_rest:.4f} s ({est_once:.4f} s once, "
          f"{est_rest / 2 ** d_out * 1e3:.3f} ms a block)", flush=True)
    return out


def path_state(name, form, sim, ref, W, compile_s, stats, out_elems=None):
    """One path's state; ``W`` None: the width the wall estimate picks.
    Its modeled peak is ``metrics.scheme_device_peak_bytes`` plus, when a
    bond is sliced, the sliced runner's static accumulator: a split pair
    of the output's ``out_elems`` (default: the simulation's output)."""
    from collections import Counter

    import numpy as np

    from artensor_tpu_torch.runtime import gatherk, metrics
    from artensor_tpu_torch.runtime.executor import precompute_static_steps
    from artensor_tpu_torch.runtime.sparse import kernel_kind, scheme_digest

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
        run_steps, k, slicing_axes=sim.slicing_axes, width=W)
    if out_elems is None:
        out_elems = 2 ** len(sim.output_bonds) * (
            len(sim.bitstrings_sorted) if sim.pattern == "sparse" else 1)
    model_peak = metrics.scheme_device_peak_bytes(
        run_steps, W, sim.slicing_axes) + (8 * out_elems if k else 0)
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
          f"slice_batch {W}; wall estimate at that width "
          f"{est_s:.4f} s; modeled peak at width {W} "
          f"{model_peak / 2 ** 30:.3f} GiB, staged operands "
          f"{staged / 2 ** 30:.3f} GiB", flush=True)
    cases = kernel_cases(run_steps, operand_batching(run_steps,
                                                     sim.slicing_axes))
    # the floor under the run (``bench``'s roofline_s) and the scheme's
    # digest (sparse: phase 9 holds the CLI's scheme to it)
    roof_s = n_slices * metrics.scheme_roofline_seconds(run_steps)
    digest = scheme_digest(sim.steps) \
        if getattr(sim, "pattern", None) == "sparse" else None
    forms = {}   # GK and GGK steps by the form gatherk.gk_form picks
    for kind in ("gk", "ggk"):
        forms[kind] = Counter()
        for plan, bx, by in cases.get(kind, []):
            xs, ws = (bx, by) if plan.w_is_j else (by, bx)
            forms[kind][gatherk.gk_form(plan, W, xs, ws)] += 1
    return dict(name=label, workload=name, form=form, sim=sim, ref=ref, W=W,
                compile_s=compile_s, compile_stats=stats, n_slices=n_slices,
                census=census, cases=cases, forms=forms, est_s=est_s,
                model_peak=model_peak, staged=staged, roof_s=roof_s,
                digest=digest)


def report(label, r):
    print(f"kernel {label} ({r['step']}) width {r['width']}, checked in "
          f"{r.get('check_s', 0.0):.2f} s: "
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


SEEN = {}   # call_key -> result: a kernel call made once for every path


def call_key(kind, plan, bx, by, width, f64):
    """What a GK kernel call depends on (its operands' sizes and width
    axes, its index tables and scalars): two steps of equal keys, on one
    path or two (the block walk's slice-invariant steps are the default
    whole-state path's), are one call, checked once.  Other kinds: the
    plan object itself."""
    if kind != "gk":
        return (kind, id(plan), bx, by, width, f64)
    import hashlib

    import numpy as np

    tables = hashlib.sha1(b"".join(
        np.ascontiguousarray(t, dtype=np.int64).tobytes()
        for t in (plan.xoff, plan.yoff, plan.koff))).hexdigest()
    return (kind, plan.w_is_j, plan.K, plan.H, plan.F, plan.hstride,
            plan.x_elems, plan.y_elems, tuple(plan.x_dims), plan.x_roles,
            tables, bx, by, width, f64)


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
        at_w = {}       # step index -> its result at the path's width
        for i, width in [(i, W) for i in range(len(cases[kind]))] + (
                [(largest, 1)] if W > 1 else []):
            plan, bx, by = cases[kind][i]
            f64 = (kind in F64_KINDS and i == largest
                   and width == W)
            label = f"{path['name']} {kind} step {i + 1}/{len(cases[kind])}"
            key = call_key(kind, plan, bx, by, width, f64)
            if key in SEEN:
                r = SEEN[key]
                print(f"kernel {label} ({r['step']}) width {width}: the "
                      f"same call as {r['label']}", flush=True)
            else:
                t0 = time.perf_counter()
                r = SEEN[key] = dict(run_kernel(kind, plan, bx, by, width,
                                                seed=n, f64=f64),
                                     label=label)
                r["check_s"] = time.perf_counter() - t0
                report(label, r)
            res["max_err"] = max(res["max_err"], r["max_abs_err"])
            if width != W:
                continue
            at_w[i] = r
            res["ms_per_group"] += r["ms"]
            res["design_bound_ms_per_group"] += r["design_bound_ms"]
            res["fp32_bound_ms_per_group"] += r["bound_ms"]
            res["forms"][r["form"]] = res["forms"].get(r["form"], 0) + 1
            if i == largest:
                res["largest"] = r
            if "costliest" not in res or r["ms"] > res["costliest"]["ms"]:
                res["costliest"] = r
        # the one-pass form at the largest step that runs a tensor-core
        # form (GK and GGK "mma", every Pair step)
        mma = [i for i, r in at_w.items() if r["form"] == "mma"]
        if kind in ONE_PASS_KINDS and mma:
            i = max(mma, key=lambda i: cases[kind][i][0].flops)
            plan, bx, by = cases[kind][i]
            key = ("one-pass",) + call_key(kind, plan, bx, by, W, False)
            if key not in SEEN:
                SEEN[key] = run_one_pass(kind, plan, bx, by, W, seed=n,
                                         ms3=at_w[i]["ms"])
            res["one_pass"] = SEEN[key]
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
        # the one-pass form against the plain TF32 form
        before = pallas_mm.complex_batched_matmul.one_pass
        one = lambda: pallas_mm.complex_batched_matmul(a, b, passes=1)
        kr, ki = one()
        tr, ti = pallas_mm.complex_batched_matmul_plain(a, b, tf32=True)
        torch.cuda.synchronize()
        check(pallas_mm.complex_batched_matmul.one_pass == before + 1,
              "complex_mm: the one-pass launch was not counted as one")
        tref = torch.complex(tr, ti)
        err1 = torch.abs(torch.complex(kr, ki) - tref).max().item()
        tol1 = ONE_PASS_RTOL * torch.abs(tref).max().item() + ONE_PASS_ATOL
        check(np.isfinite(err1) and err1 <= tol1,
              f"complex_mm {step} one-pass form: max|d| {err1:.3e} to the "
              f"plain TF32 form > tol {tol1:.3e}")
        fp32 = torch.abs(torch.complex(kr, ki) - ref).max().item() / scale
        r.update(one_pass=dict(
            step=step, width=1, one_pass_ms=time_ms(one, reps),
            three_pass_ms=r["ms"], one_pass_max_abs_err=err1,
            one_pass_tol=tol1, tf32_vs_fp32_rel=fp32))
        print(f"  one-pass TF32 form ({step}): ms "
              f"{r['one_pass']['one_pass_ms']:.4f} against the 3-pass "
              f"{r['ms']:.4f}; max|d| to the plain TF32 form {err1:.3e} (tol "
              f"{tol1:.2e}); to the float32 plain {fp32:.2e} of max|plain|",
              flush=True)
        out.append(r)
        del a, b, kr, ki, pr, pi, ref, ac, bc, tr, ti, tref
        torch.cuda.empty_cache()
    return out


# a GGK step of GK's mma form (K 32, H 32, F 512: bound by operations),
# for the one-pass check where no path has one: (rx_i, rx_j, riy, rd_i,
# rd_j, B, bi_rows, bj_rows)
GGK_MMA_STEP = (("k0", "k1", "k2", "k3", "k4", "f"),
                ("k0", "k1", "k2", "k3", "k4", "h0", "h1", "h2", "h3", "h4"),
                ("h0", "h1", "h2", "h3", "h4", "f"), (2,) * 5 + (512,),
                (2,) * 10, 2048, 256, 64)


def check_ggk_one_pass():
    """Phase 4c: GGK's mma form on ``GGK_MMA_STEP`` against its plain
    version, and its one-pass TF32 form against the plain TF32 form."""
    import numpy as np

    from artensor_tpu_torch.runtime import gatherk

    *case, B, bi_rows, bj_rows = GGK_MMA_STEP
    rng = np.random.default_rng(7)
    gi = np.sort(rng.integers(0, bi_rows, B))
    gj = rng.integers(0, bj_rows, B)
    old = gatherk.GGK_MIN_WORK
    gatherk.GGK_MIN_WORK = 1
    try:
        plan = gatherk.plan_ggk_step(*case, gi, gj, bi_rows, bj_rows)
    finally:
        gatherk.GGK_MIN_WORK = old
    check(plan is not None and isinstance(plan.row, gatherk.GKPlan)
          and gatherk.gk_form(plan, 1, False, False) == "mma",
          f"the synthetic GGK step does not plan in the mma form "
          f"({gatherk.LAST_REJECT})")
    r = run_kernel("ggk", plan, False, False, 1, seed=300)
    report("ggk synthetic", r)
    r["one_pass"] = run_one_pass("ggk", plan, False, False, 1, seed=300,
                                 ms3=r["ms"])
    return r


def fresh_memory():
    """Free what earlier phases left cached (the caching allocator's free
    blocks, every stream's cuBLAS workspace), so that a run's measured
    peak counts its own allocations: a graph run's warm-up makes the
    capture stream's workspace, an eager run the current stream's."""
    import torch

    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def timed_runs(fn, n=3):
    """Host seconds of ``n`` calls of ``fn``, each to its result's first
    value on the host."""
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        out[0].reshape(-1)[0].item()
        walls.append(time.perf_counter() - t0)
        del out
    return walls


def state_gate(got, ref, chunk=1 << 26):
    """max|got - ref| over two flat split results on the card, and the
    largest share of the fixture gate (``AMP_RTOL*|ref| +
    AMP_RMS_TOL*rms(ref)``) it reaches, a chunk at a time."""
    import torch

    gr, gi = (c.reshape(-1) for c in got)
    rr, ri = (c.reshape(-1) for c in ref)
    rms = (norm2(rr, ri) / rr.numel()) ** 0.5
    d_max = share = 0.0
    for s in range(0, rr.numel(), chunk):
        sl = slice(s, s + chunk)
        d = torch.hypot(gr[sl] - rr[sl], gi[sl] - ri[sl])
        bound = AMP_RTOL * torch.hypot(rr[sl], ri[sl]) + AMP_RMS_TOL * rms
        d_max = max(d_max, d.max().item())
        share = max(share, (d / bound).max().item())
    return d_max, share


def fixture_share(path, res):
    """Worst |d|/bound of a run's flat result against the fixture."""
    import numpy as np
    import torch

    sim, ref = path["sim"], path["ref"]
    if sim.pattern == "sparse":
        amps = sim.field.unwrap(res).reshape(sim.out_shape).transpose(
            sim.permute_dims)
        r = np.array([ref[b] for b in sim.bitstrings_sorted])
    else:
        bits = list(ref)
        idx = torch.as_tensor(flat_index(bits, sim.output_bonds),
                              device=DEVICE)
        amps = (res[0].reshape(-1)[idx].double().cpu().numpy()
                + 1j * res[1].reshape(-1)[idx].double().cpu().numpy())
        r = np.array([ref[b] for b in bits])
    rms = float(np.sqrt(np.mean(np.abs(r) ** 2)))
    return float((np.abs(amps - r) / (AMP_RTOL * np.abs(r)
                                      + AMP_RMS_TOL * rms)).max())


def graph_vs_eager(path, held=0):
    """The path's whole run, eagerly and as graph replay, on the same
    staged inputs (one ``_staged``): the graph run first, from a fresh
    allocator (its peak over its first call, capture included, and over
    three warm runs, less ``held`` and the first call's result, and the
    allocator's largest reserve), then the eager
    one; both warm walls (median of 3), the capture seconds, both
    results against the fixture and against each other (held to the
    fixture's gate, ``state_gate``)."""
    import torch

    from artensor_tpu_torch.runtime import executor as ex

    sim, W, name = path["sim"], path["W"], path["name"]
    fresh_memory()
    torch.cuda.reset_peak_memory_stats()
    field, run_steps, arrays, out_shape, execute, _ = sim._staged(
        torch.device(DEVICE))
    mk = lambda eager: ex.make_sliced_runner(
        execute, run_steps, sim.slicing_axes, len(sim.slicing_bonds),
        out_shape, field, slice_batch=W, eager=eager)
    run = mk(False)
    t0 = time.perf_counter()
    res_g = run(arrays)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    # the warm runs' peak, less the first call's result kept for the
    # comparison (a caller's copy, not the run's)
    torch.cuda.reset_peak_memory_stats()
    walls_g = timed_runs(lambda: run(arrays))
    peak = max(peak, torch.cuda.max_memory_allocated() - held
               - nbytes(*res_g))
    reserved = torch.cuda.max_memory_reserved()
    stats = dict(run.stats)
    check(stats["captures"] == 1 and stats["replays"] ==
          4 * path["n_slices"] // W,
          f"{name}: graph runner stats {stats}")
    del run
    run = mk(True)
    res_e = run(arrays)
    walls_e = timed_runs(lambda: run(arrays))
    del run
    d, share = state_gate(res_g, res_e)
    err_g, err_e = fixture_share(path, res_g), fixture_share(path, res_e)
    est = metrics_seg(run_steps, path["n_slices"], W)["one_s"]
    out = dict(graph_s=statistics.median(walls_g), graph_walls=walls_g,
               graph_est_s=est,
               eager_s=statistics.median(walls_e), eager_walls=walls_e,
               first_s=first_s, capture_s=stats["capture_s"],
               graph_vs_eager_max_abs=d, graph_vs_eager_gate_share=share,
               graph_fixture_share=err_g, eager_fixture_share=err_e,
               peak_gib=peak / 2 ** 30, reserved_gib=reserved / 2 ** 30)
    print(f"graph {name} at width {W}: graph replay {out['graph_s']:.4f} s "
          f"of {['%.4f' % w for w in walls_g]}, eager {out['eager_s']:.4f} "
          f"s of {['%.4f' % w for w in walls_e]}; first call {first_s:.3f} "
          f"s, warm-up and capture {stats['capture_s']:.3f} s; max|graph - "
          f"eager| {d:.3e} ({share:.3e} of the gate); worst |d|/bound vs "
          f"fixture graph {err_g:.3e} eager {err_e:.3e}; estimates: as "
          f"one graph a group {est:.4f} s, eager {path['est_s']:.4f} s; "
          f"graph peak "
          f"{out['peak_gib']:.3f} GiB (model {path['model_peak'] / 2 ** 30:.3f}"
          f" + staged {path['staged'] / 2 ** 30:.3f} + reserve), reserved "
          f"{out['reserved_gib']:.3f} GiB", flush=True)
    check(share <= 1.0, f"{name}: graph and eager runs differ beyond the "
          "gate")
    check(max(err_g, err_e) <= 1.0, f"{name}: a run misses the fixture")
    check_peak(path, peak)
    del res_g, res_e, arrays
    return out


def main_run(path, wrappers, report=None):
    """The path through ``contraction()``, as a user calls it (graph
    replay on the card), from a fresh allocator, its kernels counted on
    the card (``counted_on_card``), with the kernel launch counts of that
    run (``run_counts``).  Checks that it ran at the width asked for."""
    sim, W, name = path["sim"], path["W"], path["name"]
    fresh_memory()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    amps, ran = counted_on_card(lambda: sim.contraction(
        slice_batch=W, device=DEVICE, report=report))
    first_s = time.perf_counter() - t0
    st = sim.run_stats
    check(st["executor"] == "graph" and st["slice_batch"] == W,
          f"{name}: ran as {st['executor']} at width {st['slice_batch']}, "
          f"asked for graph replay at {W}")
    return amps, first_s, run_counts(path, wrappers, ran, st)


def counted_on_card(fn):
    """``fn()`` and the port's kernels that the card ran meanwhile, as the
    kernels count themselves (``kernels.device_runs``: each kernel's first
    thread adds one to its slot, so a graph replay counts as a launch
    does): by kind, and for GK and GGK by form.  Not a ``torch.profiler``
    trace: on the H100 it lost a dense run's device events now and then,
    GK kernels among them (PERF.md)."""
    import torch

    from artensor_tpu_torch.kernels import device_runs

    before = device_runs()
    out = fn()
    torch.cuda.synchronize()
    after = device_runs()
    counts = dict.fromkeys(KERNELS, 0)
    forms = {"gk": {}, "ggk": {}}
    for (kind, form), n in after.items():
        n -= before[kind, form]
        if kind in counts:
            counts[kind] += n
        if kind in forms and n:
            forms[kind][form] = n
    return out, dict(counts=counts, forms=forms)


def run_counts(path, wrappers, ran, st):
    """The kernel launches of the run just made, two ways: the wrappers'
    counts (``launches``, the launches they made: the warm-up group's and
    the steps run once eagerly; a capture records the kernels and a
    replay calls no wrapper), and the kernels that the card ran
    (``device_launches``, the kernels' own counts: the warm-up group's and
    every replay's).  Each is held to the census times the groups it
    covers."""
    launches, forms = check_counts(
        path, {k: f.launches for k, f in wrappers.items()},
        {k: dict(wrappers[k].forms) for k in ("gk", "ggk")},
        st["warmup_groups"], "launches")
    device, device_forms = check_counts(
        path, ran["counts"], ran["forms"],
        st["warmup_groups"] + st["replays"], "kernels run on the card")
    return dict(launches=launches, forms=forms, device_launches=device,
                device_forms=device_forms, replays=st["replays"],
                warmup_groups=st["warmup_groups"])


def drive(path, wrappers):
    """Phase 5 for a sparse path: the run through ``contraction()`` (its
    report, its launch counts, every amplitude against the fixture), then
    graph against eager (``graph_vs_eager``: walls, capture, peak)."""
    import numpy as np

    from artensor_tpu_torch.runtime.metrics import ContractionReport

    sim, ref, W, name = path["sim"], path["ref"], path["W"], path["name"]
    rep = ContractionReport()
    amps, first_s, counts = main_run(path, wrappers, rep)
    print(f"path {name}: first run {first_s:.3f} s (staging, warm-up, "
          f"capture and the counters' reads included); "
          f"{counts_line(counts)}",
          flush=True)
    print(f"report {name}: {rep.summary()}", flush=True)
    check(amps.shape == (len(ref),), f"{name}: amplitude shape {amps.shape}")
    r = np.array([ref[b] for b in sim.bitstrings_sorted])
    worst = amp_check(name, amps, r, sim.bitstrings_sorted)
    print(f"path {name}: mean 2^30|a|^2 "
          f"{(2 ** 30) * float(np.mean(np.abs(amps) ** 2)):.4f}", flush=True)
    cmp = graph_vs_eager(path)
    out = dict(**counts, first_s=first_s,
               warm_s=cmp["graph_s"], walls=cmp["graph_walls"],
               peak_gib=cmp["peak_gib"], compile_s=path["compile_s"],
               compile_stats=path["compile_stats"], slice_batch=W,
               slices=path["n_slices"], census=dict(path["census"]),
               est_s=path["est_s"],
               model_peak_gib=path["model_peak"] / 2 ** 30,
               staged_gib=path["staged"] / 2 ** 30, worst_over_bound=worst,
               report=rep.summary(), graph=cmp, roofline_s=path["roof_s"],
               roofline_achieved=path["roof_s"] / cmp["graph_s"])
    print(f"path {name}: roofline (metrics.scheme_roofline_seconds x "
          f"{path['n_slices']} slices) {path['roof_s']:.4f} s, "
          f"{out['roofline_achieved']:.3f} of the warm wall", flush=True)
    check(0 < out["roofline_achieved"] <= 1,
          f"{name}: roofline {path['roof_s']:.4f} s is not below the warm "
          f"wall {cmp['graph_s']:.4f} s")
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


def warm_walls(sim, W, held=0):
    """Warm wall times of three whole runs (graph replay) after one
    warm-up, and the peak device memory over all four, less ``held``:
    the bytes of a result the caller holds on purpose."""
    import torch

    fresh_memory()
    torch.cuda.reset_peak_memory_stats()
    run = sim.prepare(slice_batch=W, device=DEVICE)
    run()
    torch.cuda.synchronize()
    walls = timed_runs(run)
    peak = torch.cuda.max_memory_allocated() - held
    del run
    torch.cuda.empty_cache()
    return walls, peak


def _qubit(bond):
    return int(str(bond).split("-")[1])


def flat_index(bits, bonds):
    """Index of each bitstring (MSB first, qubit 0 first) in a flat state
    whose axes are the open legs ``bonds`` in order."""
    import numpy as np

    digits = np.array([[int(c) for c in b] for b in bits], dtype=np.int64)
    n = len(bonds)
    return sum(digits[:, _qubit(b)] << (n - 1 - a)
               for a, b in enumerate(bonds))


def norm2(re, im, chunk=1 << 26):
    """Sum of |amplitude|^2 over a flat split state, in float64 on the
    device, a chunk at a time."""
    import torch

    tot = torch.zeros((), dtype=torch.float64, device=re.device)
    fr, fi = re.reshape(-1), im.reshape(-1)
    for s in range(0, fr.numel(), chunk):
        tot += fr[s:s + chunk].double().square().sum() \
            + fi[s:s + chunk].double().square().sum()
    return tot.item()


def amp_check(name, got, ref_vals, bits):
    """The fixture gate over amplitudes keyed by bitstring."""
    import numpy as np

    check(bool(np.isfinite(got).all()), f"{name}: non-finite amplitudes")
    rms = float(np.sqrt(np.mean(np.abs(ref_vals) ** 2)))
    err = np.abs(got - ref_vals)
    bound = AMP_RTOL * np.abs(ref_vals) + AMP_RMS_TOL * rms
    worst = int(np.argmax(err / bound))
    print(f"path {name} amplitudes: {len(got)} vs fixture, max|d| "
          f"{err.max():.3e}, max rel "
          f"{float((err / np.abs(ref_vals)).max()):.3e}, worst |d|/bound "
          f"{float(err[worst] / bound[worst]):.3e} at {bits[worst]}",
          flush=True)
    check(bool((err <= bound).all()),
          f"{name}: amplitudes disagree with the fixture beyond "
          "1e-3*|ref| + 1e-6*rms(ref)")
    return float(err[worst] / bound[worst])


def reset_counts(wrappers):
    for f in wrappers.values():
        f.launches = 0
    for kind in ("gk", "ggk"):
        for form in getattr(wrappers.get(kind), "forms", ()):
            wrappers[kind].forms[form] = 0


def check_counts(path, counts, forms, groups, what):
    """``counts`` (by kind) and ``forms`` (GK and GGK by form) of the run
    just made: each kernel's census times ``groups`` slice groups
    (blocks), plus its steps run once (``census_once``: the block walk's
    slice-invariant steps, run eagerly).  Returns them."""
    name = path["name"]
    once = path.get("census_once", {})
    for kind, n in counts.items():
        want = path["census"].get(kind, 0) * groups + once.get(kind, 0)
        check(n == want, f"{name} {kind}: {n} {what}, expected {want}")
    for kind, by_form in forms.items():
        for form in set(by_form) | set(path["forms"][kind]):
            n = by_form.get(form, 0)
            want = path["forms"][kind].get(form, 0) * groups + \
                path.get("forms_once", {}).get(kind, {}).get(form, 0)
            check(n == want, f"{name} {kind}: {n} {what} of the {form} "
                  f"form, expected {want} (gatherk.gk_form of its steps)")
    return counts, forms


def counts_line(c):
    return (f"launches (warm-up group, by the wrappers) "
            f"{json.dumps(c['launches'])}, kernels run on the card "
            f"(their own counts; warm-up group and {c['replays']} replays) "
            f"{json.dumps(c['device_launches'])}; GK and GGK by form: "
            f"launches {json.dumps(c['forms'])}, run "
            f"{json.dumps(c['device_forms'])}")


def check_peak(path, peak):
    from artensor_tpu_torch.planner.cost import PEAK_RESERVE_BYTES

    covered = path["model_peak"] + path["staged"] + PEAK_RESERVE_BYTES
    check(peak <= covered and path["model_peak"] >= PEAK_MODEL_SHARE * peak,
          f"{path['name']}: measured peak {peak / 2 ** 30:.3f} GiB against "
          f"the modeled {path['model_peak'] / 2 ** 30:.3f} GiB (+ staged "
          f"operands and the runtime reserve: {covered / 2 ** 30:.3f} GiB)")


def drive_dense(path, wrappers):
    """A dense whole-state path end to end through ``prepare()`` (one
    graph, captured at its first call): the launch counts of one run, the
    11000 fixture amplitudes read from the state on the card (the output
    permutation applied to their indices, not to the state), the state's
    norm^2 in float64, then graph against eager (``graph_vs_eager``, the
    state held apart).  Returns the run's numbers and the state (split
    pair, ``output_bonds`` order)."""
    import numpy as np
    import torch

    sim, ref, name = path["sim"], path["ref"], path["name"]
    fresh_memory()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    run = sim.prepare(slice_batch=1, device=DEVICE)
    (re, im), ran = counted_on_card(run)
    first_s = time.perf_counter() - t0
    st = dict(run.stats)
    del run
    check(st["captures"] == 1 and st["replays"] == 1,
          f"{name}: graph runner stats {st}")
    counts = run_counts(path, wrappers, ran, st)
    print(f"path {name}: first run {first_s:.3f} s (staging, warm-up, "
          f"capture and the counters' reads included); "
          f"{counts_line(counts)}",
          flush=True)
    n_q = CIRCUIT["rows"] * CIRCUIT["cols"]
    check(re.numel() == 2 ** len(sim.output_bonds) == 2 ** n_q,
          f"{name}: state of {re.numel()} amplitudes")
    bits = list(ref)
    idx = torch.as_tensor(flat_index(bits, sim.output_bonds), device=DEVICE)
    got = (re.reshape(-1)[idx].double().cpu().numpy()
           + 1j * im.reshape(-1)[idx].double().cpu().numpy())
    worst = amp_check(name, got, np.array([ref[b] for b in bits]), bits)
    nrm = norm2(re, im)
    print(f"path {name}: norm^2 {nrm:.9f} (|norm^2 - 1| "
          f"{abs(nrm - 1):.3e}, limit {NORM_TOL})", flush=True)
    check(abs(nrm - 1) <= NORM_TOL, f"{name}: norm^2 {nrm} off 1")
    cmp = graph_vs_eager(path, held=nbytes(re, im))
    print(f"path {name} warm wall: median {cmp['graph_s']:.4f} s, estimate "
          f"{path['est_s']:.4f} s; peak {cmp['peak_gib']:.3f} GiB measured, "
          f"modeled {path['model_peak'] / 2 ** 30:.3f} GiB (+ staged "
          f"operands {path['staged'] / 2 ** 30:.3f} GiB)", flush=True)
    out = dict(**counts, first_s=first_s,
               warm_s=cmp["graph_s"], walls=cmp["graph_walls"],
               peak_gib=cmp["peak_gib"], compile_s=path["compile_s"],
               compile_stats=path["compile_stats"], slice_batch=1,
               slices=1, census=dict(path["census"]), est_s=path["est_s"],
               model_peak_gib=path["model_peak"] / 2 ** 30,
               staged_gib=path["staged"] / 2 ** 30, norm2=nrm,
               worst_over_bound=worst, graph=cmp)
    return out, (re, im)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def drop_tables(paths):
    """Free the device index tables that the kernel checks and earlier
    runs left on the paths' kernel plans (``_dev``), so that a run's peak
    counts its own (``metrics.kernel_table_bytes``) and no other's."""
    for p in paths:
        for cases in p["cases"].values():
            for plan, _, _ in cases:
                for obj in (plan, getattr(plan, "row", None)):
                    if hasattr(obj, "_dev"):
                        obj._dev.clear()


def block_walk(path, post, eager=False, mode="split"):
    """One ``contraction_output_blocks(d_out)`` walk in field ``mode``
    with ``post`` as its postprocess (``eager``: every step from the
    host, else one graph replayed a slice); returns the results, the
    seconds from the
    generator's start to its last block less the block scheme's compile
    (the post-hoc walk recompiles it each walk, a planned walk never), the
    compile's seconds (``scheme.LAST_COMPILE``: fusion and negotiation,
    the whole of the default form's compile) and the seconds of the
    blocks after the first."""
    from artensor_tpu_torch.runtime import scheme

    sim = path["sim"]
    t0 = time.perf_counter()
    stamps, res = [], []
    for bits, qubits, v in sim.contraction_output_blocks(
            path["d_out"], mode=mode, postprocess=post, device=DEVICE,
            eager=eager):
        stamps.append(time.perf_counter())
        res.append((bits, qubits, v))
    compile_s = 0.0 if path["planned"] else \
        scheme.LAST_COMPILE["fuse_s"] + scheme.LAST_COMPILE["negotiate_s"]
    return (res, stamps[-1] - t0 - compile_s, compile_s,
            stamps[-1] - stamps[0])


def drive_blocks(path, wrappers, state, state_bonds, eager_check=True):
    """A block walk end to end: every block on the card against the
    same block of the whole state ``state`` (axes ``state_bonds``), read
    through an index built on the card; the fixture amplitudes and the
    norm^2 from the blocks; the launch counts of that walk; the warm
    walk (median of 3 after one warm-up; the post-hoc walk recompiles the
    block scheme each walk, timed apart) and its seconds a block; the
    walk's peak memory (less the whole state held here) against the
    model; ``eager_check``: then graph against eager, block by block."""
    import numpy as np
    import torch

    name, ref = path["name"], path["ref"]
    sim, d_out, k = path["sim"], path["d_out"], path["k"]
    n_q = len(state_bonds)
    n, L = 2 ** d_out, n_q - d_out
    full = [c.reshape(-1) for c in state]
    pos = {_qubit(b): a for a, b in enumerate(state_bonds)}
    rms = (norm2(*state) / 2 ** n_q) ** 0.5
    bits = list(ref)
    lead_q = sorted(pos)[:d_out]
    oid_of = np.array([int("".join(b[q] for q in lead_q), 2) for b in bits])
    tab = {}

    def check_block(field, oid, raw):
        if "local" not in tab:      # the block scheme's axes are known now
            lb = sim.block_output_bonds
            ar = torch.arange(2 ** L, device=DEVICE)
            tab["local"] = sum(((ar >> (L - 1 - p)) & 1)
                               << (n_q - 1 - pos[_qubit(b)])
                               for p, b in enumerate(lb))
            tab["fix"] = torch.as_tensor(flat_index(bits, lb),
                                         device=DEVICE)
        sel = np.nonzero(oid_of == oid)[0]
        bb = np.binary_repr(oid, d_out)
        idx = tab["local"] + sum(int(c) << (n_q - 1 - pos[q])
                                 for q, c in zip(lead_q, bb))
        r, i = (c.reshape(-1) for c in raw)
        d = torch.hypot(r - full[0][idx], i - full[1][idx]).max()
        nrm = r.double().square().sum() + i.double().square().sum()
        loc = tab["fix"][torch.as_tensor(sel, device=DEVICE)]
        stats = torch.stack([d.double(), nrm]).float()
        return (torch.cat([r[loc], stats]),
                torch.cat([i[loc], torch.zeros_like(stats)]))

    fresh_memory()
    reset_counts(wrappers)
    (res, walk_s, compile_s, _), ran = counted_on_card(
        lambda: block_walk(path, check_block))
    st = dict(sim.block_run_stats)
    check(st["captures"] == 1 and st["replays"] == n * 2 ** k,
          f"{name}: block graph stats {st}")
    counts = run_counts(path, wrappers, ran, st)
    check(len(res) == n and [r[0] for r in res] ==
          [np.binary_repr(o, d_out) for o in range(n)],
          f"{name}: blocks {[r[0] for r in res]}")
    worst_d = max(float(v[-2].real) for _, _, v in res)
    nrm = sum(float(v[-1].real) for _, _, v in res)
    got = np.zeros(len(bits), dtype=np.complex128)
    for oid, (_, qubits, v) in enumerate(res):
        check(qubits == lead_q, f"{name}: block qubits {qubits}")
        got[np.nonzero(oid_of == oid)[0]] = v[:-2]
    print(f"path {name}: {n} blocks of 2^{L} in {walk_s:.3f} s after a "
          f"{compile_s:.3f} s compile (first walk, counters read); "
          f"{counts_line(counts)};"
          f" max|block - whole state| {worst_d:.3e} (limit "
          f"{BLOCK_TOL} x rms {rms:.3e}); norm^2 {nrm:.9f}", flush=True)
    check(worst_d <= BLOCK_TOL * rms, f"{name}: a block differs from the "
          f"whole state by {worst_d:.3e}")
    check(abs(nrm - 1) <= NORM_TOL, f"{name}: norm^2 {nrm} off 1")
    worst = amp_check(name, got, np.array([ref[b] for b in bits]), bits)

    # warm walks: a postprocess that pulls one value (the walk's own work)
    tab.clear()
    touch = lambda field, oid, raw: tuple(c.reshape(-1)[:1] for c in raw)
    fresh_memory()
    torch.cuda.reset_peak_memory_stats()
    block_walk(path, touch)
    torch.cuda.synchronize()
    walks, compiles, blocks = [], [], []
    for _ in range(3):
        _, a, c, b = block_walk(path, touch)
        walks.append(a)
        compiles.append(c)
        blocks.append(b / (n - 1))
    peak = torch.cuda.max_memory_allocated() - nbytes(*state)
    reserved = torch.cuda.max_memory_reserved()
    warm, per_block = statistics.median(walks), statistics.median(blocks)
    print(f"path {name} warm walk: median {warm:.4f} s of "
          f"{['%.4f' % w for w in walks]} for {n} blocks (the steps run "
          f"once, staging included; the scheme compile apart: "
          f"{['%.3f' % t for t in compiles]} s), estimate "
          f"{path['est_s']:.4f} s; blocks 2-{n} {per_block * 1e3:.3f} ms a "
          f"block, estimate {path['est_block_s'] * 1e3:.3f} ms; peak "
          f"{peak / 2 ** 30:.3f} GiB measured (the whole state held apart),"
          f" modeled {path['model_peak'] / 2 ** 30:.3f} GiB (+ staged "
          f"operands {path['staged'] / 2 ** 30:.3f} GiB), reserved "
          f"{reserved / 2 ** 30:.3f} GiB", flush=True)
    graph = dict(graph_s=warm, graph_walls=walks, capture_s=st["capture_s"],
                 peak_gib=peak / 2 ** 30, reserved_gib=reserved / 2 ** 30)
    if eager_check:
        graph.update(eager_walks(path, touch, warm, per_block, st))
    check_peak(path, peak)
    return dict(**counts, first_s=compile_s + walk_s,
                warm_s=warm, walls=walks, s_per_block=per_block,
                est_block_s=path["est_block_s"], scheme_compile_s=compiles,
                peak_gib=peak / 2 ** 30,
                compile_s=path["compile_s"],
                compile_stats=path["compile_stats"], slice_batch=1,
                slices=n * 2 ** k, blocks=n, census=dict(path["census"]),
                est_s=path["est_s"],
                model_peak_gib=path["model_peak"] / 2 ** 30,
                staged_gib=path["staged"] / 2 ** 30, norm2=nrm,
                max_block_diff=worst_d, worst_over_bound=worst, graph=graph)


def eager_walks(path, touch, warm, per_block, st):
    """Graph against eager on a block walk: the graph walk's blocks kept
    on the card, then an eager walk held to them block by block; two more
    eager walks.  Returns their numbers."""
    name, n = path["name"], 2 ** path["d_out"]
    kept = {}

    def keep(field, oid, raw):
        kept[oid] = tuple(c.clone() for c in raw)
        return touch(field, oid, raw)

    block_walk(path, keep)
    cmp = dict(d=0.0, share=0.0)

    def against(field, oid, raw):
        d, share = state_gate(kept.pop(oid), raw)
        cmp["d"], cmp["share"] = max(cmp["d"], d), max(cmp["share"], share)
        return touch(field, oid, raw)

    walls, blocks = [], []
    for post in (against, touch, touch):
        _, a, _, b = block_walk(path, post, eager=True)
        walls.append(a)
        blocks.append(b / (n - 1))
    check(not kept, f"{name}: {len(kept)} blocks not compared")
    print(f"graph {name}: graph walk {warm:.4f} s ({per_block * 1e3:.3f} ms "
          f"a block), eager walk {statistics.median(walls):.4f} s of "
          f"{['%.4f' % w for w in walls]} "
          f"({statistics.median(blocks) * 1e3:.3f} ms a block); "
          f"capture (first block's warm-up included) {st['capture_s']:.3f}"
          f" s; max|graph - eager| over the blocks {cmp['d']:.3e} "
          f"({cmp['share']:.3e} of the gate)", flush=True)
    check(cmp["share"] <= 1.0, f"{name}: graph and eager walks differ "
          "beyond the gate")
    return dict(eager_s=statistics.median(walls),
                eager_walls=walls,
                eager_s_per_block=statistics.median(blocks),
                graph_vs_eager_max_abs=cmp["d"],
                graph_vs_eager_gate_share=cmp["share"])


def staged(sim):
    """``sim._staged`` on the card: ``(field, run_steps, arrays,
    out_shape, execute, apply_step)``."""
    import torch

    return sim._staged(torch.device(DEVICE))


def drive_segmented(path, held=None):
    """The segmented executor (``runtime/segmented.run_segmented``) on the
    path's staged inputs at ``SEGMENT_STEPS`` steps a segment and as one
    segment, three runs each, at the path's width and (sparse) at
    ``SEGMENT_COST_WIDTH``: the segments, the width used, the capture and
    replay seconds, the per-segment replay cost (the replay seconds'
    difference over the extra replays), the result at the path's width
    against the fixture (and the whole state ``held``, on the dense path)
    and its peak against the model."""
    import torch

    from artensor_tpu_torch.runtime import segmented

    sim, name = path["sim"], path["name"]
    field, run_steps, arrays, out_shape, _, step = staged(sim)
    k = len(sim.slicing_bonds)
    held_b = nbytes(*held) if held is not None else 0
    widths = [path["W"]] + ([SEGMENT_COST_WIDTH]
                            if path["n_slices"] > SEGMENT_COST_WIDTH else [])
    out = {}
    for W in widths:
        rows = {}
        for ss in (SEGMENT_STEPS, len(run_steps)):
            fresh_memory()
            torch.cuda.reset_peak_memory_stats()
            runs, res = [], None
            for _ in range(3):
                res = None      # a run's result is not held over the next
                res = segmented.run_segmented(
                    arrays, run_steps, sim.slicing_axes, k, out_shape,
                    field, step, segment_steps=ss, slice_batch=W)
                runs.append(dict(segmented.LAST_RUN))
                check(runs[-1]["width"] == W and runs[-1]["graphs"],
                      f"{name} segmented: ran {runs[-1]}, asked for "
                      f"graphs at width {W}")
            peak = torch.cuda.max_memory_allocated() - held_b
            rows[ss] = dict(
                segments=runs[-1]["segments"], replays=runs[-1]["replays"],
                replay_s=statistics.median(r["replay_s"] for r in runs),
                capture_s=statistics.median(r["capture_s"] for r in runs),
                peak_gib=peak / 2 ** 30)
            if W == path["W"] and ss == SEGMENT_STEPS:
                share = fixture_share(path, res)
                rows[ss]["fixture_share"] = share
                check(share <= 1.0, f"{name} segmented misses the fixture")
                if held is not None:
                    d, g = state_gate(res, held)
                    rows[ss].update(vs_state_max_abs=d, vs_state_share=g)
                    check(g <= 1.0, f"{name} segmented: differs from the "
                          "whole-group state beyond the gate")
                check_peak(path, peak)
            del res
        seg, one = rows[SEGMENT_STEPS], rows[len(run_steps)]
        extra = (seg["segments"] - one["segments"]) * path["n_slices"] // W
        check(extra > 0, f"{name} segmented: one segment only")
        per_seg = (seg["replay_s"] - one["replay_s"]) / extra
        launch_s = graph_launch_s()
        est = metrics_seg(run_steps, path["n_slices"], W)
        out[W] = dict(rows={str(kk): v for kk, v in rows.items()},
                      per_segment_replay_s=per_seg, graph_launch_s=launch_s,
                      est=est)
        print(f"segmented {name} at width {W}: {seg['segments']} segments "
              f"of {SEGMENT_STEPS} steps, {seg['replays']} group replays: "
              f"replays {seg['replay_s']:.4f} s (capture with warm-up "
              f"{seg['capture_s']:.3f} s) against one segment's "
              f"{one['replay_s']:.4f} s ({one['capture_s']:.3f} s): "
              f"{per_seg * 1e6:.1f} us a segment replay over {extra} extra "
              f"replays (a one-kernel graph's replay, back to back: "
              f"{launch_s * 1e6:.2f} us); estimate {est['seg_s']:.4f} s segmented, "
              f"{est['one_s']:.4f} s as one graph; peak "
              f"{seg['peak_gib']:.3f} GiB; "
              f"{json.dumps({kk: v for kk, v in seg.items() if 'share' in kk or 'max_abs' in kk})}",
              flush=True)
    del arrays
    return out


def graph_launch_s(n=2000):
    """Seconds a replay of a one-kernel graph takes, replayed ``n`` times
    back to back (``executor.GroupGraphs``, as the segmented run replays
    its segments): the launch cost a segment adds to a group."""
    import torch

    from artensor_tpu_torch.runtime.executor import GroupGraphs

    x = torch.zeros(1, device=DEVICE)
    graphs = GroupGraphs(x.device)
    graphs.capture(lambda: x.add_(1))
    for _ in range(10):
        graphs.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        graphs.replay()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    check(x.item() == n + 10, "the one-kernel graph did not run")
    return dt


def metrics_seg(run_steps, n_slices, W):
    """The segmented wall estimate at ``SEGMENT_STEPS`` and as one graph
    (``metrics.segmented_wall_estimate``)."""
    from artensor_tpu_torch.runtime import metrics

    return dict(
        seg_s=metrics.segmented_wall_estimate(run_steps, n_slices, W,
                                              SEGMENT_STEPS)[0],
        one_s=metrics.segmented_wall_estimate(run_steps, n_slices, W,
                                              len(run_steps))[0])


def drive_rescaled(path, held=None):
    """Scientific notation (``runtime/rescaled.py``, width 1): on a sparse
    path through ``contraction(scientific_notation=True)``, on the dense
    path through the rescaled runner on the staged inputs (the state
    stays on the card); t * 10**f against the fixture (and the whole
    state ``held``: its norm^2 too), the wall, the factor and the peak
    against the device model at width 1."""
    import numpy as np
    import torch

    from artensor_tpu_torch.planner.cost import PEAK_RESERVE_BYTES
    from artensor_tpu_torch.runtime import metrics
    from artensor_tpu_torch.runtime.rescaled import make_rescaled_runner

    sim, name, ref = path["sim"], path["name"], path["ref"]
    fresh_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = {}
    if sim.pattern == "sparse":
        amps, f = sim.contraction(scientific_notation=True, device=DEVICE)
        wall = time.perf_counter() - t0
        st = sim.run_stats
        check(st["executor"] == "rescaled" and st["slice_batch"] == 1
              and st["graphs"], f"{name} rescaled: ran {st}")
        r = np.array([ref[b] for b in sim.bitstrings_sorted])
        out["worst_over_bound"] = amp_check(
            f"{name} rescaled", amps * 10.0 ** f, r, sim.bitstrings_sorted)
        mant = float(np.abs(amps).max())
        run_steps = staged(sim)[1]
    else:
        field, run_steps, arrays, out_shape, _, step = staged(sim)
        run = make_rescaled_runner(step, run_steps, sim.slicing_axes,
                                   len(sim.slicing_bonds), out_shape, field)
        t, fac = run(arrays)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = dict(run.stats)
        del run
        f = float(fac)
        mant = max(float(torch.linalg.vector_norm(c, float("inf")))
                   for c in t)
        for c in t:
            c.mul_(10.0 ** f)
        out["worst_over_bound"] = fixture_share(path, t)
        # the renormalised products round elsewhere than the plain ones:
        # held to the state as a block is (BLOCK_TOL x rms)
        out["vs_state_max_abs"], _ = state_gate(t, held)
        rms = (norm2(*held) / held[0].numel()) ** 0.5
        nrm = norm2(*t)
        out["norm2"] = nrm
        check(out["worst_over_bound"] <= 1.0
              and out["vs_state_max_abs"] <= BLOCK_TOL * rms
              and abs(nrm - 1) <= NORM_TOL, f"{name} rescaled: fixture "
              f"{out['worst_over_bound']}, max|d| to the state "
              f"{out['vs_state_max_abs']:.3e} (rms {rms:.3e}), norm^2 {nrm}")
        del t, arrays
    peak = torch.cuda.max_memory_allocated() - (nbytes(*held) if held
                                                is not None else 0)
    model = metrics.scheme_device_peak_bytes(run_steps, 1, sim.slicing_axes)
    out.update(wall_s=wall, factor=f, max_mantissa=mant,
               capture_s=st["capture_s"], replays=st["replays"],
               peak_gib=peak / 2 ** 30, model_peak_gib=model / 2 ** 30)
    print(f"rescaled {name}: {wall:.3f} s at width 1 ({st['replays']} "
          f"replays, warm-up and capture {st['capture_s']:.3f} s), log10 "
          f"factor {f:.6f}, largest |mantissa| {mant:.4f}; worst |d|/bound "
          f"of t*10^f vs fixture {out['worst_over_bound']:.3e}"
          f"{'' if held is None else '; max|d| to the state %.3e, norm^2 %.9f' % (out['vs_state_max_abs'], out['norm2'])}; peak "
          f"{out['peak_gib']:.3f} GiB, model at width 1 "
          f"{out['model_peak_gib']:.3f} GiB (+ staged "
          f"{path['staged'] / 2 ** 30:.3f})", flush=True)
    check(mant < 10.0, f"{name} rescaled: mantissa {mant} not O(1)")
    check(peak <= model + path["staged"] + PEAK_RESERVE_BYTES,
          f"{name} rescaled: peak {peak / 2 ** 30:.3f} GiB over the model")
    return out


class Interrupted(Exception):
    pass


def drive_checkpoint(path):
    """Checkpoint/resume (``runtime/checkpoint.py``) at width
    ``CKPT_WIDTH``, a chunk an eighth of the slices: a run stopped on
    purpose after chunk 3 of 8 (the file then holds slice 3 * chunk),
    resumed through ``contraction(checkpoint_path=...)``, held to the
    fixture; the file is gone at the end."""
    import tempfile

    import numpy as np

    from artensor_tpu_torch.runtime import executor as ex
    from artensor_tpu_torch.runtime.checkpoint import run_sliced_checkpointed

    sim, name, ref = path["sim"], path["name"], path["ref"]
    k = len(sim.slicing_bonds)
    chunk = 2 ** k // 8
    fresh_memory()
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "acc.npz")
        field, run_steps, arrays, out_shape, execute, _ = staged(sim)
        run = ex.make_sliced_runner(execute, run_steps, sim.slicing_axes, k,
                                    out_shape, field, slice_batch=CKPT_WIDTH)

        def stop(done, total):
            if done == 3 * chunk:
                raise Interrupted

        t0 = time.perf_counter()
        try:
            run_sliced_checkpointed(run, arrays, k, out_shape, field, ck,
                                    chunk=chunk, progress=stop)
        except Interrupted:
            pass
        first_s = time.perf_counter() - t0
        check(os.path.exists(ck) and int(np.load(ck)["next_slice"])
              == 3 * chunk, f"{name} checkpoint: no file at slice "
              f"{3 * chunk}")
        del run, arrays
        t0 = time.perf_counter()
        amps = sim.contraction(checkpoint_path=ck, slice_batch=CKPT_WIDTH,
                               device=DEVICE)
        resume_s = time.perf_counter() - t0
        st = sim.run_stats
        check(st["executor"] == "checkpointed" and st["graphs"]
              and st["slice_batch"] == CKPT_WIDTH
              and st["replays"] == 5 * chunk // CKPT_WIDTH,
              f"{name} checkpoint: resumed run {st}")
        check(not os.path.exists(ck), f"{name} checkpoint: file left")
    r = np.array([ref[b] for b in sim.bitstrings_sorted])
    worst = amp_check(f"{name} checkpointed", amps, r, sim.bitstrings_sorted)
    print(f"checkpoint {name}: stopped after chunk 3 of 8 ({chunk} slices "
          f"a chunk, width {CKPT_WIDTH}) in {first_s:.3f} s, resumed chunks "
          f"4-8 in {resume_s:.3f} s ({st['replays']} replays); the file is "
          f"gone", flush=True)
    return dict(stop_s=first_s, resume_s=resume_s, replays=st["replays"],
                worst_over_bound=worst)


# -- 7. the number-field modes ------------------------------------------------

FIELD_PATHS = ("1k/default", "1k-sc25/default", "dense/default")
BASE_MODE = ("split", "naive", "highest", "f32")   # (mode, algo, precision,
FULL_MODES = (("split", "karatsuba", "highest", "f32"),   # storage)
              ("complex", "naive", "highest", "f32"),
              ("fused", "naive", "highest", "f32"),
              ("split", "naive", "high", "f32"))
READ_MODES = (("split", "naive", "default", "f32"),
              ("complex", "naive", "default", "f32"),
              ("split", "naive", "highest", "bf16"),
              ("split", "naive", "highest", "f16"))
ONE_PASS_WRAPPERS = (("runtime.gatherk.gk_call", "mma"),
                     ("runtime.gatherk.ggk_call", "mma"),
                     ("runtime.lanes.pair_call", None))


def mode_name(m):
    mode, algo, precision, storage = m
    return f"{mode}/{algo}/{precision}" + ("" if storage == "f32"
                                          else f"/{storage}")


def as_pair(field, x):
    """A field's value on the card as two real views (re, im)."""
    bufs = field.buffers(x)
    if len(bufs) == 2:
        return bufs
    (t,) = bufs
    if t.is_complex():
        return t.real, t.imag
    v = t.reshape(t.shape[:-1] + (-1, 2))
    return v[..., 0], v[..., 1]


def gather_amps(field, x, idx):
    """The amplitudes at flat indices ``idx`` of a state on the card, as
    complex128 numpy, without a copy of the state."""
    bufs = field.buffers(x)
    if len(bufs) == 2:
        re, im = (c.reshape(-1)[idx] for c in bufs)
    elif bufs[0].is_complex():
        v = bufs[0].reshape(-1)[idx]
        re, im = v.real, v.imag
    else:
        v = bufs[0].reshape(-1, 2)[idx]
        re, im = v[:, 0], v[:, 1]
    return re.double().cpu().numpy() + 1j * im.double().cpu().numpy()


def norm2_any(field, x, chunk=1 << 26):
    """Sum of |amplitude|^2 of any field's state, in float64 on the
    card, a chunk at a time."""
    import torch

    tot = torch.zeros((), dtype=torch.float64, device=DEVICE)
    for c in field.buffers(x):
        f = (torch.view_as_real(c) if c.is_complex() else c).reshape(-1)
        for s in range(0, f.numel(), chunk):
            tot += f[s:s + chunk].double().square().sum()
    return tot.item()


def field_amps(path, field, res):
    """``(amplitudes, fixture values, bitstrings)`` of a run's flat result
    in ``field``'s form: a sparse path's every amplitude, a dense state's
    fixture amplitudes read on the card."""
    import numpy as np
    import torch

    sim, ref = path["sim"], path["ref"]
    if sim.pattern == "sparse":
        bits = sim.bitstrings_sorted
        amps = field.unwrap(res).reshape(sim.out_shape).transpose(
            sim.permute_dims)
    else:
        bits = list(ref)
        idx = torch.as_tensor(flat_index(bits, sim.output_bonds),
                              device=DEVICE)
        amps = gather_amps(field, res, idx)
    return amps, np.array([ref[b] for b in bits]), bits


def amp_errors(amps, r):
    """A reading's errors against the fixture: max|d| / rms(ref), the
    worst |d| / |ref|, the worst share of the gate; finite or not."""
    import numpy as np

    rms = float(np.sqrt(np.mean(np.abs(r) ** 2)))
    err = np.abs(amps - r)
    bound = AMP_RTOL * np.abs(r) + AMP_RMS_TOL * rms
    return dict(finite=bool(np.isfinite(amps).all()),
                max_abs_over_rms=float(err.max() / rms),
                worst_rel=float((err / np.abs(r)).max()),
                worst_over_bound=float((err / bound).max()))


def reset_one_pass():
    for spec, _ in ONE_PASS_WRAPPERS:
        wrapper(spec).one_pass = 0


def one_pass_counts():
    return sum(wrapper(spec).one_pass for spec, _ in ONE_PASS_WRAPPERS)


def mma_launches(wrappers):
    """The wrappers' launches in a tensor-core form (GK and GGK "mma",
    Pair): what runs in one pass under precision 'default'."""
    return (wrappers["gk"].forms["mma"] + wrappers["ggk"].forms["mma"]
            + wrappers["pair"].launches)


def mode_counts(path, field, wrappers, st, precision):
    """The kernels of a mode's first run, by the wrappers' counts (the
    warm-up group's launches; the capture records the same calls, and a
    replay runs what it recorded).  Split float32 mode: the census, as on
    the main run, and one-pass launches exactly under 'default'.  Any
    other mode: no launch at all."""
    launched = {k: f.launches for k, f in wrappers.items()}
    if field.supports_lanes:
        check_counts(path, launched,
                     {k: dict(wrappers[k].forms) for k in ("gk", "ggk")},
                     st["warmup_groups"], "launches")
        want = mma_launches(wrappers) if precision == "default" else 0
        check(one_pass_counts() == want, f"{path['name']} "
              f"{precision}: {one_pass_counts()} one-pass launches, "
              f"expected {want}")
    else:
        check(not any(launched.values()) and one_pass_counts() == 0,
              f"{path['name']}: a kernel launched outside split float32 "
              f"mode: {launched}")
    return launched


def drive_fields(path, wrappers, held=None):
    """Phase 7 on a path: the split/naive/highest run, then each mode of
    ``FULL_MODES`` (held to the fixture gate; a dense state's norm^2 too;
    split at 'high' equal to 'highest', max|d| 0) and of ``READ_MODES``
    (errors printed, held only to finite values), at the path's width.
    A sparse path runs each float32-storage mode through ``contraction()``
    (its out-of-memory halving included: the width used is read from
    ``run_stats``) and its warm walls through ``prepare()``; a dense path
    and the reduced storage run ``make_field`` + the sliced runner on the
    staged inputs.  The kernel launches of each first run
    (``mode_counts``); the warm wall (median of 3, graph replay), the
    capture seconds, the peak (less ``held``, the default state kept for
    the block walk) and the width used."""
    import numpy as np
    import torch

    from artensor_tpu_torch.ops.field import make_field
    from artensor_tpu_torch.runtime import executor as ex

    sim, W, name = path["sim"], path["W"], path["name"]
    sparse = sim.pattern == "sparse"
    held_b = nbytes(*held) if held is not None else 0
    out, base, arrays = {}, None, None
    for m in (BASE_MODE,) + FULL_MODES + READ_MODES:
        mode, algo, precision, storage = m
        label = f"{name} {mode_name(m)}"
        field = make_field(np.complex64, precision, mode, algo, storage)
        fresh_memory()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(wrappers)
        reset_one_pass()
        t0 = time.perf_counter()
        if sparse and storage == "f32":
            amps = sim.contraction(precision=precision, mode=mode,
                                   algo=algo, slice_batch=W, device=DEVICE)
            st = dict(sim.run_stats)
            width, res = st["slice_batch"], None
        else:
            _, run_steps, arrays, out_shape, execute, _ = sim._staged(
                torch.device(DEVICE), field)
            run = ex.make_sliced_runner(
                execute, run_steps, sim.slicing_axes,
                len(sim.slicing_bonds), out_shape, field, slice_batch=W)
            res = run(arrays)
            torch.cuda.synchronize()
            st, width = dict(run.stats), W
            amps = None
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held_b
        launched = mode_counts(path, field, wrappers, st, precision)
        if res is not None:
            amps, r, bits = field_amps(path, field, res)
        else:
            r = np.array([path["ref"][b] for b in sim.bitstrings_sorted])
            bits = sim.bitstrings_sorted
        errs = amp_errors(amps, r)
        row = dict(width=width, halved=width != W, first_s=first_s,
                   capture_s=st["capture_s"], captures=st["captures"],
                   launches=launched, **errs)
        if not sparse:
            row["norm2"] = norm2_any(field, res)
        # warm walls, graph replay
        torch.cuda.reset_peak_memory_stats()
        if res is None:
            run = sim.prepare(slice_batch=width, device=DEVICE,
                              precision=precision, mode=mode, algo=algo)
            run()
            kept = 0
            walls = timed_runs(run)
        else:
            kept = nbytes(*field.buffers(res))
            walls = timed_runs(lambda: run(arrays))
        del run
        peak = max(peak, torch.cuda.max_memory_allocated() - held_b - kept)
        row.update(warm_s=statistics.median(walls), walls=walls,
                   peak_gib=peak / 2 ** 30)
        if m == BASE_MODE:
            base = dict(amps=amps, warm_s=row["warm_s"])
            if held is not None:
                d, _ = state_gate(as_pair(field, res), held)
                row["vs_default_state_max_abs"] = d
        row["split_naive_warm_s"] = base["warm_s"]
        if m == ("split", "naive", "high", "f32"):
            d = float(np.abs(amps - base["amps"]).max())
            if held is not None:
                d = max(d, state_gate(as_pair(field, res), held)[0])
            row["vs_highest_max_abs"] = d
            check(d == 0.0, f"{label}: differs from 'highest' by {d:.3e}")
        check(errs["finite"], f"{label}: non-finite amplitudes")
        if m == BASE_MODE or m in FULL_MODES:
            amp_check(label, amps, r, bits)
            if not sparse:
                check(abs(row["norm2"] - 1) <= NORM_TOL,
                      f"{label}: norm^2 {row['norm2']} off 1")
        print(f"fields {label}: width {width}{' (halved)' if width != W else ''}"
              f", warm wall {row['warm_s']:.4f} s of "
              f"{['%.4f' % w for w in walls]} (split/naive "
              f"{base['warm_s']:.4f} s), first call {first_s:.3f} s "
              f"(capture {st['capture_s']:.3f} s, {st['captures']} "
              f"captures), peak {row['peak_gib']:.3f} GiB; max|d|/rms "
              f"{errs['max_abs_over_rms']:.3e}, worst |d|/|ref| "
              f"{errs['worst_rel']:.3e}, worst |d|/bound "
              f"{errs['worst_over_bound']:.3e}"
              f"{'' if sparse else ', norm^2 %.9f' % row['norm2']}; "
              f"launches {json.dumps(launched)}, one-pass "
              f"{one_pass_counts()}",
              flush=True)
        out[mode_name(m)] = row
        res = amps = arrays = None   # nothing of a mode outlives its row
    return out


def drive_mode_walk(path, mode, state, state_bonds):
    """One ``contraction_output_blocks(D_OUT, mode=mode)`` walk: every
    block against the same block of the default state on the card
    (within ``BLOCK_TOL`` x its rms), no kernel step run as a kernel, the
    walk's seconds (the block scheme's compile apart) and a block's."""
    import numpy as np
    import torch

    sim, name = path["sim"], path["name"]
    n_q = len(state_bonds)
    L = n_q - D_OUT
    full = [c.reshape(-1) for c in state]
    pos = {_qubit(b): a for a, b in enumerate(state_bonds)}
    lead_q = sorted(pos)[:D_OUT]
    rms = (norm2(*state) / 2 ** n_q) ** 0.5
    tab = {}

    def against(field, oid, raw):
        if "local" not in tab:
            ar = torch.arange(2 ** L, device=DEVICE)
            tab["local"] = sum(((ar >> (L - 1 - p)) & 1)
                               << (n_q - 1 - pos[_qubit(b)])
                               for p, b in enumerate(sim.block_output_bonds))
        idx = tab["local"] + sum(int(c) << (n_q - 1 - pos[q]) for q, c in
                                 zip(lead_q, np.binary_repr(oid, D_OUT)))
        r, i = (c.reshape(-1) for c in as_pair(field, raw))
        z = field.zeros((1,), DEVICE)
        field.buffers(z)[0].reshape(-1)[0] = torch.hypot(
            r - full[0][idx], i - full[1][idx]).max()
        return z

    kernel_calls = {k: wrapper(v[0]).launches for k, v in KERNELS.items()}
    fresh_memory()
    torch.cuda.reset_peak_memory_stats()
    res, walk_s, compile_s, rest_s = block_walk(path, against, mode=mode)
    peak = torch.cuda.max_memory_allocated() - nbytes(*state)
    st = dict(sim.block_run_stats)
    n = 2 ** D_OUT
    check(len(res) == n and all(q == lead_q for _, q, _ in res),
          f"{name} {mode} walk: blocks {[b for b, _, _ in res]}")
    worst = max(float(v.reshape(-1)[0].real) for _, _, v in res)
    check(all(wrapper(v[0]).launches == kernel_calls[k]
              for k, v in KERNELS.items()),
          f"{name} {mode} walk: a kernel wrapper launched")
    out = dict(walk_s=walk_s, compile_s=compile_s,
               s_per_block=rest_s / (n - 1), captures=st["captures"],
               replays=st["replays"], capture_s=st["capture_s"],
               max_block_diff=worst, rms=rms, peak_gib=peak / 2 ** 30)
    print(f"fields {name} {mode} walk: {n} blocks in {walk_s:.3f} s after "
          f"a {compile_s:.3f} s compile ({out['s_per_block'] * 1e3:.3f} ms "
          f"a block after the first; capture {st['capture_s']:.3f} s); "
          f"max|block - default state| {worst:.3e} (limit {BLOCK_TOL} x "
          f"rms {rms:.3e}); peak {out['peak_gib']:.3f} GiB", flush=True)
    check(worst <= BLOCK_TOL * rms, f"{name} {mode} walk: a block differs "
          f"from the default state by {worst:.3e}")
    return out


def no_kernel_launched(before, what):
    launched = {k: wrapper(v[0]).launches - before[k]
                for k, v in KERNELS.items()}
    check(not any(launched.values()), f"{what}: kernels launched "
          f"{launched} outside split float32 mode")


def kernel_launches():
    return {k: wrapper(v[0]).launches for k, v in KERNELS.items()}


def drive_segmented_fused(path):
    """The segmented executor in the fused mode on the path's width
    (``SEGMENT_STEPS`` steps a segment): the result against the fixture,
    no kernel launched, the wall of a run (capture included) and of its
    replays."""
    import numpy as np
    import torch

    from artensor_tpu_torch.ops.field import make_field
    from artensor_tpu_torch.runtime import segmented

    sim, name, W = path["sim"], path["name"], path["W"]
    field = make_field(np.complex64, "highest", "fused")
    _, run_steps, arrays, out_shape, _, step = sim._staged(
        torch.device(DEVICE), field)
    before = kernel_launches()
    fresh_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = segmented.run_segmented(arrays, run_steps, sim.slicing_axes,
                                  len(sim.slicing_bonds), out_shape, field,
                                  step, segment_steps=SEGMENT_STEPS,
                                  slice_batch=W)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = dict(segmented.LAST_RUN)
    peak = torch.cuda.max_memory_allocated()
    no_kernel_launched(before, f"{name} segmented fused")
    check(run["graphs"] and run["segments"] > 1,
          f"{name} segmented fused: ran {run}")
    amps, r, bits = field_amps(path, field, res)
    worst = amp_check(f"{name} segmented fused", amps, r, bits)
    print(f"fields segmented fused {name}: width {run['width']} (asked "
          f"{W}), {run['segments']} segments, {run['replays']} replays in "
          f"{run['replay_s']:.4f} s, capture {run['capture_s']:.3f} s, "
          f"first run {wall:.3f} s, peak {peak / 2 ** 30:.3f} GiB",
          flush=True)
    return dict(width=run["width"], segments=run["segments"],
                replay_s=run["replay_s"], capture_s=run["capture_s"],
                wall_s=wall, peak_gib=peak / 2 ** 30,
                worst_over_bound=worst)


def drive_rescaled_complex(path):
    """Scientific notation in the complex mode through
    ``contraction(scientific_notation=True, mode='complex')``: t * 10**f
    against the fixture, no kernel launched, the wall."""
    import numpy as np

    sim, name, ref = path["sim"], path["name"], path["ref"]
    before = kernel_launches()
    fresh_memory()
    t0 = time.perf_counter()
    t, f = sim.contraction(scientific_notation=True, mode="complex",
                           device=DEVICE)
    wall = time.perf_counter() - t0
    st = dict(sim.run_stats)
    no_kernel_launched(before, f"{name} rescaled complex")
    check(st["executor"] == "rescaled" and st["graphs"],
          f"{name} rescaled complex: ran {st}")
    r = np.array([ref[b] for b in sim.bitstrings_sorted])
    worst = amp_check(f"{name} rescaled complex", t * 10.0 ** f, r,
                      sim.bitstrings_sorted)
    print(f"fields rescaled complex {name}: {wall:.3f} s at width 1 "
          f"({st['replays']} replays, capture {st['capture_s']:.3f} s), "
          f"log10 factor {f:.6f}", flush=True)
    return dict(wall_s=wall, factor=f, replays=st["replays"],
                capture_s=st["capture_s"], worst_over_bound=worst)


CKPT_MODE_WIDTHS = (16, 32)   # written at the first, resumed at the second


def drive_checkpoint_complex(path):
    """Checkpoint/resume in the complex mode: a run at width 16 stopped
    after chunk 3 of 8 (slice 3 * 2^k / 8), resumed through
    ``contraction(checkpoint_path=..., slice_batch=32, mode='complex')``:
    chunks of 32 from there, the last of them the rest of the run at a
    width that 32 does not divide (one capture for each width used), held
    to the fixture; the file (``acc``: a complex array) is gone at the
    end."""
    import tempfile

    import numpy as np
    import torch

    from artensor_tpu_torch.ops.field import make_field
    from artensor_tpu_torch.runtime import executor as ex
    from artensor_tpu_torch.runtime.checkpoint import run_sliced_checkpointed

    sim, name, ref = path["sim"], path["name"], path["ref"]
    k = len(sim.slicing_bonds)
    chunk = 2 ** k // 8
    w1, w2 = CKPT_MODE_WIDTHS
    left = 2 ** k - 3 * chunk
    check(left % w2 != 0, f"{name}: {left} slices left; the resume must "
          f"leave a rest at width {w2}")
    field = make_field(np.complex64, "highest", "complex")
    before = kernel_launches()
    fresh_memory()
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "acc.npz")
        _, run_steps, arrays, out_shape, execute, _ = sim._staged(
            torch.device(DEVICE), field)
        run = ex.make_sliced_runner(execute, run_steps, sim.slicing_axes, k,
                                    out_shape, field, slice_batch=w1)

        def stop(done, total):
            if done == 3 * chunk:
                raise Interrupted

        try:
            run_sliced_checkpointed(run, arrays, k, out_shape, field, ck,
                                    chunk=chunk, progress=stop)
        except Interrupted:
            pass
        saved = np.load(ck)
        check(sorted(saved.files) == ["acc", "next_slice"]
              and int(saved["next_slice"]) == 3 * chunk
              and np.iscomplexobj(saved["acc"]),
              f"{name} checkpoint complex: file {saved.files}")
        del run, arrays, saved
        t0 = time.perf_counter()
        amps = sim.contraction(mode="complex", checkpoint_path=ck,
                               slice_batch=w2, device=DEVICE)
        resume_s = time.perf_counter() - t0
        st = dict(sim.run_stats)
        check(not os.path.exists(ck), f"{name} checkpoint complex: file "
              "left")
    no_kernel_launched(before, f"{name} checkpoint complex")
    # the resumed chunks (contraction's chunk: max(width, 2^k / 8)) and
    # the group widths each one runs at
    widths, groups, start = set(), 0, 3 * chunk
    while start < 2 ** k:
        n = min(max(w2, chunk), 2 ** k - start)
        for w, g in ex.group_widths(n, w2):
            widths.add(w)
            groups += g
        start += n
    check(st["executor"] == "checkpointed" and st["graphs"]
          and st["captures"] == len(widths) and st["replays"] == groups,
          f"{name} checkpoint complex: resumed run {st}, expected captures "
          f"at widths {sorted(widths)} and {groups} replays")
    r = np.array([ref[b] for b in sim.bitstrings_sorted])
    worst = amp_check(f"{name} checkpoint complex", amps, r,
                      sim.bitstrings_sorted)
    print(f"fields checkpoint complex {name}: stopped at slice {3 * chunk} "
          f"(width {w1}), resumed at width {w2} in {resume_s:.3f} s "
          f"({st['replays']} replays, {st['captures']} captures: widths "
          f"{sorted(widths)})", flush=True)
    return dict(resume_s=resume_s, replays=st["replays"],
                captures=st["captures"], widths=sorted(widths),
                worst_over_bound=worst)


# -- 8. the planned paths -------------------------------------------------------

def native_build():
    """The native planner search, built from the checkout's source (never
    the Python search in its place); returns its build seconds."""
    from artensor_tpu_torch import native

    t0 = time.perf_counter()
    ok = native.native_available()
    check(ok, f"the native planner search did not build: "
          f"{native.build_error()}")
    print(f"planner: native search built in {native.BUILD_SECONDS:.2f} s "
          f"(0: a cached build; loaded in {time.perf_counter() - t0:.2f} s)",
          flush=True)
    return native.BUILD_SECONDS


def plan_summary(sim, committed=None):
    """The plan's sliced bonds, complexity and total work (log10 of the
    per-slice multiply-adds x 2^slices), and whether it is ``committed``
    (a plan file) bond for bond."""
    import math

    from artensor_tpu_torch.plan_io import plan_to_dict

    tc, sc, mc = sim.ctree.complexity()
    out = dict(plan_s=sim.plan_seconds, compile_s=sim.compile_seconds,
               sliced=list(sim.slicing_bonds), tc=tc, sc=sc, mc=mc,
               total_log10=tc + len(sim.slicing_bonds) * math.log10(2))
    if committed is not None:
        with open(committed) as f:
            ref = json.load(f)
        d = plan_to_dict(sim.ctree)
        out["equals_committed"] = all(d[k] == ref[k] for k in (
            "order", "slicing_bonds", "tensor_bonds"))
    return out


def drive_planned(wrappers):
    """8a: the 1k batch planned by the port, as a user calls it
    (``quantum_circuit_simulation(circuit, bits, sc_target=PLANNED_SC)``:
    plan, default scheme compile, run at width 1 on the card), every
    amplitude against the fixture keyed by the returned bitstrings, its
    kernels counted on the card; then that simulation at the model's width
    as phase 3 and 5 drive a path (each kernel step against its plain
    version; through ``contraction()``: launches against the census, the
    warm wall, capture, peak against the model).  Returns the path's state
    and its run."""
    import numpy as np

    from artensor_tpu_torch import (TensorNetworkCircuit,
                                    TensorNetworkSimulation,
                                    quantum_circuit_simulation,
                                    random_circuit)
    from artensor_tpu_torch.runtime import sparse

    build_s = native_build()
    ref = load_fixture(PATHS["1k"][1])
    kept = []
    real = TensorNetworkSimulation.prepare_contraction

    def keep(self, *a, **k):     # the one-shot's simulation, for its numbers
        kept.append(self)
        return real(self, *a, **k)

    fresh_memory()
    reset_counts(wrappers)
    TensorNetworkSimulation.prepare_contraction = keep
    try:
        t0 = time.perf_counter()
        (amps, bits), ran = counted_on_card(
            lambda: quantum_circuit_simulation(
                TensorNetworkCircuit(random_circuit(**CIRCUIT)), list(ref),
                sc_target=PLANNED_SC))
        one_shot_s = time.perf_counter() - t0
    finally:
        TensorNetworkSimulation.prepare_contraction = real
    (sim,) = kept
    plan = plan_summary(sim, PATHS["1k"][0])
    stats = dict(sparse.LAST_COMPILE)
    st = sim.run_stats
    check(st["executor"] == "graph" and st["slice_batch"] == 1,
          f"1k-planned: the one-shot ran as {st['executor']} at width "
          f"{st['slice_batch']}")
    first_s = one_shot_s - plan["plan_s"] - plan["compile_s"]
    print(f"path 1k-planned: quantum_circuit_simulation in "
          f"{one_shot_s:.3f} s: planner {plan['plan_s']:.3f} s, "
          f"{len(plan['sliced'])} sliced bonds {plan['sliced']}, "
          f"complexity tc {plan['tc']:.6f} sc {plan['sc']:.1f} mc "
          f"{plan['mc']:.6f} (total log10 {plan['total_log10']:.6f}); "
          f"equal to the committed sc24 plan: {plan['equals_committed']}; "
          f"scheme compile {plan['compile_s']:.3f} s (fusion "
          f"{stats['fuse_s']:.2f} s, negotiation {stats['negotiate_s']:.2f}"
          f" s); first call (staging, warm-up, capture, {2 ** len(plan['sliced'])}"
          f" replays at width 1) {first_s:.3f} s", flush=True)
    worst = amp_check("1k-planned", np.asarray(amps),
                      np.array([ref[b] for b in bits]), list(bits))
    one = path_state("1k-planned", "one-shot", sim, ref, 1,
                     plan["compile_s"], stats)
    counts = run_counts(one, wrappers, ran, st)
    print(f"path 1k-planned one-shot: {counts_line(counts)}", flush=True)
    path = path_state("1k-planned", "planned", sim, ref, None,
                      plan["compile_s"], stats)
    path["name"] = "1k-planned"
    return path, dict(one_shot_s=one_shot_s, one_shot_first_s=first_s,
                      native_build_s=build_s, worst_over_bound=worst,
                      one_shot_counts=counts, census=dict(one["census"]),
                      **plan)


def plan_walk(dense_ref):
    """8b, the plan: ``prepare_output_sharded(*PLANNED_WALK)`` under
    ``PlannerConfig``'s defaults on the dense network; returns the walk's
    path state (``block_path``)."""
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.runtime import scheme
    from artensor_tpu_torch.simulation import _dense_shard_setup

    native_build()
    d_out, sc = PLANNED_WALK
    sim = TensorNetworkSimulation.from_circuit(random_circuit(**CIRCUIT))
    sim.prepare_output_sharded(d_out, sc_target=sc)
    stats = dict(scheme.LAST_COMPILE)
    plan = plan_summary(sim)
    steps, axes, chosen, output_bonds, k, _ = _dense_shard_setup(sim, d_out)
    print(f"planner dense-planned: prepare_output_sharded({d_out}, "
          f"sc_target={sc}): planner {plan['plan_s']:.3f} s, {k} sliced "
          f"bonds {plan['sliced']} a block, complexity tc {plan['tc']:.6f} "
          f"sc {plan['sc']:.1f} mc {plan['mc']:.6f}; the walk's total log10"
          f" {plan['total_log10'] + d_out * 0.30102999566398120:.6f}; "
          f"block scheme compile {plan['compile_s']:.3f} s", flush=True)
    path = block_path(sim, "dense-planned", f"d{d_out}-sc{sc}", steps, axes,
                      chosen, k, d_out, dense_ref, plan["compile_s"], stats,
                      2 ** len(output_bonds), planned=True)
    path["plan"] = plan
    return path


def drive_planned_walk(path, wrappers, state, state_bonds, post_hoc):
    """8b, the walk: ``drive_blocks`` on the planned blocks (no eager
    walks), its peak below the post-hoc walk's (``post_hoc``: that walk's
    run) and held to the model."""
    out = drive_blocks(path, wrappers, state, state_bonds,
                       eager_check=False)
    print(f"path dense-planned: peak {out['peak_gib']:.3f} GiB (the whole "
          f"state held apart) against the post-hoc walk's "
          f"{post_hoc['peak_gib']:.3f} GiB; warm walk {out['warm_s']:.4f} s"
          f", {out['s_per_block'] * 1e3:.3f} ms a block of 2^{path['k']} "
          f"slices, against the post-hoc walk's {post_hoc['warm_s']:.4f} s"
          f" ({post_hoc['s_per_block'] * 1e3:.3f} ms a block)", flush=True)
    check(out["peak_gib"] < post_hoc["peak_gib"],
          f"dense-planned: the planned walk's peak {out['peak_gib']:.3f} GiB"
          f" is not below the post-hoc walk's {post_hoc['peak_gib']:.3f}")
    out.update(path["plan"], d_out=path["d_out"])
    return out


CLI_VERIFY_QSIM = os.path.join(ROOT, "tests", "data", "circuit_n12_rcs.qsim")
CLI_BENCH_WIDTH = 64          # bench's --slice-batch: 1k/default's width
CLI_BENCH_TOL = 0.15          # bench's wall against phase 5's warm wall


def write_qsim(path, n, layers):
    """``(n, layers)`` as a qsim file (as tests/test_aux.py writes one)."""
    lines = [str(n)]
    for li, layer in enumerate(layers):
        for name, qubits, params in layer:
            lines.append(" ".join(
                [str(li), name, *map(str, qubits), *map(str, params)]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def cli_main(argv):
    """``python -m artensor_tpu_torch`` in this process (``main(argv)``):
    its standard output and error.  An exit other than 0 fails the run."""
    import contextlib
    import io

    from artensor_tpu_torch.__main__ import main as cli

    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli(argv)
    except SystemExit as e:
        raise SmokeFailure(f"python -m artensor_tpu_torch {argv[0]} exited "
                           f"{e.code}: {err.getvalue()[-2000:]}") from e
    return out.getvalue(), err.getvalue()


def cli_amps(text):
    """The amplitudes ``simulate`` prints, by bitstring."""
    got = {}
    for ln in text.strip().splitlines():
        bs, re, im = ln.split()
        got[bs] = complex(float(re), float(im))
    return got


def drive_cli(wrappers, dflt, dflt_run):
    """9: the command line on the 1k batch (``dflt``: the 1k/default path,
    ``dflt_run``: its phase-5 run).  ``simulate --plan`` as a subprocess,
    the user's path (every amplitude against the fixture, its wall and its
    report line), then in this process (its kernels counted on the card
    and held to the census of its scheme, which must be 1k/default's);
    ``bench`` at ``CLI_BENCH_WIDTH`` against phase 5's warm wall and its
    roofline below the wall; ``verify`` on ``CLI_VERIFY_QSIM`` (exit 0,
    fidelity estimate above 0.999); ``info`` and ``plan`` (the native
    search) on the qsim file; the scheme cache cold then warm on the 1k
    default scheme, the warm steps equal to the cold ones and a run from
    them held to the fixture.  Returns the phase's numbers."""
    import pickle
    import shutil
    import tempfile

    import numpy as np

    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.plan_io import plan_from_dict
    from artensor_tpu_torch.runtime import scheme_cache
    from artensor_tpu_torch.runtime.sparse import scheme_digest

    t_phase = time.perf_counter()
    plan = PATHS["1k"][0]
    ref = load_fixture(PATHS["1k"][1])
    keys = sorted(ref)
    want = np.array([ref[b] for b in keys])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    out = {}
    try:
        qsim = os.path.join(tmp, "rcs_n30_m14_s0.qsim")
        write_qsim(qsim, *random_circuit(**CIRCUIT))
        bits = os.path.join(tmp, "bitstrings_1k.txt")
        with open(bits, "w") as f:
            f.write("\n".join(ref) + "\n")
        sim_args = ["simulate", qsim, "--bitstrings", "@" + bits, "--plan",
                    plan]

        # 9a. the user's path: a process of its own
        fresh_memory()
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "artensor_tpu_torch",
                            *sim_args], cwd=ROOT, capture_output=True,
                           text=True, timeout=900)
        out["subprocess_s"] = time.perf_counter() - t0
        check(r.returncode == 0, f"cli simulate exited {r.returncode}: "
              f"{r.stderr[-3000:]}")
        got = cli_amps(r.stdout)
        check(sorted(got) == keys, f"cli simulate printed {len(got)} "
              "amplitudes, not the 1000 asked for")
        out["subprocess_worst_over_bound"] = amp_check(
            "cli-subprocess", np.array([got[b] for b in keys]), want, keys)
        out["subprocess_report"] = [ln for ln in r.stderr.splitlines()
                                    if ln.startswith("# ")][-1]
        print(f"cli simulate (subprocess): {out['subprocess_s']:.3f} s from "
              f"launch to exit; stderr: {out['subprocess_report']}",
              flush=True)

        # 9b. the same command in this process, its kernels counted
        kept = []
        real = TensorNetworkSimulation.contraction

        def keep(self, *a, **k):     # the CLI's simulation, for its numbers
            kept.append(self)
            return real(self, *a, **k)

        fresh_memory()
        reset_counts(wrappers)
        TensorNetworkSimulation.contraction = keep
        try:
            t0 = time.perf_counter()
            (text, err), ran = counted_on_card(lambda: cli_main(sim_args))
            out["in_process_s"] = time.perf_counter() - t0
        finally:
            TensorNetworkSimulation.contraction = real
        (sim,) = kept
        check(scheme_digest(sim.steps) == dflt["digest"],
              "cli simulate compiled another scheme than load_plan's "
              "default (1k/default)")
        got = cli_amps(text)
        check(sorted(got) == keys, "cli simulate (in process): amplitudes")
        out["in_process_worst_over_bound"] = amp_check(
            "cli-in-process", np.array([got[b] for b in keys]), want, keys)
        cli = path_state("1k", "cli", sim, ref, 1, sim.compile_seconds, {})
        st = sim.run_stats
        check(st["executor"] == "graph" and st["slice_batch"] == 1,
              f"cli simulate ran as {st['executor']} at width "
              f"{st['slice_batch']}")
        counts = run_counts(cli, wrappers, ran, st)
        missing = [k for k in ("gk", "ggk", "rgrow", "pair")
                   if not counts["device_launches"][k]]
        check(not missing, f"cli simulate ran no {missing} kernel")
        out.update(counts, compile_s=sim.compile_seconds,
                   census=dict(cli["census"]), stderr=err.strip())
        out["run_s"] = out["in_process_s"] - sim.compile_seconds
        print(f"cli simulate (in process): {out['in_process_s']:.3f} s "
              f"(default compile {sim.compile_seconds:.3f} s, the rest "
              f"{out['run_s']:.3f} s: staging, warm-up, capture, "
              f"{st['replays']} replays at width 1); "
              f"{counts_line(counts)}", flush=True)

        # 9c. bench at the default path's width
        fresh_memory()
        text, _ = cli_main(["bench", qsim, "--plan", plan, "--bitstrings",
                            "@" + bits, "--slice-batch",
                            str(CLI_BENCH_WIDTH)])
        bench = json.loads(text.strip().splitlines()[-1])
        out["bench"] = bench
        ratio = bench["wall_s"] / dflt_run["warm_s"]
        print(f"cli bench: {json.dumps(bench)}; wall {ratio:.3f}x "
              f"1k/default's warm wall {dflt_run['warm_s']:.4f} s "
              f"(phase 5)", flush=True)
        check(abs(ratio - 1) <= CLI_BENCH_TOL,
              f"cli bench: wall {bench['wall_s']:.4f} s is not within "
              f"{CLI_BENCH_TOL:.0%} of 1k/default's {dflt_run['warm_s']:.4f}")
        check(0 < bench["roofline_achieved"] <= 1,
              f"cli bench: roofline_achieved {bench['roofline_achieved']}")

        # 9d. verify against the MPS oracle (exact at the default chi)
        t0 = time.perf_counter()
        text, err = cli_main(["verify", CLI_VERIFY_QSIM, "--serial"])
        stats = json.loads(err.strip().splitlines()[-1])
        out["verify"] = dict(stats, seconds=time.perf_counter() - t0)
        print(f"cli verify {os.path.basename(CLI_VERIFY_QSIM)}: "
              f"{json.dumps(out['verify'])}", flush=True)
        check(stats["mps_fidelity_estimate"] > 0.999
              and stats["max_abs_diff"] <= stats["threshold"],
              f"cli verify: {stats}")

        # 9e. info and plan (the native search, under the script's seed)
        info = json.loads(cli_main(["info", qsim])[0])
        check(info["qubits"] == CIRCUIT["rows"] * CIRCUIT["cols"],
              f"cli info: {info}")
        t0 = time.perf_counter()
        planned = json.loads(cli_main(
            ["plan", qsim, "--out", os.path.join(tmp, "plan.json")])[0])
        plan_s = time.perf_counter() - t0
        info_plan = json.loads(cli_main(
            ["info", os.path.join(tmp, "plan.json")])[0])
        check(info_plan["sc"] == planned["sc"] <= 30, f"cli plan: {planned}")
        out.update(info=info, plan=dict(planned, seconds=plan_s,
                                        info=info_plan))
        print(f"cli info: {json.dumps(info)}; cli plan in {plan_s:.3f} s: "
              f"{json.dumps(planned)}; info {json.dumps(info_plan)}",
              flush=True)

        # 9f. the scheme cache, cold then warm, on the 1k default scheme
        os.environ[scheme_cache.ENV] = os.path.join(tmp, "schemes")
        with open(plan) as f:
            pd = json.load(f)
        csim = TensorNetworkSimulation.from_circuit(random_circuit(**CIRCUIT),
                                                    list(ref))
        csim.order, csim.slicing_bonds, csim.ctree = plan_from_dict(pd)
        sc = float(pd["meta"]["sc_target"])
        t0 = time.perf_counter()
        cold = scheme_cache.cached_scheme_sparse(plan, csim.ctree,
                                                 csim.bitstrings, sc)
        cold_s = time.perf_counter() - t0
        check(len(os.listdir(os.path.join(tmp, "schemes"))) == 1,
              "scheme cache: the cold call wrote no file")
        t0 = time.perf_counter()
        warm = scheme_cache.cached_scheme_sparse(plan, csim.ctree,
                                                 csim.bitstrings, sc)
        warm_s = time.perf_counter() - t0
        check(scheme_digest(cold[0]) == scheme_digest(warm[0])
              == dflt["digest"] and cold[1:] == warm[1:]
              and all(pickle.dumps(a) == pickle.dumps(b)
                      for a, b in zip(cold[0], warm[0])),
              "scheme cache: the warm steps differ from the cold ones")
        csim._set_scheme(*warm)
        fresh_memory()
        amps = csim.contraction(slice_batch=dflt["W"], device=DEVICE)
        out["cache"] = dict(
            cold_s=cold_s, warm_s=warm_s,
            worst_over_bound=amp_check(
                "cli-cache", amps,
                np.array([ref[b] for b in csim.bitstrings_sorted]),
                csim.bitstrings_sorted))
        print(f"scheme cache 1k/default: cold {cold_s:.3f} s (compile and "
              f"write), warm {warm_s:.4f} s (load); the warm scheme's run at "
              f"width {dflt['W']} within the fixture gate", flush=True)
    finally:
        os.environ.pop(scheme_cache.ENV, None)
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"cli: phase 9 in {out['phase_s']:.1f} s", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slice-batch", type=int, default=32,
                    help="slices per group of the sliced runner")
    args = ap.parse_args()
    if os.environ.get("PYTHONHASHSEED") != PLAN_HASH_SEED:
        # the planner's plans depend on the string hash seed: every run
        # plans under the same one
        os.execve(sys.executable, [sys.executable, os.path.abspath(__file__),
                                   *sys.argv[1:]],
                  dict(os.environ, PYTHONHASHSEED=PLAN_HASH_SEED))

    global T0
    T0 = time.perf_counter()
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
    paths += compile_dense_paths()
    for off, dflt in zip(paths[::2], paths[1::2]):
        dflt["off_sim"] = off["sim"]
        dropped = sorted(set(off["census"]) - set(dflt["census"]))
        if dropped:
            print(f"scheme {dflt['name']}: no {', '.join(dropped)} step "
                  f"(held on {off['name']})", flush=True)
    paths.append(compile_block_path(paths[-1]))
    labels = [p["name"] for p in paths]
    missing = [k for k in KERNELS if not any(k in p["cases"] for p in paths)]
    check(not missing, f"no path plans a step for {missing}")

    # -- 3. kernels against their plain versions ------------------------------
    checked = {p["name"]: check_kernels(p) for p in paths}

    # -- 4. lane forms the paths lack, the complex matmul (on no path) --------
    forms = check_lane_forms()
    cmm = check_complex_mm()
    one_pass = {k: next((checked[n][k]["one_pass"] for n in labels
                         if "one_pass" in checked[n].get(k, {})), None)
                for k in ONE_PASS_KINDS}
    if one_pass["ggk"] is None:     # no path runs a GGK step on mma
        one_pass["ggk"] = check_ggk_one_pass()["one_pass"]
    one_pass["complex_mm"] = cmm[-1]["one_pass"]

    # -- 5. the paths end to end ----------------------------------------------
    wrappers = {k: wrapper(v[0]) for k, v in {**KERNELS, **OFF_PATH}.items()}
    runs, modes, fields, state = {}, {}, {}, None
    field_paths, dense_default, planned = [], None, []
    for p in paths:
        drop_tables(paths)
        if p["workload"] == "dense":
            runs[p["name"]], st = drive_dense(p, wrappers)
            if p["form"] == "default":    # the block walk's reference
                state, state_bonds = st, p["sim"].output_bonds
                # -- 6. the other execution modes on the dense state -------
                modes["segmented dense/default"] = drive_segmented(p, st)
                modes["rescaled dense/default"] = drive_rescaled(p, st)
                dense_default = p
            del st
            if p is dense_default:      # phase 7 runs after the walk
                p["off_sim"] = None
                continue
        elif p["workload"] == "dense-blocks":
            runs[p["name"]] = drive_blocks(p, wrappers, state, state_bonds)
            # -- 8b. the planned walk, held to the same state -------------
            walk = plan_walk(p["ref"])
            checked[walk["name"]] = check_kernels(walk)
            drop_tables(paths + [walk])
            runs[walk["name"]] = drive_planned_walk(
                walk, wrappers, state, state_bonds, runs[p["name"]])
            walk["sim"] = None
            drop_tables([walk])
            planned.append(walk)
            # -- 7. the field modes, after every main run (and its trace):
            # the dense state in each mode, the mode walks, then the
            # sparse paths ---------------------------------------------
            fields[dense_default["name"]] = drive_fields(
                dense_default, wrappers, held=state)
            for mode in ("complex", "fused"):
                fields[f"{p['name']} {mode}"] = drive_mode_walk(
                    p, mode, state, state_bonds)
            state = dense_default["sim"] = None
            for q in field_paths:
                fields[q["name"]] = drive_fields(q, wrappers)
                q["sim"] = None
        else:
            runs[p["name"]] = drive(p, wrappers)
            # -- 6. the other execution modes on the sparse paths ----------
            if p["name"] == "1k/default":
                modes["segmented 1k/default"] = drive_segmented(p)
                fields["segmented fused 1k/default"] = \
                    drive_segmented_fused(p)
            elif p["name"] == "1k-sc25/default":
                modes["rescaled 1k-sc25/default"] = drive_rescaled(p)
                fields["rescaled complex 1k-sc25/default"] = \
                    drive_rescaled_complex(p)
            elif p["name"] == "10k/default":
                modes["checkpoint 10k/default"] = drive_checkpoint(p)
                fields["checkpoint complex 10k/default"] = \
                    drive_checkpoint_complex(p)
            if p["name"] in FIELD_PATHS:   # phase 7 runs after the walk
                field_paths.append(p)
                p["off_sim"] = None
                continue
        p["sim"] = p["off_sim"] = None
    # -- 8a. the planned 1k path (the planned walk ran after dense-blocks) --
    path, one_shot = drive_planned(wrappers)
    checked[path["name"]] = check_kernels(path)
    drop_tables(paths + planned + [path])
    runs[path["name"]] = dict(drive(path, wrappers), one_shot=one_shot)
    path["sim"] = None
    planned.append(path)
    labels += [p["name"] for p in planned]
    # -- 9. the command line on the 1k batch --------------------------------
    dflt = next(p for p in paths if p["name"] == "1k/default")
    cli = drive_cli(wrappers, dflt, runs[dflt["name"]])
    print(f"paths: {json.dumps(runs)}", flush=True)
    print(f"cli: {json.dumps(cli)}", flush=True)
    print(f"modes: {json.dumps(modes)}", flush=True)
    print(f"fields: {json.dumps(fields)}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - T0:.1f} s from the start",
          flush=True)

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
            "launches": sum(runs[n]["launches"][kind] for n in labels)
            + cli["launches"][kind],
            "device_launches": sum(runs[n]["device_launches"][kind]
                                   for n in labels)
            + cli["device_launches"][kind],
            "cli_launches": cli["launches"][kind],
            "cli_device_launches": cli["device_launches"][kind],
            "max_abs_err": big["max_abs_err"], "ms": big["ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": big["library_ms"],
            "form": big["form"], "bound_3xtf32_ms": big["bound_3xtf32_ms"],
            "path": first, "step": big["step"], "steps": res["steps"],
            "kernel_ms_per_group": res["ms_per_group"],
            "costliest": {k: res["costliest"][k] for k in keys},
            "paths": {n: {"launches": runs[n]["launches"][kind],
                          "device_launches":
                              runs[n]["device_launches"][kind],
                          "replays": runs[n]["replays"],
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
        if kind in ONE_PASS_KINDS:
            line[-1]["one_pass"] = one_pass[kind]
    (_, source, replaces), big = OFF_PATH["complex_mm"], cmm[-1]
    line.append({
        "name": "complex_mm", "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(runs[n]["launches"]["complex_mm"] for n in labels),
        "device_launches": None,    # its kernel is Pair's: counted there
        **{k: big[k] for k in keys}, "path": None,
        "one_pass": one_pass["complex_mm"],
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
