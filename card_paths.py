"""The n30 m14 paths the port is checked and timed on, and what the card
tests and the card scripts share about them.

A path is one scheme of a workload at one slice width: the three sparse
workloads (``PATHS``: 1000 bitstrings "1k" with 64 slices, 10000 "10k"
with 128, and the 1000 at sc_target 25 "1k-sc25" with 32), each in the
"off" form (``contraction_scheme_sparse(..., fuse=False,
negotiate=False)`` at ``OFF_WIDTH``) and the "default" form that
``TensorNetworkSimulation.load_plan`` compiles (at the width
``metrics.dividing_slice_width`` picks); the whole 2^30-amplitude state
(``DENSE_PLAN``, no sliced bond) in both forms at width 1; and
"dense-blocks", ``contraction_output_blocks(D_OUT)``'s walk over 64
blocks of 2^24, a slice instance a block.  ``compile_label`` compiles a
path by its label ("<workload>/<form>" or "dense-blocks").

``KERNEL_STEPS`` gives, per path, its width and how many kernel steps of
each kind its scheme runs there (the sparse default forms' from
``tests/data/torch_port_default_schemes.json``, which
``scripts/default_schemes_torch_port.py --write`` remakes); ``F64_CASES``
and ``ONE_PASS_CASES`` the (path, kind) pairs whose largest step takes the
float64 check and which run a tensor-core ("mma") step.  The card tests
(``tests/test_torch_card_paths.py``) are parametrised from them, and
``tests/test_torch_card_cases.py`` holds them to the compiled schemes on
the CPU.

Nothing of the port is imported when this module loads: it runs on the
card's machine and on the CPU, and ``tests/test_torch_isolation.py``
holds it to loading no JAX."""

import json
import os
import statistics
import subprocess

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "artensor_tpu_torch", "data")
PATHS = {   # workload: (plan, JAX fixture)
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
CIRCUIT = dict(rows=5, cols=6, cycles=14, seed=0)   # random_circuit args
OFF_WIDTH = 32                # the off form's slice width
D_OUT = 6                     # the block walk's sliced output legs: 64
                              # blocks of 2^24 amplitudes
DEVICE = "cuda"

# -- the gates ---------------------------------------------------------------
KERNEL_RTOL = 2e-4            # kernel vs plain: max|d| <=
KERNEL_ATOL = 1e-5            #   rtol*max|plain| + atol (float32 sums
                              #   in another order)
# the one-pass TF32 form (precision 'default') against the plain version's
# TF32 form: the same products of the same TF32 operands, each exact in
# float32, summed in another order -- the 3-pass form's tolerance
ONE_PASS_RTOL, ONE_PASS_ATOL = KERNEL_RTOL, KERNEL_ATOL
AMP_RTOL = 1e-3               # amplitudes vs fixture:
AMP_RMS_TOL = 1e-6            #   |d| <= rtol*|ref| + rms_tol*rms(ref)
NORM_TOL = 1e-4               # |norm^2 - 1| of a dense state (float64 sum)
BLOCK_TOL = 1e-5              # block vs whole state: max|d| <= tol*rms
F64_ERR_RATIO = 4             # kernel vs plain error against float64
F64_KINDS = ("gk", "ggk", "rgrow", "rgflat", "pair")   # ... at the largest
F64_MAX_ELEMS = 1 << 28       # largest step (X + Y elements of one slice
                              # instance) whose float64 check fits beside
                              # its buffers
F64_ROWS = 1 << 14            # rows of a dot product checked in float64
PEAK_MODEL_SHARE = 0.9        # the peak model's share of the measured peak
PLAIN_CHUNK = 32              # slice instances a plain-version call covers
LIBRARY_MAX_WIDTH = 32        # widest call that also runs the yardstick (its
                              # complex64 copies of a width-128 step would not
                              # fit beside the step's buffers)

ONE_PASS_KINDS = ("gk", "ggk", "pair")   # kernels with a tensor-core form
FORM_KINDS = ("gk", "ggk")   # kernels whose launches are counted by form
# the tensor-core product each (kind, form) runs on
CORES = {("gk", "mma"): "wgmma", ("pair", "mma"): "wgmma",
         ("ggk", "mma"): "wgmma"}
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

# -- the paths' kernel steps, as the schemes compile them --------------------
# the default schemes' record (``scripts/default_schemes_torch_port.py
# --write``): per sparse workload its census, digest, the width the wall
# estimate picks and its kernel steps by kind there
DEFAULT_RECORD = os.path.join(ROOT, "tests", "data",
                              "torch_port_default_schemes.json")
with open(DEFAULT_RECORD) as _f:
    _DEFAULTS = json.load(_f)
# label: (slice width, kernel steps by kind): the off forms and the dense
# paths recorded here, the sparse default forms from the record
_RECORDED = {
    "1k/off": (32, {"ggk": 2, "gk": 18, "pair": 1, "rgrow": 1}),
    "10k/off": (32, {"ggk": 1, "gk": 21, "pair": 2, "rgflat": 1}),
    "1k-sc25/off": (32, {"gk": 9, "lane": 1, "pair": 1, "rgflat": 1}),
    "dense/off": (1, {"gk": 14}),
    "dense/default": (1, {"gk": 14}),
    "dense-blocks": (1, {"gk": 12}),
}
KERNEL_STEPS = {
    **{f"{w}/{f}": _RECORDED[f"{w}/off"] if f == "off" else
       (_DEFAULTS[w]["width"], _DEFAULTS[w]["kernel_steps"])
       for w in PATHS for f in ("off", "default")},
    **{lb: v for lb, v in _RECORDED.items() if lb.startswith("dense")}}
# (path, kind) whose largest step takes the float64 check: every kind of
# F64_KINDS on the sparse paths; none of the dense paths' 2^30-element
# steps fits (F64_MAX_ELEMS)
F64_CASES = tuple((label, k) for label, (_, kinds) in KERNEL_STEPS.items()
                  if not label.startswith("dense")
                  for k in sorted(kinds) if k in F64_KINDS)
# (path, kind) with a step in the tensor-core form at the path's width
ONE_PASS_CASES = tuple(
    (label, k) for label in KERNEL_STEPS
    for k in ONE_PASS_KINDS if k in KERNEL_STEPS[label][1]
    and (k != "ggk" or label.startswith("1k/")))

# -- the synthetic steps and shapes ------------------------------------------
# lane steps of the forms the paths lack, from the index lists of
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
# the benchmark cells' largest dot products at their widths (B, M, K, N):
# dense-state steps 6, 25, 7, 11, 8 and 30 (30 also sparse-1k-sc25's step
# 32), sparse-1k-sc25's steps 21 (the role swap) and 46 (a chunk),
# sparse-1k's step 63 (a chunk)
CMM_DOT_SHAPES = ((1, 65536, 256, 16384), (1, 1 << 23, 128, 128),
                  (1, 1 << 24, 64, 64), (1, 1 << 25, 32, 32),
                  (1, 1 << 26, 16, 16), (1, 1 << 27, 8, 8),
                  (1, 64, 64, 1 << 24), (123, 65536, 32, 2),
                  (31616, 1024, 8, 8))
# the main path's largest reorders, as the permute-copy kernel
# (csrc/permute.cu, ops/permute.py) gets them on the benchmark's cells at
# their widths: (sizes, strides, components); a split pair is one launch
PERMUTE_STEPS = {
    "1k-sc25 dot 22": ((32, 2, 32, 524288), (33554432, 16777216, 1, 32), 2),
    "1k-sc25 dot 31": ((32, 4, 2, 8, 524288),
                       (33554432, 8, 16777216, 1, 32), 2),
    "dense dot 30": ((256, 8192, 64, 2, 2, 2),
                     (2097152, 128, 1, 536870912, 1048576, 64), 1),
    "1k GK 24": ((64, 8, 2, 2, 2, 4, 4, 8, 2, 8, 4, 8, 4),
                 (16777216, 524288, 32768, 512, 16, 1, 4194304, 1024, 32,
                  65536, 8192, 64, 4), 2),
}
# a GGK step of GK's mma form (K 32, H 32, F 512: bound by operations),
# for the one-pass check where no path has one: (rx_i, rx_j, riy, rd_i,
# rd_j, B, bi_rows, bj_rows)
GGK_MMA_STEP = (("k0", "k1", "k2", "k3", "k4", "f"),
                ("k0", "k1", "k2", "k3", "k4", "h0", "h1", "h2", "h3", "h4"),
                ("h0", "h1", "h2", "h3", "h4", "f"), (2,) * 5 + (512,),
                (2,) * 10, 2048, 256, 64)
GGK_CUT_STEP = (16, 16, 512)    # (K, H, F) of the 1k path's GGK step that
                                # gatherk.gk_form's GGK cut decides


def plan_ggk_mma_step():
    """``GGK_MMA_STEP`` planned (``GGK_MIN_WORK``, the size gate, lifted
    for the call)."""
    import numpy as np

    from artensor_tpu_torch.runtime import gatherk

    *case, B, bi_rows, bj_rows = GGK_MMA_STEP
    rng = np.random.default_rng(7)
    gi = np.sort(rng.integers(0, bi_rows, B))
    gj = rng.integers(0, bj_rows, B)
    old = gatherk.GGK_MIN_WORK
    gatherk.GGK_MIN_WORK = 1
    try:
        return gatherk.plan_ggk_step(*case, gi, gj, bi_rows, bj_rows)
    finally:
        gatherk.GGK_MIN_WORK = old


def require_card(config):
    """For a card test's fixture (``config``: pytest's): nothing where a
    CUDA card is present; else skip the test, or fail it where the run
    asked for the card tests by their mark (``-m gpu``), so that a card
    check that finds no card does not pass."""
    import pytest
    import torch

    if torch.cuda.is_available():
        return
    expr = config.getoption("markexpr") or ""
    if "gpu" in expr and "not gpu" not in expr:
        pytest.fail("needs a CUDA card: none found, and the run asked for "
                    "the card tests (-m gpu)")
    pytest.skip("needs a CUDA card")


class CardCheckError(AssertionError):
    """A card check failed."""


def check(cond, msg):
    if not cond:
        raise CardCheckError(msg)


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
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


def load_fixture(path):
    ref = {}
    with open(path) as f:
        for ln in f:
            p = ln.split()
            if len(p) == 3:
                ref[p[0]] = complex(float(p[1]), float(p[2]))
    return ref


def amp_check(got, ref_vals, name=""):
    """The fixture gate over amplitudes: finite, and each within
    ``AMP_RTOL``*|ref| + ``AMP_RMS_TOL``*rms(ref)."""
    import numpy as np

    got = np.asarray(got)
    check(np.isfinite(got).all(), f"{name}: amplitudes not finite")
    rms = float(np.sqrt(np.mean(np.abs(ref_vals) ** 2)))
    share = np.abs(got - ref_vals) / (AMP_RTOL * np.abs(ref_vals)
                                      + AMP_RMS_TOL * rms)
    check((share <= 1).all(), f"{name}: an amplitude at "
          f"{float(share.max()):.3f} of the fixture gate")


# -- kernel steps -------------------------------------------------------------

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


def launch_forms(cases, width):
    """A scheme's GK and GGK steps by the form each launches in (the
    wrappers' and the kernels' own counts); ``cases`` as ``kernel_cases``
    gives them."""
    from collections import Counter

    return {kind: Counter(step_form(kind, plan, width, bx, by)
                          for plan, bx, by in cases.get(kind, []))
            for kind in FORM_KINDS}


def step_form(kind, plan, width, bx, by):
    """The form a kernel step launches in: GK's and GGK's by
    ``gatherk.gk_form``, "mma" for Pair, "fma" for the rest."""
    from artensor_tpu_torch.runtime import gatherk

    if kind in FORM_KINDS:
        xs, ws = (bx, by) if plan.w_is_j else (by, bx)
        return gatherk.gk_form(plan, width, xs, ws)
    return "mma" if kind == "pair" else "fma"


def largest_step(cases, kind):
    """Index of the kind's largest step by flops."""
    return max(range(len(cases[kind])), key=lambda i: cases[kind][i][0].flops)


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

    call = lambda: torch.einsum(spec, xc, wc)  # noqa: E731
    shape = ((xr.shape[0] if xs else wr.shape[0],) if lead else ()) + \
        (len(plan.xoff), plan.H, plan.F)
    return call, view, shape


def library_call(kind, plan, args, width):
    """The one PyTorch call of a GK, Pair or Lane step that computes what
    the kernel does (the yardstick; the port calls neither): ``(call,
    err)``, ``err(pr, pi)`` the call's max|d| to the plain version's
    output.  None for the other kinds and above ``LIBRARY_MAX_WIDTH``."""
    import torch

    _, xr, xi, wr, wi, xs, ws = args
    if width > LIBRARY_MAX_WIDTH or kind not in ("gk", "pair", "lane"):
        return None
    if kind == "gk":
        call, view, shape = gk_library(plan, xr, xi, wr, wi, xs, ws)

        def err(pr, pi):
            y = call().reshape(shape)
            # a block of outer indices at a time: the index of a whole
            # 2^30-element output would not fit beside it
            rows = max(1, (1 << 24) // (plan.H * plan.F))
            return max(
                torch.abs(y[..., o0:o0 + rows, :, :]
                          - view(pr, pi, slice(o0, o0 + rows))).max().item()
                for o0 in range(0, len(plan.xoff), rows))
        return call, err
    if kind == "pair":
        xc = torch.complex(xr, xi).reshape(
            ((width,) if xs else ()) + (plan.K, plan.M))
        vc = torch.complex(wr, wi).reshape(
            ((width,) if ws else ()) + (plan.K, plan.N))
        call = lambda: torch.matmul(xc.transpose(-1, -2), vc)  # noqa: E731
    else:
        # the step over X's and W's stored legs, output in iy order: the
        # lane kernel's output layout
        a, rest = plan.spec.split(",")
        b, c = rest.split("->")
        z = lambda on: "z" if on else ""  # noqa: E731
        spec = f"{z(xs)}{a},{z(ws)}{b}->{z(xs or ws)}{c}"
        xc = torch.complex(xr, xi).reshape(xr.shape[:-1] + plan.x_dims)
        wc = torch.complex(wr, wi).reshape(wr.shape[:-1] + plan.w_dims)
        call = lambda: torch.einsum(spec, xc, wc)  # noqa: E731
    return call, lambda pr, pi: torch.abs(
        call().reshape(pr.shape) - torch.complex(pr, pi)).max().item()


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
    rnd = lambda shape: torch.randn(shape, generator=gen,  # noqa: E731
                                    device=DEVICE)
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


def step_bytes_flops(ops, plan, width):
    """A step call's bytes (each input row it reads once, its output
    written once) and flops at slice width ``width``."""
    wx = width if ops["xs"] else 1
    ww = width if ops["ws"] else 1
    wy = width if (ops["xs"] or ops["ws"]) else 1
    return (8 * (wx * ops["x_need"] + ww * ops["w_need"] + wy * ops["y_n"]),
            plan.flops * wy)


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
        pick = lambda t, b: (t[s] if b else t).double()  # noqa: E731
        rr, ri = plain(plan, pick(xr, xs), pick(xi, xs), pick(wr, ws),
                       pick(wi, ws), False, False)
        ref = torch.complex(rr, ri)
        at = lambda t: (t[s] if lead else t).double()  # noqa: E731
        scale = max(scale, torch.abs(ref).max().item())
        d_k = max(d_k, torch.abs(torch.complex(at(kr), at(ki)) - ref)
                  .max().item())
        d_p = max(d_p, torch.abs(torch.complex(at(pr), at(pi)) - ref)
                  .max().item())
        del rr, ri, ref
    return dict(f64_rel_err=d_k / scale, plain_f64_rel_err=d_p / scale)


def _reps(flops, elems):
    return 5 if flops > 1e12 or 8 * elems > 1 << 32 else 20


def measure(kind, plan, bx, by, width, seed):
    """One kernel step at slice width ``width`` on random operands: its
    device ms, bounds, form and core, its plain version's ms, max|d| to it
    and the card tests' tolerance there (``tol``), the yardstick's ms
    (None above ``LIBRARY_MAX_WIDTH``); RGRow and RGFlat also ``step_ms``
    (through ``apply_ggk_step``) and the copies their reads absorb, timed
    alone (``x_reorder_ms``, ``w_transpose_ms``); a step in the
    tensor-core form also ``one_pass_ms``."""
    import torch

    from artensor_tpu_torch.runtime import metrics

    ops = kernel_operands(kind, plan, bx, by, width, seed)
    call, plain, args = ops["call"], ops["plain"], ops["args"]
    nbytes, flops = step_bytes_flops(ops, plan, width)
    form = step_form(kind, plan, width, bx, by)
    reps = _reps(flops, ops["x_n"] + ops["y_n"])
    kr, ki = call(*args)
    err, scale, (pr, pi) = plain_error(
        kr, ki, plain_chunks(plain, args, width), ops["xs"] or ops["ws"])
    out = dict(width=width, step=describe(kind, plan), form=form,
               core=CORES.get((kind, form)), max_abs_err=err,
               tol=KERNEL_RTOL * scale + KERNEL_ATOL,
               ms=time_ms(lambda: call(*args), reps),
               plain_ms=time_ms(lambda: [None for _ in plain_chunks(
                   plain, args, width)], 3),
               **metrics.bounds(nbytes, flops, form), library_ms=None,
               bytes=nbytes, flops=flops, x_batched=ops["xs"],
               w_batched=ops["ws"])
    if form == "mma":
        out["one_pass_ms"] = time_ms(lambda: call(*args, passes=1), reps)
    if kind in ("rgrow", "rgflat"):
        out.update(_step_glue(plan, args, reps))
    del kr, ki
    lib = library_call(kind, plan, args, width)
    if lib is not None:
        out["library_ms"] = time_ms(lib[0], reps)
    del ops, args, pr, pi, lib
    torch.cuda.empty_cache()
    return out


def measure_checked(*args, **kw):
    """``measure``, failing (``CardCheckError``) where the kernel strays
    from its plain version beyond the card tests' tolerance."""
    r = measure(*args, **kw)
    check(r["max_abs_err"] <= r["tol"],
          f"{r['step']} width {r['width']}: {r['max_abs_err']:.3e} "
          f"from the plain version, tol {r['tol']:.3e}")
    return r


def _step_glue(plan, args, reps):
    """An RGRow or RGFlat step through ``gatherk.apply_ggk_step`` (the
    kernel and any copies around it), and, timed alone on the same
    operands, the copies the kernel's stored-order reads absorb: the
    reorder of the whole X buffer to canonical (F, K) rows (RGRow's
    ``pre_perm``) and the transpose of the W rows to (H, K)."""
    from artensor_tpu_torch.ops.field import SplitField
    from artensor_tpu_torch.runtime import gatherk, lowering

    _, xr, xi, wr, wi, xs, ws = args
    field, row = SplitField(), plan.row
    x, w = (xr, xi), (wr, wi)
    pi, pj, bi, bj = (x, w, xs, ws) if row.w_is_j else (w, x, ws, xs)
    xlead = (xr.shape[0],) if xs else ()
    wlead = (wr.shape[0],) if ws else ()
    out = dict(step_ms=time_ms(
        lambda: gatherk.apply_ggk_step(field, pi, pj, plan, bi, bj), reps),
        x_reorder_ms=0.0)
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


# -- the paths ----------------------------------------------------------------

def compile_path(name, W):
    """A sparse workload's fixture and plan, its scheme compiled in the
    off form (``contraction_scheme_sparse(..., fuse=False,
    negotiate=False)``) at slice width ``W``: the path's state
    (``path_state``)."""
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.plan_io import plan_from_dict
    from artensor_tpu_torch.runtime import sparse

    plan, fixture = PATHS[name]
    ref = load_fixture(fixture)
    sim = TensorNetworkSimulation.from_circuit(random_circuit(**CIRCUIT),
                                               list(ref))
    with open(plan) as f:
        pd = json.load(f)
    sim.order, sim.slicing_bonds, sim.ctree = plan_from_dict(pd)
    sim.sc_target = float(pd["meta"]["sc_target"])
    sim._set_scheme(*sparse.contraction_scheme_sparse(
        sim.ctree, sim.bitstrings, sim.sc_target, fuse=False,
        negotiate=False))
    return path_state(name, "off", sim, ref, W)


def compile_default_path(name):
    """A sparse workload's default form, as ``load_plan`` compiles it, at
    the width the wall estimate picks."""
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit

    ref = load_fixture(PATHS[name][1])
    sim = TensorNetworkSimulation.from_circuit(random_circuit(**CIRCUIT),
                                               list(ref))
    sim.load_plan(PATHS[name][0])
    return path_state(name, "default", sim, ref, None)


def compile_paths(name, W):
    """Both forms of a sparse workload's scheme: the off form at ``W``,
    then the default form.  Returns the two paths' states, off first."""
    return [compile_path(name, W), compile_default_path(name)]


def dense_ref():
    """Both fixtures' 11000 amplitudes: a dense path's reference."""
    ref = {}
    for path in DENSE_FIXTURES:
        ref.update(load_fixture(path))
    return ref


def compile_dense_path(form):
    """The dense workload's whole state in ``form``: "off"
    (``scheme.contraction_scheme(..., fuse=False, negotiate=False)``) or
    "default" (what ``load_plan`` compiles), at width 1 (nothing is
    sliced)."""
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.plan_io import plan_from_dict
    from artensor_tpu_torch.runtime import scheme

    sim = TensorNetworkSimulation.from_circuit(random_circuit(**CIRCUIT))
    if form == "default":
        sim.load_plan(DENSE_PLAN)
    else:
        with open(DENSE_PLAN) as f:
            pd = json.load(f)
        sim.order, sim.slicing_bonds, sim.ctree = plan_from_dict(pd)
        sim._set_scheme(*scheme.contraction_scheme(sim.ctree, fuse=False,
                                                   negotiate=False))
    return path_state("dense", form, sim, dense_ref(), 1)


def compile_block_path(dense):
    """The block walk's scheme on the dense default path's simulation:
    ``D_OUT`` open legs sliced post hoc and the default form recompiled,
    as ``contraction_output_blocks`` does (the legs are restored at
    once); a slice instance of it is one block."""
    return post_hoc_block_path(dense, D_OUT, "dense-blocks", "default")


def post_hoc_block_path(dense, d_out, name="dense", form=None):
    """The dense default path's block scheme at ``d_out`` legs sliced post
    hoc (``block_path``), as ``contraction_output_blocks`` and
    ``contraction_output_sharded`` compile it (the legs restored at
    once)."""
    from artensor_tpu_torch.simulation import _dense_shard_setup

    sim = dense["sim"]
    steps, axes, chosen, output_bonds, k, restore = \
        _dense_shard_setup(sim, d_out)
    restore()
    check(k == 0, f"the dense plan slices {k} bonds: a block has 2^{k} "
          "slices")
    return block_path(sim, name, form or f"sharded-d{d_out}", steps, axes,
                      chosen, k, d_out, dense["ref"], 2 ** len(output_bonds))


def block_path(sim, name, form, steps, axes, chosen, k, d_out, ref,
               out_elems):
    """A block walk's state (``path_state`` at width 1: a slice instance
    of the block scheme ``steps`` is one slice of one block; 2^k slices a
    block), with the steps the walk runs once (slice-invariant:
    ``census_once``) apart from those it runs a slice (``census``)."""
    from collections import Counter
    from types import SimpleNamespace

    from artensor_tpu_torch.runtime.executor import (precompute_static_steps,
                                                     split_invariant_steps)
    from artensor_tpu_torch.runtime.sparse import kernel_kind

    view = SimpleNamespace(steps=steps, slicing_axes=axes,
                           slicing_bonds=chosen + list(sim.slicing_bonds),
                           tensors=sim.tensors)
    out = path_state(name, form, view, ref, 1, out_elems)
    # the walk runs the slice-invariant steps once, the rest per slice
    run_steps, _ = precompute_static_steps(
        steps, [sim.tensors[i] for i in range(len(sim.tensors))], axes)
    once, rest = split_invariant_steps(run_steps, axes)
    census = lambda st: Counter(kernel_kind(s) or "dot"  # noqa: E731
                                for s in st)
    bat = dict(zip(map(id, run_steps), operand_batching(run_steps, axes)))

    def gk_forms(st):
        return launch_forms(kernel_cases(st, [bat[id(s)] for s in st]), 1)

    out.update(name=name, sim=sim, d_out=d_out, k=k, census=census(rest),
               census_once=census(once), forms=gk_forms(rest),
               forms_once=gk_forms(once))
    return out


def path_state(name, form, sim, ref, W, out_elems=None):
    """One path's state; ``W`` None: the width the wall estimate picks.
    Its modeled peak is ``metrics.scheme_device_peak_bytes`` plus, when a
    bond is sliced, the sliced runner's static accumulator: a split pair
    of the output's ``out_elems`` (default: the simulation's output)."""
    from collections import Counter

    import numpy as np

    from artensor_tpu_torch.runtime import metrics
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
    if out_elems is None:
        out_elems = 2 ** len(sim.output_bonds) * (
            len(sim.bitstrings_sorted) if sim.pattern == "sparse" else 1)
    model_peak = metrics.scheme_device_peak_bytes(
        run_steps, W, sim.slicing_axes) + (8 * out_elems if k else 0)
    # the staged operands, on the card for the whole run: the peak model
    # counts a sliced leaf's width copies, not the staged tensor itself
    staged = sum(8 * int(np.prod(np.shape(a))) for a in host)
    cases = kernel_cases(run_steps, operand_batching(run_steps,
                                                     sim.slicing_axes))
    # the floor under the run (``bench``'s roofline_s) and the scheme's
    # digest (a sparse path's: the CLI's scheme is held to it)
    roof_s = n_slices * metrics.scheme_roofline_seconds(run_steps)
    digest = scheme_digest(sim.steps) \
        if getattr(sim, "pattern", None) == "sparse" else None
    return dict(name=label, workload=name, form=form, sim=sim, ref=ref, W=W,
                n_slices=n_slices, census=census, cases=cases,
                forms=launch_forms(cases, W), model_peak=model_peak,
                staged=staged, roof_s=roof_s, digest=digest)


def compile_label(label):
    """A path by its label: "<workload>/off", "<workload>/default" (the
    sparse workloads and "dense") or "dense-blocks"."""
    if label == "dense-blocks":
        return compile_block_path(compile_dense_path("default"))
    name, form = label.split("/")
    if name == "dense":
        return compile_dense_path(form)
    if form == "off":
        return compile_path(name, OFF_WIDTH)
    return compile_default_path(name)


def step_cases(path):
    """A path's kernel steps as ``KERNEL_STEPS`` records them: its width
    and the count of each kind."""
    return path["W"], {k: len(v) for k, v in sorted(path["cases"].items())}


def f64_case(path, kind):
    """Whether the kind's largest step takes the float64 check: a kind of
    ``F64_KINDS`` whose X and Y of one slice instance fit
    ``F64_MAX_ELEMS``."""
    if kind not in F64_KINDS or kind not in path["cases"]:
        return False
    plan, bx, by = path["cases"][kind][largest_step(path["cases"], kind)]
    if kind == "pair":
        x_n, y_n = plan.K * plan.M, plan.M * plan.N
    elif kind == "gk":
        x_n, y_n = plan.x_elems, plan.y_elems
    else:
        row = plan.row
        x_n = plan.bi_rows * (row.x_elems if kind == "ggk"
                              else row.F * row.K)
        y_n = plan.B * (row.y_elems if kind == "ggk" else row.F * row.H)
    return x_n + y_n <= F64_MAX_ELEMS


def mma_steps(path, kind):
    """Indices of the kind's steps that run a tensor-core form at the
    path's width."""
    return [i for i, (plan, bx, by) in enumerate(path["cases"].get(kind, []))
            if step_form(kind, plan, path["W"], bx, by) == "mma"]


# -- launch counts ------------------------------------------------------------

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
                  f"form, expected {want} (launch_forms of its steps)")
    return counts, forms


def permute_held(name, perm, st, once=False, what="permute"):
    """The permute-copy kernel's reorders in a run (``perm``, as
    ``counted_on_card`` counts them; ``st``: the run's ``captures``,
    ``warmup_groups`` and ``replays``), or (``what``) the complex
    matmul's routed dot products.  A capture records one slice
    group's reorders without a launch, so the reorders made less the
    launches, over the captures, are a group's (``per_group``); the
    warm-up groups launched as many each (``once``: and the steps the run
    makes once, a block walk's), and the card ran those launches and
    every replay's group.  Returns the counts."""
    recorded = perm["made"] - perm["launches"]
    caps = st["captures"]
    check(caps > 0 and recorded % caps == 0,
          f"{name} {what}: {recorded} recorded in {caps} captures, not as "
          "many in each")
    per = recorded // caps
    extra = perm["launches"] - per * st["warmup_groups"]
    check(extra >= 0 if once else extra == 0,
          f"{name} {what}: {perm['launches']} launches, {per} a group in "
          f"{st['warmup_groups']} warm-up groups")
    ran = sum(perm["runs"].values())
    want = perm["launches"] + per * st["replays"]
    check(ran == want, f"{name} {what}: {ran} kernels run on the card "
          f"({json.dumps(perm['runs'])}), expected {want}: the "
          f"{perm['launches']} launches and {per} a replay over "
          f"{st['replays']} replays")
    return dict(per_group=per, launches=perm["launches"],
                device_launches=ran, device_modes=perm["runs"],
                once=extra)


def cmm_held(name, cmm, st, once=False):
    """The complex matmul's launches in a run (``cmm``, as
    ``counted_on_card`` counts them), held to the dot products the run
    routed to it as ``permute_held`` holds the copy kernel's to its
    reorders: a group's products are those a capture recorded, the
    warm-up groups launched as many each, and the card ran those and
    every replay's.  Returns the counts."""
    return permute_held(name, cmm, st, once, what="complex_mm")


def permute_counts():
    """The permute-copy kernel's counts so far: the reorders the port
    made (``made``: the ``tracing`` counters ``permute.row`` and
    ``permute.tile``, launched or recorded into a graph under capture),
    the launches made (``permute_copy.launches``) and the launches that
    ran on the card, by mode (``permute.permute_runs``)."""
    from artensor_tpu_torch.ops import permute
    from artensor_tpu_torch.runtime import tracing

    c = tracing.counters()
    return dict(made=c.get("permute.row", 0) + c.get("permute.tile", 0),
                launches=permute.permute_copy.launches,
                runs=permute.permute_runs())


def cmm_counts():
    """The complex matmul's counts so far: the dot products the port made
    on it (``made``: the ``tracing`` counter ``dot.cmm``, launched or
    recorded into a graph under capture), the launches made
    (``complex_batched_matmul.launches``) and the launches that ran on
    the card (``kernels.device_runs``)."""
    from artensor_tpu_torch.kernels import device_runs
    from artensor_tpu_torch.ops import pallas_mm
    from artensor_tpu_torch.runtime import tracing

    return dict(made=tracing.counters().get("dot.cmm", 0),
                launches=pallas_mm.complex_batched_matmul.launches,
                runs={"cmm": device_runs()[("complex_mm", None)]})


def counted_on_card(fn):
    """``fn()`` and the port's kernels that the card ran meanwhile, as the
    kernels count themselves (``kernels.device_runs``: each kernel's first
    thread adds one to its slot, so a graph replay counts as a launch
    does): by kind, and for GK and GGK by form; and the permute-copy
    kernel's counts over the call (``permute_counts``) and the complex
    matmul's (``cmm_counts``).  Not a ``torch.profiler`` trace: on the
    H100 it lost a dense run's device events now and then, GK kernels
    among them."""
    import torch

    from artensor_tpu_torch.kernels import device_runs

    before, perm, cmm = device_runs(), permute_counts(), cmm_counts()
    out = fn()
    torch.cuda.synchronize()
    after, perm_after, cmm_after = (device_runs(), permute_counts(),
                                    cmm_counts())
    held = lambda b, a: dict(  # noqa: E731
        made=a["made"] - b["made"], launches=a["launches"] - b["launches"],
        runs={m: n - b["runs"][m] for m, n in a["runs"].items()})
    perm, cmm = held(perm, perm_after), held(cmm, cmm_after)
    counts = dict.fromkeys(KERNELS, 0)
    forms = {k: {} for k in FORM_KINDS}
    for (kind, form), n in after.items():
        n -= before[kind, form]
        if kind in counts:
            counts[kind] += n
        if kind in forms and n:
            forms[kind][form] = n
    return out, dict(counts=counts, forms=forms, permute=perm, cmm=cmm)


def wrappers():
    """The kernel wrappers by kind."""
    return {k: wrapper(v[0]) for k, v in KERNELS.items()}


def reset_counts(wraps):
    """Zero the wrappers' launch counts (by form too)."""
    for f in wraps.values():
        f.launches = 0
    for kind in FORM_KINDS:
        for form in getattr(wraps.get(kind), "forms", ()):
            wraps[kind].forms[form] = 0


def run_counts(path, wraps, ran, st):
    """The kernel launches of the run just made, two ways: the wrappers'
    counts (``launches``, the launches they made: the warm-up group's and
    the steps run once eagerly; a capture records the kernels and a
    replay calls no wrapper), and the kernels that the card ran
    (``device_launches``, the kernels' own counts: the warm-up group's and
    every replay's).  Each is held to the census times the groups it
    covers; the permute-copy kernel's to its reorders a group
    (``permute_held``), the complex matmul's to its routed dot products a
    group (``cmm_held``)."""
    launches, forms = check_counts(
        path, {k: f.launches for k, f in wraps.items()},
        {k: dict(wraps[k].forms) for k in FORM_KINDS},
        st["warmup_groups"], "launches")
    device, device_forms = check_counts(
        path, ran["counts"], ran["forms"],
        st["warmup_groups"] + st["replays"], "kernels run on the card")
    once = bool(path.get("census_once"))
    perm = permute_held(path["name"], ran["permute"], st, once=once)
    cmm = cmm_held(path["name"], ran["cmm"], st, once=once)
    return dict(launches=launches, forms=forms, device_launches=device,
                device_forms=device_forms, replays=st["replays"],
                warmup_groups=st["warmup_groups"], permute=perm, cmm=cmm)


def main_run(path, wraps, report=None):
    """The path through ``contraction()``, as a user calls it (graph
    replay on the card) at the path's width, the launch counts zeroed
    first: its launches held to its census (``run_counts``) and its
    groups reordering through the permute-copy kernel.  Returns the
    amplitudes and the counts."""
    sim, W = path["sim"], path["W"]
    reset_counts(wraps)
    amps, ran = counted_on_card(lambda: sim.contraction(
        slice_batch=W, device=DEVICE, report=report))
    st = sim.run_stats
    check(st["executor"] == "graph" and st["slice_batch"] == W,
          f"{path['name']}: ran as {st['executor']} at width "
          f"{st['slice_batch']}, not graph replay at {W}")
    counts = run_counts(path, wraps, ran, st)
    check(counts["permute"]["per_group"] > 0,
          f"{path['name']}: no reorder through the permute-copy kernel")
    return amps, counts
