"""The port's n30 m14 paths on the card at their full size (``card_paths``):
every kernel step of every path against its plain version, the synthetic
steps no path has, each path end to end against its JAX fixture with its
kernel launches held to its census, the other execution modes, the field
modes, the planned paths, the command line and the multi-device layer.

Marked ``gpu``: skipped where no card is present, and failed there in a
run that asks for the card tests (``-m gpu``).  ``chip_smoke.py`` runs
them after its own checks; alone, on a machine with a card:

    python -m pytest --noconftest tests/test_torch_card_paths.py -q -m gpu

The paths compile once each on the card's host and are kept for the
module (``_path``); a test that measures the card's peak frees what
earlier tests left first (``_fresh``)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import card_paths as cp

pytestmark = pytest.mark.gpu

SEGMENT_STEPS = 16            # steps a segment in the segmented runs
SEGMENT_COST_WIDTH = 8        # the segmented run also at this width
CKPT_WIDTH = 16               # the checkpointed run's width (a chunk's)
CKPT_MODE_WIDTHS = (16, 32)   # the complex mode's: written, resumed
PLANNED_SC = 24               # the planned 1k path: the port plans the 1k
                              # fixture's batch at this sc_target through
                              # quantum_circuit_simulation
PLANNED_WALK = (4, 28)        # the planned walk: prepare_output_sharded(
                              # d_out, sc_target) under PlannerConfig's
                              # defaults, 16 blocks of 2^26 amplitudes
CLI_BENCH_WIDTH = 64          # bench's --slice-batch: 1k/default's width
MESH_DEVICES = ("cuda:0", "cuda:0")   # two replicas on the one card, the
                              # stand-in for two cards
MESH_WIDTH = 32               # each replica's slice width: half of
                              # 1k/default's 64 (two pools share the card)
DIST_TIMEOUT = 300            # seconds, each torch.distributed process


@pytest.fixture(scope="module")
def card(request):
    """The kernels built, TF32 off in PyTorch's own products; the kernel
    wrappers by kind.  Without a card: skipped, or failed in a run of the
    card tests (``card_paths.require_card``)."""
    cp.require_card(request.config)
    from artensor_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.load()
    return cp.wrappers()


_PATHS = {}


def _path(label):
    """A path by its label, compiled once for the module."""
    if label not in _PATHS:
        _PATHS[label] = (cp.compile_block_path(_path("dense/default"))
                         if label == "dense-blocks"
                         else cp.compile_label(label))
    return _PATHS[label]


def _fresh():
    """Free what earlier tests left cached: the kept paths' device index
    tables (``_dev``), the allocator's free blocks and every stream's
    cuBLAS workspace, so that a run's measured peak counts its own
    allocations."""
    for p in list(_PATHS.values()) + list(_PLANNED.values()):
        for cases in p["cases"].values():
            for plan, _, _ in cases:
                for obj in (plan, getattr(plan, "row", None)):
                    if hasattr(obj, "_dev"):
                        obj._dev.clear()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _check_peak(path, peak):
    from artensor_tpu_torch.planner.cost import PEAK_RESERVE_BYTES

    covered = path["model_peak"] + path["staged"] + PEAK_RESERVE_BYTES
    assert peak <= covered, (path["name"], peak, covered)
    assert path["model_peak"] >= cp.PEAK_MODEL_SHARE * peak, \
        (path["name"], path["model_peak"], peak)


# -- amplitudes and states ----------------------------------------------------

def _sparse_ref(sim, ref):
    return np.array([ref[b] for b in sim.bitstrings_sorted])


def _qubit(bond):
    return int(str(bond).split("-")[1])


def _flat_index(bits, bonds):
    """Index of each bitstring (MSB first, qubit 0 first) in a flat state
    whose axes are the open legs ``bonds`` in order."""
    digits = np.array([[int(c) for c in b] for b in bits], dtype=np.int64)
    n = len(bonds)
    return sum(digits[:, _qubit(b)] << (n - 1 - a)
               for a, b in enumerate(bonds))


def _norm2(re, im, chunk=1 << 26):
    """Sum of |amplitude|^2 over a flat split state, in float64 on the
    device, a chunk at a time."""
    tot = torch.zeros((), dtype=torch.float64, device=re.device)
    fr, fi = re.reshape(-1), im.reshape(-1)
    for s in range(0, fr.numel(), chunk):
        tot += fr[s:s + chunk].double().square().sum() \
            + fi[s:s + chunk].double().square().sum()
    return tot.item()


def _state_gate(got, ref, chunk=1 << 26):
    """max|got - ref| over two flat split results on the card, and the
    largest share of the fixture gate (``AMP_RTOL*|ref| +
    AMP_RMS_TOL*rms(ref)``) it reaches, a chunk at a time."""
    gr, gi = (c.reshape(-1) for c in got)
    rr, ri = (c.reshape(-1) for c in ref)
    rms = (_norm2(rr, ri) / rr.numel()) ** 0.5
    d_max = share = 0.0
    for s in range(0, rr.numel(), chunk):
        sl = slice(s, s + chunk)
        d = torch.hypot(gr[sl] - rr[sl], gi[sl] - ri[sl])
        bound = cp.AMP_RTOL * torch.hypot(rr[sl], ri[sl]) \
            + cp.AMP_RMS_TOL * rms
        d_max = max(d_max, d.max().item())
        share = max(share, (d / bound).max().item())
    return d_max, share


def _as_pair(field, x):
    """A field's value on the card as two real views (re, im)."""
    bufs = field.buffers(x)
    if len(bufs) == 2:
        return bufs
    (t,) = bufs
    if t.is_complex():
        return t.real, t.imag
    v = t.reshape(t.shape[:-1] + (-1, 2))
    return v[..., 0], v[..., 1]


def _field_amps(path, field, res):
    """``(amplitudes, fixture values)`` of a run's flat result in
    ``field``'s form: a sparse path's every amplitude, a dense state's
    fixture amplitudes read on the card (its output order applied to the
    indices, not to the state)."""
    sim, ref = path["sim"], path["ref"]
    if sim.pattern == "sparse":
        amps = field.unwrap(res).reshape(sim.out_shape).transpose(
            sim.permute_dims)
        return amps, _sparse_ref(sim, ref)
    bits = list(ref)
    idx = torch.as_tensor(_flat_index(bits, sim.output_bonds),
                          device=cp.DEVICE)
    re, im = (c.reshape(-1)[idx] for c in _as_pair(field, res))
    return (re.double().cpu().numpy() + 1j * im.double().cpu().numpy(),
            np.array([ref[b] for b in bits]))


def _fixture_gate(path, res):
    """A run's flat split result against the fixture (``_amp_check``)."""
    from artensor_tpu_torch.ops.field import SplitField

    cp.amp_check(*_field_amps(path, SplitField(), res))


def _dense_state(dense):
    """The dense default path's whole state on the card (a split pair,
    ``output_bonds`` order), as ``prepare()`` runs it."""
    run = dense["sim"].prepare(slice_batch=1, device=cp.DEVICE)
    state = run()
    del run
    return state


# -- kernel steps -------------------------------------------------------------

def _seed(kind):
    return list(cp.KERNELS).index(kind)


def _kernel_check(kind, plan, bx, by, width, seed, f64=False):
    """One kernel call against its plain version at slice width ``width``
    (``KERNEL_RTOL``); a GK or GGK call's bytes as ``gatherk.gk_bytes``
    counts them; the PyTorch yardstick (GK, Pair, Lane up to
    ``LIBRARY_MAX_WIDTH``) equal to the plain version within the same
    tolerance; an RGRow or RGFlat step through ``apply_ggk_step`` (the
    kernel and any copy around it, as the executor runs it) equal to the
    kernel's output; with ``f64`` the kernel's error against a float64
    product at most ``F64_ERR_RATIO`` times the plain version's."""
    from artensor_tpu_torch.runtime import gatherk

    ops = cp.kernel_operands(kind, plan, bx, by, width, seed)
    call, plain, args = ops["call"], ops["plain"], ops["args"]
    kr, ki = call(*args)
    err, scale, (pr, pi) = cp.plain_error(
        kr, ki, cp.plain_chunks(plain, args, width), ops["xs"] or ops["ws"])
    torch.cuda.synchronize()
    tol = cp.KERNEL_RTOL * scale + cp.KERNEL_ATOL
    assert np.isfinite(err) and err <= tol, (cp.describe(kind, plan), err,
                                             tol)
    if kind in cp.FORM_KINDS:
        nbytes, _ = cp.step_bytes_flops(ops, plan, width)
        assert nbytes == gatherk.gk_bytes(plan, width, ops["xs"], ops["ws"])
    if f64:
        e = cp.f64_errors(kr, ki, pr, pi, plain, args)
        assert e["f64_rel_err"] <= cp.F64_ERR_RATIO * e["plain_f64_rel_err"], e
    if kind in ("rgrow", "rgflat"):
        from artensor_tpu_torch.ops.field import SplitField

        _, xr, xi, wr, wi, xs, ws = args
        x, w = (xr, xi), (wr, wi)
        pi_, pj, bi, bj = (x, w, xs, ws) if plan.row.w_is_j \
            else (w, x, ws, xs)
        yr, yi = gatherk.apply_ggk_step(SplitField(), pi_, pj, plan, bi, bj)
        assert torch.equal(yr.reshape(kr.shape), kr)
        assert torch.equal(yi.reshape(ki.shape), ki)
        del yr, yi
    del kr, ki
    lib = cp.library_call(kind, plan, args, width)
    if lib is not None:
        assert lib[1](pr, pi) <= tol
    del ops, args, pr, pi, lib
    torch.cuda.empty_cache()


def _one_pass_check(kind, plan, bx, by, width, seed):
    """The kernel's one-pass TF32 form (``passes=1``: precision 'default')
    counted as one one-pass launch and held to the plain version's TF32
    form (operands rounded as the kernel rounds them, products in
    float32) within ``ONE_PASS_RTOL``."""
    ops = cp.kernel_operands(kind, plan, bx, by, width, seed)
    call, plain, args = ops["call"], ops["plain"], ops["args"]
    before = call.one_pass
    kr, ki = call(*args, passes=1)
    torch.cuda.synchronize()
    assert call.one_pass == before + 1
    err, scale, _ = cp.plain_error(
        kr, ki, cp.plain_chunks(plain, args, width, tf32=True),
        ops["xs"] or ops["ws"])
    tol = cp.ONE_PASS_RTOL * scale + cp.ONE_PASS_ATOL
    assert np.isfinite(err) and err <= tol, (cp.describe(kind, plan), err,
                                             tol)
    del ops, args, kr, ki
    torch.cuda.empty_cache()


def _step_cases(paths):
    return [pytest.param(label, kind, i, id=f"{label}-{kind}{i}")
            for label, (_, kinds) in paths.items()
            for kind, n in sorted(kinds.items()) for i in range(n)]


def _kind_cases(pairs):
    return [pytest.param(label, kind, id=f"{label}-{kind}")
            for label, kind in pairs]


@pytest.mark.parametrize("label,kind,i", _step_cases(cp.KERNEL_STEPS))
def test_kernel_step_matches_plain(card, label, kind, i):
    """Every kernel step of every path at the path's width, with the
    operand batching of the main path."""
    path = _path(label)
    plan, bx, by = path["cases"][kind][i]
    _kernel_check(kind, plan, bx, by, path["W"], _seed(kind))


@pytest.mark.parametrize("label,kind", _kind_cases(
    (label, kind) for label, (W, kinds) in cp.KERNEL_STEPS.items() if W > 1
    for kind in sorted(kinds)))
def test_largest_step_at_width_one(card, label, kind):
    """Each kind's largest step (by flops) also at slice width 1."""
    path = _path(label)
    plan, bx, by = path["cases"][kind][cp.largest_step(path["cases"], kind)]
    _kernel_check(kind, plan, bx, by, 1, _seed(kind))


@pytest.mark.parametrize("label,kind", _kind_cases(cp.F64_CASES))
def test_largest_step_against_float64(card, label, kind):
    """At each kind's largest step, over two slice instances, the kernel's
    error against a float64 product of the same inputs is at most
    ``F64_ERR_RATIO`` times the plain version's (float32 on cuBLAS)."""
    path = _path(label)
    plan, bx, by = path["cases"][kind][cp.largest_step(path["cases"], kind)]
    _kernel_check(kind, plan, bx, by, path["W"], _seed(kind), f64=True)


@pytest.mark.parametrize("label,kind", _kind_cases(cp.ONE_PASS_CASES))
def test_one_pass_at_largest_mma_step(card, label, kind):
    """The one-pass TF32 form at the kind's largest step that runs a
    tensor-core form at the path's width."""
    path = _path(label)
    i = max(cp.mma_steps(path, kind),
            key=lambda i: path["cases"][kind][i][0].flops)
    plan, bx, by = path["cases"][kind][i]
    _one_pass_check(kind, plan, bx, by, path["W"], _seed(kind))


# -- the synthetic steps ------------------------------------------------------

@pytest.mark.parametrize("form", list(cp.LANE_FORMS))
def test_lane_kernel_at_forms_the_paths_lack(card, form):
    """The lane kernel on the head orientation, combo legs and a pinned
    grid leg (X of 2^24 elements) at width 1, and its yardstick."""
    from artensor_tpu_torch.runtime import lanes

    ix_x, ix_w, iy, dx, dw, kw = cp.LANE_FORMS[form]
    plan = lanes.plan_lane_step(ix_x, ix_w, iy, dx, dw, **kw)
    assert plan is not None, lanes.LAST_REJECT
    _kernel_check("lane", plan, False, False, 1,
                  100 + list(cp.LANE_FORMS).index(form))


@pytest.mark.parametrize("bmkn", cp.CMM_SHAPES + cp.CMM_DOT_SHAPES, ids=str)
def test_complex_matmul_at_card_shapes(card, bmkn):
    """The complex batched matmul against its plain version at
    ``CMM_SHAPES`` (with ``torch.matmul`` of complex64 as its yardstick
    and its one-pass form against the plain TF32 form) and at the
    benchmark cells' largest dot products (``CMM_DOT_SHAPES``): where
    ``cmm_route`` sends the product to the kernel, its error against
    float64 on the first ``F64_ROWS`` rows (columns, for the role swap)
    at most twice cuBLAS's.  The card runs the kernel once a call."""
    from artensor_tpu_torch.kernels import device_runs
    from artensor_tpu_torch.ops import pallas_mm

    B, M, K, N = bmkn
    gen = torch.Generator(device=cp.DEVICE).manual_seed(200)
    a = tuple(torch.randn((B, M, K), generator=gen, device=cp.DEVICE)
              for _ in range(2))
    b = tuple(torch.randn((B, K, N), generator=gen, device=cp.DEVICE)
              for _ in range(2))
    before = device_runs()[("complex_mm", None)]
    kr, ki = pallas_mm.complex_batched_matmul(a, b)
    pr, pi = pallas_mm.complex_batched_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert device_runs()[("complex_mm", None)] == before + 1
    err = torch.abs(torch.complex(kr - pr, ki - pi)).max().item()
    scale = torch.abs(torch.complex(pr, pi)).max().item()
    tol = cp.KERNEL_RTOL * scale + cp.KERNEL_ATOL
    assert np.isfinite(err) and err <= tol, (err, tol)
    if bmkn in cp.CMM_DOT_SHAPES:
        if pallas_mm.cmm_route(B, M, K, N, cp.DEVICE, "highest", "naive",
                               "f32"):
            rows = (slice(None), slice(0, cp.F64_ROWS), slice(None))
            cols = (slice(None), slice(None), slice(0, cp.F64_ROWS))
            cut = rows if M >= N else cols
            sa = tuple(t[:, cut[1]].double() for t in a)
            sb = tuple(t[:, :, cut[2]].double() for t in b)
            f64 = torch.complex(*pallas_mm.complex_batched_matmul_plain(
                sa, sb))
            e64 = lambda y: torch.abs(torch.complex(  # noqa: E731
                y[0][cut].double(), y[1][cut].double()) - f64).max().item()
            assert e64((kr, ki)) <= 2 * e64((pr, pi)), \
                (e64((kr, ki)), e64((pr, pi)))
        return
    ref = torch.complex(pr, pi)
    lib = torch.matmul(torch.complex(*a), torch.complex(*b))
    assert torch.abs(lib - ref).max().item() <= tol
    before = pallas_mm.complex_batched_matmul.one_pass
    kr, ki = pallas_mm.complex_batched_matmul(a, b, passes=1)
    tr, ti = pallas_mm.complex_batched_matmul_plain(a, b, tf32=True)
    torch.cuda.synchronize()
    assert pallas_mm.complex_batched_matmul.one_pass == before + 1
    tref = torch.complex(tr, ti)
    err1 = torch.abs(torch.complex(kr, ki) - tref).max().item()
    tol1 = cp.ONE_PASS_RTOL * torch.abs(tref).max().item() + cp.ONE_PASS_ATOL
    assert np.isfinite(err1) and err1 <= tol1, (err1, tol1)


@pytest.mark.parametrize("step", list(cp.PERMUTE_STEPS))
def test_permute_kernel_at_path_reorders(card, step):
    """The permute-copy kernel at the main path's largest reorders: a
    split pair in one launch, which the card runs once, each component
    bit for bit PyTorch's strided copy of the same view."""
    from artensor_tpu_torch.ops import permute

    sizes, strides, ncomp = cp.PERMUTE_STEPS[step]
    n = 1 + sum((d - 1) * st for d, st in zip(sizes, strides))
    gen = torch.Generator(device=cp.DEVICE).manual_seed(300)
    src = [torch.randn(n, generator=gen, device=cp.DEVICE)
           for _ in range(ncomp)]
    views = tuple(x.as_strided(sizes, strides) for x in src)
    outs = tuple(torch.empty(sizes, device=cp.DEVICE) for _ in views)
    _, ran = cp.counted_on_card(lambda: permute.copy(views, outs))
    perm = ran["permute"]
    assert perm["launches"] == 1 == sum(perm["runs"].values()), perm
    want = torch.empty(sizes, device=cp.DEVICE)
    for v, o in zip(views, outs):
        want.copy_(v)
        assert torch.equal(o.view(torch.int32), want.view(torch.int32))


def test_ggk_mma_form_at_a_synthetic_step(card):
    """GGK's mma form where no path has one: ``GGK_MMA_STEP`` (K 32 H 32
    F 512) plans in that form, against its plain version, and its
    one-pass form against the plain TF32 form."""
    from artensor_tpu_torch.runtime import gatherk

    plan = cp.plan_ggk_mma_step()
    assert plan is not None and isinstance(plan.row, gatherk.GKPlan), \
        gatherk.LAST_REJECT
    assert gatherk.gk_form(plan, 1, False, False) == "mma"
    _kernel_check("ggk", plan, False, False, 1, 300)
    _one_pass_check("ggk", plan, False, False, 1, 300)


@pytest.mark.parametrize("form", ["stream", "mma"])
def test_ggk_cut_step_in_both_forms(card, monkeypatch, form):
    """The 1k/default path's K 16 H 16 F 512 GGK step, which
    ``gatherk.gk_form``'s cut for GGK decides, at the path's width in
    each form of the GK kernel, against its plain version."""
    from artensor_tpu_torch.runtime import gatherk

    path = _path("1k/default")
    steps = [c for c in path["cases"].get("ggk", [])
             if isinstance(c[0].row, gatherk.GKPlan)
             and (c[0].row.K, c[0].row.H, c[0].row.F) == cp.GGK_CUT_STEP]
    assert steps
    plan, bx, by = steps[0]
    monkeypatch.setattr(gatherk, "gk_form", lambda *a, **k: form)
    _kernel_check("ggk", plan, bx, by, path["W"], 400)


# -- the paths end to end -----------------------------------------------------

def _timed_runs(fn, n=3):
    """Host seconds of ``n`` calls of ``fn``, each to its result's first
    value on the host."""
    import time

    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        out[0].reshape(-1)[0].item()
        walls.append(time.perf_counter() - t0)
        del out
    return walls


def _graph_vs_eager(path, held=0, reorders=None):
    """The path's whole run, as graph replay and eagerly, on the same
    staged inputs: the graph run from a fresh allocator (its first call,
    capture included, then three warm runs: one capture, a replay a group
    a run), its peak (less ``held`` and the first result, which the
    comparison keeps) held to the model; the eager run's first call
    launching the permute kernel for a group's ``reorders`` in every
    group; the two results within the fixture's gate of each other and
    each within it of the fixture.  Returns the median warm wall of the
    graph runs."""
    import statistics

    from artensor_tpu_torch.runtime import executor as ex

    sim, W, name = path["sim"], path["W"], path["name"]
    _fresh()
    field, run_steps, arrays, out_shape, execute, _ = sim._staged(
        torch.device(cp.DEVICE))
    mk = lambda eager: ex.make_sliced_runner(  # noqa: E731
        execute, run_steps, sim.slicing_axes, len(sim.slicing_bonds),
        out_shape, field, slice_batch=W, eager=eager)
    run = mk(False)
    res_g = run(arrays)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    walls = _timed_runs(lambda: run(arrays))
    peak = max(peak, torch.cuda.max_memory_allocated() - held
               - _nbytes(*res_g))
    assert run.stats["captures"] == 1, run.stats
    assert run.stats["replays"] == 4 * path["n_slices"] // W, run.stats
    del run
    run = mk(True)
    res_e, ran = cp.counted_on_card(lambda: run(arrays))
    del run
    eager = ran["permute"]
    if reorders is not None:
        groups = path["n_slices"] // W
        assert eager["launches"] == eager["made"] == \
            sum(eager["runs"].values()) == reorders * groups, (eager, groups)
    _, share = _state_gate(res_g, res_e)
    assert share <= 1.0, (name, share)
    _fixture_gate(path, res_g)
    _fixture_gate(path, res_e)
    _check_peak(path, peak)
    del res_g, res_e, arrays
    return statistics.median(walls)


def _drive(path, wraps):
    """A sparse path end to end: ``contraction()`` (its report, its
    launches against the census, every amplitude against the fixture),
    graph against eager, and the floor (``metrics.scheme_roofline_seconds``
    x its slices) below the warm wall."""
    from artensor_tpu_torch.runtime.metrics import ContractionReport

    sim, ref = path["sim"], path["ref"]
    _fresh()
    amps, counts = cp.main_run(path, wraps, ContractionReport())
    assert amps.shape == (len(ref),)
    cp.amp_check(amps, _sparse_ref(sim, ref))
    warm = _graph_vs_eager(path, reorders=counts["permute"]["per_group"])
    assert 0 < path["roof_s"] / warm <= 1, (path["roof_s"], warm)


SPARSE = [f"{w}/{f}" for w in cp.PATHS for f in ("off", "default")]


@pytest.mark.parametrize("label", SPARSE)
def test_sparse_path_end_to_end(card, label):
    _drive(_path(label), card)


@pytest.mark.parametrize("form", ["off", "default"])
def test_dense_path_end_to_end(card, form):
    """The whole 2^30-amplitude state through ``prepare()`` (one graph,
    captured at its first call): the launches of the run against the
    census, the 11000 fixture amplitudes read from the state on the card,
    its norm^2 in float64 within ``NORM_TOL`` of 1, then graph against
    eager with the state held apart."""
    path = _path(f"dense/{form}")
    sim = path["sim"]
    _fresh()
    cp.reset_counts(card)
    run = sim.prepare(slice_batch=1, device=cp.DEVICE)
    (re, im), ran = cp.counted_on_card(run)
    st = dict(run.stats)
    del run
    assert st["captures"] == 1 and st["replays"] == 1, st
    counts = cp.run_counts(path, card, ran, st)
    assert counts["permute"]["per_group"] > 0
    n_q = cp.CIRCUIT["rows"] * cp.CIRCUIT["cols"]
    assert re.numel() == 2 ** len(sim.output_bonds) == 2 ** n_q
    amps, r = _field_amps(path, sim.field, (re, im))
    cp.amp_check(amps, r)
    assert abs(_norm2(re, im) - 1) <= cp.NORM_TOL
    _graph_vs_eager(path, held=_nbytes(re, im),
                    reorders=counts["permute"]["per_group"])


def _block_walk(path, post, eager=False, mode="split"):
    return list(path["sim"].contraction_output_blocks(
        path["d_out"], mode=mode, postprocess=post, device=cp.DEVICE,
        eager=eager))


def _block_index(path, state_bonds):
    """``index(oid)``: the flat indices in the whole state (axes
    ``state_bonds``) of block ``oid``'s amplitudes, in the block's own
    order; and the block's leading qubits."""
    d_out, n_q = path["d_out"], len(state_bonds)
    L = n_q - d_out
    pos = {_qubit(b): a for a, b in enumerate(state_bonds)}
    lead_q = sorted(pos)[:d_out]
    tab = {}

    def index(oid):
        if "local" not in tab:      # the block scheme's axes are known now
            ar = torch.arange(2 ** L, device=cp.DEVICE)
            tab["local"] = sum(((ar >> (L - 1 - p)) & 1)
                               << (n_q - 1 - pos[_qubit(b)])
                               for p, b in enumerate(
                                   path["sim"].block_output_bonds))
        return tab["local"] + sum(
            int(c) << (n_q - 1 - pos[q])
            for q, c in zip(lead_q, np.binary_repr(oid, d_out)))
    return index, lead_q


def _walk_peak(path, state):
    """The card's peak over four walks (each block's postprocess pulls one
    value), less the whole state held."""
    touch = lambda field, oid, raw: tuple(  # noqa: E731
        c.reshape(-1)[:1] for c in raw)
    _fresh()
    for _ in range(4):
        _block_walk(path, touch)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - _nbytes(*state)


def _drive_blocks(path, wraps, state, state_bonds):
    """A block walk end to end: every block on the card against the same
    block of the whole state ``state`` within ``BLOCK_TOL`` x its rms,
    the blocks in order; the fixture amplitudes and the norm^2 from the
    blocks; the launches of the walk against its census (the steps run
    once apart); the walk's peak (the state held apart) against the
    model.  Returns the peak."""
    ref = path["ref"]
    d_out, k = path["d_out"], path["k"]
    n = 2 ** d_out
    full = [c.reshape(-1) for c in state]
    rms = (_norm2(*state) / full[0].numel()) ** 0.5
    bits = list(ref)
    index, lead_q = _block_index(path, state_bonds)
    oid_of = np.array([int("".join(b[q] for q in lead_q), 2) for b in bits])
    fix = {}

    def check_block(field, oid, raw):
        if "idx" not in fix:
            fix["idx"] = torch.as_tensor(_flat_index(
                bits, path["sim"].block_output_bonds), device=cp.DEVICE)
        idx = index(oid)
        r, i = (c.reshape(-1) for c in raw)
        d = torch.hypot(r - full[0][idx], i - full[1][idx]).max()
        nrm = r.double().square().sum() + i.double().square().sum()
        loc = fix["idx"][torch.as_tensor(np.nonzero(oid_of == oid)[0],
                                         device=cp.DEVICE)]
        stats = torch.stack([d.double(), nrm]).float()
        return (torch.cat([r[loc], stats]),
                torch.cat([i[loc], torch.zeros_like(stats)]))

    _fresh()
    cp.reset_counts(wraps)
    res, ran = cp.counted_on_card(lambda: _block_walk(path, check_block))
    st = dict(path["sim"].block_run_stats)
    assert st["captures"] == 1 and st["replays"] == n * 2 ** k, st
    cp.run_counts(path, wraps, ran, st)
    assert [r[0] for r in res] == [np.binary_repr(o, d_out)
                                   for o in range(n)]
    got = np.zeros(len(bits), dtype=np.complex128)
    for oid, (_, qubits, v) in enumerate(res):
        assert qubits == lead_q
        got[np.nonzero(oid_of == oid)[0]] = v[:-2]
    assert max(float(v[-2].real) for _, _, v in res) <= cp.BLOCK_TOL * rms
    assert abs(sum(float(v[-1].real) for _, _, v in res) - 1) <= cp.NORM_TOL
    cp.amp_check(got, np.array([ref[b] for b in bits]))
    del check_block, index, fix     # the index tables: not the walk's own
    peak = _walk_peak(path, state)
    _check_peak(path, peak)
    return peak


_WALK_PEAK = {}


def test_dense_block_walk(card):
    """``contraction_output_blocks(D_OUT)``: 64 blocks of 2^24, one graph
    replayed a block, against the dense default state; then the same walk
    eagerly (every step from the host), block by block within the
    fixture's gate of the graph walk's blocks."""
    dense, path = _path("dense/default"), _path("dense-blocks")
    state = _dense_state(dense)
    _WALK_PEAK["dense-blocks"] = _drive_blocks(
        path, card, state, dense["sim"].output_bonds)
    del state
    kept = {}

    def keep(field, oid, raw):
        kept[oid] = tuple(c.clone() for c in raw)
        return tuple(c.reshape(-1)[:1] for c in raw)

    _block_walk(path, keep)
    share = []

    def against(field, oid, raw):
        share.append(_state_gate(kept.pop(oid), raw)[1])
        return tuple(c.reshape(-1)[:1] for c in raw)

    _block_walk(path, against, eager=True)
    assert not kept and max(share) <= 1.0, (len(kept), max(share))


# -- the other execution modes ------------------------------------------------

@pytest.mark.parametrize("label", ["1k/default", "dense/default"])
def test_segmented_runs(card, label):
    """The segmented executor (one graph a segment, one pool) at
    ``SEGMENT_STEPS`` steps a segment and as one segment, at the path's
    width and (sparse) at ``SEGMENT_COST_WIDTH``, each run at the width
    asked for as graphs; at the path's width in segments, the result
    against the fixture (and the dense state: within the fixture's gate),
    its peak against the model."""
    from artensor_tpu_torch.runtime import segmented

    path = _path(label)
    sim = path["sim"]
    held = _dense_state(path) if sim.pattern != "sparse" else None
    field, run_steps, arrays, out_shape, _, step = sim._staged(
        torch.device(cp.DEVICE))
    k = len(sim.slicing_bonds)
    held_b = _nbytes(*held) if held is not None else 0
    widths = [path["W"]] + ([SEGMENT_COST_WIDTH]
                            if path["n_slices"] > SEGMENT_COST_WIDTH else [])
    for W in widths:
        for ss in (SEGMENT_STEPS, len(run_steps)):
            _fresh()
            for _ in range(3):
                res = None      # a run's result is not held over the next
                res = segmented.run_segmented(
                    arrays, run_steps, sim.slicing_axes, k, out_shape,
                    field, step, segment_steps=ss, slice_batch=W)
                run = dict(segmented.LAST_RUN)
                assert run["width"] == W and run["graphs"], run
                assert run["segments"] == -(-len(run_steps) // ss), run
            peak = torch.cuda.max_memory_allocated() - held_b
            if W == path["W"] and ss == SEGMENT_STEPS:
                assert run["segments"] > 1
                _fixture_gate(path, res)
                if held is not None:
                    assert _state_gate(res, held)[1] <= 1.0
                _check_peak(path, peak)
            del res


@pytest.mark.parametrize("label", ["1k-sc25/default", "dense/default"])
def test_rescaled_run(card, label):
    """Scientific notation (``runtime/rescaled.py``, width 1, graph
    replay): a sparse path through ``contraction(scientific_notation=
    True)``, the dense state through the rescaled runner on the staged
    inputs; t * 10**f against the fixture (the dense state also within
    ``BLOCK_TOL`` x rms of the default state and its norm^2 within
    ``NORM_TOL``), every mantissa below 10, the peak within the device
    model at width 1."""
    from artensor_tpu_torch.planner.cost import PEAK_RESERVE_BYTES
    from artensor_tpu_torch.runtime import metrics
    from artensor_tpu_torch.runtime.rescaled import make_rescaled_runner

    path = _path(label)
    sim = path["sim"]
    held = None
    if sim.pattern == "sparse":
        _fresh()
        amps, f = sim.contraction(scientific_notation=True, device=cp.DEVICE)
        st = sim.run_stats
        assert st["executor"] == "rescaled" and st["slice_batch"] == 1 \
            and st["graphs"], st
        cp.amp_check(amps * 10.0 ** f, _sparse_ref(sim, path["ref"]))
        mant = float(np.abs(amps).max())
        run_steps = sim._staged(torch.device(cp.DEVICE))[1]
    else:
        held = _dense_state(path)
        _fresh()
        field, run_steps, arrays, out_shape, _, step = sim._staged(
            torch.device(cp.DEVICE))
        run = make_rescaled_runner(step, run_steps, sim.slicing_axes,
                                   len(sim.slicing_bonds), out_shape, field)
        t, fac = run(arrays)
        torch.cuda.synchronize()
        del run, arrays
        f = float(fac)
        mant = max(float(torch.linalg.vector_norm(c, float("inf")))
                   for c in t)
        for c in t:
            c.mul_(10.0 ** f)
        _fixture_gate(path, t)
        # the renormalised products round elsewhere than the plain ones:
        # held to the state as a block is (BLOCK_TOL x rms)
        rms = (_norm2(*held) / held[0].numel()) ** 0.5
        assert _state_gate(t, held)[0] <= cp.BLOCK_TOL * rms
        assert abs(_norm2(*t) - 1) <= cp.NORM_TOL
        del t
    peak = torch.cuda.max_memory_allocated() - (
        _nbytes(*held) if held is not None else 0)
    assert mant < 10.0, mant
    model = metrics.scheme_device_peak_bytes(run_steps, 1, sim.slicing_axes)
    assert peak <= model + path["staged"] + PEAK_RESERVE_BYTES, (peak, model)


class _Interrupted(Exception):
    pass


def _stop_at(slice_no):
    def stop(done, total):
        if done == slice_no:
            raise _Interrupted
    return stop


def test_checkpoint_resume(card, tmp_path):
    """Checkpoint/resume on 10k/default at ``CKPT_WIDTH``, a chunk an
    eighth of the slices: a run stopped on purpose after chunk 3 (the file
    then holds slice 3 * chunk), resumed through ``contraction(
    checkpoint_path=...)`` as graph replay at that width (the 5 chunks
    left), held to the fixture; the file is gone at the end."""
    from artensor_tpu_torch.runtime import executor as ex
    from artensor_tpu_torch.runtime.checkpoint import run_sliced_checkpointed

    path = _path("10k/default")
    sim = path["sim"]
    k = len(sim.slicing_bonds)
    chunk = 2 ** k // 8
    ck = str(tmp_path / "acc.npz")
    field, run_steps, arrays, out_shape, execute, _ = sim._staged(
        torch.device(cp.DEVICE))
    run = ex.make_sliced_runner(execute, run_steps, sim.slicing_axes, k,
                                out_shape, field, slice_batch=CKPT_WIDTH)
    with pytest.raises(_Interrupted):
        run_sliced_checkpointed(run, arrays, k, out_shape, field, ck,
                                chunk=chunk, progress=_stop_at(3 * chunk))
    assert int(np.load(ck)["next_slice"]) == 3 * chunk
    del run, arrays
    amps = sim.contraction(checkpoint_path=ck, slice_batch=CKPT_WIDTH,
                           device=cp.DEVICE)
    st = sim.run_stats
    assert st["executor"] == "checkpointed" and st["graphs"], st
    assert st["slice_batch"] == CKPT_WIDTH, st
    assert st["replays"] == 5 * chunk // CKPT_WIDTH, st
    assert not os.path.exists(ck)
    cp.amp_check(amps, _sparse_ref(sim, path["ref"]))


# -- the number-field modes ---------------------------------------------------

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
ONE_PASS_WRAPPERS = ("runtime.gatherk.gk_call", "runtime.gatherk.ggk_call",
                     "runtime.lanes.pair_call")


def _one_pass_launches():
    return sum(cp.wrapper(spec).one_pass for spec in ONE_PASS_WRAPPERS)


def _mode_run(path, wraps, m):
    """One run of the path in field mode ``m`` at the path's width: a
    sparse path's float32 modes through ``contraction()`` (its
    out-of-memory halving included), the rest through ``make_field`` and
    the sliced runner on the staged inputs.  The kernels of the run: in
    split float32 mode the census, and one-pass launches exactly under
    'default'; no launch at all in any other mode.  Returns ``(field,
    amplitudes, fixture values, the flat result or None, its norm^2 or
    None)``."""
    from artensor_tpu_torch.ops.field import make_field
    from artensor_tpu_torch.runtime import executor as ex

    sim, W = path["sim"], path["W"]
    mode, algo, precision, storage = m
    field = make_field(np.complex64, precision, mode, algo, storage)
    _fresh()
    cp.reset_counts(wraps)
    for spec in ONE_PASS_WRAPPERS:
        cp.wrapper(spec).one_pass = 0
    res = nrm = None
    if sim.pattern == "sparse" and storage == "f32":
        amps = sim.contraction(precision=precision, mode=mode, algo=algo,
                               slice_batch=W, device=cp.DEVICE)
        st = dict(sim.run_stats)
        r = _sparse_ref(sim, path["ref"])
    else:
        _, run_steps, arrays, out_shape, execute, _ = sim._staged(
            torch.device(cp.DEVICE), field)
        run = ex.make_sliced_runner(
            execute, run_steps, sim.slicing_axes, len(sim.slicing_bonds),
            out_shape, field, slice_batch=W)
        res = run(arrays)
        torch.cuda.synchronize()
        st = dict(run.stats)
        del run, arrays
        amps, r = _field_amps(path, field, res)
        if sim.pattern != "sparse":
            re, im = _as_pair(field, res)
            nrm = _norm2(re.float(), im.float())
    launched = {k: f.launches for k, f in wraps.items()}
    if field.supports_lanes:
        cp.check_counts(path, launched,
                        {k: dict(wraps[k].forms) for k in cp.FORM_KINDS},
                        st["warmup_groups"], "launches")
        mma = (wraps["gk"].forms["mma"] + wraps["ggk"].forms["mma"]
               + wraps["pair"].launches)
        assert _one_pass_launches() == (mma if precision == "default"
                                        else 0)
    else:
        assert not any(launched.values()) and _one_pass_launches() == 0, \
            launched
    assert np.isfinite(amps).all()
    return field, amps, r, res, nrm


def _mode_id(m):
    mode, algo, precision, storage = m
    return f"{mode}-{algo}-{precision}" + ("" if storage == "f32"
                                          else f"-{storage}")


@pytest.mark.parametrize("m", (BASE_MODE,) + FULL_MODES + READ_MODES,
                         ids=_mode_id)
@pytest.mark.parametrize("label", FIELD_PATHS)
def test_field_mode_run(card, label, m):
    """A path in each number-field mode (``ops/field.make_field``) at the
    path's width: split/naive/highest and the full-accuracy modes held to
    the fixture gate (a dense state's norm^2 within ``NORM_TOL``; split at
    'high' equal to 'highest', max|d| 0); 'default' and the bf16 and f16
    storage held to finite values only (they miss the gate, as the JAX
    package records); each run's kernel launches as ``_mode_run``
    holds them."""
    path = _path(label)
    field, amps, r, res, nrm = _mode_run(path, card, m)
    if m != BASE_MODE and m not in FULL_MODES:
        return
    cp.amp_check(amps, r)
    if nrm is not None:
        assert abs(nrm - 1) <= cp.NORM_TOL, nrm
    if m[2] == "high":
        _, base, _, _, _ = _mode_run(path, card, BASE_MODE)
        assert np.abs(amps - base).max() == 0.0
        if res is not None:     # the whole state: the default one's
            d, _ = _state_gate(_as_pair(field, res), _dense_state(path))
            assert d == 0.0


@pytest.mark.parametrize("mode", ["complex", "fused"])
def test_field_mode_block_walk(card, mode):
    """``contraction_output_blocks(D_OUT, mode=mode)``: every block
    against the same block of the default state on the card within
    ``BLOCK_TOL`` x its rms, the blocks in order, no kernel launched."""
    dense, path = _path("dense/default"), _path("dense-blocks")
    state = _dense_state(dense)
    full = [c.reshape(-1) for c in state]
    rms = (_norm2(*state) / full[0].numel()) ** 0.5
    index, lead_q = _block_index(path, dense["sim"].output_bonds)

    def against(field, oid, raw):
        idx = index(oid)
        r, i = (c.reshape(-1) for c in _as_pair(field, raw))
        z = field.zeros((1,), cp.DEVICE)
        field.buffers(z)[0].reshape(-1)[0] = torch.hypot(
            r - full[0][idx], i - full[1][idx]).max()
        return z

    before = {k: f.launches for k, f in card.items()}
    res = _block_walk(path, against, mode=mode)
    assert len(res) == 2 ** cp.D_OUT and all(q == lead_q for _, q, _ in res)
    assert {k: f.launches for k, f in card.items()} == before
    worst = max(float(v.reshape(-1)[0].real) for _, _, v in res)
    assert worst <= cp.BLOCK_TOL * rms, (worst, rms)


def test_segmented_fused(card):
    """The segmented executor in the fused mode on 1k/default at the
    path's width: graphs, more than one segment, no kernel launched, the
    result against the fixture."""
    from artensor_tpu_torch.ops.field import make_field
    from artensor_tpu_torch.runtime import segmented

    path = _path("1k/default")
    sim = path["sim"]
    field = make_field(np.complex64, "highest", "fused")
    _, run_steps, arrays, out_shape, _, step = sim._staged(
        torch.device(cp.DEVICE), field)
    before = {k: f.launches for k, f in card.items()}
    res = segmented.run_segmented(arrays, run_steps, sim.slicing_axes,
                                  len(sim.slicing_bonds), out_shape, field,
                                  step, segment_steps=SEGMENT_STEPS,
                                  slice_batch=path["W"])
    run = dict(segmented.LAST_RUN)
    assert {k: f.launches for k, f in card.items()} == before
    assert run["graphs"] and run["segments"] > 1, run
    amps, r = _field_amps(path, field, res)
    cp.amp_check(amps, r)


def test_rescaled_complex(card):
    """Scientific notation in the complex mode on 1k-sc25/default through
    ``contraction(scientific_notation=True, mode='complex')``: graphs, no
    kernel launched, t * 10**f against the fixture."""
    path = _path("1k-sc25/default")
    sim = path["sim"]
    before = {k: f.launches for k, f in card.items()}
    t, f = sim.contraction(scientific_notation=True, mode="complex",
                           device=cp.DEVICE)
    st = dict(sim.run_stats)
    assert {k: f.launches for k, f in card.items()} == before
    assert st["executor"] == "rescaled" and st["graphs"], st
    cp.amp_check(t * 10.0 ** f, _sparse_ref(sim, path["ref"]))


def test_checkpoint_complex(card, tmp_path):
    """Checkpoint/resume in the complex mode on 10k/default: a run at width
    16 stopped after chunk 3 of 8 (the file holds a complex ``acc`` and
    ``next_slice``), resumed through ``contraction(checkpoint_path=...,
    slice_batch=32, mode='complex')``: chunks of 32 from there, the last
    the rest at a width that 32 does not divide, one capture for each
    width used and a replay a group; held to the fixture, no kernel
    launched, the file gone at the end."""
    from artensor_tpu_torch.ops.field import make_field
    from artensor_tpu_torch.runtime import executor as ex
    from artensor_tpu_torch.runtime.checkpoint import run_sliced_checkpointed

    path = _path("10k/default")
    sim = path["sim"]
    k = len(sim.slicing_bonds)
    chunk = 2 ** k // 8
    w1, w2 = CKPT_MODE_WIDTHS
    assert (2 ** k - 3 * chunk) % w2 != 0
    field = make_field(np.complex64, "highest", "complex")
    before = {kk: f.launches for kk, f in card.items()}
    ck = str(tmp_path / "acc.npz")
    _, run_steps, arrays, out_shape, execute, _ = sim._staged(
        torch.device(cp.DEVICE), field)
    run = ex.make_sliced_runner(execute, run_steps, sim.slicing_axes, k,
                                out_shape, field, slice_batch=w1)
    with pytest.raises(_Interrupted):
        run_sliced_checkpointed(run, arrays, k, out_shape, field, ck,
                                chunk=chunk, progress=_stop_at(3 * chunk))
    saved = np.load(ck)
    assert sorted(saved.files) == ["acc", "next_slice"]
    assert int(saved["next_slice"]) == 3 * chunk
    assert np.iscomplexobj(saved["acc"])
    del run, arrays, saved
    amps = sim.contraction(mode="complex", checkpoint_path=ck,
                           slice_batch=w2, device=cp.DEVICE)
    st = dict(sim.run_stats)
    assert not os.path.exists(ck)
    assert {kk: f.launches for kk, f in card.items()} == before
    # the resumed chunks (contraction's chunk: max(width, 2^k / 8)) and
    # the group widths each one runs at
    widths, groups, start = set(), 0, 3 * chunk
    while start < 2 ** k:
        n = min(max(w2, chunk), 2 ** k - start)
        for w, g in ex.group_widths(n, w2):
            widths.add(w)
            groups += g
        start += n
    assert st["executor"] == "checkpointed" and st["graphs"], st
    assert st["captures"] == len(widths) and st["replays"] == groups, \
        (st, widths, groups)
    cp.amp_check(amps, _sparse_ref(sim, path["ref"]))


# -- the planned paths --------------------------------------------------------

_PLANNED = {}


def _planned_1k(wraps):
    """The 1k batch planned by the port as a user calls it
    (``quantum_circuit_simulation(circuit, bits, sc_target=PLANNED_SC)``:
    the native search, the default scheme, a run at width 1 on the card):
    the run graph replay at width 1, every amplitude against the fixture
    keyed by the returned bitstrings, its launches against the census of
    its scheme at width 1.  Kept for the module: the planned path at the
    model's width."""
    if "1k-planned" in _PLANNED:
        return _PLANNED["1k-planned"]
    from artensor_tpu_torch import (TensorNetworkCircuit,
                                    TensorNetworkSimulation, native,
                                    quantum_circuit_simulation,
                                    random_circuit)

    assert native.native_available(), native.build_error()
    ref = cp.load_fixture(cp.PATHS["1k"][1])
    kept = []
    real = TensorNetworkSimulation.prepare_contraction

    def keep(self, *a, **k):     # the one-shot's simulation
        kept.append(self)
        return real(self, *a, **k)

    _fresh()
    cp.reset_counts(wraps)
    TensorNetworkSimulation.prepare_contraction = keep
    try:
        (amps, bits), ran = cp.counted_on_card(
            lambda: quantum_circuit_simulation(
                TensorNetworkCircuit(random_circuit(**cp.CIRCUIT)),
                list(ref), sc_target=PLANNED_SC))
    finally:
        TensorNetworkSimulation.prepare_contraction = real
    (sim,) = kept
    st = sim.run_stats
    assert st["executor"] == "graph" and st["slice_batch"] == 1, st
    cp.amp_check(np.asarray(amps), np.array([ref[b] for b in bits]))
    cp.run_counts(cp.path_state("1k-planned", "one-shot", sim, ref, 1),
                  wraps, ran, st)
    path = cp.path_state("1k-planned", "planned", sim, ref, None)
    path["name"] = "1k-planned"
    _PLANNED["1k-planned"] = path
    return path


def _all_kernel_steps(path):
    """Every kernel step of a path whose plan is made on the card's host
    (its steps are not known before): each at the path's width, each
    kind's largest also at width 1 and (``F64_KINDS``, where it fits)
    against float64, and the one-pass form at the largest mma step."""
    W, cases = path["W"], path["cases"]
    for kind in sorted(cases):
        big = cp.largest_step(cases, kind)
        for i, (plan, bx, by) in enumerate(cases[kind]):
            _kernel_check(kind, plan, bx, by, W, _seed(kind),
                          f64=i == big and cp.f64_case(path, kind))
        if W > 1:
            _kernel_check(kind, *cases[kind][big], 1, _seed(kind))
        mma = cp.mma_steps(path, kind) if kind in cp.ONE_PASS_KINDS else []
        if mma:
            i = max(mma, key=lambda i: cases[kind][i][0].flops)
            _one_pass_check(kind, *cases[kind][i], W, _seed(kind))


def test_planned_1k_kernel_steps(card):
    _all_kernel_steps(_planned_1k(card))


def test_planned_1k_end_to_end(card):
    """The planned 1k path at the model's width as a sparse path is
    driven: its launches against the census, every amplitude, graph
    against eager, its peak and its floor."""
    _drive(_planned_1k(card), card)


def _planned_walk():
    """``prepare_output_sharded(*PLANNED_WALK)`` under ``PlannerConfig``'s
    defaults on the dense network, its block scheme as a path (2^k slices
    a block), kept for the module."""
    if "dense-planned" in _PLANNED:
        return _PLANNED["dense-planned"]
    from artensor_tpu_torch import (TensorNetworkSimulation, native,
                                    random_circuit)
    from artensor_tpu_torch.simulation import _dense_shard_setup

    assert native.native_available(), native.build_error()
    d_out, sc = PLANNED_WALK
    sim = TensorNetworkSimulation.from_circuit(random_circuit(**cp.CIRCUIT))
    sim.prepare_output_sharded(d_out, sc_target=sc)
    steps, axes, chosen, output_bonds, k, _ = _dense_shard_setup(sim, d_out)
    path = cp.block_path(sim, "dense-planned", f"d{d_out}-sc{sc}", steps,
                         axes, chosen, k, d_out, cp.dense_ref(),
                         2 ** len(output_bonds))
    _PLANNED["dense-planned"] = path
    return path


def test_dense_planned_kernel_steps(card):
    _all_kernel_steps(_planned_walk())


def test_dense_planned_walk(card):
    """The planned walk (each block the sum of its 2^k slices, one graph
    replayed a slice) against the dense default state as the post-hoc
    walk is held to it, its peak (the state held apart) below the post-hoc
    walk's."""
    dense, path = _path("dense/default"), _planned_walk()
    state = _dense_state(dense)
    peak = _drive_blocks(path, card, state, dense["sim"].output_bonds)
    if "dense-blocks" not in _WALK_PEAK:
        _WALK_PEAK["dense-blocks"] = _walk_peak(_path("dense-blocks"), state)
    assert peak < _WALK_PEAK["dense-blocks"], (peak, _WALK_PEAK)


# -- the command line ---------------------------------------------------------

def _write_inputs(tmp):
    """The n30 circuit as a qsim file (as tests/test_aux.py writes one)
    and the 1k bitstrings as an ``@file``: their paths and the fixture."""
    from artensor_tpu_torch import random_circuit

    ref = cp.load_fixture(cp.PATHS["1k"][1])
    n, layers = random_circuit(**cp.CIRCUIT)
    lines = [str(n)]
    for li, layer in enumerate(layers):
        for name, qubits, params in layer:
            lines.append(" ".join(
                [str(li), name, *map(str, qubits), *map(str, params)]))
    qsim, bits = tmp / "rcs_n30_m14_s0.qsim", tmp / "bitstrings_1k.txt"
    qsim.write_text("\n".join(lines) + "\n")
    bits.write_text("\n".join(ref) + "\n")
    return str(qsim), "@" + str(bits), ref


def _cli_main(argv):
    """``python -m artensor_tpu_torch`` in this process: its standard
    output and error; an exit is a failure."""
    import contextlib
    import io

    from artensor_tpu_torch.__main__ import main as cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli(argv)
    return out.getvalue(), err.getvalue()


def _cli_amps(text, ref):
    got = {}
    for ln in text.strip().splitlines():
        bs, re, im = ln.split()
        got[bs] = complex(float(re), float(im))
    keys = sorted(ref)
    assert sorted(got) == keys
    cp.amp_check(np.array([got[b] for b in keys]),
               np.array([ref[b] for b in keys]))


def test_cli_simulate_subprocess(card, tmp_path):
    """``python -m artensor_tpu_torch simulate <qsim> --bitstrings @<file>
    --plan <1k plan>`` as a process of its own, the user's path: exit 0,
    every printed amplitude against the fixture."""
    qsim, bits, ref = _write_inputs(tmp_path)
    _fresh()    # the process shares the card with this one
    r = subprocess.run([sys.executable, "-m", "artensor_tpu_torch",
                        "simulate", qsim, "--bitstrings", bits, "--plan",
                        cp.PATHS["1k"][0]], cwd=cp.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    _cli_amps(r.stdout, ref)


def test_cli_simulate_counts_on_card(card, tmp_path):
    """The same command in this process: its scheme is 1k/default's (the
    digest), every amplitude against the fixture, graph replay at width
    1, its launches against the census, a GK, GGK, RGRow and Pair kernel
    among them."""
    from artensor_tpu_torch import TensorNetworkSimulation

    qsim, bits, ref = _write_inputs(tmp_path)
    kept = []
    real = TensorNetworkSimulation.contraction

    def keep(self, *a, **k):     # the CLI's simulation
        kept.append(self)
        return real(self, *a, **k)

    _fresh()
    cp.reset_counts(card)
    TensorNetworkSimulation.contraction = keep
    try:
        (text, _), ran = cp.counted_on_card(lambda: _cli_main(
            ["simulate", qsim, "--bitstrings", bits, "--plan",
             cp.PATHS["1k"][0]]))
    finally:
        TensorNetworkSimulation.contraction = real
    (sim,) = kept
    from artensor_tpu_torch.runtime.sparse import scheme_digest

    assert scheme_digest(sim.steps) == _path("1k/default")["digest"]
    _cli_amps(text, ref)
    st = sim.run_stats
    assert st["executor"] == "graph" and st["slice_batch"] == 1, st
    counts = cp.run_counts(cp.path_state("1k", "cli", sim, ref, 1), card,
                           ran, st)
    assert all(counts["device_launches"][k]
               for k in ("gk", "ggk", "rgrow", "pair")), counts


def test_cli_bench_times_the_graph_runner(card, monkeypatch, tmp_path):
    """``bench --slice-batch CLI_BENCH_WIDTH`` times the graph runner: the
    runner it builds captures one slice group and replays every group of
    its first and of each timed run at that width (none of them eager);
    its JSON line's ``roofline_achieved`` is in (0, 1]."""
    from artensor_tpu_torch.runtime import executor as ex

    qsim, bits, _ = _write_inputs(tmp_path)
    runners = []
    real = ex.make_sliced_runner

    def keep(*a, **k):
        runners.append((k, real(*a, **k)))
        return runners[-1][1]

    monkeypatch.setattr(ex, "make_sliced_runner", keep)
    _fresh()
    text, _ = _cli_main(["bench", qsim, "--plan", cp.PATHS["1k"][0],
                         "--bitstrings", bits, "--slice-batch",
                         str(CLI_BENCH_WIDTH)])
    bench = json.loads(text.strip().splitlines()[-1])
    ((kw, runner),) = runners
    assert kw.get("slice_batch") == CLI_BENCH_WIDTH
    assert not kw.get("eager", False)
    groups = bench["slices"] // CLI_BENCH_WIDTH
    assert runner.stats["captures"] == 1, runner.stats
    assert runner.stats["replays"] == 4 * groups, runner.stats
    assert 0 < bench["roofline_achieved"] <= 1, bench


def test_cli_verify_info_and_plan(card, tmp_path):
    """``verify`` on ``tests/data/circuit_n12_rcs.qsim`` (fidelity estimate
    above 0.999, max|d| within its threshold), ``info`` on the n30 qsim
    file (30 qubits) and ``plan`` on it (the native search), whose file
    ``info`` reads back at the same sc, at most 30."""
    qsim, _, _ = _write_inputs(tmp_path)
    _, err = _cli_main(["verify", os.path.join(cp.ROOT, "tests", "data",
                                               "circuit_n12_rcs.qsim"),
                        "--serial"])
    stats = json.loads(err.strip().splitlines()[-1])
    assert stats["mps_fidelity_estimate"] > 0.999, stats
    assert stats["max_abs_diff"] <= stats["threshold"], stats
    info = json.loads(_cli_main(["info", qsim])[0])
    assert info["qubits"] == cp.CIRCUIT["rows"] * cp.CIRCUIT["cols"], info
    out = str(tmp_path / "plan.json")
    planned = json.loads(_cli_main(["plan", qsim, "--out", out])[0])
    info_plan = json.loads(_cli_main(["info", out])[0])
    assert info_plan["sc"] == planned["sc"] <= 30, (planned, info_plan)


def _fill_scheme_cache(schemes):
    """The 1k default scheme through the scheme cache in ``schemes``, cold
    (compiled and written) then warm (loaded): ``(cold, warm, sim)``."""
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.plan_io import plan_from_dict
    from artensor_tpu_torch.runtime import scheme_cache

    plan = cp.PATHS["1k"][0]
    ref = cp.load_fixture(cp.PATHS["1k"][1])
    with open(plan) as f:
        pd = json.load(f)
    sim = TensorNetworkSimulation.from_circuit(random_circuit(**cp.CIRCUIT),
                                               list(ref))
    sim.order, sim.slicing_bonds, sim.ctree = plan_from_dict(pd)
    sc = float(pd["meta"]["sc_target"])
    cold = scheme_cache.cached_scheme_sparse(plan, sim.ctree, sim.bitstrings,
                                             sc)
    assert len(os.listdir(schemes)) == 1
    warm = scheme_cache.cached_scheme_sparse(plan, sim.ctree, sim.bitstrings,
                                             sc)
    return cold, warm, sim


def test_scheme_cache_cold_then_warm(card, monkeypatch, tmp_path):
    """The scheme cache (``runtime/scheme_cache.py``) on the 1k default
    scheme: the cold call writes one file, the warm call's steps equal the
    cold ones (and 1k/default's digest), and a run from them is held to
    the fixture."""
    import pickle

    from artensor_tpu_torch.runtime import scheme_cache
    from artensor_tpu_torch.runtime.sparse import scheme_digest

    monkeypatch.setenv(scheme_cache.ENV, str(tmp_path))
    cold, warm, sim = _fill_scheme_cache(str(tmp_path))
    assert scheme_digest(cold[0]) == scheme_digest(warm[0]) == \
        _path("1k/default")["digest"]
    assert cold[1:] == warm[1:]
    assert all(pickle.dumps(a) == pickle.dumps(b)
               for a, b in zip(cold[0], warm[0]))
    sim._set_scheme(*warm)
    _fresh()
    amps = sim.contraction(slice_batch=_path("1k/default")["W"],
                           device=cp.DEVICE)
    cp.amp_check(amps, _sparse_ref(sim, cp.load_fixture(cp.PATHS["1k"][1])))


# -- multi-device -------------------------------------------------------------

def _mesh_counts(path, wraps, ran, replicas):
    """A mesh run's launches (``run_counts``): the replicas share the
    card's counters, so each kernel is held to its census times the
    replicas' warm-up groups (the wrappers) and their warm-up groups and
    replays (the card), summed (a segmented replica, which keeps no
    ``captures``, captures its one width once)."""
    return cp.run_counts(path, wraps, ran, dict(
        warmup_groups=sum(r["warmup_groups"] for r in replicas),
        replays=sum(r["replays"] for r in replicas),
        captures=sum(r.get("captures", 1) for r in replicas)))


def _mesh_path(label, W):
    p = _path(label)
    return cp.path_state(p["workload"], f"w{W}", p["sim"], p["ref"], W)


@pytest.mark.parametrize("which", ["mesh2", "make_mesh"])
def test_mesh_contraction(card, which):
    """1k/default through ``contraction(mesh=...)`` at ``MESH_WIDTH`` a
    replica, over ``MESH_DEVICES`` (two replicas on the one card) and over
    ``make_mesh()`` (every card): each replica's graphs captured once at
    that width, the launches of the call against the census times the
    replicas' groups, every amplitude against the fixture, and a later
    run through ``run_sliced_contraction`` too."""
    from artensor_tpu_torch import parallel

    path = _mesh_path("1k/default", MESH_WIDTH)
    sim = path["sim"]
    mesh = parallel.make_mesh(devices=MESH_DEVICES) if which == "mesh2" \
        else parallel.make_mesh()
    _fresh()
    cp.reset_counts(card)
    amps, ran = cp.counted_on_card(lambda: sim.contraction(
        mesh=mesh, slice_batch=MESH_WIDTH))
    st = sim.run_stats
    reps = st["replicas"]
    assert st["executor"] == "mesh" and st["graphs"], st
    assert [r["device"] for r in reps] == [str(d) for d in mesh.devices]
    assert all(r["slice_batch"] == MESH_WIDTH and r["captures"] == 1
               for r in reps), reps
    _mesh_counts(path, card, ran, reps)
    cp.amp_check(amps, _sparse_ref(sim, path["ref"]))
    field, run_steps, arrays, out_shape, execute, _ = sim._staged(
        mesh.devices[0])
    res = parallel.run_sliced_contraction(
        arrays, run_steps, sim.slicing_axes, len(sim.slicing_bonds),
        out_shape, mesh, field=field, execute=execute,
        slice_batch=MESH_WIDTH)
    _fixture_gate(path, res)


def test_segmented_over_the_mesh(card):
    """``run_segmented_sharded`` of 1k/default over the two replicas at
    ``SEGMENT_STEPS`` steps a segment and ``MESH_WIDTH``: each replica's
    width, segments and graphs, the launches against the census, the sum
    against the fixture."""
    from artensor_tpu_torch import parallel
    from artensor_tpu_torch.runtime import segmented

    path = _mesh_path("1k/default", MESH_WIDTH)
    sim = path["sim"]
    mesh = parallel.make_mesh(devices=MESH_DEVICES)
    field, run_steps, arrays, out_shape, _, step = sim._staged(
        mesh.devices[0])
    _fresh()
    cp.reset_counts(card)
    res, ran = cp.counted_on_card(lambda: segmented.run_segmented_sharded(
        arrays, run_steps, sim.slicing_axes, len(sim.slicing_bonds),
        out_shape, field, step, list(mesh.devices),
        segment_steps=SEGMENT_STEPS, slice_batch=MESH_WIDTH))
    reps = segmented.LAST_RUN["replicas"]
    n_seg = -(-len(run_steps) // SEGMENT_STEPS)
    assert len(reps) == len(mesh.devices)
    assert all(r["width"] == MESH_WIDTH and r["segments"] == n_seg
               and r["graphs"] for r in reps), reps
    _mesh_counts(path, card, ran, reps)
    _fixture_gate(path, res)


def test_dispatch_batches(card):
    """``parallel.dispatch_batches`` of 1k/default and 10k/default (each at
    half its model width) over the two replicas, both runners built
    (captured) before either runs: every kernel held to the census of
    both summed, the permute-copy kernel's runs to the reorders each
    runner's capture recorded, each result against its fixture."""
    from artensor_tpu_torch import parallel

    paths = [_mesh_path("1k/default", MESH_WIDTH),
             _mesh_path("10k/default", 2 * MESH_WIDTH)]
    devices = parallel.make_mesh(devices=MESH_DEVICES).devices
    calls, perms = [], []

    def make_runner(path):
        def runner(dev):
            call = path["sim"].prepare(slice_batch=path["W"], device=dev)
            before = cp.permute_counts()
            call.capture()
            after = cp.permute_counts()
            perms.append({k: after[k] - before[k]
                          for k in ("made", "launches")})
            calls.append(call)
            return call
        return runner

    _fresh()
    cp.reset_counts(card)
    res, ran = cp.counted_on_card(lambda: parallel.dispatch_batches(
        make_runner, paths, list(devices)))
    for kind in cp.KERNELS:
        want_w = sum(p["census"].get(kind, 0) * c.stats["warmup_groups"]
                     for p, c in zip(paths, calls))
        want_d = sum(p["census"].get(kind, 0) * (c.stats["warmup_groups"]
                                                 + c.stats["replays"])
                     for p, c in zip(paths, calls))
        assert card[kind].launches == want_w, kind
        assert ran["counts"][kind] == want_d, kind
    assert ran["permute"]["launches"] == sum(p["launches"] for p in perms)
    assert ran["permute"]["made"] == sum(p["made"] for p in perms)
    want = 0
    for p, c, q in zip(paths, calls, perms):
        per = q["made"] - q["launches"]   # a group's, as the capture
        assert c.stats["captures"] == 1 and per > 0, (p["name"], q, c.stats)
        assert q["launches"] == per * c.stats["warmup_groups"], (q, c.stats)
        want += q["launches"] + per * c.stats["replays"]
    assert sum(ran["permute"]["runs"].values()) == want, (ran, want)
    for p, r in zip(paths, res):
        _fixture_gate(p, r)
    del calls


def _sharded_state_check(res, ref, state_bonds, fixture, d_out):
    """The gathered state ``res`` (qubit order, on the host) at the
    fixture's amplitudes, and block by block on the card against the
    whole state ``ref`` (flat split pair on the card, its axes
    ``state_bonds``) within ``BLOCK_TOL`` x rms, with its norm^2 in
    float64.  A block of the ``d_out`` leading qubits is one span of the
    gathered buffer: it is uploaded flat as stored and read against
    ``ref`` through an index built on the card."""
    n = res.ndim
    assert res.shape == (2,) * len(state_bonds)
    bits = list(fixture)
    digits = np.array([[int(c) for c in b] for b in bits])
    cp.amp_check(res[tuple(digits.T)].astype(np.complex128),
               np.array([fixture[b] for b in bits]))
    rms = (_norm2(*ref) / ref[0].numel()) ** 0.5
    pos = {_qubit(b): a for a, b in enumerate(state_bonds)}
    d_max = nrm = 0.0
    for b in np.ndindex(*(2,) * d_out):
        v = torch.from_numpy(res[b])
        L = v.dim()
        order = sorted(range(L), key=lambda a: -v.stride(a))
        c = v.permute(*order)
        assert c.is_contiguous(), b
        g = c.reshape(-1).to(cp.DEVICE)
        # stored axis i is qubit d_out + order[i]; its bit in ref's index
        ar = torch.arange(2 ** L, device=cp.DEVICE)
        idx = torch.full_like(ar, sum(int(x) << (n - 1 - pos[q])
                                      for q, x in enumerate(b)))
        for i, a in enumerate(order):
            idx += ((ar >> (L - 1 - i)) & 1) << (n - 1 - pos[d_out + a])
        del ar
        d = torch.hypot(g.real - ref[0][idx], g.imag - ref[1][idx])
        d_max = max(d_max, d.max().item())
        nrm += torch.view_as_real(g).double().square().sum().item()
        del v, c, g, idx, d
    assert d_max <= cp.BLOCK_TOL * rms, (d_max, rms)
    assert abs(nrm - 1) <= cp.NORM_TOL, nrm


@pytest.mark.parametrize("which", ["planned", "post-hoc"])
def test_output_sharded(card, which):
    """The dense state through ``contraction_output_sharded`` over the two
    replicas, planned (the planned walk's simulation, 16 blocks of 2^26)
    and post hoc (dense/default, 4 blocks of 2^28): each replica's blocks
    captured once, the launches against the census (the steps run once
    apart), then block by block against the default state within
    ``BLOCK_TOL`` x rms, its norm^2 and the 11000 fixture amplitudes."""
    from artensor_tpu_torch import parallel

    mesh = parallel.make_mesh(devices=MESH_DEVICES)
    dense = _path("dense/default")
    path = _planned_walk() if which == "planned" \
        else cp.post_hoc_block_path(dense, 2)
    d_out, n = path["d_out"], len(mesh.devices)
    _fresh()
    cp.reset_counts(card)
    res, ran = cp.counted_on_card(
        lambda: path["sim"].contraction_output_sharded(mesh, d_out=d_out))
    reps = parallel.LAST_RUN["replicas"]
    assert len(reps) == n and all(r["blocks"] == 2 ** d_out // n
                                  and r["captures"] == 1 for r in reps), reps
    _mesh_counts(path, card, ran, reps)
    _fresh()
    ref = tuple(c.reshape(-1) for c in _dense_state(dense))
    _sharded_state_check(res, ref, dense["sim"].output_bonds, dense["ref"],
                         d_out)


DIST_WORKER = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as tdist
sys.path.insert(0, {root!r})
import card_paths as cp
from artensor_tpu_torch import TensorNetworkSimulation, kernels, random_circuit
from artensor_tpu_torch.parallel import distributed
from artensor_tpu_torch.plan_io import plan_from_dict
from artensor_tpu_torch.runtime import scheme_cache

torch.backends.cuda.matmul.allow_tf32 = False
kernels.load()
rank = int(os.environ["ARTENSOR_PROC_ID"])
size = int(os.environ["ARTENSOR_NUM_PROCS"])
backend, prefix, W = {backend!r}, {prefix!r}, {width}
if size > 1:
    assert distributed.initialize(backend=backend)
else:
    tdist.init_process_group(
        backend, init_method="tcp://" + os.environ["ARTENSOR_COORDINATOR"],
        rank=0, world_size=1)
mesh = distributed.global_mesh()
assert mesh.size == size and mesh.rank == rank and mesh.group is not None
plan, ref = cp.PATHS["1k"][0], cp.load_fixture(cp.PATHS["1k"][1])
sim = TensorNetworkSimulation.from_circuit(random_circuit(**cp.CIRCUIT),
                                           list(ref))
with open(plan) as f:
    pd = json.load(f)
sim.order, sim.slicing_bonds, sim.ctree = plan_from_dict(pd)
sim.sc_target = float(pd["meta"]["sc_target"])
sim._set_scheme(*scheme_cache.cached_scheme_sparse(
    plan, sim.ctree, sim.bitstrings, sim.sc_target))
field, run_steps, arrays, out_shape, execute, _ = sim._staged(
    mesh.devices[0])
wraps = cp.wrappers()
cp.reset_counts(wraps)
res, ran = cp.counted_on_card(lambda: distributed.run_sliced_distributed(
    arrays, run_steps, sim.slicing_axes, len(sim.slicing_bonds), out_shape,
    mesh, field=field, execute=execute, slice_batch=W))
from artensor_tpu_torch import parallel
replicas = parallel.LAST_RUN["replicas"]
if size == 1:   # psum leaves a group of one alone: the backend's own
    bufs = field.buffers(res)          # all-reduce, twice
    before = [c.clone() for c in bufs]
    for _ in range(2):
        for c in bufs:
            tdist.all_reduce(c, group=mesh.group)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(before, bufs))
np.save(f"{{prefix}}.{{rank}}.npy",
        field.unwrap(res).reshape(out_shape).transpose(sim.permute_dims))
with open(f"{{prefix}}.{{rank}}.json", "w") as f:
    json.dump(dict(rank=rank, bits=sim.bitstrings_sorted, replicas=replicas,
                   launches={{k: w.launches for k, w in wraps.items()}},
                   forms={{k: dict(wraps[k].forms) for k in cp.FORM_KINDS}},
                   ran=ran), f)
tdist.destroy_process_group()
"""


@pytest.mark.parametrize("label,n_procs,backend", [("dist2", 2, "gloo"),
                                                   ("nccl1", 1, "nccl")])
def test_distributed_ranks(card, monkeypatch, tmp_path, label, n_procs,
                           backend):
    """``torch.distributed`` on the 1k batch, each rank a process of its
    own loading the 1k default scheme from the scheme cache and running
    ``run_sliced_distributed`` at ``MESH_WIDTH``: two ranks joined with
    gloo, both on the card (NCCL refuses two ranks on one device), or one
    rank with NCCL (its sum all-reduced twice more through NCCL,
    unchanged).  Every rank's amplitudes equal the others' and the
    fixture; each rank's launches are held to the census times its
    replicas' groups, its permute kernel's to its reorders."""
    from artensor_tpu_torch.runtime import scheme_cache

    _fresh()    # the ranks share the card with this process
    schemes = tmp_path / "schemes"
    schemes.mkdir()
    monkeypatch.setenv(scheme_cache.ENV, str(schemes))
    _fill_scheme_cache(str(schemes))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    prefix = str(tmp_path / label)
    code = DIST_WORKER.format(root=cp.ROOT, backend=backend, prefix=prefix,
                              width=MESH_WIDTH)
    env = dict(os.environ, ARTENSOR_COORDINATOR=f"127.0.0.1:{port}",
               ARTENSOR_NUM_PROCS=str(n_procs))
    # each rank's output to a file: kept whole for the report, and no rank
    # blocks on a full pipe while another is waited for
    logs = [tmp_path / f"{label}.{r}.log" for r in range(n_procs)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code],
                env=dict(env, ARTENSOR_PROC_ID=str(r)), stdout=out,
                stderr=subprocess.STDOUT))
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not timed_out and all(p.returncode == 0 for p in procs), \
        "\n".join(f"rank {r} exited {p.returncode}"
                  f"{' (killed at the time limit)' if timed_out else ''}:"
                  f"\n{log.read_text()[-8000:]}"
                  for r, (p, log) in enumerate(zip(procs, logs)))
    amps = [np.load(f"{prefix}.{r}.npy") for r in range(n_procs)]
    assert all(np.array_equal(a, amps[0]) for a in amps)
    path = _mesh_path("1k/default", MESH_WIDTH)
    for r in range(n_procs):
        with open(f"{prefix}.{r}.json") as f:
            rk = json.load(f)
        if r == 0:
            ref = path["ref"]
            cp.amp_check(amps[0], np.array([ref[b] for b in rk["bits"]]))
        reps = rk["replicas"]
        warm = sum(x["warmup_groups"] for x in reps)
        replays = sum(x["replays"] for x in reps)
        cp.check_counts(path, rk["launches"], rk["forms"], warm, "launches")
        cp.check_counts(path, rk["ran"]["counts"], rk["ran"]["forms"],
                        warm + replays, "kernels run on the card")
        cp.permute_held(f"{label} rank {r}", rk["ran"]["permute"], dict(
            warmup_groups=warm, replays=replays,
            captures=sum(x["captures"] for x in reps)))
