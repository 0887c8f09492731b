"""The wgmma core (Pair, the complex matmul, GK's and GGK's mma form), on
the CPU.

Three things are held here without a card:

* the promoted accumulation's arithmetic (``csrc/wgmma_core.cuh``): a
  numpy emulation in which the tensor cores add each k8 slice's TF32
  products into their accumulator rounding toward zero, and every
  ``kernels.wgmma_promote()`` slices that accumulator is added into
  float32 rounding to nearest.  It checks the scheme's arithmetic, not the
  kernel (as ``tests/test_torch_tc.py`` does for the split): the kernel's own
  accuracy is held on the card, against float64, by ``chip_smoke.py`` and
  the card tests;
* the host rules: that every Pair and GK mma step of the three committed
  n30 plans runs on the wgmma core with 16-byte copies, in which
  orientation, and which shapes and buffers take its 4-byte copies;
* ``pair_call``, ``gk_call``, ``ggk_call`` and the complex matmul
  counting launches (by form), on fake launches (no kernel runs), and
  passing what the C entry points take.
"""

import types
from functools import lru_cache

import numpy as np
import pytest
import torch

from artensor_tpu_torch import kernels
from artensor_tpu_torch.ops import pallas_mm
from artensor_tpu_torch.runtime import gatherk, lanes

from test_torch_tc import DATA, MMA_STEPS, PATHS, WIDTH, _gk_steps, _tf32


# -- the promoted accumulation ------------------------------------------------

def _rz(x):
    """float64 -> float32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _promoted(a, b, promote):
    """(M, K) . (K, N) as the wgmma core sums it: per k8 slice the three
    3xTF32 terms (lo.hi, hi.lo, hi.hi), each an exact 8-term dot, added
    into the tensor cores' float32 accumulator rounding toward zero (the
    window's first term starts it afresh: scale-d 0); every ``promote``
    slices, and after the last, the accumulator added into the float32
    result rounding to nearest.  ``promote`` K/8: all of K inside the
    tensor cores."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    terms = [(al, bh), (ah, bl), (ah, bh)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    slices = a.shape[1] // 8
    for s in range(slices):
        ks = slice(8 * s, 8 * s + 8)
        for q, (x, y) in enumerate(terms):
            dot = x[:, ks].astype(np.float64) @ y[ks, :].astype(np.float64)
            d = _rz(dot if s % promote == 0 and q == 0
                    else d.astype(np.float64) + dot)
        if s % promote == promote - 1 or s == slices - 1:
            acc = (acc + d).astype(np.float32)
    return acc


def _float32_product(a, b):
    """The plain version's product: float32 sums rounded to nearest, one
    k at a time."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc = (acc + np.outer(a[:, k], b[k, :]).astype(np.float32)).astype(
            np.float32)
    return acc


@pytest.mark.parametrize("K", [64, 512, 1024, 4096])
def test_promoted_accumulation_is_float32_class(K):
    """At the chosen interval the emulated error against float64 stays
    within 2x the float32 product's (the card holds the kernel to 4x the
    plain version's); all of K summed inside the tensor cores is at least
    2.5x it, growing with K (wgmma_core.cuh records 12x at K 1024 on the
    card)."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((16, K)).astype(np.float32)
    b = rng.standard_normal((K, 24)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    err = lambda y: float(np.abs(y - ref).max())
    plain = err(_float32_product(a, b))
    chosen = err(_promoted(a, b, kernels.wgmma_promote()))
    whole = err(_promoted(a, b, K // 8))
    assert chosen <= 2 * plain, (chosen, plain)
    assert whole >= 2.5 * plain, (whole, plain)
    assert whole > 2 * chosen


def test_promotion_interval_is_the_headers():
    """The interval the emulation holds is the one the kernels compile
    with: a constant of the header, not a build option."""
    assert kernels.wgmma_promote() == 1
    assert not any("PROMOTE" in f for f in kernels.NVCC_FLAGS)


# -- the host rules ----------------------------------------------------------

@lru_cache(maxsize=None)
def _pair_steps(name):
    """The Pair plans of a path's off-form scheme per slice group, after
    the static folds (the scheme ``test_torch_tc._gk_steps`` reads)."""
    import json
    import os

    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.plan_io import plan_from_dict
    from artensor_tpu_torch.runtime.executor import precompute_static_steps
    from artensor_tpu_torch.runtime.sparse import (contraction_scheme_sparse,
                                                   kernel_kind)

    plan, fixture = PATHS[name]
    with open(os.path.join(DATA, fixture)) as f:
        bits = [ln.split()[0] for ln in f if ln.strip()]
    with open(os.path.join(DATA, plan)) as f:
        pd = json.load(f)
    sim = TensorNetworkSimulation.from_circuit(
        random_circuit(5, 6, 14, seed=0), bits)
    sim.order, sim.slicing_bonds, sim.ctree = plan_from_dict(pd)
    sim._set_scheme(*contraction_scheme_sparse(
        sim.ctree, bits, pd["meta"]["sc_target"], fuse=False,
        negotiate=False))
    run_steps, _ = precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)
    return [s.lane for s in run_steps if kernel_kind(s) == "pair"]


@pytest.mark.parametrize("name", sorted(PATHS))
def test_every_path_step_takes_the_wgmma_core(name):
    """Every GK mma step and every Pair step of the three committed plans
    runs on the wgmma core with its 16-byte copies: GK's offsets on the
    4-float grid (``gatherk.gk_aligned``) and K a multiple of 4 (W's
    rows), Pair's M and N multiples of 4.  GK's orientation: X's flat
    (outer index, f) values on the product's M side, W's H rows on its N
    side, within the kernel's int M."""
    mma = set()
    for p, xb, wb in _gk_steps(name):
        if gatherk.gk_form(p, WIDTH, xb, wb) != "mma":
            continue
        mma.add((p.K, p.H, p.F, len(p.xoff)))
        assert gatherk.gk_aligned(p) and p.K % 4 == 0
        assert len(p.xoff) * p.F < 2 ** 31
    assert mma == MMA_STEPS[name]
    pairs = _pair_steps(name)
    assert pairs
    for p in pairs:
        assert p.M % 4 == 0 and p.N % 4 == 0, (p.K, p.M, p.N)


def _gk_plan(monkeypatch, g, k, f, h):
    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1)
    p = gatherk.plan_gk_step(("g1", "c1", "f1"), ("c1", "n1"),
                             ("g1", "n1", "f1"), (g, k, f), (k, h))
    assert p is not None, gatherk.LAST_REJECT
    return p


def test_unaligned_steps_keep_the_mma_form(monkeypatch):
    """An f run or a K off the 4-float grid keeps a step in the mma form
    (the wgmma core then copies 4 bytes at a time): its form is chosen
    from its bytes and flops alone, and only ``gk_aligned`` (the 16-byte
    copies of X) changes."""
    p = _gk_plan(monkeypatch, 3, 64, 64, 64)
    assert gatherk.gk_aligned(p)
    assert gatherk.gk_form(p, 1, True, False) == "mma"
    k34 = _gk_plan(monkeypatch, 3, 34, 64, 64)
    assert gatherk.gk_aligned(k34)       # X's rows; W's are checked in C
    assert gatherk.gk_form(k34, 1, True, False) == "mma"
    monkeypatch.setattr(gatherk, "F_MIN", 2)
    p6 = _gk_plan(monkeypatch, 5, 12, 6, 20)
    assert not gatherk.gk_aligned(p6)
    assert gatherk.gk_form(p6, 1, True, False) == \
        gatherk.gk_form(_gk_plan(monkeypatch, 5, 12, 8, 20), 1, True, False)


# -- counting, on fake launches ----------------------------------------------

class _FakeLaunches:
    """Stands in for the card: the wrappers' operand check reports a CUDA
    device, outputs are made on the CPU, and each launch records its C
    entry point's arguments instead of running."""

    def __init__(self, monkeypatch):
        self.calls = []
        cuda = types.SimpleNamespace(type="cuda")
        empty = torch.empty
        monkeypatch.setattr(kernels, "check_operands",
                            lambda *a, **k: cuda)
        monkeypatch.setattr(torch, "empty",
                            lambda shape, dtype=None, device=None:
                            empty(shape, dtype=dtype))
        monkeypatch.setattr(gatherk, "_device_tables",
                            lambda plan, dev, names: {
                                n: torch.as_tensor(np.asarray(getattr(
                                    plan, n)), dtype=torch.long)
                                for n in names})
        lib = types.SimpleNamespace(pair_launch="pair_launch",
                                    gk_launch="gk_launch",
                                    ggk_launch="ggk_launch",
                                    cmm_launch="cmm_launch")
        monkeypatch.setattr(kernels, "load", lambda: lib)
        monkeypatch.setattr(kernels, "launch", self.launch)

    def launch(self, name, fn, dev, *args):
        # the C entry point's arguments, the stream (appended by
        # kernels.launch) aside
        sig = next(fns[fn] for fns in kernels.SIGNATURES.values()
                   if fn in fns)
        assert len(args) + 1 == len(sig), fn
        self.calls.append((fn, args))
        return 1


def _off16(n):
    """A float32 vector of ``n`` elements starting 4 bytes into its
    allocation (off 16-byte alignment)."""
    return torch.zeros(n + 1)[1:]


def test_pair_forms_count_fake_launches(monkeypatch):
    """Pair has one form, on the wgmma core, whatever its alignment (the
    kernel picks its copies from the pointers it is given): every call
    is one launch, and a one-pass call is counted as such."""
    fake = _FakeLaunches(monkeypatch)
    before = lanes.pair_call.launches, lanes.pair_call.one_pass
    cases = [(64, 64, False, 3), (64, 64, True, 3), (66, 64, False, 1)]
    for M, N, off, passes in cases:
        plan = lanes.PairPlan(8, M, N, None, (M, N), 8 * M * N * 8)
        mk = _off16 if off else torch.zeros
        x = [mk(8 * M) for _ in "ri"]
        v = [torch.zeros(8 * N) for _ in "ri"]
        lanes.pair_call(plan, *x, *v, False, False, passes=passes)
    # pair_launch's K, M, N, strides, W and passes
    assert [args[6:] for fn, args in fake.calls] == [
        (8, M, N, 0, 0, 0, 1, passes) for M, N, _, passes in cases]
    assert lanes.pair_call.launches - before[0] == 3
    assert lanes.pair_call.one_pass - before[1] == 1


def test_gk_forms_count_fake_launches(monkeypatch):
    """gk_call counts each launch in the form it passes (``GK_FORMS``),
    and passes the 16-byte flag where the offsets and X, Y allow it."""
    fake = _FakeLaunches(monkeypatch)
    before = dict(gatherk.gk_call.forms)
    cases = [(_gk_plan(monkeypatch, 3, 64, 64, 64), False, "mma", 1),
             (_gk_plan(monkeypatch, 3, 64, 64, 64), True, "mma", 0),
             (_gk_plan(monkeypatch, 3, 34, 64, 64), False, "mma", 1),
             (_gk_plan(monkeypatch, 4, 8, 256, 8), False, "stream", 1)]
    for p, off, _, _ in cases:
        mk = _off16 if off else torch.zeros
        x = [mk(p.x_elems) for _ in "ri"]
        w = [torch.zeros(p.H * p.K) for _ in "ri"]
        gatherk.gk_call(p, *x, *w, False, False)
    # gk_launch's form code and 16-byte flag: its 19th and 20th arguments
    assert [args[18:20] for fn, args in fake.calls] == \
        [(gatherk.GK_FORMS.index(f), vec) for _, _, f, vec in cases]
    after = gatherk.gk_call.forms
    assert {f: after[f] - before[f] for f in gatherk.GK_FORMS} == \
        {"stream": 1, "mma": 3}


def _ggk_plan(monkeypatch, k, h, f, B=40):
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    gi = np.repeat(np.arange(B // 2), 2)
    gj = np.arange(B) % 8
    p = gatherk.plan_ggk_step(("k", "f"), ("k", "h"), ("h", "f"), (k, f),
                              (k, h), gi, gj, B // 2, 8)
    assert p is not None and isinstance(p.row, gatherk.GKPlan), \
        gatherk.LAST_REJECT
    return p


def test_ggk_forms_count_fake_launches(monkeypatch):
    """ggk_call counts each launch in the form it passes, with the W row
    offsets (``woff``) of every outer index and its pass count; a
    one-pass mma launch is counted as such."""
    fake = _FakeLaunches(monkeypatch)
    monkeypatch.setattr(kernels, "ptr", lambda t: t)   # keep the tables
    before = dict(gatherk.ggk_call.forms), gatherk.ggk_call.one_pass
    cases = [(_ggk_plan(monkeypatch, 16, 16, 512), "mma", 3),
             (_ggk_plan(monkeypatch, 64, 64, 128), "mma", 1),
             (_ggk_plan(monkeypatch, 2, 2, 64), "stream", 1)]
    for p, form, passes in cases:
        monkeypatch.setattr(gatherk, "gk_form", lambda *a, _f=form, **k: _f)
        row = p.row
        x = [torch.zeros(p.bi_rows * row.x_elems) for _ in "ri"]
        w = [torch.zeros((2, p.bj_rows * row.H * row.K)) for _ in "ri"]
        gatherk.ggk_call(p, *x, *w, False, True, passes=passes)
    # ggk_launch: the woff table (9th argument) holds each outer index's W
    # row; then O, H, K, F, and the width, form code, 16-byte flag and
    # passes last
    for (fn, args), (p, form, passes) in zip(fake.calls, cases):
        row = p.row
        assert fn == "ggk_launch"
        assert args[8].tolist() == p.woff.tolist()
        assert args[10:14] == (len(p.xoff), row.H, row.K, row.F)
        assert args[18:] == (2, gatherk.GK_FORMS.index(form), 1, passes)
    after = gatherk.ggk_call.forms
    assert {f: after[f] - before[0][f] for f in gatherk.GK_FORMS} == \
        {"stream": 1, "mma": 2}
    assert gatherk.ggk_call.one_pass - before[1] == 1


def test_complex_matmul_counts_fake_launches(monkeypatch):
    """The complex matmul passes B, M, K, N, the batch strides, the tile
    (``cmm_tile``'s N tile, K chunk, swap and passes; one pass: the 128 x
    64 x 32 tile) and its pass count to ``cmm_launch`` (one launch, the
    batch the product's width axis) and counts one-pass launches
    apart."""
    fake = _FakeLaunches(monkeypatch)
    before = (pallas_mm.complex_batched_matmul.launches,
              pallas_mm.complex_batched_matmul.one_pass)
    for B, M, K, N, passes in ((2, 100, 37, 70, 3), (32, 1024, 256, 1024, 1)):
        a = (torch.zeros((B, M, K)), torch.zeros((B, M, K)))
        b = (torch.zeros((B, K, N)), torch.zeros((B, K, N)))
        yr, yi = pallas_mm.complex_batched_matmul(a, b, passes=passes)
        assert yr.shape == yi.shape == (B, M, N)
    assert [(fn, args[6:]) for fn, args in fake.calls] == [
        ("cmm_launch", (2, 100, 37, 70, 3700, 2590, 64, 32, 0, 3)),
        ("cmm_launch", (32, 1024, 256, 1024, 262144, 262144, 64, 32, 0, 1))]
    assert pallas_mm.complex_batched_matmul.launches - before[0] == 2
    assert pallas_mm.complex_batched_matmul.one_pass - before[1] == 1
