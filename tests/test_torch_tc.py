"""The GK kernel's two forms and the 3xTF32 product, on the CPU.

``gatherk.gk_form`` picks the form of every GK step of the three committed
n30 plans ("stream" where the bytes bound the step at 0.6 of the float32
FMA rate, "mma" on the tensor cores otherwise); the stream steps' offsets
allow its 16-byte loads; and a numpy emulation of the 3xTF32 split that
``csrc/tc_core.cuh`` runs (TF32: 10 mantissa bits, rounded to nearest)
meets float32-class accuracy where single-pass TF32 does not.  The
emulation checks the split's arithmetic, not the kernel (see
``_product``)."""

import os
from collections import Counter
from functools import lru_cache

import numpy as np
import pytest

from artensor_tpu_torch import TensorNetworkSimulation, kernels, random_circuit
from artensor_tpu_torch.runtime import gatherk
from artensor_tpu_torch.runtime.executor import precompute_static_steps
from artensor_tpu_torch.runtime.sparse import kernel_kind

DATA = os.path.join(os.path.dirname(__file__), "..", "artensor_tpu_torch",
                    "data")
PATHS = {   # name: (plan, fixture), as chip_smoke.py drives them
    "1k": ("rcs_n30_m14_s0_sparse_sc24.json", "rcs_n30_m14_s0_amps1000.txt"),
    "10k": ("rcs_n30_m14_s0_sparse10k_sc24.json",
            "rcs_n30_m14_s0_amps10000.txt"),
    "1k-sc25": ("rcs_n30_m14_s0_sparse_sc25.json",
                "rcs_n30_m14_s0_amps1000.txt"),
}
WIDTH = 32   # chip_smoke.py's slice width
# the mma steps of each off-form path as (K, H, F, G), the pre-permuted
# steps' f runs cut to gatherk.PRE_TAIL_F; every other GK step streams
MMA_STEPS = {
    "1k": {(32, 32, 2048, 256), (32, 32, 32768, 16), (32, 64, 4096, 1),
           (32, 128, 128, 64), (32, 512, 4096, 2), (64, 64, 16384, 16),
           (64, 64, 32768, 8), (128, 128, 128, 256), (128, 128, 512, 4)},
    "10k": {(16, 128, 128, 128), (32, 32, 2048, 256), (32, 32, 32768, 8),
            (32, 32, 32768, 16), (64, 64, 32768, 4), (64, 128, 1024, 2),
            (64, 256, 32768, 2)},
    "1k-sc25": {(32, 32, 8192, 128), (32, 128, 1024, 8),
                (64, 256, 64, 256)},
}
FORM_COUNTS = {"1k": {"stream": 8, "mma": 10},
               "10k": {"stream": 10, "mma": 11},
               "1k-sc25": {"stream": 6, "mma": 3}}


@lru_cache(maxsize=None)
def _gk_steps(name):
    """(plan, x batched, w batched) of every GK step the off-form path
    runs per slice group, after the static folds."""
    import json

    from artensor_tpu_torch.plan_io import plan_from_dict
    from artensor_tpu_torch.runtime.sparse import contraction_scheme_sparse

    plan, fixture = PATHS[name]
    with open(os.path.join(DATA, fixture)) as f:
        bits = [ln.split()[0] for ln in f if ln.strip()]
    with open(os.path.join(DATA, plan)) as f:
        pd = json.load(f)
    # the off form, as chip_smoke.py's off paths compile it
    sim = TensorNetworkSimulation.from_circuit(
        random_circuit(5, 6, 14, seed=0), bits)
    sim.order, sim.slicing_bonds, sim.ctree = plan_from_dict(pd)
    sim._set_scheme(*contraction_scheme_sparse(
        sim.ctree, bits, pd["meta"]["sc_target"], fuse=False,
        negotiate=False))
    run_steps, _ = precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)
    dyn = {tid for entries in sim.slicing_axes for tid, *_ in entries}
    out = []
    for s in run_steps:
        bi, bj = s.i in dyn, s.j in dyn
        if s.j in dyn:
            dyn.add(s.i)
        if kernel_kind(s) == "gk":
            p = s.lane
            out.append((p, bi, bj) if p.w_is_j else (p, bj, bi))
    return out


@pytest.mark.parametrize("name", sorted(PATHS))
def test_gk_form_of_every_path_step(name):
    forms = {}
    for p, xb, wb in _gk_steps(name):
        forms[(p.K, p.H, p.F, len(p.xoff))] = gatherk.gk_form(
            p, WIDTH, xb, wb)
    assert {k for k, f in forms.items() if f == "mma"} == MMA_STEPS[name]
    counts = Counter(gatherk.gk_form(p, WIDTH, xb, wb)
                     for p, xb, wb in _gk_steps(name))
    assert dict(counts) == FORM_COUNTS[name]


@pytest.mark.parametrize("name", sorted(PATHS))
def test_stream_steps_are_16_byte_aligned(name):
    """Every stream step's F, xoff, koff, yoff, hstride and width strides
    are multiples of 4 floats, so it takes the 16-byte loads; a step that
    is not would be flagged for the 4-byte variant, named here."""
    flagged = []
    for p, xb, wb in _gk_steps(name):
        if gatherk.gk_form(p, WIDTH, xb, wb) != "stream":
            continue
        assert gatherk.stream_hchunk(p.H) * p.K <= gatherk.STREAM_W_CAP
        ok = gatherk.gk_aligned(p)
        assert ok == all(int(v) % 4 == 0 for v in [
            p.F, p.hstride, p.x_elems, p.y_elems, *p.xoff, *p.yoff,
            *p.koff])
        if not ok:
            flagged.append(f"K {p.K} H {p.H} F {p.F} G {len(p.xoff)}")
    assert flagged == [], f"{name}: 4-byte load variant for {flagged}"


def test_gk_form_rules(monkeypatch):
    """The choice is bytes against FMA flops at STREAM_FMA_SHARE of the
    FMA rate, at any width; a W chunk over the stream form's shared-memory
    cap goes to mma; an f run off the 4-float grid is flagged unaligned."""
    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1)
    step = lambda k, h, f: gatherk.plan_gk_step(
        ("g", "c", "f"), ("c", "n"), ("g", "n", "f"), (4, k, f), (k, h))
    for k, h, want in [(8, 8, "stream"), (16, 16, "stream"),
                       (16, 32, "stream"), (32, 32, "mma"),
                       (16, 128, "mma"), (128, 128, "mma")]:
        p = step(k, h, 256)
        for width, xb, wb in [(1, False, False), (32, True, False),
                              (32, True, True)]:
            assert gatherk.gk_form(p, width, xb, wb) == want, (k, h)
    p = step(2048, 4, 64)          # byte-bound, but W chunk 4 x 2048 > cap
    assert gatherk.gk_bytes(p) / kernels.H100_HBM_BYTES_PER_S >= \
        gatherk.gk_flops(p) / (gatherk.STREAM_FMA_SHARE
                               * kernels.H100_FP32_FLOP_PER_S)
    assert gatherk.gk_form(p) == "mma"
    assert gatherk.gk_aligned(step(8, 8, 256))
    monkeypatch.setattr(gatherk, "F_MIN", 2)
    assert not gatherk.gk_aligned(step(8, 8, 6))


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), nearest-even."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~np.uint64(0x1FFF)
    return (b & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def _product(a, b, passes):
    """(M, K) . (K, N) from TF32 operands: exact products, float32
    accumulation rounded to nearest along k.  ``passes`` 3: the 3xTF32
    split; 1: single-pass TF32.  This models the split's arithmetic, not
    the kernel's: an mma sums its 8 products inside the tensor cores
    without rounding to nearest, which this does not model (so a kernel
    that adds all of K into the mma accumulators would pass here).  The
    kernel's own accuracy is held on the card, against float64, by
    chip_smoke.py and the card tests."""
    ah = _tf32(a)
    bh = _tf32(b)
    terms = [(ah, bh)]
    if passes == 3:
        al = _tf32(a - ah)
        bl = _tf32(b - bh)
        terms += [(ah, bl), (al, bh)]
    acc = np.zeros((a.shape[0], b.shape[1]), dtype=np.float32)
    for k in range(a.shape[1]):
        for x, y in terms:
            acc += np.outer(x[:, k], y[k, :]).astype(np.float32)
    return acc


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("K", [64, 1024])
def test_3xtf32_split_accuracy(K, passes):
    """3xTF32 matches a float64 product to 2^-20 * sum_k |a_k||b_k| at
    every output; single-pass TF32 misses that bound."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((24, K)).astype(np.float32)
    b = rng.standard_normal((K, 40)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    bound = 2.0 ** -20 * (np.abs(a).astype(np.float64)
                          @ np.abs(b).astype(np.float64))
    err = np.abs(_product(a, b, passes) - ref)
    if passes == 3:
        assert (err <= bound).all(), float((err / bound).max())
    else:
        assert (err > bound).any()
        assert float((err / bound).max()) > 8


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = np.array([1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                  1 + 2 ** -11 + 2 ** -20, -(1 + 2 ** -11)],
                 dtype=np.float32)
    want = [1 + 2 ** -10, 1.0, 1 + 2 ** -9, 1 + 2 ** -10, -1.0]
    assert _tf32(x).tolist() == want
    r = _tf32(np.random.default_rng(0).standard_normal(1000))
    assert not (r.view(np.uint32) & 0x1FFF).any()
