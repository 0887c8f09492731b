"""The CUDA kernels on the card: each wrapper against its plain version on
the same CUDA tensors, and the n30 main path against the JAX fixture.

Marked ``gpu``: skipped where no card is present.  On a machine with one
(``--noconftest``: ``tests/conftest.py`` imports JAX, which the port's
machine need not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m gpu
"""

import os

import numpy as np
import pytest
import torch

from artensor_tpu_torch.ops import pallas_mm
from artensor_tpu_torch.runtime import gatherk, lanes

pytestmark = pytest.mark.gpu

DATA = os.path.join(os.path.dirname(__file__), "..", "artensor_tpu_torch",
                    "data")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda")


def _check(call, plain, args):
    before = call.launches
    kr, ki = call(*args)
    pr, pi = plain(*args)
    torch.cuda.synchronize()
    assert call.launches == before + 1
    err = torch.abs(torch.complex(kr - pr, ki - pi)).max().item()
    scale = torch.abs(torch.complex(pr, pi)).max().item()
    assert err <= 2e-4 * scale + 1e-5, (err, scale)


GK_SHAPES = [   # (ix_x, ix_w, iy, dims_x, dims_w)
    (("g1", "c1", "g2", "c2", "f1"), ("c1", "c2", "n1"),
     ("g1", "g2", "n1", "f1"), (2, 2, 4, 2, 256), (2, 2, 2)),
    (tuple(f"c{k}" for k in range(6)) + ("g1", "f1"),
     tuple(f"c{k}" for k in range(6)) + ("n1", "n2"),
     ("g1", "n1", "n2", "f1"), (2,) * 7 + (96,), (2,) * 6 + (8, 5)),
    (("c1", "g1", "f1"), ("c1", "n1"), ("g1", "n1", "f1"),
     (2, 3, 4096), (2, 2)),
    # one shape for each remaining tile of gatherk.cu's launch_any:
    # 4 x 64 (H 2, F 64), 16 x 128 (H 16, F 128), 32 x 32 (H 32, F 32)
    (("g1", "c1", "f1"), ("c1", "n1"), ("g1", "n1", "f1"),
     (5, 4, 64), (4, 2)),
    (("c1", "g1", "f1"), ("c1", "n1"), ("g1", "n1", "f1"),
     (8, 3, 128), (8, 16)),
    (("g1", "c1", "f1"), ("c1", "n1"), ("g1", "n1", "f1"),
     (7, 32, 32), (32, 32)),
]


@pytest.mark.parametrize("batched", [(False, False), (True, False),
                                     (True, True)])
@pytest.mark.parametrize("shape", range(len(GK_SHAPES)))
def test_gk_kernel_matches_plain(cuda, monkeypatch, shape, batched):
    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1)
    ix_x, ix_w, iy, dx, dw = GK_SHAPES[shape]
    plan = gatherk.plan_gk_step(ix_x, ix_w, iy, dx, dw)
    assert plan is not None, gatherk.LAST_REJECT
    xb, wb = batched
    gen = torch.Generator(device="cuda").manual_seed(shape)
    W = 3
    x = [_rand(((W,) if xb else ()) + (plan.x_elems,), gen) for _ in "ri"]
    w = [_rand(((W,) if wb else ()) + (plan.H * plan.K,), gen) for _ in "ri"]
    _check(gatherk.gk_call, gatherk.gk_plain, (plan, *x, *w, xb, wb))


# (ix_x, ix_w, iy, dims_x, dims_w): shapes for both GK forms, with tiles
# of neither form dividing H or the flat (outer index, f) run
GK_FORM_SHAPES = {
    "h64_k64": (("g1", "c1", "c2", "f1"), ("c1", "c2", "n1"),
                ("g1", "n1", "f1"), (3, 8, 8, 96), (8, 8, 64)),
    "h40_k32": (("c1", "g1", "c2", "f1"), ("c2", "c1", "n1", "n2"),
                ("g1", "n1", "n2", "f1"), (4, 2, 8, 160), (8, 4, 5, 8)),
    "h130_k8": (("g1", "c1", "f1"), ("c1", "n1", "n2"), ("g1", "n1", "n2",
                                                          "f1"),
                (3, 8, 64), (8, 10, 13)),
    "h512_k32": (("g1", "c1", "f1"), ("c1", "n1"), ("g1", "n1", "f1"),
                 (2, 32, 256), (32, 512)),
}


@pytest.mark.parametrize("form", ["stream", "mma"])
@pytest.mark.parametrize("batched", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("shape", sorted(GK_FORM_SHAPES))
def test_gk_forms_match_plain(cuda, monkeypatch, shape, batched, form):
    """Each GK form against the plain version at width 1 (neither operand
    batched) and 4, with x and w batched and not."""
    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1)
    plan = gatherk.plan_gk_step(*GK_FORM_SHAPES[shape])
    assert plan is not None, gatherk.LAST_REJECT
    assert gatherk.gk_aligned(plan)
    monkeypatch.setattr(gatherk, "gk_form", lambda *a, **k: form)
    xb, wb = batched
    gen = torch.Generator(device="cuda").manual_seed(len(shape))
    W = 4
    x = [_rand(((W,) if xb else ()) + (plan.x_elems,), gen) for _ in "ri"]
    w = [_rand(((W,) if wb else ()) + (plan.H * plan.K,), gen) for _ in "ri"]
    before = gatherk.gk_call.forms[form]
    _check(gatherk.gk_call, gatherk.gk_plain, (plan, *x, *w, xb, wb))
    assert gatherk.gk_call.forms[form] == before + 1


@pytest.mark.parametrize("form", ["stream", "mma"])
@pytest.mark.parametrize("case", ["f_run_6", "x_pointer"])
def test_gk_forms_unaligned(cuda, monkeypatch, case, form):
    """Offsets or buffers off 16-byte alignment take the 4-byte variant of
    either form: an f run of 6 (a 4-float group spans two outer indices),
    or X starting one float into its allocation."""
    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1)
    if case == "f_run_6":
        monkeypatch.setattr(gatherk, "F_MIN", 2)
        plan = gatherk.plan_gk_step(("g1", "c1", "f1"), ("c1", "n1"),
                                    ("g1", "n1", "f1"), (5, 12, 6), (12, 20))
        assert plan is not None and not gatherk.gk_aligned(plan)
    else:
        plan = gatherk.plan_gk_step(*GK_FORM_SHAPES["h40_k32"])
        assert gatherk.gk_aligned(plan)
    monkeypatch.setattr(gatherk, "gk_form", lambda *a, **k: form)
    gen = torch.Generator(device="cuda").manual_seed(11)
    W = 3
    x = [_rand((W * plan.x_elems + 1,), gen)[1:].reshape(W, plan.x_elems)
         for _ in "ri"]
    if case == "x_pointer":
        assert x[0].data_ptr() % 16 != 0 and x[0].is_contiguous()
    w = [_rand((plan.H * plan.K,), gen) for _ in "ri"]
    _check(gatherk.gk_call, gatherk.gk_plain, (plan, *x, *w, True, False))


GATHERED = {   # form: (rx_i, rx_j, riy, rd_i, rd_j)
    "gk_row": (("g", "k", "f0", "f1"), ("k", "h"), ("g", "h", "f0", "f1"),
               (3, 4, 2, 128), (4, 2)),
    "rgrow": (("k0", "k1", "f0", "k2", "f1"), ("k1", "k0", "k2", "h"),
              ("h", "f0", "f1"), (4, 2, 2, 16, 4), (2, 4, 16, 2)),
    "rgflat": (("f0", "k0", "k1", "k2", "k3", "k4", "f1", "f2"),
               ("k2", "k0", "k4", "k1", "k3", "h0", "h1"),
               ("h0", "h1", "f0", "f1", "f2"), (2,) * 8, (2,) * 7),
    # the 10k plan's RGFlat row: 16 contract then 8 free cells, H 2
    "rgflat_10k_row": (tuple(f"k{d}" for d in range(4)) + ("f0", "f1", "f2"),
                       ("k1", "k2", "k0", "k3", "h"), ("h", "f0", "f1", "f2"),
                       (2,) * 7, (2,) * 5),
}
WRAPPERS = {gatherk.GKPlan: (gatherk.ggk_call, gatherk.ggk_plain),
            gatherk.RGRow: (gatherk.rgrow_call, gatherk.rgrow_plain),
            gatherk.RGFlat: (gatherk.rgflat_call, gatherk.rgflat_plain)}


@pytest.mark.parametrize("w_batched", [False, True])
@pytest.mark.parametrize("form", sorted(GATHERED))
def test_gathered_kernels_match_plain(cuda, monkeypatch, form, w_batched):
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    rng = np.random.default_rng(3)
    gi = np.sort(rng.integers(0, 7, 40))
    gj = rng.integers(0, 6, 40)
    plan = gatherk.plan_ggk_step(*GATHERED[form], gi, gj, 7, 6)
    assert plan is not None, gatherk.LAST_REJECT
    row = plan.row
    assert type(row).__name__ == {"gk_row": "GKPlan", "rgrow": "RGRow"}.get(
        form, "RGFlat")
    xrow = row.x_elems if isinstance(row, gatherk.GKPlan) else row.F * row.K
    gen = torch.Generator(device="cuda").manual_seed(7)
    W = 4
    x = [_rand((W, plan.bi_rows * xrow), gen) for _ in "ri"]
    w = [_rand(((W,) if w_batched else ()) + (plan.bj_rows * row.H * row.K,),
               gen) for _ in "ri"]
    call, plain = WRAPPERS[type(row)]
    _check(call, plain, (plan, *x, *w, True, w_batched))


@pytest.mark.parametrize("kmn", [(64, 256, 160), (100, 90, 130),
                                 (40, 300, 516)])
def test_pair_kernel_matches_plain(cuda, kmn):
    K, M, N = kmn
    plan = lanes.plan_pair_step(("k", "m"), ("k", "n"), ("m", "n"),
                                (K, M), (K, N))
    assert plan is not None, lanes.LAST_REJECT
    gen = torch.Generator(device="cuda").manual_seed(K)
    W = 2
    x = [_rand((W, K * M), gen) for _ in "ri"]
    v = [_rand((K * N,), gen) for _ in "ri"]
    _check(lanes.pair_call, lanes.pair_plain, (plan, *x, *v, True, False))


@pytest.mark.parametrize("batched", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("kmn", [(100, 130, 136), (37, 300, 250),
                                 (512, 32768, 256)])
def test_pair_kernel_widths_and_path_shape(cuda, kmn, batched):
    """The tensor-core pair kernel at widths 1 and 4, operands batched and
    not: ragged M, N and K tiles (M and N off the 4-float grid take the
    4-byte copies), and the 10k path's K 512 M 32768 N 256."""
    K, M, N = kmn
    plan = lanes.plan_pair_step(("k", "m"), ("k", "n"), ("m", "n"),
                                (K, M), (K, N))
    assert plan is not None, lanes.LAST_REJECT
    xb, vb = batched
    gen = torch.Generator(device="cuda").manual_seed(M)
    W = 4 if (xb or vb) else 1
    x = [_rand(((W,) if xb else ()) + (K * M,), gen) for _ in "ri"]
    v = [_rand(((W,) if vb else ()) + (K * N,), gen) for _ in "ri"]
    _check(lanes.pair_call, lanes.pair_plain, (plan, *x, *v, xb, vb))


# (ix_x, ix_w, iy, dims_x, dims_w, plan_lane_step arguments): the forms
# of tests/test_lanes.py, and a small copy of the n30 sc25 path's tail step
# (pinned batch axis, lane-free legs among the lanes: T 8 of L 128)
LANE_FORMS = {
    "head": (("a", "b", "c", "d"), ("a", "b", "n", "m"), ("n", "m", "c", "d"),
             (4, 32, 128, 16), (4, 32, 4, 4),
             dict(lane_count=2, orient="head")),
    "combos": (("a", "b", "c", "g", "e", "d"), ("a", "e", "n"),
               ("g", "c", "b", "n", "d"), (64, 2, 64, 2, 2, 256), (64, 2, 8),
               dict(lane_count=2, orient="head")),
    "tail": (("c", "d", "a", "b"), ("a", "b", "n"), ("c", "d", "n"),
             (128, 16, 4, 32), (4, 32, 16), dict(lane_count=2, orient="tail")),
    "pinned": (("B", "a", "b", "c"), ("a", "b", "n"), ("B", "n", "c"),
               (6, 4, 32, 512), (4, 32, 8),
               dict(lane_count=2, pin=1, orient="head")),
    "sc25_tail": (("B",) + tuple(f"f{k}" for k in range(10))
                  + ("p0", "k0", "p1", "k1", "p2", "p3", "k2"),
                  ("k1", "k2", "k0", "n0", "n1", "n2"),
                  ("B",) + tuple(f"f{k}" for k in range(10))
                  + ("p0", "p1", "p2", "p3", "n0", "n1", "n2"),
                  (4,) + (2,) * 17, (2,) * 6,
                  dict(lane_count=7, pin=1, orient="tail")),
}


@pytest.mark.parametrize("batched", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("form", sorted(LANE_FORMS))
def test_lane_kernel_matches_plain(cuda, form, batched):
    ix_x, ix_w, iy, dx, dw, kw = LANE_FORMS[form]
    plan = lanes.plan_lane_step(ix_x, ix_w, iy, dx, dw, **kw)
    assert plan is not None, lanes.LAST_REJECT
    xb, wb = batched
    gen = torch.Generator(device="cuda").manual_seed(len(form))
    W = 3
    x = [_rand(((W,) if xb else ()) + (plan.x_elems,), gen) for _ in "ri"]
    w = [_rand(((W,) if wb else ()) + (plan.w_elems,), gen) for _ in "ri"]
    _check(lanes.lane_call, lanes.lane_plain, (plan, *x, *w, xb, wb))


@pytest.mark.parametrize("bmkn", [(2, 256, 64, 256), (3, 100, 37, 70)])
def test_complex_matmul_kernel_matches_plain(cuda, bmkn):
    B, M, K, N = bmkn
    gen = torch.Generator(device="cuda").manual_seed(M)
    a = tuple(_rand((B, M, K), gen) for _ in "ri")
    b = tuple(_rand((B, K, N), gen) for _ in "ri")
    _check(pallas_mm.complex_batched_matmul,
           pallas_mm.complex_batched_matmul_plain, (a, b))


@pytest.mark.parametrize("n_bits,plan", [
    (1000, "rcs_n30_m14_s0_sparse_sc24.json"),
    (10000, "rcs_n30_m14_s0_sparse10k_sc24.json"),
    (1000, "rcs_n30_m14_s0_sparse_sc25.json")])
def test_n30_main_path_matches_fixture(cuda, n_bits, plan):
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit

    ref = {}
    with open(os.path.join(DATA, f"rcs_n30_m14_s0_amps{n_bits}.txt")) as f:
        for ln in f:
            b, re, im = ln.split()
            ref[b] = complex(float(re), float(im))
    sim = TensorNetworkSimulation.from_circuit(
        random_circuit(5, 6, 14, seed=0), list(ref)).load_plan(
        os.path.join(DATA, plan))
    amps = sim.contraction(slice_batch=16)
    r = np.array([ref[b] for b in sim.bitstrings_sorted])
    rms = np.sqrt(np.mean(np.abs(r) ** 2))
    assert (np.abs(amps - r) <= 1e-3 * np.abs(r) + 1e-6 * rms).all()
