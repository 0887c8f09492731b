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
    # small H or F: H 2 F 64, H 16 F 128, H 32 F 32
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


def _gathered(case, B, bi_rows, bj_rows, seed=3):
    rng = np.random.default_rng(seed)
    gi = np.sort(rng.integers(0, bi_rows, B))
    gj = rng.integers(0, bj_rows, B)
    plan = gatherk.plan_ggk_step(*case, gi, gj, bi_rows, bj_rows)
    assert plan is not None, gatherk.LAST_REJECT
    return plan


def _run_gathered(plan, xb, wb, seed=7, W=4, x_shift=0):
    """Each gathered wrapper against its plain version; ``x_shift``
    starts X that many floats into its allocation."""
    row = plan.row
    xrow = row.x_elems if isinstance(row, gatherk.GKPlan) else row.F * row.K
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = plan.bi_rows * xrow
    lx = (W,) if xb else ()
    x = [_rand((W * n + x_shift,), gen)[x_shift:x_shift + (W if xb else 1)
                                        * n].reshape(lx + (n,))
         for _ in "ri"]
    w = [_rand(((W,) if wb else ()) + (plan.bj_rows * row.H * row.K,), gen)
         for _ in "ri"]
    call, plain = WRAPPERS[type(row)]
    _check(call, plain, (plan, *x, *w, xb, wb))


@pytest.mark.parametrize("w_batched", [False, True])
@pytest.mark.parametrize("form", sorted(GATHERED))
def test_gathered_kernels_match_plain(cuda, monkeypatch, form, w_batched):
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    plan = _gathered(GATHERED[form], 40, 7, 6)
    assert type(plan.row).__name__ == {"gk_row": "GKPlan",
                                       "rgrow": "RGRow"}.get(form, "RGFlat")
    _run_gathered(plan, True, w_batched)


BATCHINGS = [(False, False), (True, False), (False, True), (True, True)]
# (rx_i, rx_j, riy, rd_i, rd_j, B, bi_rows, bj_rows, forms): the three GGK
# steps of the paths (K, H, F and G as there, B cut to a few hundred)
GGK_PATH_STEPS = {
    "1k_k2_h2_f64_g64": (("g0", "k", "g1", "f"), ("k", "h"),
                         ("h", "g1", "g0", "f"), (8, 2, 8, 64), (2, 2),
                         300, 290, 4, ("stream",)),
    "1k_k16_h16_f512": (("k0", "k1", "k2", "k3", "f"),
                        ("k0", "k1", "k2", "k3", "h0", "h1", "h2", "h3"),
                        ("h0", "h1", "h2", "h3", "f"), (2, 2, 2, 2, 512),
                        (2,) * 8, 270, 128, 32, ("stream", "mma")),
    "10k_k32_h2_f64": (tuple(f"k{d}" for d in range(5)) + ("f",),
                       ("h",) + tuple(f"k{d}" for d in range(5)),
                       ("h", "f"), (2,) * 5 + (64,), (2,) * 6,
                       400, 230, 128, ("stream",)),
}


@pytest.mark.parametrize("batched", BATCHINGS)
@pytest.mark.parametrize("form", ["stream", "mma"])
@pytest.mark.parametrize("step", sorted(GGK_PATH_STEPS))
def test_ggk_forms_at_path_shapes(cuda, monkeypatch, step, form, batched):
    """GGK in each form that takes the step, at each path step's shape,
    with X and W each batched or not (X unbatched with W batched is the 1k
    K 16 H 16 step's case); the mma form refuses an f run that is not a
    multiple of its 128-wide tile."""
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    *case, B, bi, bj, forms = GGK_PATH_STEPS[step]
    plan = _gathered(tuple(case), B, bi, bj)
    assert isinstance(plan.row, gatherk.GKPlan) and gatherk.gk_aligned(plan)
    monkeypatch.setattr(gatherk, "gk_form", lambda *a, **k: form)
    xb, wb = batched
    if form not in forms:
        with pytest.raises(RuntimeError, match="ggk"):
            _run_gathered(plan, xb, wb)
        return
    before = gatherk.ggk_call.forms[form]
    _run_gathered(plan, xb, wb)
    assert gatherk.ggk_call.forms[form] == before + 1


@pytest.mark.parametrize("case,form", [("f_run_6", "stream"),
                                       ("x_pointer", "stream"),
                                       ("x_pointer", "mma")])
def test_ggk_forms_unaligned(cuda, monkeypatch, case, form):
    """GGK offsets or buffers off 16-byte alignment take the 4-byte
    variant: an f run of 6 (a 4-float group spans two outer indices, each
    with its own W row; the mma form takes no such run), or X one float
    into its allocation."""
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    if case == "f_run_6":
        monkeypatch.setattr(gatherk, "F_MIN", 2)
        plan = _gathered((("g", "k", "f"), ("k", "h"), ("g", "h", "f"),
                          (5, 12, 6), (12, 3)), 50, 9, 7)
        assert not gatherk.gk_aligned(plan)
    else:
        *c, B, bi, bj, _ = GGK_PATH_STEPS["1k_k16_h16_f512"]
        plan = _gathered(tuple(c), 60, 20, 8)
        assert gatherk.gk_aligned(plan)
    monkeypatch.setattr(gatherk, "gk_form", lambda *a, **k: form)
    _run_gathered(plan, True, True, x_shift=1)


@pytest.mark.parametrize("batched,x_shift", [((True, True), 0),
                                             ((True, False), 1),
                                             ((False, True), 0)])
def test_ggk_stream_w_rows_through_l1(cuda, monkeypatch, batched, x_shift):
    """A GGK step whose W rows for the outer indices one stream block spans
    would pass the 64 KiB staging cap (F 32, K 256: 17 rows of 4 x 256
    complex) reads them through L1 instead; aligned and not."""
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    plan = _gathered((("k", "f"), ("k", "h"), ("h", "f"), (256, 32),
                      (256, 4)), 60, 20, 9)
    assert isinstance(plan.row, gatherk.GKPlan) and plan.row.F == 32
    monkeypatch.setattr(gatherk, "gk_form", lambda *a, **k: "stream")
    _run_gathered(plan, *batched, x_shift=x_shift)


def _rg_case(F, H, K, hy_first, stored, seed=0):
    """An RGRow step of F free cells, H fresh and K contract values (binary
    digits).  ``stored``: X's digits in a shuffled order (the kernel reads
    it through a non-identity digit permutation), with two free digits
    minor in storage as on the 1k path, and W's fresh digits minor (its
    W[:, k] are vector loads); else the canonical order (frees, then
    contract) and W's fresh digits leading.  W's contract digits are
    shuffled."""
    rng = np.random.default_rng(seed)
    nf, nh, nk = (int(np.log2(v)) for v in (F, H, K))
    fr = [f"f{d}" for d in range(nf)]
    kk = [f"k{d}" for d in range(nk)]
    hh = [f"h{d}" for d in range(nh)]
    if stored:
        rest = fr[:-2] + kk if nf >= 2 else fr + kk
        x = list(rng.permutation(rest)) + (fr[-2:] if nf >= 2 else [])
    else:
        x = fr + kk
    w = list(rng.permutation(kk))
    w = w + hh if stored else hh + w
    riy = hh + fr if hy_first else fr + hh
    return (tuple(x), tuple(w), tuple(riy), (2,) * len(x), (2,) * len(w))


RG_SHAPES = [   # (F, H, K, hy_first, stored); H 1 has no fresh leg to lead
    (1, 1, 256, False, False), (1, 1, 16384, False, False),
    (16, 4, 2048, True, True), (16, 4, 2048, True, False),
    (16, 1, 512, False, True), (16, 8, 128, False, True),
    (256, 8, 128, True, True), (256, 4, 128, False, False),
    (256, 1, 128, False, True), (64, 2, 256, True, True),
]


@pytest.mark.parametrize("batched", [(True, True), (True, False),
                                     (False, True)])
@pytest.mark.parametrize("shape", RG_SHAPES, ids=str)
def test_rgrow_kernel_shapes(cuda, monkeypatch, shape, batched):
    """RGRow across its plan's range: F 1, 16 and 256, H 1 to 8, both
    output orders, X in a stored order that is not the canonical one and
    in the canonical one; the vector loads of the free cells on and, with
    X one float into its allocation, off."""
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    F, H, K, hy_first, stored = shape
    plan = _gathered(_rg_case(F, H, K, hy_first, stored), 120, 40, 50)
    row = plan.row
    assert isinstance(row, gatherk.RGRow)
    assert (row.F, row.H, row.K, row.hy_first) == (F, H, K, hy_first)
    assert (row.pre_perm is not None) == (stored and F > 1)
    xb, wb = batched
    _run_gathered(plan, xb, wb)
    _run_gathered(plan, xb, wb, x_shift=1)


# RGFlat X rows, stored digits major to minor ('k' contract, 'f' free, all
# binary): the 10k path's (contract major, free minor: V 4), the 1k-sc25
# path's interleaved one (V 4), a minor free pair (V 2), a minor contract
# digit (V 1), and a row of RG_ROW_CAP = 2^15 elements (the direct route)
RGF_LAYOUTS = {"10k": "kkkkfff", "sc25": "kffkkfkkff", "v2": "fkkfkkkf",
               "v1": "ffffkkkkk", "cap": "ffffkkfffkkkkff"}


def _rgf_case(layout, H, seed=0):
    """An RGFlat step: X's digits as ``RGF_LAYOUTS[layout]`` names them,
    W's contract digits shuffled with its log2(H) fresh digits placed
    among them at random, the fresh block leading the output."""
    rng = np.random.default_rng(seed)
    x = [f"{r}{d}" for d, r in enumerate(RGF_LAYOUTS[layout])]
    kk = [l for l in x if l[0] == "k"]
    hh = [f"h{d}" for d in range(int(np.log2(H)))]
    w = list(rng.permutation(kk + hh))
    riy = hh + [l for l in x if l[0] == "f"]
    return (tuple(x), tuple(w), tuple(riy), (2,) * len(x), (2,) * len(w))


@pytest.mark.parametrize("w_batched", [True, False])
@pytest.mark.parametrize("H", [1, 2, 8])
@pytest.mark.parametrize("layout", sorted(RGF_LAYOUTS))
def test_rgflat_kernel_layouts(cuda, monkeypatch, layout, H, w_batched):
    """The RGFlat kernel against its plain version at widths 1 and 32, X
    batched, W batched and slice-invariant; targets sorted with repeated
    and skipped X rows, W rows in random order.  Each case also runs with
    X one float into its allocation: the staged route then copies with
    4-byte cp.async, the direct route (the 2^15-element row) reads one
    float a load.  The route, vector width and W staging asserted are
    ``gatherk.rgf_geometry``'s."""
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    B, bi, bj = (60, 30, 9) if layout == "cap" else (300, 200, 50)
    plan = _gathered(_rgf_case(layout, H), B, bi, bj, seed=len(layout) + H)
    row = plan.row
    assert isinstance(row, gatherk.RGFlat) and row.H == H
    assert len(np.unique(plan.gi)) < B and (np.diff(plan.gi) > 1).any()
    g = gatherk.rgf_geometry(plan)
    assert g["V"] == {"v2": 2, "v1": 1}.get(layout, 4)
    assert (g["T"] == 0) == (layout == "cap")
    assert (g["wn"] > 0) == (layout != "cap" and bj * H * row.K
                             <= gatherk.RGF_W_STAGE)
    if layout == "cap":
        assert row.xrow == gatherk.RG_ROW_CAP
    assert gatherk.rgf_geometry(plan, x_aligned=False)["cp16"] is False
    for W in (1, 32):
        for x_shift in (0, 1):
            _run_gathered(plan, True, w_batched, W=W, x_shift=x_shift)


def _one_per_kernel(dev):
    """(wrapper, plain version, arguments) of one small call of each kernel
    wrapper, on device ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda n, lead=(): torch.randn(lead + (n,), generator=gen,
                                         device=dev)
    out = []
    gk = gatherk.plan_gk_step(*GK_FORM_SHAPES["h40_k32"])
    out.append((gatherk.gk_call, gatherk.gk_plain,
                (gk, rnd(gk.x_elems, (2,)), rnd(gk.x_elems, (2,)),
                 rnd(gk.H * gk.K), rnd(gk.H * gk.K), True, False)))
    for case, B, bi, bj in ((GATHERED["gk_row"], 40, 7, 6),
                            (_rg_case(16, 4, 256, True, True), 30, 9, 8),
                            (GATHERED["rgflat"], 40, 7, 6)):
        p = _gathered(case, B, bi, bj)
        row = p.row
        xrow = row.x_elems if isinstance(row, gatherk.GKPlan) \
            else row.F * row.K
        call, plain = WRAPPERS[type(row)]
        n, m = p.bi_rows * xrow, p.bj_rows * row.H * row.K
        out.append((call, plain, (p, rnd(n, (2,)), rnd(n, (2,)), rnd(m),
                                  rnd(m), True, False)))
    ix_x, ix_w, iy, dx, dw, kw = LANE_FORMS["tail"]
    lp = lanes.plan_lane_step(ix_x, ix_w, iy, dx, dw, **kw)
    out.append((lanes.lane_call, lanes.lane_plain,
                (lp, rnd(lp.x_elems), rnd(lp.x_elems), rnd(lp.w_elems),
                 rnd(lp.w_elems), False, False)))
    pp = lanes.plan_pair_step(("k", "m"), ("k", "n"), ("m", "n"),
                              (40, 300), (40, 516))
    out.append((lanes.pair_call, lanes.pair_plain,
                (pp, rnd(40 * 300), rnd(40 * 300), rnd(40 * 516),
                 rnd(40 * 516), False, False)))
    a = (rnd(37 * 100, (3,)).reshape(3, 100, 37),
         rnd(37 * 100, (3,)).reshape(3, 100, 37))
    b = (rnd(37 * 70, (3,)).reshape(3, 37, 70),
         rnd(37 * 70, (3,)).reshape(3, 37, 70))
    out.append((pallas_mm.complex_batched_matmul,
                pallas_mm.complex_batched_matmul_plain, (a, b)))
    return out


def _on_device(dev, monkeypatch):
    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1)
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    for call, plain, args in _one_per_kernel(dev):
        before = call.launches
        kr, ki = call(*args)
        pr, pi = plain(*args)
        torch.cuda.synchronize(dev)
        assert call.launches == before + 1
        assert kr.device == torch.device(dev)
        err = torch.abs(torch.complex(kr - pr, ki - pi)).max().item()
        scale = torch.abs(torch.complex(pr, pi)).max().item()
        assert err <= 2e-4 * scale + 1e-5, (call.__name__, err, scale)


def test_wrappers_on_explicit_cuda0(cuda, monkeypatch):
    """Every kernel wrapper on operands given an explicit ``cuda:0``."""
    _on_device("cuda:0", monkeypatch)


def test_wrappers_on_cuda1_while_cuda0_current(cuda, monkeypatch):
    """Every kernel wrapper on ``cuda:1`` operands while ``cuda:0`` is the
    current device: each launch must run on the operands' card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards; this machine has "
                    f"{torch.cuda.device_count()}")
    with torch.cuda.device(0):
        _on_device("cuda:1", monkeypatch)
        assert torch.cuda.current_device() == 0


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


DEFAULT_RECORD = os.path.join(os.path.dirname(__file__), "data",
                              "torch_port_default_schemes.json")
N30_WORKLOADS = {"1k": (1000, "rcs_n30_m14_s0_sparse_sc24.json"),
                 "10k": (10000, "rcs_n30_m14_s0_sparse10k_sc24.json"),
                 "1k-sc25": (1000, "rcs_n30_m14_s0_sparse_sc25.json")}


@pytest.fixture(scope="module", params=sorted(N30_WORKLOADS))
def n30_default(request):
    """A workload's simulation as ``load_plan`` compiles it (the default
    form) on this host, with its device steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.runtime.executor import precompute_static_steps

    n_bits, plan = N30_WORKLOADS[request.param]
    with open(os.path.join(DATA, f"rcs_n30_m14_s0_amps{n_bits}.txt")) as f:
        bits = [ln.split()[0] for ln in f if ln.strip()]
    sim = TensorNetworkSimulation.from_circuit(
        random_circuit(5, 6, 14, seed=0), bits).load_plan(
        os.path.join(DATA, plan))
    run_steps, host = precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)
    return request.param, sim, run_steps, host


def test_n30_default_scheme_as_on_the_cpu(cuda, n30_default):
    """The default form compiled on the card's host makes the scheme that
    the CPU compile recorded (``scripts/default_schemes_torch_port.py``)."""
    import json
    from collections import Counter

    from artensor_tpu_torch.runtime.sparse import kernel_kind, scheme_digest

    name, sim, _, _ = n30_default
    with open(DEFAULT_RECORD) as f:
        want = json.load(f)[name]
    census = Counter(kernel_kind(s) or "dot" for s in sim.steps)
    assert dict(census) == want["census"]
    assert scheme_digest(sim.steps) == want["digest"]


def test_n30_default_width_peak_is_modeled(cuda, n30_default):
    """At the width the wall estimate picks, the modeled peak (the live
    set at that width with the dot fallback's operand copies and the GK
    tables, ``metrics.scheme_device_peak_bytes``, plus what the model
    leaves out: the staged operands and the runtime's reserve,
    ``PEAK_RESERVE_BYTES``) is at least the peak the run allocates, and
    the model alone at least 90% of it: the graph run (warm-up group and
    capture included) is held to the model of the eager one."""
    from artensor_tpu_torch.planner.cost import PEAK_RESERVE_BYTES
    from artensor_tpu_torch.runtime import metrics

    name, sim, run_steps, host = n30_default
    W = metrics.dividing_slice_width(run_steps, len(sim.slicing_bonds),
                                     sim.slicing_axes)
    model = metrics.scheme_device_peak_bytes(run_steps, W,
                                             sim.slicing_axes)
    staged = sum(8 * int(np.prod(np.shape(a))) for a in host)
    # the run's own allocations: its warm-up group, its graph capture and
    # two replays (no workspace or cached block of an earlier test)
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = sim.prepare(slice_batch=W, device="cuda")
    run()
    out = run()
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated()
    del run, out
    torch.cuda.empty_cache()
    assert measured <= model + staged + PEAK_RESERVE_BYTES, \
        (name, W, measured, model, staged)
    assert model >= 0.9 * measured


DENSE_PLAN = os.path.join(DATA, "rcs_n30_m14_s0_dense_sc30.json")


@pytest.fixture(scope="module")
def dense_gk_steps():
    """The GK steps of the n30 dense path with their operands' width axes:
    ``whole``, the whole-state default scheme (unbatched, X up to 2^30
    elements); ``block``, the scheme of one of the 64 output blocks of
    ``contraction_output_blocks(6)`` (width 1 on the operands that carry
    a sliced open leg)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.runtime.executor import precompute_static_steps
    from artensor_tpu_torch.runtime.sparse import kernel_kind
    from artensor_tpu_torch.simulation import _dense_shard_setup

    sim = TensorNetworkSimulation.from_circuit(
        random_circuit(5, 6, 14, seed=0)).load_plan(DENSE_PLAN)
    leaves = [sim.tensors[i] for i in range(len(sim.tensors))]
    out = {}
    steps, axes, _, _, _, restore = _dense_shard_setup(sim, 6)
    restore()
    for name, (st, ax) in {"whole": (sim.steps, sim.slicing_axes),
                           "block": (steps, axes)}.items():
        run_steps, _ = precompute_static_steps(st, leaves, ax)
        dyn = {tid for entries in ax for tid, *_ in entries}
        cases = []
        for s in run_steps:
            if kernel_kind(s) == "gk":
                bx, by = s.i in dyn, s.j in dyn
                xs, ws = (bx, by) if s.lane.w_is_j else (by, bx)
                cases.append((s.lane, xs, ws))
            if s.j in dyn:
                dyn.add(s.i)
        out[name] = cases
    return out


@pytest.mark.parametrize("which", ["whole", "block"])
def test_gk_kernel_at_dense_path_steps(cuda, dense_gk_steps, which):
    """The GK kernel against its plain version at the dense path's GK step
    with the largest X, and of those the most outer indices: on the
    whole-state path a 2^30-element carrier (its 64-bit offsets and
    grid); on the block walk the largest step that runs per block, with
    an operand at width 1."""
    cases = dense_gk_steps[which]
    if which == "block":
        cases = [c for c in cases if c[1] or c[2]]
    plan, xs, ws = max(cases, key=lambda c: (c[0].x_elems, len(c[0].xoff)))
    if which == "whole":
        assert plan.x_elems == 1 << 30 and not (xs or ws)
    gen = torch.Generator(device="cuda").manual_seed(11)
    lead = lambda b: (1,) if b else ()
    xr, xi = (_rand(lead(xs) + (plan.x_elems,), gen) for _ in range(2))
    wr, wi = (_rand(lead(ws) + (plan.H * plan.K,), gen) for _ in range(2))
    before = gatherk.gk_call.launches
    kr, ki = gatherk.gk_call(plan, xr, xi, wr, wi, xs, ws)
    pr, pi = gatherk.gk_plain(plan, xr, xi, wr, wi, xs, ws)
    torch.cuda.synchronize()
    assert gatherk.gk_call.launches == before + 1
    err = scale = 0.0
    chunk = 1 << 26       # complex copies of a whole 2^30 output would not fit
    for s in range(0, kr.numel(), chunk):
        k, p = (torch.complex(a.reshape(-1)[s:s + chunk],
                              b.reshape(-1)[s:s + chunk])
                for a, b in ((kr, ki), (pr, pi)))
        err = max(err, torch.abs(k - p).max().item())
        scale = max(scale, torch.abs(p).max().item())
    assert err <= 2e-4 * scale + 1e-5, (err, scale)
    del xr, xi, kr, ki, pr, pi
    torch.cuda.empty_cache()


# -- CUDA-graph replay (runtime/executor.GroupGraphs) -------------------------

FAMILIES = ("gk", "ggk", "rgrow", "rgflat", "lane", "pair", "complex_mm")
RGF_PLAN = os.path.join(os.path.dirname(__file__), "data",
                        "torch_port_rcs15_rgflat_plan.json")


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, tuple):
            yield from _tensors(a)


def _device_kernels(fn):
    """``fn()``: the port's kernels the card ran meanwhile, by (kind,
    form), as the kernels count themselves (``kernels.device_runs``: a
    graph replay counts as a launch does, a capture counts nothing)."""
    from collections import Counter

    from artensor_tpu_torch.kernels import device_runs

    before = device_runs()
    fn()
    after = device_runs()
    return Counter({k: n - before[k] for k, n in after.items()
                    if n != before[k]})


def _ran(counts, kind):
    return sum(n for (k, _), n in counts.items() if k == kind)


@pytest.mark.parametrize("family", FAMILIES)
def test_graph_replay_equals_eager(cuda, monkeypatch, family):
    """Each kernel family captured in a CUDA graph: the capture launches
    nothing and the wrapper counts nothing, a replay runs the kernel once
    on the card (the kernels' own counters; it calls no wrapper) and
    gives the eager call's result, and after new values are copied into
    the same inputs a replay gives the eager call's result on them."""
    from artensor_tpu_torch.runtime.executor import GroupGraphs

    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1)
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    call, _, args = _one_per_kernel("cuda")[FAMILIES.index(family)]
    want = [c.clone() for c in call(*args)]     # warm-up: device tables
    before = call.launches
    graphs = GroupGraphs(torch.device("cuda"))
    out = {}
    graphs.capture(lambda: out.update(y=call(*args)))
    assert call.launches == before
    kind = family
    gen = torch.Generator(device="cuda").manual_seed(9)
    for _ in range(2):
        assert _ran(_device_kernels(graphs.replay), kind) == 1
        assert call.launches == before
        for g, w in zip(out["y"], want):
            assert torch.allclose(g, w, rtol=1e-6, atol=1e-7), family
        for t in _tensors(args):
            if t.dtype == torch.float32:
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
        want = [c.clone() for c in call(*args)]
        before = call.launches


def _greedy_order(tensor_bonds, bond_dims):
    """A pairwise order that always merges the connected pair with the
    smallest result (the planner is not ported: the card's machine has no
    JAX to plan with)."""
    from math import log2

    bonds = {t: set(b) for t, b in tensor_bonds.items()}
    order = []
    while len(bonds) > 1:
        best = None
        for i in bonds:
            for j in bonds:
                if i < j and bonds[i] & bonds[j]:
                    size = sum(log2(bond_dims[b]) for b in bonds[i] ^ bonds[j])
                    if best is None or size < best[0]:
                        best = (size, i, j)
        _, i, j = best
        bonds[i] ^= bonds.pop(j)
        order.append((i, j))
    return order


def _small_sim(monkeypatch, bits=True):
    """With the size gates lowered (GK, RGFlat and Lane steps): sparse,
    random_circuit(3, 5, 8, seed=13) with 128 bitstrings on the committed
    small plan; or (``bits=False``) dense, random_circuit(3, 4, 8,
    seed=13) on a greedy order of its network (no sliced bond)."""
    import json

    from artensor_tpu_torch import (TensorNetworkCircuit,
                                    TensorNetworkSimulation, random_circuit)
    from artensor_tpu_torch.runtime import lanes as planes
    from artensor_tpu_torch.runtime import sparse as psparse

    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1 << 8)
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1 << 8)
    monkeypatch.setattr(planes, "MIN_X_ELEMS", 1 << 6)
    monkeypatch.setattr(psparse, "RETAIL_MIN_ELEMS", 1 << 6)
    if not bits:
        circ = TensorNetworkCircuit(random_circuit(3, 4, 8, seed=13))
        sim = TensorNetworkSimulation.from_circuit(circ)
        plan = dict(version=1, tensor_bonds=sim.tensor_bonds,
                    bond_dims=sim.bond_dims, final_qubits=sim.final_qubits,
                    max_bitstring=1, slicing_bonds=[],
                    order=_greedy_order(sim.tensor_bonds, sim.bond_dims),
                    meta={})
        return sim.load_plan(plan), circ
    circ = TensorNetworkCircuit(random_circuit(3, 5, 8, seed=13))
    rng = np.random.default_rng(4)
    bits = [np.binary_repr(b, 15)
            for b in rng.choice(2 ** 15, 128, replace=False)]
    with open(RGF_PLAN) as f:
        plan = json.load(f)
    return TensorNetworkSimulation.from_circuit(circ, bits).load_plan(
        plan), circ


def _close(a, b):
    scale = max(c.abs().max().item() for c in b)
    return max((x - y).abs().max().item() for x, y in zip(a, b)) \
        <= 1e-6 * scale


def test_runner_replays_other_slice_ids(cuda, monkeypatch):
    """One capture serves every later call on the same staged tensors: a
    second call with other slice ids replays it and equals the eager run
    on those ids; the two halves sum to the whole run."""
    from artensor_tpu_torch.runtime import executor as ex

    sim, _ = _small_sim(monkeypatch)
    field, run_steps, arrays, out_shape, execute, _ = sim._staged(
        torch.device("cuda"))
    mk = lambda eager: ex.make_sliced_runner(
        execute, run_steps, sim.slicing_axes, len(sim.slicing_bonds),
        out_shape, field, slice_batch=2, eager=eager)
    graph, eager = mk(False), mk(True)
    n = 2 ** len(sim.slicing_bonds)
    a = graph(arrays, range(0, n // 2))
    b = graph(arrays, range(n // 2, n))
    assert graph.stats["captures"] == 1
    assert graph.stats["replays"] == n // 2
    assert _close(a, eager(arrays, range(0, n // 2)))
    assert _close(b, eager(arrays, range(n // 2, n)))
    assert _close(field.add(a, b), graph(arrays))
    assert graph.stats["captures"] == 1


def test_segmented_graphs_equal_whole_group(cuda, monkeypatch):
    """The segmented run (one graph a segment, one shared pool) equals the
    whole-group graph at width 2, with the width it asked for."""
    from artensor_tpu_torch.runtime import executor as ex
    from artensor_tpu_torch.runtime import segmented

    sim, _ = _small_sim(monkeypatch)
    field, run_steps, arrays, out_shape, execute, step = sim._staged(
        torch.device("cuda"))
    k = len(sim.slicing_bonds)
    whole = ex.make_sliced_runner(execute, run_steps, sim.slicing_axes, k,
                                  out_shape, field, slice_batch=2)(arrays)
    seg = segmented.run_segmented(arrays, run_steps, sim.slicing_axes, k,
                                  out_shape, field, step, segment_steps=3,
                                  slice_batch=2)
    run = segmented.LAST_RUN
    assert run["graphs"] and run["width"] == 2
    assert run["segments"] == -(-len(run_steps) // 3)
    assert run["replays"] == 2 ** k // 2
    assert _close(seg, whole)


def test_block_walk_under_graphs_equals_state(cuda, monkeypatch):
    """The dense output-block walk, one graph replayed a block, gives the
    whole state's blocks and the state vector."""
    sim, circ = _small_sim(monkeypatch, bits=False)
    state = sim.contraction(device="cuda")
    assert sim.run_stats["executor"] == "graph"
    exact = circ.state_vec()
    assert np.abs(state - exact).max() <= 2e-5 * np.abs(exact).max()
    n = 0
    for bits, qubits, block in sim.contraction_output_blocks(
            3, device="cuda"):
        idx = tuple(int(b) for b in bits)
        want = np.moveaxis(state, qubits, range(len(qubits)))[idx]
        assert np.abs(block - want).max() <= 1e-6 * np.abs(state).max()
        n += 1
    assert n == 8
    st = sim.block_run_stats
    assert st["captures"] == 1 and st["replays"] == 8


def test_contraction_runs_kernels_at_every_replay(cuda, monkeypatch):
    """``contraction()`` on the card from scratch, its kernels counted on
    the card (``kernels.device_runs``)
    (its warm-up group, capture and replays): the card runs every kernel
    step once a group, the warm-up group and each replay, while the
    wrappers count the warm-up group's launches only."""
    from collections import Counter

    from artensor_tpu_torch.runtime.executor import precompute_static_steps
    from artensor_tpu_torch.runtime.sparse import kernel_kind

    sim, _ = _small_sim(monkeypatch)
    run_steps, _ = precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)
    census = Counter(kernel_kind(s) for s in run_steps if kernel_kind(s))
    assert {"gk", "rgflat", "lane"} <= set(census)
    wrappers = dict(zip(FAMILIES, (gatherk.gk_call, gatherk.ggk_call,
                                   gatherk.rgrow_call, gatherk.rgflat_call,
                                   lanes.lane_call, lanes.pair_call)))
    before = {k: f.launches for k, f in wrappers.items()}
    ran = _device_kernels(lambda: sim.contraction(slice_batch=2,
                                                  device="cuda"))
    st = sim.run_stats
    assert st["executor"] == "graph" and st["captures"] == 1
    assert st["warmup_groups"] == 1
    assert st["replays"] == 2 ** len(sim.slicing_bonds) // 2
    for kind, f in wrappers.items():
        assert f.launches - before[kind] == census[kind], kind
        assert _ran(ran, kind) == census[kind] * (1 + st["replays"]), kind


# -- the one-pass TF32 form and the field modes ------------------------------
#
# The one-pass form of a tensor-core kernel multiplies TF32 operands (low
# 13 mantissa bits cleared) once; its plain version rounds the operands
# the same way (``kernels.tf32_round``) and multiplies them in float32.
# The products are exact in float32 on both sides, so they differ only by
# the order of the float32 sums: ``_check``'s tolerance (2e-4 of the
# largest |value| + 1e-5), as for the 3-pass form against float32.

def _one_pass_cases(monkeypatch):
    """(name, wrapper, plain, args): GK and GGK in their mma form, Pair
    and the complex matmul, each at a ragged shape."""
    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1)
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    monkeypatch.setattr(gatherk, "gk_form", lambda *a, **k: "mma")
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = []
    gk = gatherk.plan_gk_step(*GK_FORM_SHAPES["h40_k32"])
    out.append(("gk", gatherk.gk_call, gatherk.gk_plain,
                (gk, *[_rand((4, gk.x_elems), gen) for _ in "ri"],
                 *[_rand((gk.H * gk.K,), gen) for _ in "ri"], True, False)))
    *case, B, bi, bj, _ = GGK_PATH_STEPS["1k_k16_h16_f512"]
    ggk = _gathered(tuple(case), B, bi, bj)
    row = ggk.row
    out.append(("ggk", gatherk.ggk_call, gatherk.ggk_plain,
                (ggk, *[_rand((2, ggk.bi_rows * row.x_elems), gen)
                        for _ in "ri"],
                 *[_rand((ggk.bj_rows * row.H * row.K,), gen)
                   for _ in "ri"], True, False)))
    K, M, N = 100, 130, 136
    pair = lanes.plan_pair_step(("k", "m"), ("k", "n"), ("m", "n"), (K, M),
                                (K, N))
    out.append(("pair", lanes.pair_call, lanes.pair_plain,
                (pair, *[_rand((2, K * M), gen) for _ in "ri"],
                 *[_rand((K * N,), gen) for _ in "ri"], True, False)))
    B, M, K, N = 3, 100, 37, 70
    a = tuple(_rand((B, M, K), gen) for _ in "ri")
    b = tuple(_rand((B, K, N), gen) for _ in "ri")
    out.append(("complex_mm", pallas_mm.complex_batched_matmul,
                pallas_mm.complex_batched_matmul_plain, (a, b)))
    return out


@pytest.mark.parametrize("which", ["gk", "ggk", "pair", "complex_mm"])
def test_one_pass_form_matches_tf32_plain(cuda, monkeypatch, which):
    """Each tensor-core kernel's one-pass form against its plain TF32
    form (counted as a one-pass launch), and further from a float64
    product than the 3-pass form: it is the single TF32 pass."""
    (_, call, plain, args), = [c for c in _one_pass_cases(monkeypatch)
                               if c[0] == which]
    before = call.one_pass
    kr, ki = call(*args, passes=1)
    pr, pi = plain(*args, tf32=True)
    torch.cuda.synchronize()
    assert call.one_pass == before + 1
    err = torch.abs(torch.complex(kr - pr, ki - pi)).max().item()
    scale = torch.abs(torch.complex(pr, pi)).max().item()
    assert err <= 2e-4 * scale + 1e-5, (err, scale)
    r3, i3 = call(*args)
    assert call.one_pass == before + 1
    f64 = [t.double() if isinstance(t, torch.Tensor) and t.is_floating_point()
           else t for t in args]
    if which == "complex_mm":
        f64 = (tuple(t.double() for t in args[0]),
               tuple(t.double() for t in args[1]))
        er, ei = pallas_mm.complex_batched_matmul_plain(*f64)
    else:
        er, ei = plain(*f64)
    e1 = torch.abs(torch.complex(kr.double() - er, ki.double() - ei)).max()
    e3 = torch.abs(torch.complex(r3.double() - er, i3.double() - ei)).max()
    assert e1 > 4 * e3, (e1.item(), e3.item())


@pytest.mark.parametrize("mode,algo,precision", [
    ("split", "naive", "default"), ("split", "naive", "high"),
    ("split", "karatsuba", "highest"), ("complex", "naive", "highest"),
    ("complex", "naive", "default"), ("fused", "naive", "highest")])
def test_field_modes_under_graph_replay(cuda, monkeypatch, mode, algo,
                                        precision):
    """``contraction(mode, algo, precision)`` on the card as graph replay:
    the amplitudes against the state vector (2e-5 of the largest at
    float32 products, 2e-3 where 'default' rounds the dot fallback's and
    the tensor-core kernels' operands to TF32), graph against eager max
    |d| 0; kernel steps launch their kernels in split mode only (the
    one-pass form under 'default' alone), and no port kernel runs on the
    card in the other modes."""
    sim, circ = _small_sim(monkeypatch)
    wrappers = (gatherk.gk_call, gatherk.ggk_call, gatherk.rgrow_call,
                gatherk.rgflat_call, lanes.lane_call, lanes.pair_call)
    before = [f.launches for f in wrappers]
    one = [gatherk.gk_call.one_pass, gatherk.ggk_call.one_pass,
           lanes.pair_call.one_pass]
    ran = _device_kernels(lambda: sim.contraction(
        mode=mode, algo=algo, precision=precision, slice_batch=2,
        device="cuda"))
    amps = sim.contraction(mode=mode, algo=algo, precision=precision,
                           slice_batch=2, device="cuda")
    assert sim.run_stats["executor"] == "graph"
    full = circ.state_vec().reshape(-1)
    want = np.array([full[int(b, 2)] for b in sim.bitstrings_sorted])
    tol = 2e-3 if precision == "default" else 2e-5
    assert np.abs(amps - want).max() <= tol * np.abs(want).max()
    launched = sum(f.launches - b for f, b in zip(wrappers, before))
    if mode == "split":
        assert launched > 0 and sum(ran.values()) > 0
    else:
        assert launched == 0 and sum(ran.values()) == 0
    one_now = [gatherk.gk_call.one_pass, gatherk.ggk_call.one_pass,
               lanes.pair_call.one_pass]
    if precision != "default":
        assert one_now == one


def test_checkpoint_resumes_at_any_width_under_graphs(cuda, monkeypatch,
                                                      tmp_path):
    """A checkpoint written at width 1 after 3 of the 8 slices resumes
    under graph replay at widths 2 and 4 (chunks of the width from slice
    3: the last chunk runs its rest as a narrower group), one capture per
    width used, none per chunk, to the state vector."""
    from artensor_tpu_torch.runtime import executor as ex
    from artensor_tpu_torch.runtime.checkpoint import run_sliced_checkpointed

    sim, circ = _small_sim(monkeypatch)
    field, run_steps, arrays, out_shape, execute, _ = sim._staged(
        torch.device("cuda"))
    k = len(sim.slicing_bonds)
    assert 2 ** k == 8
    full = circ.state_vec().reshape(-1)
    want = np.array([full[int(b, 2)] for b in sim.bitstrings_sorted])

    class Stop(Exception):
        pass

    def stop(done, total):
        raise Stop

    for width in (2, 4):
        path = str(tmp_path / f"acc{width}.npz")
        run1 = ex.make_sliced_runner(execute, run_steps, sim.slicing_axes,
                                     k, out_shape, field)
        with pytest.raises(Stop):
            run_sliced_checkpointed(run1, arrays, k, out_shape, field, path,
                                    chunk=3, progress=stop)
        run = ex.make_sliced_runner(execute, run_steps, sim.slicing_axes, k,
                                    out_shape, field, slice_batch=width)
        acc = run_sliced_checkpointed(run, arrays, k, out_shape, field, path,
                                      chunk=width)
        widths = {w for w, _ in ex.group_widths(5 % width or width, width)}
        widths |= {width}
        assert run.stats["captures"] == len(widths)
        assert run.stats["replays"] == 5 // width + (5 % width > 0)
        got = field.unwrap(acc).reshape(-1)
        assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


# -- the planner's entry points on the card ---------------------------------------

QSIM_N12 = os.path.join(os.path.dirname(__file__), "data",
                        "circuit_n12_rcs.qsim")


def test_native_planner_builds_on_the_card_host():
    """The C++ search builds from the repository's source on the card's
    host, and plans."""
    from artensor_tpu_torch.native import build_error, native_available
    from artensor_tpu_torch.planner import find_order

    assert native_available(), build_error()
    tb = {0: ["a", "b"], 1: ["a", "c"], 2: ["b", "c", "d"], 3: ["d"]}
    order, _, _ = find_order(tb, {b: 2.0 for b in "abcd"}, sc_target=30,
                             trials=2, iters=3, engine="native")
    assert len(order) == 3


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_planned_one_shot_on_card_equals_cpu(cuda, monkeypatch, mode):
    """``quantum_circuit_simulation`` plans the n12 file and runs it on the
    card (size gates lowered: its kernels run) to the CPU run's
    amplitudes and the state vector."""
    from artensor_tpu_torch import TensorNetworkCircuit, \
        quantum_circuit_simulation
    from artensor_tpu_torch.runtime import lanes as planes

    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1 << 8)
    monkeypatch.setattr(planes, "MIN_X_ELEMS", 1 << 6)
    state = TensorNetworkCircuit(QSIM_N12).state_vec().reshape(-1)
    picks = np.random.default_rng(7).choice(4096, 64, replace=False)
    bits = [np.binary_repr(int(p), 12) for p in picks] \
        if mode == "sparse" else ()
    kw = dict(sc_target=10, trial_num=2, iters=6)
    before = gatherk.gk_call.launches
    got, got_bits = quantum_circuit_simulation(QSIM_N12, bits, **kw)
    assert gatherk.gk_call.launches > before
    want, want_bits = quantum_circuit_simulation(QSIM_N12, bits,
                                                 device="cpu", **kw)
    assert list(got_bits) == list(want_bits)
    scale = np.abs(state).max()
    assert np.abs(got - want).max() <= 2e-5 * scale
    if mode == "sparse":
        exact = np.array([state[int(b, 2)] for b in got_bits])
    else:
        exact = state.reshape(got.shape)
    assert np.abs(got - exact).max() <= 2e-5 * scale


def test_planned_block_walk_on_card(cuda):
    """``prepare_output_sharded(3, sc_target=3)`` (3 sliced bonds a block)
    walked on the card, one graph replayed a slice: every block is the
    state vector's."""
    from artensor_tpu_torch import (TensorNetworkCircuit,
                                    TensorNetworkSimulation, random_circuit)

    n, layers = random_circuit(2, 3, 6, seed=33)
    state = TensorNetworkCircuit((n, layers)).state_vec()
    sim = TensorNetworkSimulation.from_circuit((n, layers))
    sim.prepare_output_sharded(3, sc_target=3, trials=2, iters=5,
                               betas=tuple(np.linspace(3, 21, 10)),
                               slicing_repeat=1, parallel=False)
    k = len(sim.slicing_bonds)
    assert k > 0
    blocks = list(sim.contraction_output_blocks(3, device="cuda"))
    assert len(blocks) == 8
    for bits, _, block in blocks:
        want = state[tuple(int(c) for c in bits)]
        assert np.abs(block - want).max() <= 2e-5 * np.abs(state).max()
    st = sim.block_run_stats
    assert st["captures"] == 1 and st["replays"] == 8 * 2 ** k


def _small_qsim(path, seed=2):
    """random_circuit(2, 3, 4, seed) written as a qsim file; its state."""
    from artensor_tpu_torch import TensorNetworkCircuit, random_circuit

    n, layers = random_circuit(2, 3, 4, seed=seed)
    lines = [str(n)]
    for li, layer in enumerate(layers):
        for name, qubits, params in layer:
            lines.append(" ".join(
                [str(li), name, *map(str, qubits), *map(str, params)]))
    path.write_text("\n".join(lines) + "\n")
    return n, TensorNetworkCircuit((n, layers)).state_vec().reshape(-1)


def _cli(argv, capsys):
    from artensor_tpu_torch.__main__ import main

    main(argv)
    return capsys.readouterr()


def test_cli_on_card_equals_state_vec(cuda, tmp_path, capsys):
    """``simulate`` (planned, and from a saved sliced plan), ``bench`` and
    ``verify`` on the card by default: amplitudes equal to ``state_vec``,
    the bench's roofline at most its wall, verify exit 0."""
    qsim = tmp_path / "small.qsim"
    n, psi = _small_qsim(qsim)
    bits = ["000000", "111111", "010101", "101010"]
    plan = ["--trials", "1", "--iters", "3", "--serial"]
    out = _cli(["simulate", str(qsim), "--bitstrings", ",".join(bits),
                *plan], capsys)
    assert "graph at width 1" in out.err
    saved = tmp_path / "plan.json"
    _cli(["plan", str(qsim), "--out", str(saved), "--sc-target", "3",
          "--bitstrings", ",".join(bits), *plan], capsys)
    for argv in (["simulate", str(qsim), "--bitstrings", ",".join(bits)]
                 + plan, ["simulate", str(qsim), "--bitstrings",
                          ",".join(bits), "--plan", str(saved)]):
        got = {}
        for ln in _cli(argv, capsys).out.strip().splitlines():
            bs, re, im = ln.split()
            got[bs] = complex(float(re), float(im))
        assert sorted(got) == sorted(bits)
        for bs, amp in got.items():
            assert abs(amp - psi[int(bs, 2)]) < 1e-6
    dense = _cli(["simulate", str(qsim), "--head", "64", *plan], capsys)
    amps = [complex(float(ln.split()[1]), float(ln.split()[2]))
            for ln in dense.out.strip().splitlines()]
    np.testing.assert_allclose(amps, psi, rtol=0, atol=1e-6)
    import json

    b = json.loads(_cli(["bench", str(qsim), "--plan", str(saved),
                         "--bitstrings", ",".join(bits), "--slice-batch",
                         "2"], capsys).out)
    assert b["slices"] >= 2 and 0 < b["roofline_achieved"] <= 1
    err = _cli(["verify", str(qsim), "--serial"], capsys).err
    stats = json.loads(err.strip().splitlines()[-1])
    assert stats["mps_fidelity_estimate"] > 0.999
    assert stats["max_abs_diff"] <= stats["threshold"]
