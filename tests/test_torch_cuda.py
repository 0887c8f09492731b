"""The CUDA kernels on the card: each wrapper against its plain version on
the same CUDA tensors, at small and ragged shapes, and the executors and
layers above them on small circuits (the full-size n30 paths are
``tests/test_torch_card_paths.py``'s).

Marked ``gpu``: skipped where no card is present, and failed there in a
run that asks for the card tests (``-m gpu``).  On a machine with one
(``--noconftest``: ``tests/conftest.py`` imports JAX, which the port's
machine need not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m gpu
"""

import os

import numpy as np
import pytest
import torch

import card_paths
from artensor_tpu_torch.ops import pallas_mm
from artensor_tpu_torch.runtime import gatherk, lanes

pytestmark = pytest.mark.gpu

DATA = os.path.join(os.path.dirname(__file__), "..", "artensor_tpu_torch",
                    "data")


@pytest.fixture
def cuda(request):
    card_paths.require_card(request.config)
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
    """Each GK form (the mma form on wgmma) against the plain version at
    width 1 (neither operand batched) and 4, with x and w batched and
    not."""
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
    or X starting one float into its allocation; the mma form stays the
    mma form (the wgmma core's 4-byte copies)."""
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
    before = gatherk.gk_call.forms[form]
    _check(gatherk.gk_call, gatherk.gk_plain, (plan, *x, *w, True, False))
    assert gatherk.gk_call.forms[form] == before + 1


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


@pytest.mark.parametrize("batched", BATCHINGS)
@pytest.mark.parametrize("step", sorted(GGK_PATH_STEPS))
def test_ggk_one_pass_at_path_shapes(cuda, monkeypatch, step, batched):
    """GGK's mma form (on wgmma) in one TF32 pass at each path step's
    shape, against the plain version's TF32 form, counted as a one-pass
    launch; the F 64 steps are refused by the mma form in one pass too."""
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    *case, B, bi, bj, forms = GGK_PATH_STEPS[step]
    plan = _gathered(tuple(case), B, bi, bj)
    monkeypatch.setattr(gatherk, "gk_form", lambda *a, **k: "mma")
    xb, wb = batched
    row = plan.row
    gen = torch.Generator(device="cuda").manual_seed(B)
    W = 3 if (xb or wb) else 1
    x = [_rand(((W,) if xb else ()) + (plan.bi_rows * row.x_elems,), gen)
         for _ in "ri"]
    w = [_rand(((W,) if wb else ()) + (plan.bj_rows * row.H * row.K,), gen)
         for _ in "ri"]
    args = (plan, *x, *w, xb, wb)
    if "mma" not in forms:
        with pytest.raises(RuntimeError, match="ggk"):
            gatherk.ggk_call(*args, passes=1)
        return
    before = gatherk.ggk_call.one_pass
    kr, ki = gatherk.ggk_call(*args, passes=1)
    pr, pi = gatherk.ggk_plain(*args, tf32=True)
    torch.cuda.synchronize()
    assert gatherk.ggk_call.one_pass == before + 1
    err = torch.abs(torch.complex(kr - pr, ki - pi)).max().item()
    scale = torch.abs(torch.complex(pr, pi)).max().item()
    assert err <= 2e-4 * scale + 1e-5, (err, scale)


# (K, H, F) of a GGK row (k, f) x (k, h): each tile shape of GGK's wgmma
# form (N tile 16 with K chunks of 16 and of 32, N tiles 32 and 64), f runs
# of 128 (W's rows change at every M tile) and 512 (at every fourth), a
# ragged K chunk and N tile (K 24, H 40), and K 6 (W's rows off the
# 4-float grid: its 4-byte copies)
GGK_WGMMA_SHAPES = [(16, 16, 128), (16, 16, 512), (32, 16, 128),
                    (32, 32, 512), (64, 64, 128), (24, 40, 128),
                    (6, 12, 128)]


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("batched", [(True, True), (False, True)])
@pytest.mark.parametrize("shape", GGK_WGMMA_SHAPES, ids=str)
def test_ggk_wgmma_tiles(cuda, monkeypatch, shape, batched, passes):
    """GGK's mma form at every tile shape it instantiates, against the
    plain version (its TF32 form for one pass); the kernel counts its
    launches in ``gatherk_runs``' GGK "mma" slot."""
    from artensor_tpu_torch.kernels import device_runs

    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    K, H, F = shape
    plan = _gathered((("k", "f"), ("k", "h"), ("h", "f"), (K, F), (K, H)),
                     90, 30, 11, seed=K + H)
    row = plan.row
    assert isinstance(row, gatherk.GKPlan) and (row.K, row.H, row.F) == shape
    monkeypatch.setattr(gatherk, "gk_form", lambda *a, **k: "mma")
    xb, wb = batched
    gen = torch.Generator(device="cuda").manual_seed(F + K)
    W = 3
    x = [_rand(((W,) if xb else ()) + (plan.bi_rows * row.x_elems,), gen)
         for _ in "ri"]
    w = [_rand(((W,) if wb else ()) + (plan.bj_rows * H * K,), gen)
         for _ in "ri"]
    args = (plan, *x, *w, xb, wb)
    before = device_runs()[("ggk", "mma")]
    kr, ki = gatherk.ggk_call(*args, passes=passes)
    pr, pi = gatherk.ggk_plain(*args, tf32=passes == 1)
    assert device_runs()[("ggk", "mma")] == before + 1
    err = torch.abs(torch.complex(kr - pr, ki - pi)).max().item()
    scale = torch.abs(torch.complex(pr, pi)).max().item()
    assert err <= 2e-4 * scale + 1e-5, (err, scale)


@pytest.mark.parametrize("operand", ["x", "w"])
def test_ggk_wgmma_unaligned_pointers(cuda, monkeypatch, operand):
    """GGK's mma form with X or W one float into its allocation (the
    core's 4-byte copies of that operand) at the 1k K 16 H 16 step's
    shape."""
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
    *case, B, bi, bj, _ = GGK_PATH_STEPS["1k_k16_h16_f512"]
    plan = _gathered(tuple(case), 60, 20, 8)
    row = plan.row
    monkeypatch.setattr(gatherk, "gk_form", lambda *a, **k: "mma")
    gen = torch.Generator(device="cuda").manual_seed(13)
    W = 2
    shift = lambda n, o: _rand((n + o,), gen)[o:]
    nx, nw = plan.bi_rows * row.x_elems, plan.bj_rows * row.H * row.K
    ox, ow = (1, 0) if operand == "x" else (0, 1)
    x = [shift(W * nx, ox).reshape(W, nx) for _ in "ri"]
    w = [shift(W * nw, ow).reshape(W, nw) for _ in "ri"]
    assert (x[0].data_ptr() % 16 != 0) == (operand == "x")
    assert (w[0].data_ptr() % 16 != 0) == (operand == "w")
    _check(gatherk.ggk_call, gatherk.ggk_plain, (plan, *x, *w, True, True))


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


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("bmkn", [(3, 130, 36, 68)])
def test_complex_matmul_wgmma_shapes(cuda, bmkn, passes):
    """The complex matmul on the wgmma core at a shape of ragged M and N
    tiles with K and N on the 4-float grid, against the plain version (its
    TF32 form for one pass); the kernel counts its launches in
    ``pair_runs``' second slot.  ``card_paths.CMM_SHAPES`` are
    ``tests/test_torch_card_paths.py``'s."""
    from artensor_tpu_torch.kernels import device_runs

    B, M, K, N = bmkn
    gen = torch.Generator(device="cuda").manual_seed(M + passes)
    a = tuple(_rand((B, M, K), gen) for _ in "ri")
    b = tuple(_rand((B, K, N), gen) for _ in "ri")
    before = device_runs()[("complex_mm", None)]
    kr, ki = pallas_mm.complex_batched_matmul(a, b, passes=passes)
    pr, pi = pallas_mm.complex_batched_matmul_plain(a, b, tf32=passes == 1)
    assert device_runs()[("complex_mm", None)] == before + 1
    err = torch.abs(torch.complex(kr - pr, ki - pi)).max().item()
    scale = torch.abs(torch.complex(pr, pi)).max().item()
    assert err <= 2e-4 * scale + 1e-5, (err, scale)


@pytest.mark.parametrize("operand", ["a", "b", "y"])
def test_complex_matmul_unaligned_pointers(cuda, monkeypatch, operand):
    """The complex matmul with A or B one float into its allocation, or
    the output so (the wrapper's ``torch.empty`` made to hand out such a
    buffer): the core's 4-byte copies and 4-byte stores."""
    B, M, K, N = 2, 192, 40, 136
    gen = torch.Generator(device="cuda").manual_seed(17)
    shifted = lambda shape, on: (
        _rand((int(np.prod(shape)) + 1,), gen)[1:].reshape(shape) if on
        else _rand(shape, gen))
    a = tuple(shifted((B, M, K), operand == "a") for _ in "ri")
    b = tuple(shifted((B, K, N), operand == "b") for _ in "ri")
    if operand == "y":
        empty = torch.empty
        monkeypatch.setattr(torch, "empty", lambda shape, **kw: empty(
            (int(np.prod(shape)) + 1,), **kw)[1:].reshape(shape))
    kr, ki = pallas_mm.complex_batched_matmul(a, b)
    monkeypatch.undo()
    assert (kr.data_ptr() % 16 != 0) == (operand == "y")
    pr, pi = pallas_mm.complex_batched_matmul_plain(a, b)
    torch.cuda.synchronize()
    err = torch.abs(torch.complex(kr - pr, ki - pi)).max().item()
    scale = torch.abs(torch.complex(pr, pi)).max().item()
    assert err <= 2e-4 * scale + 1e-5, (err, scale)


@pytest.mark.parametrize("which", ["ggk", "complex_mm"])
def test_wgmma_float64_error_at_most_plain(cuda, monkeypatch, which):
    """GGK's mma form at the 1k path's K 16 H 16 F 512 step (W batched,
    width 2) and the complex matmul at B 4 M 512 K 256 N 512: each one's
    largest error against a float64 product of the same inputs is at
    most the plain version's (float32 on cuBLAS)."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    if which == "ggk":
        monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1)
        monkeypatch.setattr(gatherk, "gk_form", lambda *a, **k: "mma")
        *case, B, bi, bj, _ = GGK_PATH_STEPS["1k_k16_h16_f512"]
        plan = _gathered(tuple(case), B, bi, bj)
        row = plan.row
        x = [_rand((plan.bi_rows * row.x_elems,), gen) for _ in "ri"]
        w = [_rand((2, plan.bj_rows * row.H * row.K), gen) for _ in "ri"]
        args = (plan, *x, *w, False, True)
        call, plain = gatherk.ggk_call, gatherk.ggk_plain
        f64 = (plan, *[t.double() for t in x + w], False, True)
    else:
        a = tuple(_rand((4, 512, 256), gen) for _ in "ri")
        b = tuple(_rand((4, 256, 512), gen) for _ in "ri")
        args = (a, b)
        call = pallas_mm.complex_batched_matmul
        plain = pallas_mm.complex_batched_matmul_plain
        f64 = (tuple(t.double() for t in a), tuple(t.double() for t in b))
    kr, ki = call(*args)
    pr, pi = plain(*args)
    er, ei = plain(*f64)
    ref = torch.complex(er, ei)
    d = lambda r, i: torch.abs(torch.complex(r.double(), i.double())
                               - ref).max().item()
    assert d(kr, ki) <= d(pr, pi), (d(kr, ki), d(pr, pi))


# the dot fallback's product classes on the benchmark cells' paths, M (or N,
# or B) scaled down: (B, M, K, N)
ROUTED_CLASSES = {
    "k8": (1, 1 << 16, 8, 8), "k16": (1, 1 << 15, 16, 16),
    "k32": (1, 1 << 14, 32, 32), "k64": (1, 1 << 13, 64, 64),
    "k128": (1, 1 << 12, 128, 128), "k256_wide": (1, 2048, 256, 4096),
    "swap_m64": (1, 64, 64, 1 << 14), "swap_m32": (1, 32, 32, 1 << 14),
    "b494_k8": (494, 1024, 8, 8), "n2": (8, 4096, 32, 2),
    "k1": (1, 4096, 1, 16), "tiny": (32, 8, 2, 4),
}


@pytest.mark.parametrize("cls", sorted(ROUTED_CLASSES))
def test_complex_matmul_routed_classes(cuda, cls):
    """The complex matmul at the dot fallback's product classes (at the
    tile ``cmm_tile`` picks: narrow N tiles, the 16-deep K chunk, the role
    swap, the three-term split below K 16) against
    the plain float32 product; from K ``ROUTE_MIN_K`` on, the classes the
    route may send to the kernel, its largest error against a float64
    product of the same inputs is at most twice the plain product's
    (float32 on cuBLAS), and below it the route keeps cuBLAS."""
    B, M, K, N = ROUTED_CLASSES[cls]
    gen = torch.Generator(device="cuda").manual_seed(B + M + K + N)
    a = tuple(_rand((B, M, K), gen) for _ in "ri")
    b = tuple(_rand((B, K, N), gen) for _ in "ri")
    kr, ki = pallas_mm.complex_batched_matmul(a, b)
    pr, pi = pallas_mm.complex_batched_matmul_plain(a, b)
    err = torch.abs(torch.complex(kr - pr, ki - pi)).max().item()
    scale = torch.abs(torch.complex(pr, pi)).max().item()
    assert err <= 2e-4 * scale + 1e-5, (err, scale)
    if K < pallas_mm.ROUTE_MIN_K:
        assert not pallas_mm.cmm_route(B, M, K, N, "cuda", "highest",
                                       "naive", "f32")
    else:
        er, ei = pallas_mm.complex_batched_matmul_plain(
            tuple(t.double() for t in a), tuple(t.double() for t in b))
        ref = torch.complex(er, ei)
        d = lambda r, i: torch.abs(torch.complex(r.double(), i.double())
                                   - ref).max().item()
        assert d(kr, ki) <= 2 * d(pr, pi), (d(kr, ki), d(pr, pi))


@pytest.mark.parametrize("shared", ["a", "b"])
@pytest.mark.parametrize("bmkn", [(6, 256, 32, 64), (6, 64, 8, 512)])
def test_complex_matmul_reads_a_shared_operand_in_place(cuda, shared, bmkn):
    """An operand that is the same for every batch entry, an expanded view
    of one matrix (batch stride 0), is read in place by every entry (the
    plain and the swapped tile): the product equals the one of the
    operand copied out to every entry."""
    B, M, K, N = bmkn
    gen = torch.Generator(device="cuda").manual_seed(M + N)
    one = lambda shape, on: _rand(((1,) if on else (B,)) + shape, gen) \
        .expand((B,) + shape)
    a = tuple(one((M, K), shared == "a") for _ in "ri")
    b = tuple(one((K, N), shared == "b") for _ in "ri")
    kr, ki = pallas_mm.complex_batched_matmul(a, b)
    cr, ci = pallas_mm.complex_batched_matmul(
        tuple(t.contiguous() for t in a), tuple(t.contiguous() for t in b))
    assert torch.equal(kr, cr) and torch.equal(ki, ci)


@pytest.mark.parametrize("mode,algo,precision,routed", [
    ("split", "naive", "highest", True), ("split", "naive", "high", True),
    ("split", "karatsuba", "highest", False),
    ("split", "naive", "default", False),
    ("complex", "naive", "highest", False),
    ("fused", "naive", "highest", False)])
def test_dot_products_run_on_the_complex_matmul(cuda, monkeypatch, mode,
                                                 algo, precision, routed):
    """Under graph replay a split, naive, 3xTF32 ``contraction`` runs each
    dot-fallback product that ``cmm_route`` sends to the kernel as one
    complex matmul launch: the card runs the kernel once a routed product
    in the warm-up group and in each replay (the ``dot.cmm`` products
    made, launched or recorded in a capture, over the warm-up groups and
    captures); karatsuba, 'default', the complex and the fused field run
    none and make no routed product, and neither does a split product
    stored in bf16.  The small circuit's products are launch-bound, so the
    route's size gates are lowered, as ``_small_sim`` lowers the
    kernels'."""
    from artensor_tpu_torch.ops.field import SplitField
    from artensor_tpu_torch.runtime import tracing

    monkeypatch.setattr(pallas_mm, "ROUTE_MIN_K", 1)
    monkeypatch.setattr(pallas_mm, "LAUNCH_S", 0.0)
    sim, circ = _small_sim(monkeypatch)
    made = tracing.counters().get("dot.cmm", 0)
    ran = _device_kernels(lambda: sim.contraction(
        mode=mode, algo=algo, precision=precision, slice_batch=2,
        device="cuda"))
    made = tracing.counters().get("dot.cmm", 0) - made
    st = sim.run_stats
    assert st["executor"] == "graph"
    n = ran.get(("complex_mm", None), 0)
    if routed:
        per, rest = divmod(made, st["warmup_groups"] + st["captures"])
        assert per > 0 and rest == 0, (made, st)
        assert n == per * (st["warmup_groups"] + st["replays"]), (n, per, st)
    else:
        assert made == 0 and n == 0, (made, n)
    gen = torch.Generator(device="cuda").manual_seed(5)
    a = tuple(_rand((2, 64, 32), gen).bfloat16() for _ in "ri")
    b = tuple(_rand((2, 32, 64), gen).bfloat16() for _ in "ri")
    narrow = SplitField(precision=precision, algo=algo, storage="bf16")
    before = tracing.counters().get("dot.cmm", 0)
    ran = _device_kernels(lambda: narrow.matmul(a, b))
    assert tracing.counters().get("dot.cmm", 0) == before and not ran


@pytest.mark.parametrize("name", sorted(card_paths.PATHS))
def test_n30_default_scheme_as_on_the_cpu(cuda, name):
    """The default form compiled on the card's host makes the scheme that
    the CPU compile recorded (``scripts/default_schemes_torch_port.py``):
    its census, digest, width and kernel steps there."""
    import json
    from collections import Counter

    from artensor_tpu_torch.runtime.sparse import kernel_kind, scheme_digest

    path = card_paths.compile_default_path(name)
    with open(card_paths.DEFAULT_RECORD) as f:
        want = json.load(f)[name]
    steps = path["sim"].steps
    census = Counter(kernel_kind(s) or "dot" for s in steps)
    assert dict(census) == want["census"]
    assert scheme_digest(steps) == want["digest"]
    assert card_paths.step_cases(path) == (want["width"],
                                           want["kernel_steps"])


DENSE_PLAN = os.path.join(DATA, "rcs_n30_m14_s0_dense_sc30.json")


@pytest.fixture(scope="module")
def dense_gk_steps(request):
    """The GK steps of the n30 dense path with their operands' width axes:
    ``whole``, the whole-state default scheme (unbatched, X up to 2^30
    elements); ``block``, the scheme of one of the 64 output blocks of
    ``contraction_output_blocks(6)`` (width 1 on the operands that carry
    a sliced open leg)."""
    card_paths.require_card(request.config)
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


@pytest.mark.parametrize("devices", [("cuda:0", "cuda:0"),
                                     ("cuda:0", "cuda:1")],
                         ids=["one-card-twice", "two-cards"])
def test_mesh_on_the_card_equals_the_cpu(cuda, monkeypatch, devices):
    """A mesh of two replicas on the card (one card named twice, the
    stand-in for two; or two cards, which needs them): ``contraction(
    mesh=...)`` with each replica's graphs captured, then replayed in a
    thread of its own, the segmented run over the mesh, and the dense
    state through ``contraction_output_sharded``, each equal to the CPU's
    run."""
    from artensor_tpu_torch import parallel, simulation

    if torch.cuda.device_count() < len(set(devices)):
        pytest.skip(f"needs {len(set(devices))} CUDA cards; this machine "
                    f"has {torch.cuda.device_count()}")
    mesh = parallel.make_mesh(devices=devices)
    sim, _ = _small_sim(monkeypatch)
    want = sim.contraction(device="cpu")
    scale = np.abs(want).max()
    got = sim.contraction(mesh=mesh, slice_batch=2)
    st = sim.run_stats
    assert st["executor"] == "mesh" and st["graphs"]
    assert [r["device"] for r in st["replicas"]] == list(devices)
    assert all(r["captures"] == 1 and r["replays"] >= 1
               for r in st["replicas"])
    assert np.abs(got - want).max() <= 2e-5 * scale
    monkeypatch.setattr(simulation, "SEGMENT_AUTO_THRESHOLD", 2)
    got = sim.contraction(mesh=mesh, slice_batch=2)
    assert sim.run_stats["executor"] == "segmented-sharded"
    assert np.abs(got - want).max() <= 2e-5 * scale
    dense, circ = _small_sim(monkeypatch, bits=False)
    state = dense.contraction_output_sharded(mesh, d_out=2)
    assert [r["device"] for r in parallel.LAST_RUN["replicas"]] == \
        list(devices)
    exact = circ.state_vec()
    assert np.abs(state - exact).max() <= 2e-5 * np.abs(exact).max()


GLOO_WORKER = """
import os, sys
import numpy as np
sys.path.insert(0, {repo!r})
from artensor_tpu_torch import (TensorNetworkCircuit,
                                TensorNetworkSimulation, random_circuit)
from artensor_tpu_torch.parallel import distributed as dist
from artensor_tpu_torch.runtime import gatherk, lanes, sparse

gatherk.MIN_X_ELEMS = gatherk.GGK_MIN_WORK = 1 << 8
lanes.MIN_X_ELEMS = sparse.RETAIL_MIN_ELEMS = 1 << 6
assert dist.initialize(backend="gloo")
mesh = dist.global_mesh()
rng = np.random.default_rng(4)
bits = [np.binary_repr(b, 15)
        for b in rng.choice(2 ** 15, 128, replace=False)]
sim = TensorNetworkSimulation.from_circuit(
    TensorNetworkCircuit(random_circuit(3, 5, 8, seed=13)), bits)
sim.load_plan({plan!r})
amps = sim.contraction(mesh=mesh, slice_batch=2)
assert sim.run_stats["graphs"], sim.run_stats
np.save(os.environ["OUT"] + "." + os.environ["ARTENSOR_PROC_ID"] + ".npy",
        amps)
"""


def test_gloo_two_ranks_on_one_card(cuda, monkeypatch, tmp_path):
    """Two processes joined with gloo (NCCL refuses two ranks on one
    device), each on ``cuda:{rank % count}``, sum their shares of the
    small sparse run on the card through ``contraction(mesh=
    global_mesh())``; every rank's amplitudes equal the CPU run."""
    import socket
    import subprocess
    import sys

    sim, _ = _small_sim(monkeypatch)
    want = sim.contraction(device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = GLOO_WORKER.format(repo=repo, plan=RGF_PLAN)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, ARTENSOR_COORDINATOR=f"127.0.0.1:{port}",
                 ARTENSOR_NUM_PROCS="2", ARTENSOR_PROC_ID=str(r),
                 OUT=str(tmp_path / "amps")))
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    for r in range(2):
        got = np.load(tmp_path / f"amps.{r}.npy")
        assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


# -- the wgmma core (csrc/wgmma_core.cuh): Pair and GK's mma form -----------

def _pair_plan(K, M, N):
    plan = lanes.plan_pair_step(("k", "m"), ("k", "n"), ("m", "n"),
                                (K, M), (K, N))
    assert plan is not None, lanes.LAST_REJECT
    return plan


def _pair_args(plan, xb, vb, W, seed, x_shift=0):
    """Pair operands; ``x_shift`` starts X that many floats into its
    allocation."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    K, M, N = plan.K, plan.M, plan.N
    n = (W if xb else 1) * K * M
    x = [_rand((n + x_shift,), gen)[x_shift:].reshape(
        ((W,) if xb else ()) + (K * M,)) for _ in "ri"]
    v = [_rand(((W,) if vb else ()) + (K * N,), gen) for _ in "ri"]
    return (plan, *x, *v, xb, vb)


def _counted(call, form, args, **kw):
    """``call(*args, **kw)``, held to one launch (of ``form``, for a
    wrapper that counts by form) and to one run of its kernel on the card
    (the kernels' own counters)."""
    before = call.launches, dict(getattr(call, "forms", {}))
    out = {}
    ran = _device_kernels(lambda: out.update(y=call(*args, **kw)))
    kind = "pair" if call is lanes.pair_call else "gk"
    assert ran == {(kind, form): 1}, ran
    assert call.launches == before[0] + 1
    after = getattr(call, "forms", {})
    assert {f: after[f] - before[1][f] for f in after} == \
        {f: int(f == form) for f in after}, (form, before, after)
    return out["y"]


@pytest.mark.parametrize("batched", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("kmn", [(37, 532, 468), (100, 260, 196),
                                 (17, 1028, 1100), (1000, 388, 644)])
def test_pair_wgmma_ragged(cuda, kmn, batched):
    """Pair on the wgmma core at M, N multiples of 4 but of neither 64 nor
    128 and K of no multiple of 8, at width 1 and 4, batched and
    slice-invariant operands."""
    plan = _pair_plan(*kmn)
    xb, vb = batched
    args = _pair_args(plan, xb, vb, 4 if (xb or vb) else 1, sum(kmn))
    _counted(lanes.pair_call, None, args)
    _check(lanes.pair_call, lanes.pair_plain, args)


@pytest.mark.parametrize("case", ["m_130", "n_250", "x_pointer"])
def test_pair_wgmma_unaligned(cuda, case):
    """M or N off the 4-float grid, or X one float into its allocation:
    the wgmma core's 4-byte copies, against the plain version."""
    kmn = {"m_130": (200, 130, 128), "n_250": (200, 128, 250),
           "x_pointer": (200, 128, 128)}[case]
    plan = _pair_plan(*kmn)
    args = _pair_args(plan, True, False, 2, 3,
                      x_shift=1 if case == "x_pointer" else 0)
    assert (args[1].data_ptr() % 16 != 0) == (case == "x_pointer")
    _counted(lanes.pair_call, None, args)
    _check(lanes.pair_call, lanes.pair_plain, args)


@pytest.mark.parametrize("kmn,W", [((1024, 4096, 4096), 1),
                                   ((512, 32768, 256), 2)])
def test_pair_wgmma_path_shapes(cuda, kmn, W):
    """The 1k path's Pair step (K 1024 M 4096 N 4096) and the 10k path's
    (K 512 M 32768 N 256) on wgmma, against the plain version, and no
    further from a float64 product than 4x the plain version."""
    plan = _pair_plan(*kmn)
    args = _pair_args(plan, W > 1, False, W, 17)
    kr, ki = _counted(lanes.pair_call, None, args)
    pr, pi = lanes.pair_plain(*args)
    err = torch.abs(torch.complex(kr - pr, ki - pi)).max().item()
    scale = torch.abs(torch.complex(pr, pi)).max().item()
    assert err <= 2e-4 * scale + 1e-5, (err, scale)
    # the first slice instance (X carries the width axis, V not)
    one = lambda t: t[0] if W > 1 else t
    _, xr, xi, vr, vi, _, _ = args
    er, ei = lanes.pair_plain(plan, one(xr).double(), one(xi).double(),
                              vr.double(), vi.double(), False, False)
    d = lambda r, i: torch.abs(torch.complex(one(r).double() - er,
                                             one(i).double() - ei)).max()
    assert d(kr, ki) <= 4 * d(pr, pi), (d(kr, ki).item(), d(pr, pi).item())


# GK steps at each H the paths have (32 .. 512) and F 64 and 32768
GK_WGMMA_SHAPES = [(g, k, f, h) for h in (32, 64, 128, 256, 512)
                   for g, k, f in ((48, 64 if h < 512 else 32, 64),
                                   (2, 32, 32768))] + \
    [(5, 36, 96, 40), (3, 16, 128, 128), (4, 128, 512, 128),
     (3, 34, 64, 64)]   # K 34: W's rows take the 4-byte copies


@pytest.mark.parametrize("batched", [(True, False), (False, True)])
@pytest.mark.parametrize("gkfh", GK_WGMMA_SHAPES)
def test_gk_wgmma_shapes(cuda, monkeypatch, gkfh, batched):
    """GK's mma form on the wgmma core at H 32, 64, 128, 256, 512, f runs
    of 64 and 32768, ragged M (G*F), N (H) and K tiles, batched X or W."""
    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1)
    g, k, f, h = gkfh
    plan = gatherk.plan_gk_step(("g1", "c1", "f1"), ("c1", "n1"),
                                ("g1", "n1", "f1"), (g, k, f), (k, h))
    assert plan is not None, gatherk.LAST_REJECT
    monkeypatch.setattr(gatherk, "gk_form", lambda *a, **kw: "mma")
    xb, wb = batched
    gen = torch.Generator(device="cuda").manual_seed(h + f)
    W = 2
    x = [_rand(((W,) if xb else ()) + (plan.x_elems,), gen) for _ in "ri"]
    w = [_rand(((W,) if wb else ()) + (plan.H * plan.K,), gen) for _ in "ri"]
    args = (plan, *x, *w, xb, wb)
    _counted(gatherk.gk_call, "mma", args)
    _check(gatherk.gk_call, gatherk.gk_plain, args)


def _wgmma_cases(monkeypatch):
    """(name, wrapper, plain, args): Pair and GK at ragged shapes that the
    wgmma core takes."""
    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1)
    monkeypatch.setattr(gatherk, "gk_form", lambda *a, **k: "mma")
    pair = _pair_args(_pair_plan(100, 260, 196), True, False, 3, 23)
    gk = gatherk.plan_gk_step(*GK_FORM_SHAPES["h40_k32"])
    gen = torch.Generator(device="cuda").manual_seed(29)
    gk_args = (gk, *[_rand((3, gk.x_elems), gen) for _ in "ri"],
               *[_rand((gk.H * gk.K,), gen) for _ in "ri"], True, False)
    return {"pair": (lanes.pair_call, lanes.pair_plain, pair),
            "gk": (gatherk.gk_call, gatherk.gk_plain, gk_args)}


@pytest.mark.parametrize("which", ["pair", "gk"])
def test_wgmma_one_pass_matches_tf32_plain(cuda, monkeypatch, which):
    """The wgmma core's one-pass TF32 form against the plain TF32 form
    (operands rounded as the kernel rounds them, products in float32)."""
    call, plain, args = _wgmma_cases(monkeypatch)[which]
    form = None if which == "pair" else "mma"
    kr, ki = _counted(call, form, args, passes=1)
    pr, pi = plain(*args, tf32=True)
    err = torch.abs(torch.complex(kr - pr, ki - pi)).max().item()
    scale = torch.abs(torch.complex(pr, pi)).max().item()
    assert err <= 2e-4 * scale + 1e-5, (err, scale)


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("which", ["pair", "gk"])
def test_wgmma_graph_replay_equals_eager(cuda, monkeypatch, which, passes):
    """Each wgmma kernel captured in a CUDA graph and replayed gives the
    eager call's result exactly (max|d| 0), before and after new values
    are copied into the same inputs; the replay runs the wgmma kernel on
    the card (its own counter)."""
    from artensor_tpu_torch.runtime.executor import GroupGraphs

    call, _, args = _wgmma_cases(monkeypatch)[which]
    form = None if which == "pair" else "mma"
    want = [c.clone() for c in call(*args, passes=passes)]
    graphs = GroupGraphs(torch.device("cuda"))
    out = {}
    graphs.capture(lambda: out.update(y=call(*args, passes=passes)))
    gen = torch.Generator(device="cuda").manual_seed(31)
    for _ in range(2):
        ran = _device_kernels(graphs.replay)
        assert ran == {(which, form): 1}, ran
        for g, w in zip(out["y"], want):
            assert torch.equal(g, w), (g - w).abs().max().item()
        for t in _tensors(args):
            if t.dtype == torch.float32:
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
        want = [c.clone() for c in call(*args, passes=passes)]


# -- the permute-copy kernel (csrc/permute.cu) -------------------------------

PERMUTE_DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64,
                  torch.complex64, torch.complex128]
PERMUTE_CASES = {       # (logical dims, permutation)
    "transpose": ((1000, 768), (1, 0)),
    "shared-run": ((64, 8, 48), (1, 0, 2)),
    "short-run": ((9, 40, 3), (1, 0, 2)),
    "twos": ((2,) * 14, (13, 0, 12, 1, 11, 2, 10, 3, 9, 4, 8, 5, 7, 6)),
    "width": ((32,) + (2,) * 11, (0, 1, 3, 5, 7, 9, 11, 2, 4, 6, 8, 10)),
    "odd": ((5, 7, 11, 3), (2, 0, 3, 1)),
    "copy": ((3, 1 << 16), (0, 1)),
}


def _bits(t):
    """``t``'s bits, for comparisons that NaNs and signed zeros pass."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("case", sorted(PERMUTE_CASES))
@pytest.mark.parametrize("dtype", PERMUTE_DTYPES, ids=str)
def test_permute_kernel_bit_for_bit(cuda, dtype, case):
    """Every element size: the kernel's copy of a permuted view (from an
    unaligned start too) is ``.contiguous()``'s, bit for bit, and a pair
    of one layout is one launch."""
    from artensor_tpu_torch.ops import permute

    dims, perm = PERMUTE_CASES[case]
    n = int(np.prod(dims))
    gen = torch.Generator(device="cuda").manual_seed(5)
    raw = torch.randint(-2 ** 15, 2 ** 15, (2, (n + 1) * 8), generator=gen,
                        dtype=torch.int16, device="cuda")
    for start in (0, 1):
        base = raw.view(torch.uint8).view(dtype)
        xs = tuple(b[start:start + n].view(dims).permute(*perm)
                   for b in base)
        before = permute.permute_copy.launches
        got = permute.contiguous(xs)
        assert permute.permute_copy.launches == before + (
            0 if xs[0].is_contiguous() else 1)
        for g, x in zip(got, xs):
            assert g.is_contiguous() and g.shape == x.shape
            assert torch.equal(_bits(g), _bits(x.contiguous()))


def test_permute_kernel_above_2_31_bytes(cuda):
    """A component of 2^30 float32 (4 GiB), its odd and even axes parted
    as in dense-state step 30's reorder (at PyTorch's 25 dims), bit for
    bit."""
    from artensor_tpu_torch.ops import permute

    x = torch.arange(1 << 30, dtype=torch.int32, device="cuda").view(
        torch.float32)
    perm = (0,) + tuple(range(1, 25, 2)) + tuple(range(2, 25, 2))
    v = x.view((64,) + (2,) * 24).permute(*perm)
    (got,) = permute.contiguous((v,))
    want = v.contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_permute_kernel_in_a_captured_graph(cuda):
    """A split pair's regroup captured in a CUDA graph: the capture
    launches nothing, each replay runs the kernel once (its own counter,
    by mode) and copies the inputs' current values."""
    from artensor_tpu_torch.ops import permute
    from artensor_tpu_torch.runtime.executor import GroupGraphs

    gen = torch.Generator(device="cuda").manual_seed(9)
    xs = tuple(torch.randn(32 * 2 ** 11, generator=gen, device="cuda")
               for _ in range(2))
    dims = (32,) + (2,) * 11
    perm = (0, 1, 3, 5, 7, 9, 11, 2, 4, 6, 8, 10)
    want = lambda: [x.view(dims).permute(*perm).reshape(32, -1)
                    for x in xs]
    out = {}
    graphs = GroupGraphs(torch.device("cuda"))
    before = permute.permute_copy.launches
    graphs.capture(lambda: out.update(
        y=permute.regroup(xs, dims, perm, (32, -1))))
    assert permute.permute_copy.launches == before
    for _ in range(2):
        runs = permute.permute_runs()
        graphs.replay()
        after = permute.permute_runs()
        assert (after["tile"] - runs["tile"], after["row"] - runs["row"]) \
            == (1, 0)
        for g, w in zip(out["y"], want()):
            assert torch.equal(g, w)
        for x in xs:
            x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))


def test_permute_kernel_counts_each_mode(cuda):
    """The kernel counts its launches by mode on the card, the wrapper
    and the host counters by launch and by bytes."""
    from artensor_tpu_torch.ops import permute
    from artensor_tpu_torch.runtime import tracing

    x = torch.randn(64, 8, 64, device="cuda")
    views = {"row": x.permute(1, 0, 2), "tile": x.permute(2, 0, 1)}
    for mode, v in views.items():
        runs, host = permute.permute_runs(), tracing.counters()
        before = permute.permute_copy.launches
        permute.contiguous((v,))
        after, now = permute.permute_runs(), tracing.counters()
        assert {m: after[m] - runs[m] for m in runs} == {
            m: int(m == mode) for m in runs}
        assert permute.permute_copy.launches == before + 1
        assert now[f"permute.{mode}"] == host.get(f"permute.{mode}", 0) + 1
        assert now["permute.bytes"] - host.get("permute.bytes", 0) == \
            2 * x.numel() * 4


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_permute_kernel_concat(cuda, axis):
    """A split pair's concat along each axis: each part (one permuted, one
    contiguous, one of another length) copied into its slice of the
    outputs by the kernel, one launch a part, ``torch.cat``'s bits."""
    from artensor_tpu_torch.ops import permute

    gen = torch.Generator(device="cuda").manual_seed(13)
    shape = [16, 24, 40]
    parts = []
    for k, n in enumerate((8, 16, 4)):
        s = list(shape)
        s[axis] = n
        raw = [torch.randn(s, generator=gen, device="cuda") for _ in "ri"]
        if k == 0:      # a permuted view of the same shape
            raw = [torch.randn([s[2], s[0], s[1]], generator=gen,
                               device="cuda").permute(1, 2, 0)
                   for _ in "ri"]
        parts.append(tuple(raw))
    before = permute.permute_copy.launches
    got = permute.concat(parts, axis)
    assert permute.permute_copy.launches == before + len(parts)
    for i in range(2):
        assert torch.equal(got[i], torch.cat([p[i] for p in parts], axis))
