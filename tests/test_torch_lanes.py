"""The port's lane module against the JAX package's, with the shapes of
tests/test_lanes.py: the lane planner and the lane scheduler (the same
plans, output orders and reject strings), the lane kernel's plain version
and its address table against JAX's apply_lane_step (Pallas in interpret
mode) and np.einsum at widths 1 and 4, pair steps the same way (widths 1,
4 and 3), and the fused complex batched matmul of ``ops/pallas_mm.py``."""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from artensor_tpu.ops.field import make_field as jax_make_field
from artensor_tpu.runtime import gatherk as jgk
from artensor_tpu.runtime import lanes as jlanes
from artensor_tpu_torch.ops import pallas_mm as pmm
from artensor_tpu_torch.ops.field import SplitField
from artensor_tpu_torch.runtime import gatherk as pgk
from artensor_tpu_torch.runtime import lanes as planes

TOL = dict(rtol=2e-4, atol=1e-4)      # as tests/test_lanes.py's pair check

PAIR_CASES = {
    "both_big_k64": (("a", "b", "c"), ("a", "d", "e"), ("b", "c", "d", "e"),
                     (64, 64, 32), (64, 64, 32)),
    "k_order_mismatch": (("a", "b", "c", "d"), ("b", "a", "e"),
                         ("c", "d", "e"), (8, 16, 64, 32), (16, 8, 256)),
    "scattered_pre_permute": (("m1", "a", "m2", "b"), ("n1", "b", "a", "n2"),
                              ("m1", "m2", "n1", "n2"), (16, 8, 128, 16),
                              (16, 16, 8, 16)),
    "plain_k128": (("k1", "m1"), ("k1", "n1"), ("m1", "n1"),
                   (128, 256), (128, 256)),
}
MODES = {"w1": (0, True), "w4_both": (4, True), "w4_shared_v": (4, False),
         "w3_both": (3, True)}


def _rand(shape, rng):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(PAIR_CASES))
def test_pair_step_matches_jax(name, mode):
    ix_i, ix_j, iy, di, dj = PAIR_CASES[name]
    jplan = jlanes.plan_pair_step(ix_i, ix_j, iy, di, dj)
    pplan = planes.plan_pair_step(ix_i, ix_j, iy, di, dj)
    assert jplan is not None, jlanes.LAST_REJECT
    assert pplan is not None, planes.LAST_REJECT
    assert (pplan.K, pplan.M, pplan.N) == (jplan.K, jplan.M, jplan.N)
    width, v_batched = MODES[mode]
    bi, bj = bool(width), bool(width) and v_batched
    rng = np.random.default_rng(sum(name.encode()) + width)
    xi = _rand(((width,) if bi else ()) + di, rng)
    xj = _rand(((width,) if bj else ()) + dj, rng)

    pf = SplitField()
    wrap = lambda a, b: pf.reshape(pf.wrap(a, "cpu"),
                                   ((a.shape[0],) if b else ()) + (-1,))
    out = planes.apply_pair_step(pf, wrap(xi, bi), wrap(xj, bj), pplan,
                                 bi, bj)
    got = out[0].numpy() + 1j * out[1].numpy()

    jf = jax_make_field(np.complex64, "highest", "split")
    flat = lambda a, b: a.reshape(a.shape[0], -1) if b else a.reshape(-1)
    pair = lambda a: (np.ascontiguousarray(a.real),
                      np.ascontiguousarray(a.imag))
    one = lambda a, b: jlanes.apply_pair_step(jf, a, b, jplan,
                                              interpret=True)
    if width:
        jout = jax.vmap(one, in_axes=((0, 0), (0, 0) if bj else None))(
            pair(flat(xi, bi)), pair(flat(xj, bj)))
    else:
        jout = one(pair(flat(xi, bi)), pair(flat(xj, bj)))
    want_j = np.asarray(jout[0]) + 1j * np.asarray(jout[1])

    lab = {l: k for k, l in enumerate({*ix_i, *ix_j, *iy, "#w"})}
    w = ["#w"] if width else []
    want = np.einsum(xi, [lab[l] for l in (w + list(ix_i))],
                     xj, [lab[l] for l in ((w if bj else []) + list(ix_j))],
                     [lab[l] for l in (w + list(iy))])
    np.testing.assert_allclose(got.reshape(want.shape), want, **TOL)
    np.testing.assert_allclose(got.reshape(want.shape),
                               want_j.reshape(want.shape), **TOL)


def test_k_order_mismatch_uses_row_gather():
    ix_i, ix_j, iy, di, dj = PAIR_CASES["k_order_mismatch"]
    plan = planes.plan_pair_step(ix_i, ix_j, iy, di, dj)
    assert plan.v_perm is not None and plan.re_j is None
    assert sorted(plan.v_perm.tolist()) == list(range(plan.K))
    plan = planes.plan_pair_step(*PAIR_CASES["scattered_pre_permute"])
    assert plan.re_i is not None and plan.re_j is not None
    assert plan.K == 128


def test_pair_rejections():
    assert planes.plan_pair_step(("a", "b"), ("a", "c"), ("b", "c"),
                                 (64, 64), (64, 2)) is None
    assert planes.LAST_REJECT == "pair-small"
    assert planes.plan_pair_step(("a", "b"), ("c", "d"), ("a", "b", "c", "d"),
                                 (128, 128), (128, 128)) is None
    assert planes.LAST_REJECT == "pair-outer"
    # iy interleaves the two operands' rows
    assert planes.plan_pair_step(("k", "b", "c"), ("k", "d", "e"),
                                 ("b", "d", "c", "e"), (64, 64, 32),
                                 (64, 64, 32)) is None
    assert planes.LAST_REJECT == "pair-iy"


def test_pair_wrapper_validates_operands():
    plan = planes.plan_pair_step(*PAIR_CASES["plain_k128"])
    x = torch.zeros(plan.K * plan.M)
    with pytest.raises(ValueError, match="shape"):
        planes.pair_call(plan, x[:-1], x[:-1], x, x, False, False)
    with pytest.raises(TypeError, match="float32"):
        planes.pair_call(plan, x.half(), x.half(), x, x, False, False)
    before = planes.pair_call.launches
    planes.pair_call(plan, x, x, x, x, False, False)
    assert planes.pair_call.launches == before


# -- lane steps ----------------------------------------------------------------

LANE_TOL = dict(rtol=2e-4, atol=1e-5)   # as tests/test_lanes.py
_SC25_X = ("B",) + tuple(f"f{k}" for k in range(10)) \
    + ("p0", "k0", "p1", "k1", "p2", "p3", "k2")
# (ix_x, ix_w, iy, dims_x, dims_w, plan_lane_step arguments)
LANE_CASES = {
    "head_basic": (("a", "b", "c", "d"), ("a", "b", "n", "m"),
                   ("n", "m", "c", "d"), (4, 32, 128, 16), (4, 32, 4, 4),
                   dict(lane_count=2, orient="head")),
    "head_combo_and_hoist": (("a", "b", "c", "g", "e", "d"), ("a", "e", "n"),
                             ("g", "c", "b", "n", "d"),
                             (64, 2, 64, 2, 2, 256), (64, 2, 8),
                             dict(lane_count=2, orient="head")),
    "tail_basic": (("c", "d", "a", "b"), ("a", "b", "n"), ("c", "d", "n"),
                   (128, 16, 4, 32), (4, 32, 16),
                   dict(lane_count=2, orient="tail")),
    "pinned_leading_leg": (("B", "a", "b", "c"), ("a", "b", "n"),
                           ("B", "n", "c"), (6, 4, 32, 512), (4, 32, 8),
                           dict(lane_count=2, pin=1, orient="head")),
    # a small copy of the n30 sc25 path's lane step: pinned batch axis,
    # lane-free legs among the lanes (T 8 of L 128)
    "sc25_tail": (_SC25_X, ("k1", "k2", "k0", "n0", "n1", "n2"),
                  tuple(l for l in _SC25_X if l[0] != "k")
                  + ("n0", "n1", "n2"), (4,) + (2,) * 17, (2,) * 6,
                  dict(lane_count=7, pin=1, orient="tail")),
    # every head split (the sparse compiler's chain), best estimate kept
    "head_basic_any_split": (("a", "b", "c", "d"), ("a", "b", "n", "m"),
                             ("n", "m", "c", "d"), (4, 32, 128, 16),
                             (4, 32, 4, 4), {}),
}
_VMEM_L = tuple(f"a{k}" for k in range(7))
_VMEM_F = tuple(f"f{k}" for k in range(14))
_VMEM_H = tuple(f"h{k}" for k in range(5))
REJECT_CASES = {   # name: (step, plan_lane_step arguments, JAX reject)
    "vmem_minor_combo": ((_VMEM_L + _VMEM_F + ("c0",),
                          _VMEM_L + ("c0",) + _VMEM_H, _VMEM_H + _VMEM_F,
                          (2,) * 22, (2,) * 13), {}, "vmem"),
    "size": ((("a", "b"), ("a", "n"), ("n", "b"), (4, 64), (4, 2)),
             dict(lane_count=1), "size"),
    "no_f_run": ((("a", "b", "c"), ("a", "n"), ("n", "c", "b"),
                  (128, 64, 128), (128, 64)),
                 dict(lane_count=1), "no-f-run"),
    "L_cap": ((("a", "b", "c"), ("a", "b", "n"), ("n", "c"),
               (32, 16, 512), (32, 16, 2)), dict(lane_count=2), "L-cap"),
}


def _jax_pair(a):
    return (np.ascontiguousarray(a.real), np.ascontiguousarray(a.imag))


def assert_lane_plans_equal(p, j):
    """The JAX plan's fields (``flops`` differs by design: the port counts
    the table form's work)."""
    for f in ("w_is_j", "orient", "view_x", "combo_axes", "x_axes", "y_axes",
              "block", "L", "H", "n_combos", "view_y", "dims_y", "est_s"):
        assert getattr(p, f) == getattr(j, f), f
    np.testing.assert_array_equal(p.wp_idx, j.wp_idx)
    np.testing.assert_array_equal(p.wp_sign, j.wp_sign)


@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_plan_lane_step_matches_jax(name):
    ix_x, ix_w, iy, dx, dw, kw = LANE_CASES[name]
    pplan = planes.plan_lane_step(ix_x, ix_w, iy, dx, dw, **kw)
    jplan = jlanes.plan_lane_step(ix_x, ix_w, iy, dx, dw, **kw)
    assert jplan is not None, jlanes.LAST_REJECT
    assert pplan is not None, planes.LAST_REJECT
    assert_lane_plans_equal(pplan, jplan)


@pytest.mark.parametrize("name", sorted(REJECT_CASES))
def test_plan_lane_step_rejects_as_jax(name):
    step, kw, why = REJECT_CASES[name]
    assert jlanes.plan_lane_step(*step, **kw) is None
    assert jlanes.LAST_REJECT == why
    assert planes.plan_lane_step(*step, **kw) is None
    assert planes.LAST_REJECT == why


SCHEDULE_CASES = {   # (ix_x, ix_w, iy_set, dims_x, dims_w, consumer, pin,
                     #  orientations)
    "consumer_contract_first": (("a", "b", "c", "d"), ("a", "b", "n", "m"),
                                {"n", "m", "c", "d"}, (4, 32, 128, 16),
                                (4, 32, 4, 4), {"m"}, 0, ("head",)),
    "tail_orientation": (("c", "a", "b"), ("a", "b", "n"), {"c", "n"},
                         (1024, 8, 16), (8, 16, 32), (), 0, ("head", "tail")),
    "head_only_falls_back": (("c", "a", "b"), ("a", "b", "n"), {"c", "n"},
                             (1024, 8, 16), (8, 16, 32), (), 0, ("head",)),
    "both_big_pair": (("a", "b", "c"), ("a", "d", "e"), {"b", "c", "d", "e"},
                      (64, 64, 32), (64, 64, 32), (), 0, ("head", "tail")),
    "sc25_tail_pinned": (_SC25_X, ("k1", "k2", "k0", "n0", "n1", "n2"),
                         set(_SC25_X) - {"k0", "k1", "k2"}
                         | {"n0", "n1", "n2"}, (4,) + (2,) * 17, (2,) * 6,
                         (), 1, ("head", "tail")),
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_CASES))
def test_schedule_step_matches_jax(name):
    """The same output order and the same kind of plan (lane plans field
    for field) as the JAX scheduler under the same orientations."""
    ix_x, ix_w, iys, dx, dw, cc, pin, orients = SCHEDULE_CASES[name]
    iy, plan = planes.schedule_step(ix_x, ix_w, iys, dx, dw,
                                    consumer_contract=cc, pin=pin,
                                    orientations=orients)
    with mock.patch.object(jlanes, "ORIENTATIONS", orients):
        jiy, jplan = jlanes.schedule_step(ix_x, ix_w, iys, dx, dw,
                                          consumer_contract=cc, pin=pin)
    assert tuple(iy) == tuple(jiy)
    kinds = {jlanes.LanePlan: planes.LanePlan, jlanes.PairPlan:
             planes.PairPlan, jgk.GKPlan: pgk.GKPlan, type(None): type(None)}
    assert type(plan) is kinds[type(jplan)]
    if isinstance(plan, planes.LanePlan):
        assert_lane_plans_equal(plan, jplan)
    if isinstance(plan, planes.PairPlan):
        assert (plan.K, plan.M, plan.N) == (jplan.K, jplan.M, jplan.N)


def _lane_operands(name, width, w_batched, rng):
    ix_x, ix_w, iy, dx, dw, kw = LANE_CASES[name]
    plan = planes.plan_lane_step(ix_x, ix_w, iy, dx, dw, **kw)
    x = _rand(((width,) if width else ()) + dx, rng)
    w = _rand(((width,) if width and w_batched else ()) + dw, rng)
    lab = {l: k for k, l in enumerate({*ix_x, *ix_w, *iy, "#w"})}
    lw = ["#w"] if width else []
    want = np.einsum(x, [lab[l] for l in lw + list(ix_x)],
                     w, [lab[l] for l in (lw if w_batched else [])
                         + list(ix_w)],
                     [lab[l] for l in lw + list(iy)])
    return plan, x, w, want


LANE_MODES = {"w1": (0, False), "w4_both": (4, True),
              "w4_shared_w": (4, False)}


@pytest.mark.parametrize("mode", sorted(LANE_MODES))
@pytest.mark.parametrize("name", [n for n in sorted(LANE_CASES)
                                  if n != "head_basic_any_split"])
def test_lane_step_matches_jax_and_einsum(name, mode):
    """``apply_lane_step`` through ``lane_call`` (its plain version on the
    CPU) against JAX's apply_lane_step in interpret mode, one slice
    instance at a time, and np.einsum."""
    width, wb = LANE_MODES[mode]
    rng = np.random.default_rng(sum(name.encode()) + width)
    plan, x, w, want = _lane_operands(name, width, wb, rng)
    bx = bool(width)
    pf = SplitField()
    wrap = lambda a, b: pf.reshape(pf.wrap(a, "cpu"),
                                   ((a.shape[0],) if b else ()) + (-1,))
    out = planes.apply_lane_step(pf, wrap(x, bx), wrap(w, wb), plan, bx, wb)
    got = (out[0].numpy() + 1j * out[1].numpy()).reshape(want.shape)
    np.testing.assert_allclose(got, want, **LANE_TOL)

    ix_x, ix_w, iy, dx, dw, kw = LANE_CASES[name]
    jplan = jlanes.plan_lane_step(ix_x, ix_w, iy, dx, dw, **kw)
    jf = jax_make_field(np.complex64, "highest", "split")
    inst = range(width) if width else [None]
    for s in inst:
        xs = x if s is None else x[s]
        ws = w if (s is None or not wb) else w[s]
        jout = jlanes.apply_lane_step(jf, _jax_pair(xs.reshape(-1)),
                                      _jax_pair(ws.reshape(-1)), jplan,
                                      interpret=True)
        want_j = np.asarray(jout[0]) + 1j * np.asarray(jout[1])
        np.testing.assert_allclose(
            (got if s is None else got[s]).reshape(-1),
            want_j.reshape(-1), **LANE_TOL)


@pytest.mark.parametrize("name", [n for n in sorted(LANE_CASES)
                                  if n != "head_basic_any_split"])
def test_lane_address_table_computes_the_step(name):
    """The CUDA kernel's arithmetic, in numpy: for every grid point o,
    output h and free-run index f, y[yoff[o] + h*y_hs + f*y_fs] = sum_t
    x[xoff[o] + doff[xd[t, h]] + f*x_fs] * w[wi[t, h]] equals the step."""
    plan, x, w, want = _lane_operands(name, 0, False,
                                      np.random.default_rng(5))
    xf, wf = x.reshape(-1), w.reshape(-1)
    y = np.zeros(plan.y_elems, np.complex64)
    f = np.arange(plan.F)
    xa = (plan.xoff[:, None, None, None]
          + plan.doff[plan.xd][None, :, :, None]
          + f[None, None, None, :] * plan.x_fs)          # (G, T, H, F)
    terms = xf[xa] * wf[plan.wi][None, :, :, None]
    ya = (plan.yoff[:, None, None] + np.arange(plan.H)[None, :, None]
          * plan.y_hs + f[None, None, :] * plan.y_fs)    # (G, H, F)
    y[ya] = terms.sum(axis=1)
    assert np.unique(ya).size == plan.y_elems
    np.testing.assert_allclose(y.reshape(want.shape), want, **LANE_TOL)
    # the table covers exactly the lane matrix's nonzero entries
    assert plan.T * plan.H == int((plan.wp_sign != 0).sum())


def test_lane_wrapper_validates_operands():
    ix_x, ix_w, iy, dx, dw, kw = LANE_CASES["head_basic"]
    plan = planes.plan_lane_step(ix_x, ix_w, iy, dx, dw, **kw)
    x = torch.zeros(plan.x_elems)
    w = torch.zeros(plan.w_elems)
    with pytest.raises(ValueError, match="shape"):
        planes.lane_call(plan, x[:-1], x[:-1], w, w, False, False)
    with pytest.raises(TypeError, match="float32"):
        planes.lane_call(plan, x.double(), x.double(), w, w, False, False)
    before = planes.lane_call.launches
    planes.lane_call(plan, x, x, w, w, False, False)
    assert planes.lane_call.launches == before


def test_prune_lane_plans_keeps_the_most_work():
    from dataclasses import dataclass

    @dataclass(frozen=True)
    class Step:
        lane: object

    plan = lambda flops: type("P", (), {"flops": flops})()
    steps = [Step(plan(f)) for f in (5, 1, 9, 3)] + [Step(None)]
    assert planes.prune_lane_plans(steps, cap=2) == 2
    assert [s.lane.flops if s.lane else None for s in steps] == \
        [5, None, 9, None, None]
    assert planes.prune_lane_plans(steps) == 2


# -- the fused complex batched matmul -------------------------------------------

def test_complex_batched_matmul_matches_jax():
    """The plain version against the JAX Pallas kernel in interpret mode
    (the mock of tests/test_aux.py) on its shape, and np.matmul."""
    from jax.experimental import pallas as pl

    import artensor_tpu.ops.pallas_mm as jpm

    rng = np.random.default_rng(0)
    B, M, K, N = 2, 256, 64, 256
    a = [rng.random((B, M, K), np.float32) for _ in "ri"]
    b = [rng.random((B, K, N), np.float32) for _ in "ri"]
    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call",
                           lambda *args, **kw: orig(*args, interpret=True,
                                                    **kw)):
        jre, jim = jpm.complex_batched_matmul(tuple(a), tuple(b))
    re, im = pmm.complex_batched_matmul(tuple(map(torch.tensor, a)),
                                        tuple(map(torch.tensor, b)))
    want = (a[0] + 1j * a[1]) @ (b[0] + 1j * b[1])
    got = re.numpy() + 1j * im.numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jre) + 1j * np.asarray(jim),
                               rtol=2e-4, atol=1e-4)


def test_complex_batched_matmul_ragged_and_validated():
    """Ragged M and N, which the TPU kernel refuses, and operand checks."""
    rng = np.random.default_rng(1)
    a = [rng.standard_normal((3, 100, 37)).astype(np.float32) for _ in "ri"]
    b = [rng.standard_normal((3, 37, 70)).astype(np.float32) for _ in "ri"]
    re, im = pmm.complex_batched_matmul(tuple(map(torch.tensor, a)),
                                        tuple(map(torch.tensor, b)))
    want = (a[0] + 1j * a[1]) @ (b[0] + 1j * b[1])
    np.testing.assert_allclose(re.numpy() + 1j * im.numpy(), want,
                               rtol=2e-4, atol=1e-4)
    t = torch.zeros((2, 4, 3))
    with pytest.raises(ValueError, match="shape"):
        pmm.complex_batched_matmul((t, t), (t, t))
    with pytest.raises(TypeError, match="float32"):
        pmm.complex_batched_matmul((t.double(), t.double()),
                                   (t[:, :3].double(), t[:, :3].double()))
    assert pmm.complex_batched_matmul.launches == 0
