"""Port pair steps (plain version on the CPU) against the JAX package's
apply_pair_step (Pallas in interpret mode) and np.einsum, with the shapes
of tests/test_lanes.py, at widths 1 and 4 (batched and shared V) and 3."""

import jax
import numpy as np
import pytest
import torch

from artensor_tpu.ops.field import make_field as jax_make_field
from artensor_tpu.runtime import lanes as jlanes
from artensor_tpu_torch.ops.field import SplitField
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
