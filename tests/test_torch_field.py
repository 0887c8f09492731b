"""Port SplitField (artensor_tpu_torch.ops.field) against the JAX SplitField:
the same numpy inputs through each method of both, compared in numpy."""

import numpy as np
import pytest
import torch

from artensor_tpu.ops.field import make_field as jax_make_field
from artensor_tpu_torch.ops.field import SplitField

TOL = dict(rtol=2e-6, atol=1e-6)


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _np(x):
    return np.asarray(x[0]).astype(np.float64) \
        + 1j * np.asarray(x[1]).astype(np.float64)


def _pt(x):
    return x[0].numpy().astype(np.float64) + 1j * x[1].numpy().astype(
        np.float64)


@pytest.fixture(scope="module")
def fields():
    return jax_make_field(np.complex64, "highest", "split"), SplitField()


def test_wrap_unwrap(fields):
    jf, pf = fields
    a = _rand((3, 8), 0)
    pw = pf.wrap(a, "cpu")
    assert pw[0].dtype == torch.float32 and pw[0].device.type == "cpu"
    np.testing.assert_array_equal(_pt(pw), _np(jf.wrap(a)))
    np.testing.assert_array_equal(pf.unwrap(pw), jf.unwrap(jf.wrap(a)))


def test_supports_lanes_is_f32_only():
    assert SplitField(np.complex64).supports_lanes
    assert not SplitField(np.complex128).supports_lanes
    assert SplitField(np.complex128).rdtype == torch.float64


def _cases():
    """(name, jax_fn, port_fn, inputs) — each method on the same data."""
    a = _rand((4, 6), 1)
    b = _rand((4, 6), 2)
    c = _rand((2, 3, 4), 3)
    idx = np.array([3, 0, 2, 2])
    m1 = _rand((2, 3, 5), 4)
    m2 = _rand((5, 2, 4), 5)
    dn = (((2,), (0,)), ((0,), (1,)))
    return [
        ("add", lambda f, x, y: f.add(x, y), (a, b)),
        ("scale", lambda f, x: f.scale(x, 0.5), (a,)),
        ("sum0", lambda f, x: f.sum0(x), (c,)),
        ("reshape", lambda f, x: f.reshape(x, (2, 12)), (a,)),
        ("take", lambda f, x: f.take(x, idx, axis=0), (a,)),
        ("take_axis1", lambda f, x: f.take(x, idx, axis=1), (a,)),
        ("concat", lambda f, x, y: f.concat([x, y], axis=0), (a, b)),
        ("concat_axis1", lambda f, x, y: f.concat([x, y], axis=1), (a, b)),
        ("transpose", lambda f, x: f.transpose(x, (2, 0, 1)), (c,)),
        ("regroup", lambda f, x: f.regroup(x, (2, 3, 4), (1, 2, 0),
                                           (12, 2)), (c,)),
        ("index_logical", lambda f, x: f.index_logical(
            x, (2, 3, 4), 1, 2, (2, 4)), (c,)),
        ("dot", lambda f, x, y: f.dot(x, y, dn), (m1, m2)),
    ]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_method_matches_jax(fields, case):
    jf, pf = fields
    _, fn, inputs = case
    want = _np(fn(jf, *[jf.wrap(a) for a in inputs]))
    got = _pt(fn(pf, *[pf.wrap(a, "cpu") for a in inputs]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_zeros(fields):
    jf, pf = fields
    z = pf.zeros((3, 5), "cpu")
    np.testing.assert_array_equal(_pt(z), _np(jf.zeros((3, 5))))


def test_index_logical_per_instance(fields):
    """Tensor index: one index per slice instance, from an unbatched and
    from an already-batched buffer, equals the int form per instance."""
    _, pf = fields
    c = pf.wrap(_rand((2, 3, 4), 6), "cpu")
    bits = torch.tensor([2, 0, 1, 2])
    got = pf.index_logical(c, (2, 3, 4), 1, bits, (2, 4))
    assert got[0].shape == (4, 2, 4)
    for w, b in enumerate(bits.tolist()):
        want = pf.index_logical(c, (2, 3, 4), 1, b, (2, 4))
        np.testing.assert_array_equal(got[0][w].numpy(), want[0].numpy())
        np.testing.assert_array_equal(got[1][w].numpy(), want[1].numpy())
    # second selection on the batched result
    got2 = pf.index_logical(got, (2, 4), 0, torch.tensor([1, 1, 0, 1]),
                            (4,))
    for w, (b1, b2) in enumerate(zip(bits.tolist(), [1, 1, 0, 1])):
        want = pf.index_logical(c, (2, 3, 4), 1, b1, (2, 4))
        want = pf.index_logical(want, (2, 4), 0, b2, (4,))
        np.testing.assert_array_equal(got2[0][w].numpy(), want[0].numpy())


@pytest.mark.parametrize("caller", [True, False])
def test_dot_keeps_the_callers_tf32_setting(fields, caller, monkeypatch):
    """``dot`` runs its products in full float32 and gives the caller's
    ``allow_tf32`` back: set True (or False) before, the same after, and
    the product still matches ``np.einsum``."""
    _, pf = fields
    flags = torch.backends.cuda.matmul
    monkeypatch.setattr(flags, "allow_tf32", caller)
    m1, m2 = _rand((2, 3, 5), 4), _rand((5, 2, 4), 5)
    dn = (((2,), (0,)), ((0,), (1,)))
    got = _pt(pf.dot(pf.wrap(m1, "cpu"), pf.wrap(m2, "cpu"), dn))
    assert flags.allow_tf32 is caller
    want = np.einsum("bik,kbj->bij", m1.astype(np.complex128),
                     m2.astype(np.complex128))
    np.testing.assert_allclose(got, want, **TOL)



# (a shape, b shape, dnums): no batch axes with the contracted axes between
# free ones; batch axes not leading; the rhs the larger operand; both
# operands already in matrix form (views, no copy)
SPLIT_DOT_CASES = {
    "free": ((4, 3, 5, 2), (2, 6, 3), (((1, 3), (2, 0)), ((), ()))),
    "batch": ((3, 4, 2, 5), (4, 2, 3, 2), (((1,), (0,)), ((0, 2), (2, 1)))),
    "rhs_larger": ((2, 3), (3, 2, 4, 5), (((1,), (0,)), ((0,), (1,)))),
    "views": ((2, 6, 4), (2, 4, 3), (((2,), (1,)), ((0,), (0,)))),
}


@pytest.mark.parametrize("case", sorted(SPLIT_DOT_CASES))
def test_split_dot_matches_einsum(case):
    """``_split_dot`` (both orders of the component copies) against a
    complex128 ``torch.einsum`` of the same dot_general: output axes
    batch, then a's free, then b's free, in stored order."""
    from artensor_tpu_torch.ops.field import _split_dot

    sa, sb, dn = SPLIT_DOT_CASES[case]
    (ca, cb), (ba, bb) = dn
    a, b = _rand(sa, 1).astype(np.complex128), _rand(sb, 2)
    b = b.astype(np.complex128)
    la, lb = [None] * len(sa), [None] * len(sb)
    letters = iter("abcdefghijklmnop")
    for i, j in zip(ba, bb):
        la[i] = lb[j] = next(letters)
    bat = [la[i] for i in ba]
    for i, j in zip(ca, cb):
        la[i] = lb[j] = next(letters)
    fa = [la.__setitem__(d, next(letters)) or la[d]
          for d in range(len(sa)) if la[d] is None]
    fb = [lb.__setitem__(d, next(letters)) or lb[d]
          for d in range(len(sb)) if lb[d] is None]
    want = torch.einsum(f"{''.join(la)},{''.join(lb)}->"
                        f"{''.join(bat + fa + fb)}",
                        torch.from_numpy(a), torch.from_numpy(b)).numpy()
    split = lambda x: (torch.from_numpy(x.real.copy()),
                       torch.from_numpy(x.imag.copy()))
    got = _split_dot(split(a), split(b), dn)
    assert got[0].dtype == torch.float64
    np.testing.assert_allclose(_pt(got), want, rtol=1e-12, atol=1e-12)
