"""The port's number fields (``ops/field.py``: split naive / karatsuba,
complex, fused, reduced storage; ``ops/einsum.py``) against the JAX
package's: each method on the same numpy inputs, with and without a
leading slice-width axis; the fused field's single-product plans
(``runtime/lowering._lower_fused``) field by field, and every lowered
step of a small circuit's sparse and dense schemes run by both fields;
bf16 / f16 storage end to end through the sliced runner; the kernels'
precision clamp (``kernel_precision``) and their TF32 plain forms; and
no kernel step runs outside split float32 mode."""

import numpy as np
import pytest
import torch

from artensor_tpu.ops.field import make_field as jax_make_field
from artensor_tpu.runtime.lowering import apply_lowered as jax_apply_lowered
from artensor_tpu_torch.ops.field import (ComplexField, FusedField,
                                          SplitField, make_field)
from artensor_tpu_torch.runtime.lowering import apply_lowered

from test_torch_checkpoint import cases  # noqa: F401  (module fixture)

FIELDS = [("split", "naive"), ("split", "karatsuba"), ("complex", "naive"),
          ("fused", "naive")]
TOL = dict(rtol=2e-6, atol=2e-6)     # float32 sums in another order
W = 3                                 # slice width of the batched cases


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _fields(mode, algo, storage="f32", dtype=np.complex64):
    return (jax_make_field(dtype, "highest", mode, algo, storage),
            make_field(dtype, "highest", mode, algo, storage))


def _np(field, x):
    """A value of either package's field as complex128 numpy."""
    return np.asarray(field.unwrap(x)).astype(np.complex128)


def _method_cases():
    """(name, fn(field, *values), input arrays, batched variant): the
    batched variant ``fnb(field, *values)`` runs the method on inputs
    stacked to a leading width W; result instance w must equal ``fn`` on
    instance w (None: no batched form)."""
    a, b = _rand((4, 6), 1), _rand((4, 6), 2)
    c = _rand((2, 3, 4), 3)
    idx = np.array([3, 0, 2, 2])
    return [
        ("add", lambda f, x, y: f.add(x, y), (a, b), None),
        ("scale", lambda f, x: f.scale(x, 0.5), (a,), None),
        ("sum0", lambda f, x: f.sum0(x), (c,), None),
        ("max_abs", None, (c,), None),
        ("reshape", lambda f, x: f.reshape(x, (2, 12)), (a,),
         lambda f, x: f.reshape(x, (W, 2, 12))),
        ("take", lambda f, x: f.take(x, idx, axis=0), (a,),
         lambda f, x: f.take(x, torch.as_tensor(idx), axis=1)),
        ("take_axis1", lambda f, x: f.take(x, idx % 4, axis=1), (a,),
         lambda f, x: f.take(x, torch.as_tensor(idx % 4), axis=2)),
        ("take_rank1", lambda f, x: f.take(f.reshape(x, (24,)), idx, axis=0),
         (a,), lambda f, x: f.take(f.reshape(x, (W, 24)),
                                   torch.as_tensor(idx), axis=1)),
        ("concat", lambda f, x, y: f.concat([x, y], axis=0), (a, b),
         lambda f, x, y: f.concat([x, y], axis=1)),
        ("regroup", lambda f, x: f.regroup(x, (2, 3, 4), (1, 2, 0),
                                           (12, 2)), (c,),
         lambda f, x: f.regroup(x, (W, 2, 3, 4), (0, 2, 3, 1),
                                (W, 12, 2))),
        ("index_logical", lambda f, x: f.index_logical(
            x, (2, 3, 4), 1, 2, (2, 4)), (c,), None),
        ("einsum", lambda f, x, y: f.einsum(x, y, (0, 1, 2), (2, 1, 3),
                                            (1, 0, 3)),
         (c, _rand((4, 3, 5), 4)), None),
    ]


def _stack(pf, arrays):
    """Inputs stacked to a leading width W (instance w scaled by w+1)."""
    return [pf.wrap(np.stack([a * (k + 1) for k in range(W)]), "cpu")
            for a in arrays]


@pytest.mark.parametrize("case", _method_cases(), ids=lambda c: c[0])
@pytest.mark.parametrize("mode,algo", FIELDS)
def test_method_matches_jax(mode, algo, case):
    jf, pf = _fields(mode, algo)
    name, fn, inputs, fnb = case
    if mode == "fused" and name == "take_axis1":
        # JAX's fused take has no form for the folded axis of a rank-2
        # value (it asserts axis 0 there); its split field's take gives
        # the same values
        jf = jax_make_field(np.complex64, "highest", "split")
    if name == "max_abs":
        want = float(jf.max_abs(jf.wrap(inputs[0])))
        got = pf.max_abs(pf.wrap(inputs[0], "cpu"))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(want, rel=1e-7)
        return
    want = _np(jf, fn(jf, *[jf.wrap(a) for a in inputs]))
    got = _np(pf, fn(pf, *[pf.wrap(a, "cpu") for a in inputs]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    if fnb is None:
        return
    out = fnb(pf, *_stack(pf, inputs))
    for k in range(W):
        inst = fn(jf, *[jf.wrap(a * (k + 1)) for a in inputs])
        mine = out[0][k] if isinstance(out, tuple) else out[k]
        inst_np = _np(jf, inst)
        part = pf.join((out[0][k], out[1][k])) if mode == "split" \
            else mine
        np.testing.assert_allclose(_np(pf, part).reshape(inst_np.shape),
                                   inst_np, **TOL)


@pytest.mark.parametrize("mode,algo", FIELDS)
def test_wrap_unwrap_and_zeros(mode, algo):
    jf, pf = _fields(mode, algo)
    a = _rand((3, 8), 0)
    x = pf.wrap(a, "cpu")
    assert all(c.device.type == "cpu" for c in pf.buffers(x))
    np.testing.assert_array_equal(pf.unwrap(x), jf.unwrap(jf.wrap(a)))
    z = pf.zeros((3, 5), "cpu")
    assert _np(pf, z).shape == _np(jf, jf.zeros((3, 5))).shape
    assert not _np(pf, z).any()
    assert pf.join(pf.buffers(x)) is x or mode == "split"
    c = pf.clone(x)
    assert all(p.data_ptr() != q.data_ptr()
               for p, q in zip(pf.buffers(c), pf.buffers(x)))
    assert pf.device(x).type == "cpu" and pf.leading(x) == 3


@pytest.mark.parametrize("mode,algo", [f for f in FIELDS if f[0] != "fused"])
def test_dot_matches_jax(mode, algo):
    """dot_general with batch axes not leading and contracted axes
    between free ones (the fused field has no ``dot``: its steps run
    ``contract_step``)."""
    jf, pf = _fields(mode, algo)
    m1, m2 = _rand((2, 3, 5), 4), _rand((5, 2, 4), 5)
    dn = (((2,), (0,)), ((0,), (1,)))
    want = _np(jf, jf.dot(jf.wrap(m1), jf.wrap(m2), dn))
    got = _np(pf, pf.dot(pf.wrap(m1, "cpu"), pf.wrap(m2, "cpu"), dn))
    np.testing.assert_allclose(got, want, **TOL)


def _outside_cases():
    """(mode, algo, method): ``index`` on every field, ``matmul`` and
    ``transpose`` where the JAX field has them (its fused field has
    neither)."""
    out = []
    for mode, algo in FIELDS:
        out += [(mode, algo, "index"), (mode, algo, "index_tensor")]
        if mode != "fused":
            out += [(mode, algo, "matmul"), (mode, algo, "transpose")]
    return out


@pytest.mark.parametrize("mode,algo,method", _outside_cases())
def test_index_matmul_transpose_match_jax(mode, algo, method):
    """The field methods outside the executors' use, against JAX's:
    ``index`` (an int, or a one-element index tensor in the port, on the
    stored shape: the fused field's folded one), the batched ``matmul``
    and ``transpose``."""
    jf, pf = _fields(mode, algo)
    c, m1, m2 = _rand((2, 3, 4), 6), _rand((3, 2, 5), 7), _rand((3, 5, 4), 8)
    if method.startswith("index"):
        idx = 2 if method == "index" else torch.tensor([2])
        want = _np(jf, jf.index(jf.wrap(c), 2, 1))
        got = _np(pf, pf.index(pf.wrap(c, "cpu"), idx, 1))
    elif method == "matmul":
        want = _np(jf, jf.matmul(jf.wrap(m1), jf.wrap(m2)))
        got = _np(pf, pf.matmul(pf.wrap(m1, "cpu"), pf.wrap(m2, "cpu")))
    else:
        want = _np(jf, jf.transpose(jf.wrap(c), (2, 0, 1)))
        got = _np(pf, pf.transpose(pf.wrap(c, "cpu"), (2, 0, 1)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_fields_of_make_field():
    """``make_field``'s modes, defaults and refusals; ``supports_lanes``
    only for split float32 storage of complex64 (``field.py:51-52``)."""
    f = make_field()
    assert isinstance(f, SplitField) and f.algo == "naive" \
        and f.precision.name == "highest" and f.supports_lanes
    assert isinstance(make_field(mode="complex"), ComplexField)
    assert isinstance(make_field(mode="fused"), FusedField)
    assert not make_field(np.complex128).supports_lanes
    assert not make_field(storage="bf16").supports_lanes
    assert not make_field(mode="complex").supports_lanes
    assert not make_field(mode="fused").supports_lanes
    assert make_field(storage="f16").sdtype == torch.float16
    with pytest.raises(ValueError):
        make_field(mode="native")
    with pytest.raises(ValueError):
        make_field(precision="low")
    with pytest.raises(ValueError):
        make_field(mode="complex", storage="bf16")


@pytest.mark.parametrize("caller", [True, False])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("mode", ["split", "complex"])
def test_dot_sets_tf32_by_precision(mode, precision, caller, monkeypatch):
    """The dot runs its products with cuBLAS's TF32 switch as the
    precision says ('default' on, else off) and gives the caller's
    setting back."""
    flags = torch.backends.cuda.matmul
    monkeypatch.setattr(flags, "allow_tf32", caller)
    seen = []
    real = torch.matmul

    def spy(*a, **k):
        seen.append(flags.allow_tf32)
        return real(*a, **k)

    monkeypatch.setattr(torch, "matmul", spy)
    pf = make_field(np.complex64, precision, mode)
    m1, m2 = _rand((2, 3, 5), 4), _rand((5, 2, 4), 5)
    pf.dot(pf.wrap(m1, "cpu"), pf.wrap(m2, "cpu"),
           (((2,), (0,)), ((0,), (1,))))
    assert seen and set(seen) == {precision == "default"}
    assert flags.allow_tf32 is caller


def _lows(step):
    return [step.lowered] if step.lowered is not None \
        else list(step.lowered_chunks)


@pytest.mark.parametrize("case", ["dense4", "sparse"])
def test_fused_plans_match_jax(cases, case):
    """``_lower_fused`` on every lowered step (each chunk of an aligned
    step) of both packages' off-form scheme: the same plan, field by
    field (a reorder's dims, permutation and final shape: the port runs
    every reorder as a permute, so it has no gather mode)."""
    w = cases[case]
    n = 0
    for js, ps in zip(w["js"].steps, w["ps"].steps):
        for jl, pl in zip(_lows(js), _lows(ps)):
            jp, pp = jl.fused, pl.fused
            assert (jp is None) == (pp is None)
            if jp is None:
                continue
            for f in ("w_is_j", "w4_lhs", "n_w", "dims_w", "shape_d",
                      "shape_w", "dnums", "phys_y"):
                assert getattr(pp, f) == getattr(jp, f), f
            assert (jp.re_out is None) == (pp.re_out is None)
            if jp.re_out is not None:
                assert (pp.re_out.dims, pp.re_out.perm,
                        pp.re_out.final_shape) == (
                    jp.re_out.dims, jp.re_out.perm, jp.re_out.final_shape)
            n += 1
    assert n >= 10


def _operand_sizes(low):
    """Elements of operand i and j of a lowered step."""
    a, b = int(np.prod(low.shape_l)), int(np.prod(low.shape_r))
    return (b, a) if low.swapped else (a, b)


@pytest.mark.parametrize("mode,algo", FIELDS)
@pytest.mark.parametrize("case", ["dense4", "sparse"])
def test_every_lowered_step_matches_jax(cases, case, mode, algo):
    """Each lowered step of the scheme (every chunk of an aligned step),
    on random operands, through both packages' ``apply_lowered``; and
    the port's with a width-3 axis on either or both operands against
    JAX's per instance (the fused product threads the width through its
    one product as the split dot does)."""
    jf, pf = _fields(mode, algo)
    w = cases[case]
    seed = 0
    for js, ps in zip(w["js"].steps, w["ps"].steps):
        for jl, pl in zip(_lows(js), _lows(ps)):
            ni, nj = _operand_sizes(pl)
            xs = [_rand((ni,), seed + k) for k in range(W)]
            ys = [_rand((nj,), seed + 10 + k) for k in range(W)]
            seed += 1
            want = [_np(jf, jax_apply_lowered(jf, jf.wrap(x), jf.wrap(y),
                                               jl))
                    for x, y in zip(xs, ys)]
            got = _np(pf, apply_lowered(pf, pf.wrap(xs[0], "cpu"),
                                        pf.wrap(ys[0], "cpu"), pl))
            np.testing.assert_allclose(got.reshape(want[0].shape), want[0],
                                       **TOL)
            for bx, by in ((True, False), (False, True), (True, True)):
                x = pf.wrap(np.stack(xs) if bx else xs[0], "cpu")
                y = pf.wrap(np.stack(ys) if by else ys[0], "cpu")
                out = _np(pf, apply_lowered(pf, x, y, pl, bx, by))
                for k in range(W):
                    ref = _np(jf, jax_apply_lowered(
                        jf, jf.wrap(xs[k] if bx else xs[0]),
                        jf.wrap(ys[k] if by else ys[0]), jl))
                    np.testing.assert_allclose(out[k].reshape(ref.shape),
                                               ref, **TOL)


def test_fused_split_fallback_matches_the_state(cases, monkeypatch):
    """Steps where both operands exceed ``FUSED_W_MAX_ELEMS`` have no
    fused plan and run the split products on the two halves of the
    folded tensors: with the cap lowered to 4 elements most steps take
    that route, and the run still gives the exact values."""
    from artensor_tpu_torch.runtime import lowering
    from artensor_tpu_torch.runtime.sparse import contraction_scheme_sparse

    monkeypatch.setattr(lowering, "FUSED_W_MAX_ELEMS", 4)
    w = cases["sparse"]
    ps = w["ps"]
    saved = ps.steps, ps.output_bonds, ps.bitstrings_sorted
    try:
        ps._set_scheme(*contraction_scheme_sparse(
            ps.ctree, w["bits"], ps.sc_target, fuse=False, negotiate=False))
        lows = [low for s in ps.steps for low in _lows(s)]
        assert sum(low.fused is None for low in lows) > len(lows) // 2
        for width in (1, 4):
            got = ps.contraction(mode="fused", slice_batch=width,
                                 device="cpu")
            order = np.argsort(ps.bitstrings_sorted)
            exact = w["state"][order]
            assert np.abs(got[order] - exact).max() \
                <= 2e-5 * np.abs(exact).max()
    finally:
        ps._set_scheme(*saved)


# bf16 keeps 8 mantissa bits, f16 11: each step's output is rounded once
# (relative 2^-9 / 2^-12).  Both packages round the same float32 sums, so
# they differ only where two float32 sums in another order fall on the
# two sides of a rounding boundary: a few units of the storage's last
# place on a few intermediates, not a drift.  Against JAX: 2^-6 (bf16)
# and 2^-9 (f16) of the largest |amplitude| (8 units of the last place);
# against the exact values, the rounding of ~20 steps: 2^-3 and 2^-6.
STORAGE_TOL = {"bf16": (2.0 ** -6, 2.0 ** -3), "f16": (2.0 ** -9, 2.0 ** -6)}


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("mode,algo", [("split", "naive"),
                                       ("split", "karatsuba"),
                                       ("fused", "naive")])
@pytest.mark.parametrize("storage", ["bf16", "f16"])
@pytest.mark.parametrize("case", ["dense4", "sparse"])
def test_reduced_storage_matches_jax(cases, case, storage, mode, algo,
                                     width):
    """bf16 / f16 storage through ``make_field`` and the sliced runner,
    against JAX's same field through its sliced runner (the accumulator
    float32 in both) and the exact values.  JAX's CPU backend refuses the
    sparse case's bf16 split products (``BF16 x BF16 = F32`` dots are
    unimplemented there): that case is held to the exact values alone,
    and JAX's refusal is asserted, so that the comparison comes back
    when the backend runs it."""
    import jax

    from artensor_tpu.runtime import executor as jex
    from artensor_tpu.runtime.sparse import execute_sparse as jexec
    from artensor_tpu_torch.runtime import executor as pex

    w = cases[case]
    js, ps = w["js"], w["ps"]
    jf, pf = _fields(mode, algo, storage)
    sparse = ps.bitstrings_sorted is not None
    k = len(ps.slicing_bonds)

    run_steps, host = jex.precompute_static_steps(
        js.steps, [js.tensors[i] for i in range(len(js.tensors))],
        js.slicing_axes)
    jshape = ((len(js.bitstrings_sorted),) if sparse else ()) \
        + (2,) * len(js.output_bonds)
    jrun = jax.jit(jex.make_sliced_runner(
        jexec if sparse else jex.execute_dense, run_steps, js.slicing_axes,
        k, jshape, jf))
    if case == "sparse" and storage == "bf16" and mode == "split":
        with pytest.raises(jax.errors.JaxRuntimeError,
                           match="BF16 x BF16 = F32"):
            jf.unwrap(jrun(jex.stage_tensors(jf, host)))
        want = None
    else:
        want = jf.unwrap(jrun(jex.stage_tensors(jf, host))) \
            .reshape(jshape).transpose(js.permute_dims)

    field, prun, arrays, pshape, execute, _ = ps._staged(
        torch.device("cpu"), pf)
    assert pf.buffers(arrays[0])[0].dtype == pf.sdtype
    run = pex.make_sliced_runner(execute, prun, ps.slicing_axes, k, pshape,
                                 pf, slice_batch=width)
    acc = run(arrays)
    assert all(c.dtype == torch.float32 for c in pf.buffers(acc))
    got = pf.unwrap(acc).reshape(pshape).transpose(ps.permute_dims)
    if sparse:
        got = got[np.argsort(ps.bitstrings_sorted)]
        exact = w["state"][np.argsort(ps.bitstrings_sorted)]
        if want is not None:
            want = want[np.argsort(js.bitstrings_sorted)]
    else:
        exact = w["state"]
    scale = np.abs(exact).max()
    to_jax, to_exact = STORAGE_TOL[storage]
    if want is not None:
        assert np.abs(got - want).max() <= to_jax * scale
    assert np.abs(got - exact).max() <= to_exact * scale


def test_kernel_precision_clamped_as_jax():
    """As tests/test_lanes.py:198-210: 'highest' and 'default' pass
    through, 'high' clamps to None (full-precision kernels); on the H100
    'default' is the one-pass TF32 form, the rest 3xTF32."""
    from artensor_tpu_torch import kernels
    from artensor_tpu_torch.ops.einsum import PRECISIONS
    from artensor_tpu_torch.runtime.lanes import kernel_precision

    kp = lambda p: kernel_precision(make_field(np.complex64, p, "split"))
    assert kp("highest") == PRECISIONS["highest"]
    assert kp("high") is None
    assert kp("default") == PRECISIONS["default"]
    assert [kernels.tc_passes(kp(p)) for p in ("highest", "high",
                                              "default")] == [3, 3, 1]


def test_tf32_round_clears_13_mantissa_bits():
    """``tf32_round`` keeps the sign, the exponent and the top 10
    mantissa bits: the value truncated toward zero to 11 significant
    bits (numpy on the same bit pattern), and the TF32 plain form of the
    complex matmul equals a float64 product of those operands."""
    from artensor_tpu_torch import kernels
    from artensor_tpu_torch.ops.pallas_mm import complex_batched_matmul_plain

    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    want = (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    got = kernels.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(np.abs(got) <= np.abs(x))
    assert np.abs(got - x).max() <= 2.0 ** -10 * np.abs(x).max()
    rng = np.random.default_rng(1)
    a = [torch.from_numpy(rng.standard_normal((2, 8, 16), np.float32))
         for _ in range(2)]
    b = [torch.from_numpy(rng.standard_normal((2, 16, 4), np.float32))
         for _ in range(2)]
    yr, yi = complex_batched_matmul_plain(a, b, tf32=True)
    r = lambda t: kernels.tf32_round(t).double().numpy()
    ac, bc = r(a[0]) + 1j * r(a[1]), r(b[0]) + 1j * r(b[1])
    np.testing.assert_allclose(yr.numpy() + 1j * yi.numpy(), ac @ bc,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode,storage", [("split", "f32"),
                                          ("split", "bf16"),
                                          ("complex", "f32"),
                                          ("fused", "f32")])
def test_kernel_steps_run_in_split_f32_mode_only(mode, storage,
                                                  monkeypatch):
    """A kernel step runs its kernel (on the CPU: the wrapper's plain
    version) only in split float32 mode, once per kernel step of the
    census a group; in any other mode every step runs its lowered form
    and no kernel wrapper is called.  The committed small plan with the
    size gates lowered (tests/test_torch_sparse.py) has GK and RGFlat
    steps."""
    import json
    import os

    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.runtime import gatherk, lanes, sparse

    n, layers = random_circuit(3, 5, 8, seed=13)
    rng = np.random.default_rng(4)
    bits = [np.binary_repr(b, n)
            for b in rng.choice(2 ** n, 128, replace=False)]
    with open(os.path.join(os.path.dirname(__file__), "data",
                           "torch_port_rcs15_rgflat_plan.json")) as f:
        plan = json.load(f)
    monkeypatch.setattr(gatherk, "MIN_X_ELEMS", 1 << 8)
    monkeypatch.setattr(gatherk, "GGK_MIN_WORK", 1 << 8)
    sim = TensorNetworkSimulation.from_circuit((n, layers), bits)
    sim.load_plan(plan)
    kinds = [sparse.kernel_kind(s) for s in sim.steps]
    census = {k: kinds.count(k) for k in set(kinds) - {None}}
    assert census.get("gk") and census.get("rgflat")
    calls = dict.fromkeys(("gk", "ggk", "rgrow", "rgflat", "lane", "pair"),
                          0)
    for mod, kind, fn in ((gatherk, "gk", "gk_call"),
                          (gatherk, "ggk", "ggk_call"),
                          (gatherk, "rgrow", "rgrow_call"),
                          (gatherk, "rgflat", "rgflat_call"),
                          (lanes, "lane", "lane_call"),
                          (lanes, "pair", "pair_call")):
        real = getattr(mod, fn)

        def counted(*a, _real=real, _kind=kind, **k):
            calls[_kind] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, fn, counted)
    exact = TensorNetworkCircuit_state(n, layers)
    field = make_field(np.complex64, "highest", mode, "naive", storage)
    _, run_steps, arrays, out_shape, execute, _ = sim._staged(
        torch.device("cpu"), field)
    from artensor_tpu_torch.runtime import executor as ex

    run = ex.make_sliced_runner(execute, run_steps, sim.slicing_axes,
                                len(sim.slicing_bonds), out_shape, field,
                                slice_batch=2 ** len(sim.slicing_bonds))
    got = field.unwrap(run(arrays)).reshape(-1)
    run_kinds = [sparse.kernel_kind(s) for s in run_steps]
    want_calls = {k: run_kinds.count(k) if field.supports_lanes else 0
                  for k in calls}
    assert calls == want_calls
    want = np.array([exact[int(b, 2)] for b in sim.bitstrings_sorted])
    tol = 2e-5 if storage == "f32" else 2.0 ** -3
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def TensorNetworkCircuit_state(n, layers):
    from artensor_tpu_torch import TensorNetworkCircuit

    return TensorNetworkCircuit((n, layers)).state_vec().reshape(-1)


def test_pairwise_einsum_takes_any_labels():
    """``pairwise_einsum`` relabels to torch's sublist ints: string labels
    and a hyperedge (a label of both inputs kept in the output)."""
    from artensor_tpu_torch.ops.einsum import pairwise_einsum

    a, b = _rand((2, 3, 4), 1), _rand((4, 3, 5), 2)
    got = pairwise_einsum(torch.from_numpy(a), torch.from_numpy(b),
                          ["x", "bond", "k"], ["k", "bond", "y"],
                          ["bond", "x", "y"])
    np.testing.assert_allclose(got.numpy(),
                               np.einsum("abk,kby->bay", a, b), rtol=1e-5,
                               atol=1e-5)
