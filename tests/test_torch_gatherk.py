"""Port GK / GGK / RGRow / RGFlat steps (plain versions on the CPU) against
the JAX package's apply_gk_step / apply_ggk_step (Pallas in interpret mode)
and the np.einsum oracle, at widths 1 and 4 with batched and unbatched W.
Shapes are those of tests/test_gatherk.py (the two 64-long grid legs cut
to 8 to keep interpret mode fast); the size thresholds are lowered on both
packages as its ``_plan`` does."""

import jax
import numpy as np
import pytest
import torch

from artensor_tpu.ops.field import make_field as jax_make_field
from artensor_tpu.runtime import gatherk as jgk
from artensor_tpu_torch.ops.field import SplitField
from artensor_tpu_torch.runtime import gatherk as pgk

TOL = dict(rtol=2e-4, atol=1e-5)


def _rand(shape, rng):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _lab(*ixs):
    lab = {}
    for ix in ixs:
        for l in ix:
            lab.setdefault(l, len(lab))
    return lambda ix: [lab[l] for l in ix]


@pytest.fixture
def low_thresholds(monkeypatch):
    monkeypatch.setattr(jgk, "MIN_X_ELEMS", 1)
    monkeypatch.setattr(jgk, "SLACK", 1e9)
    monkeypatch.setattr(jgk, "GGK_MIN_WORK", 1)
    monkeypatch.setattr(pgk, "MIN_X_ELEMS", 1)
    monkeypatch.setattr(pgk, "GGK_MIN_WORK", 1)


# (ix_i, ix_j, iy, dims_i, dims_j, pin, planner) — test_gatherk.py shapes
GK_CASES = {
    "scattered_contract": (("g1", "c1", "g2", "c2", "f1"), ("c1", "c2", "n1"),
                           ("g1", "g2", "n1", "f1"), (2, 2, 4, 2, 256),
                           (2, 2, 2), 0, "gk"),
    "merged_g_runs": (("g1", "g2", "c1", "f1"), ("c1", "n1", "n2"),
                      ("g1", "g2", "n1", "n2", "f1"), (2, 2, 4, 512),
                      (4, 2, 2), 0, "gk"),
    "pinned_batch": (("b", "c1", "g1", "f1"), ("c1", "n1"),
                     ("b", "g1", "n1", "f1"), (3, 2, 2, 256), (2, 2), 1, "gk"),
    "h_equals_one": (("g1", "c1", "f1"), ("c1",), ("g1", "f1"),
                     (4, 4, 256), (4,), 0, "gk"),
    "contiguous_k64": (tuple(f"c{k}" for k in range(6)) + ("f1",),
                       tuple(f"c{k}" for k in range(6)) + ("n1",),
                       ("n1", "f1"), (2,) * 6 + (256,), (2,) * 6 + (32,),
                       0, "gk"),
    "w_on_the_left": (("c1", "n1"), ("g1", "c1", "f1"), ("g1", "n1", "f1"),
                      (2, 2), (4, 2, 256), 0, "gk"),
    "short_tail_64": (("g1", "c1", "f1"), ("c1", "n1"), ("g1", "n1", "f1"),
                      (8, 2, 64), (2, 2), 0, "gk"),
    "short_f_grid": (("g1", "c1", "c2", "f1"), ("c1", "c2", "n1"),
                     ("g1", "n1", "f1"), (8, 2, 2, 128), (2, 2, 4), 0, "gk"),
    "k16_h16": (("c1", "c2", "c3", "c4", "g1", "f1"),
                ("c1", "c2", "c3", "c4", "n1", "n2"), ("g1", "n1", "n2", "f1"),
                (2, 2, 2, 2, 2, 512), (2, 2, 2, 2, 4, 4), 0, "gk"),
    "k64_h4": (tuple(f"c{k}" for k in range(6)) + ("g1", "f1"),
               tuple(f"c{k}" for k in range(6)) + ("n1",), ("g1", "n1", "f1"),
               (2,) * 7 + (512,), (2,) * 6 + (4,), 0, "gk"),
    "k2_h1_long_f": (("c1", "g1", "f1"), ("c1", "n1"), ("g1", "n1", "f1"),
                     (2, 2, 4096), (2, 2), 0, "gk"),
    "pre_no_f_run": (("g1", "f1", "c1", "c2"), ("c1", "c2", "n1"),
                     ("g1", "n1", "f1"), (4, 256, 2, 2), (2, 2, 2), 0, "pre"),
    "pre_w_side": (("c1", "n1"), ("g1", "f1", "c1", "f2"),
                   ("g1", "n1", "f2", "f1"), (4, 2), (8, 128, 4, 3), 0, "pre"),
}


def _plans(case):
    ix_i, ix_j, iy, di, dj, pin, kind = case
    if kind == "pre":
        return (jgk.plan_gk_step_pre(ix_i, ix_j, iy, di, dj),
                pgk.plan_gk_step_pre(ix_i, ix_j, iy, di, dj))
    return (jgk.plan_gk_step(ix_i, ix_j, iy, di, dj, pin=pin),
            pgk.plan_gk_step(ix_i, ix_j, iy, di, dj, pin=pin))


def _port_step(plan, xi, xj, bi, bj, apply):
    """Run a port step on numpy operands (flat, optional width axis)."""
    pf = SplitField()
    wrap = lambda a, b: pf.reshape(pf.wrap(a, "cpu"),
                                   ((a.shape[0],) if b else ()) + (-1,))
    out = apply(pf, wrap(xi, bi), wrap(xj, bj), plan, bi, bj)
    return out[0].numpy() + 1j * out[1].numpy()


def _jax_step(plan, xi, xj, bi, bj, apply):
    """The JAX step on the same operands: vmapped over the width when an
    operand carries one (the executor's slice batching)."""
    jf = jax_make_field(np.complex64, "highest", "split")
    flat = lambda a, b: (a.reshape(a.shape[0], -1) if b else a.reshape(-1))
    xi, xj = flat(xi, bi), flat(xj, bj)
    pair = lambda a: (np.ascontiguousarray(a.real), np.ascontiguousarray(a.imag))
    one = lambda a, b: apply(jf, a, b, plan, interpret=True)
    if not (bi or bj):
        out = one(pair(xi), pair(xj))
    else:
        out = jax.vmap(one, in_axes=((0, 0) if bi else None,
                                     (0, 0) if bj else None))(
            pair(xi), pair(xj))
    return np.asarray(out[0]) + 1j * np.asarray(out[1])


MODES = {"w1": (0, False), "w4_batched_w": (4, True),
         "w4_unbatched_w": (4, False)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(GK_CASES))
def test_gk_step_matches_jax(low_thresholds, name, mode):
    ix_i, ix_j, iy, di, dj, _, _ = case = GK_CASES[name]
    jplan, pplan = _plans(case)
    assert jplan is not None, jgk.LAST_REJECT
    assert pplan is not None, pgk.LAST_REJECT
    assert (pplan.pre is not None) == (case[-1] == "pre")
    width, w_batched = MODES[mode]
    rng = np.random.default_rng(sum(name.encode()))
    # the big operand (X) carries the width; W only when w_batched
    x_is_i = pplan.w_is_j
    bi = bool(width) and (x_is_i or w_batched)
    bj = bool(width) and (not x_is_i or w_batched)
    xi = _rand(((width,) if bi else ()) + di, rng)
    xj = _rand(((width,) if bj else ()) + dj, rng)
    got = _port_step(pplan, xi, xj, bi, bj, pgk.apply_gk_step)
    want_j = _jax_step(jplan, xi, xj, bi, bj, jgk.apply_gk_step)
    lab = _lab(ix_i, ix_j, iy, ("#w",))
    w = ["#w"] if width else []
    want = np.einsum(xi, lab((w if bi else []) + list(ix_i)),
                     xj, lab((w if bj else []) + list(ix_j)),
                     lab(w + list(iy)))
    np.testing.assert_allclose(got.reshape(want.shape), want, **TOL)
    np.testing.assert_allclose(got.reshape(want.shape),
                               want_j.reshape(want.shape), **TOL)


def test_gk_rejections(low_thresholds):
    # shared batch label (aligned-gather form) is out of scope
    assert pgk.plan_gk_step(("b", "c1", "f1"), ("b", "c1", "n1"),
                            ("b", "n1", "f1"), (4, 2, 256), (4, 2, 2)) is None
    assert pgk.LAST_REJECT == "shared-batch"
    # no trailing free run
    assert pgk.plan_gk_step(("f1", "c1"), ("c1", "n1"), ("n1", "f1"),
                            (256, 2), (2, 2)) is None
    assert pgk.LAST_REJECT == "no-f-run"
    # f run below a warp's width
    assert pgk.plan_gk_step(("g1", "c1", "f1"), ("c1", "n1"),
                            ("g1", "n1", "f1"), (64, 2, 16), (2, 2)) is None
    # H legs split in iy
    assert pgk.plan_gk_step(("g1", "c1", "f1"), ("c1", "n1", "n2"),
                            ("n1", "g1", "n2", "f1"), (4, 2, 256),
                            (2, 2, 2)) is None
    assert pgk.LAST_REJECT == "h-contig"


def test_gk_output_order_matches_jax():
    args = (("g1", "c1", "g2", "c2", "f1"), ("c1", "c2", "n1"),
            {"g1", "g2", "n1", "f1"}, (2, 2, 4, 2, 256), (2, 2, 2))
    assert pgk.gk_output_order(*args) == jgk.gk_output_order(*args)
    args = (("b", "c1", "g1", "f1"), ("c1", "n1"), {"b", "g1", "n1", "f1"},
            (5, 2, 2, 128), (2, 2))
    assert pgk.gk_output_order(*args, pin=1) \
        == jgk.gk_output_order(*args, pin=1)
    assert pgk.gk_output_order(*args, consumer_contract=("g1",)) \
        == jgk.gk_output_order(*args, consumer_contract=("g1",))


def test_wk_index_matches_jax(low_thresholds):
    for name, case in GK_CASES.items():
        jplan, pplan = _plans(case)
        np.testing.assert_array_equal(pplan.wk_idx, jplan.wk_idx, name)
        assert pplan.w_perm == jplan.w_perm and pplan.w_dims == jplan.w_dims


# -- gathered steps: (rx_i, rx_j, riy, rd_i, rd_j, B, bi, bj, row kind) ------
_PATH_X = tuple(f"d{i}" for i in range(15))
_PATH_W = tuple(f"d{i}" for i in (11, 2, 3, 4, 5, 6, 7, 8, 9, 10, 0)) \
    + ("n0", "n1")
GGK_CASES = {
    "gk_row": (("k0", "k1", "f0", "f1"), ("k0", "k1", "h"), ("h", "f0", "f1"),
               (2, 4, 2, 128), (2, 4, 2), 24, 6, 5, "gk"),
    "gk_row_grid_leg": (("g", "k", "f0", "f1"), ("k", "h"),
                        ("g", "h", "f0", "f1"), (3, 4, 2, 128), (4, 2),
                        17, 4, 3, "gk"),
    # the 1k path's K 16 H 16 F 512 GGK step (the mma form's N tile of 16
    # and K chunk of 16 on the card), B cut from 894 to 20
    "gk_row_1k_k16_h16_f512": (("k0", "k1", "k2", "k3", "f"),
                               ("k0", "k1", "k2", "k3", "h0", "h1", "h2",
                                "h3"),
                               ("h0", "h1", "h2", "h3", "f"),
                               (2, 2, 2, 2, 512), (2,) * 8, 20, 6, 4, "gk"),
    "rg_interleaved": (("k0", "k1", "f0", "k2", "f1"), ("k1", "k0", "k2", "h"),
                       ("h", "f0", "f1"), (4, 2, 2, 16, 4), (2, 4, 16, 2),
                       40, 7, 6, "rg"),
    "rg_h_trailing": (("k0", "f0", "k1"), ("k0", "k1", "h"), ("f0", "h"),
                      (8, 4, 16), (8, 16, 2), 24, 5, 4, "rg"),
    "rg_h1": (("k0", "f0", "k1"), ("k1", "k0"), ("f0",), (8, 4, 16), (16, 8),
              24, 5, 4, "rg"),
    "rg_no_frees": (("k0", "k1"), ("k1", "k0", "h"), ("h",), (16, 16),
                    (16, 16, 4), 24, 5, 4, "rg"),
    # the 1k path's RGRow row (K 2048 H 4 F 16): 15 binary digits, three of
    # the four free ones minor in storage (pre_perm (12, 13, 1, 14, 0,
    # 2..11)), W's contract digits in another order than X's
    "rg_path_row": (_PATH_X, _PATH_W, ("n0", "n1", "d12", "d13", "d1", "d14"),
                    (2,) * 15, (2,) * 13, 7, 3, 4, "rg"),
    # flat rows (tests/test_gatherk.py:769-818): K = 32 scattered, frees
    # interleaved; then fresh W legs leading and a W digit order that
    # differs from X's contract order
    "rgf_basic": (("f0", "f1", "k0", "k1", "k2", "k3", "k4", "f2", "f3"),
                  ("k0", "k1", "k2", "k3", "k4"), ("f0", "f1", "f2", "f3"),
                  (2,) * 9, (2,) * 5, 23, 6, 5, "rgf"),
    "rgf_fresh_legs": (("f0", "k0", "k1", "k2", "k3", "k4", "f1", "f2"),
                       ("k2", "k0", "k4", "k1", "k3", "h0", "h1"),
                       ("h0", "h1", "f0", "f1", "f2"),
                       (2,) * 8, (2,) * 7, 19, 5, 4, "rgf"),
}
ROW_TYPE = {"gk": "GKPlan", "rg": "RGRow", "rgf": "RGFlat"}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(GGK_CASES))
def test_ggk_step_matches_jax(low_thresholds, name, mode):
    rx_i, rx_j, riy, rd_i, rd_j, B, bi_rows, bj_rows, kind = GGK_CASES[name]
    rng = np.random.default_rng(len(name) * 7 + len(mode))
    gi = rng.integers(0, bi_rows, B)
    gj = rng.integers(0, bj_rows, B)
    sidx = np.lexsort((gj, gi))
    gi, gj = gi[sidx], gj[sidx]
    jplan = jgk.plan_ggk_step(rx_i, rx_j, riy, rd_i, rd_j, gi.astype(np.int32),
                              gj.astype(np.int32), bi_rows, bj_rows)
    pplan = pgk.plan_ggk_step(rx_i, rx_j, riy, rd_i, rd_j, gi, gj,
                              bi_rows, bj_rows)
    assert jplan is not None, jgk.LAST_REJECT
    assert pplan is not None, pgk.LAST_REJECT
    assert type(pplan.row).__name__ == ROW_TYPE[kind]
    assert type(jplan.row).__name__ == ROW_TYPE[kind]
    width, w_batched = MODES[mode]
    x_is_i = pplan.w_is_j
    b_i = bool(width) and (x_is_i or w_batched)
    b_j = bool(width) and (not x_is_i or w_batched)
    xi = _rand(((width,) if b_i else ()) + (bi_rows, *rd_i), rng)
    xj = _rand(((width,) if b_j else ()) + (bj_rows, *rd_j), rng)
    got = _port_step(pplan, xi, xj, b_i, b_j, pgk.apply_ggk_step)
    want_j = _jax_step(jplan, xi, xj, b_i, b_j, jgk.apply_ggk_step)
    lab = _lab(rx_i, rx_j, riy, ("#w", "#b"))
    w = ["#w"] if width else []
    xg = np.take(xi, gi, axis=1 if b_i else 0)
    wg = np.take(xj, gj, axis=1 if b_j else 0)
    want = np.einsum(xg, lab((w if b_i else []) + ["#b"] + list(rx_i)),
                     wg, lab((w if b_j else []) + ["#b"] + list(rx_j)),
                     lab(w + ["#b"] + list(riy)))
    np.testing.assert_allclose(got.reshape(want.shape), want, **TOL)
    np.testing.assert_allclose(got.reshape(want.shape),
                               want_j.reshape(want.shape), **TOL)


def test_rg_path_row_plan():
    """The path row plans as the 1k scheme's RGRow step does, and the
    kernel's vector lanes cover 4 of its free cells a load."""
    rx_i, rx_j, riy, rd_i, rd_j = GGK_CASES["rg_path_row"][:5]
    row = pgk.plan_rg_row(rx_i, rx_j, riy, rd_i, rd_j)
    jrow = jgk.plan_rg_row(rx_i, rx_j, riy, rd_i, rd_j)
    assert (row.F, row.K, row.H, row.hy_first) == (16, 2048, 4, True)
    assert row.pre_perm == jrow.pre_perm == (12, 13, 1, 14, 0, *range(2, 12))
    assert row.w_perm == jrow.w_perm == (11, 12, 10, *range(1, 10), 0)
    assert pgk.rg_lanes(row)[0] == 4


@pytest.mark.parametrize("name", sorted(n for n, c in GGK_CASES.items()
                                        if c[-1] == "rg"))
def test_rg_tables_address_canonical_rows(name):
    """The RGRow kernel's tables read the canonical (F, K) X row and
    (H, K) W row out of the stored ones: the free cells in groups of V at
    consecutive stored offsets (``rg_lanes``), every offset a multiple of
    V, and x[f, k] = stored[foff[f] + koff[k]] equal to the JAX package's
    reordered row."""
    rx_i, rx_j, riy, rd_i, rd_j = GGK_CASES[name][:5]
    row = pgk.plan_rg_row(rx_i, rx_j, riy, rd_i, rd_j)
    V, fgoff, fcan = pgk.rg_lanes(row)
    assert sorted(fcan) == list(range(row.F))
    lanes = (fgoff[:, None] + np.arange(V)[None, :]).reshape(-1)
    np.testing.assert_array_equal(lanes, row.foff[fcan])
    assert not (fgoff % V).any() and not (row.koff % V).any()
    x = np.arange(np.prod(row.row_dims))
    canon = x.reshape(row.row_dims)
    if row.pre_perm is not None:
        canon = canon.transpose(row.pre_perm)
    np.testing.assert_array_equal(
        x[row.foff[:, None] + row.koff[None, :]].reshape(-1),
        canon.reshape(-1))
    assert (row.wk_idx == row.wk_idx[:, :1] + row.wk_idx[:1, :]).all()


def test_ggk_rejections():
    gi = np.zeros(8, np.int64)
    assert pgk.plan_ggk_step(("k", "f"), ("k", "h"), ("h", "f"), (2, 256),
                             (2, 1 << 14), gi, gi, 2, 2) is None
    assert pgk.plan_ggk_step(("k", "f"), ("k", "h"), ("h", "f"), (2, 128),
                             (2, 2), gi, gi, 2, 2) is None
    assert pgk.LAST_REJECT == "ggk:small"


_FLAT_X = ("f0", "f1", "k0", "k1", "k2", "k3", "k4", "f2", "f3")
_FLAT_K = ("k0", "k1", "k2", "k3", "k4")
# (rx_i, rx_j, riy, rd_i, rd_j): the flat-row shapes and rejection cases
# of tests/test_gatherk.py:769-842, and one case for each remaining gate;
# a rejection case is named after the gate that rejects it
RGF_ACCEPTED = {"basic", "fresh_legs", "w_on_the_left", "no_frees"}
RGF_CASES = {
    "basic": (_FLAT_X, _FLAT_K, ("f0", "f1", "f2", "f3"), (2,) * 9, (2,) * 5),
    "fresh_legs": (("f0", "k0", "k1", "k2", "k3", "k4", "f1", "f2"),
                   ("k2", "k0", "k4", "k1", "k3", "h0", "h1"),
                   ("h0", "h1", "f0", "f1", "f2"), (2,) * 8, (2,) * 7),
    "w_on_the_left": (_FLAT_K + ("h",), _FLAT_X,
                      ("h", "f0", "f1", "f2", "f3"), (2,) * 6, (2,) * 9),
    "no_frees": (("k0", "k1"), ("k1", "k0", "h"), ("h",), (16, 16),
                 (16, 16, 4)),
    "row_small": (("f0", "k0", "k1", "f1"), ("k0", "k1"), ("f0", "f1"),
                  (2, 2, 2, 2), (2, 2)),
    "f_order": (_FLAT_X, _FLAT_K, ("f2", "f3", "f0", "f1"), (2,) * 9,
                (2,) * 5),
    "h_lead": (_FLAT_X, _FLAT_K + ("h",), ("f0", "f1", "f2", "f3", "h"),
               (2,) * 9, (2,) * 6),
    "row_big": (("f0", "k0", "f1"), ("k0",), ("f0", "f1"), (256, 4, 64),
                (4,)),
    "h_cap": (_FLAT_X, _FLAT_K + ("h",), ("h", "f0", "f1", "f2", "f3"),
              (2,) * 9, (2,) * 5 + (16,)),
    "hk_cap": (("f0", "k0"), ("k0", "h"), ("h", "f0"), (8, 4096),
               (4096, 8)),
    "no_contract": (("f0", "f1"), ("h",), ("h", "f0", "f1"), (16, 16), (2,)),
    "w_legs": (_FLAT_X, _FLAT_K + ("z",), ("f0", "f1", "f2", "f3"),
               (2,) * 9, (2,) * 6),
    "y_legs": (_FLAT_X, _FLAT_K, ("f0", "f1", "f2", "f3", "z"), (2,) * 9,
               (2,) * 5),
    "dup": (_FLAT_X, _FLAT_K, ("f0", "f0", "f2", "f3"), (2,) * 9, (2,) * 5),
    "shared_batch": (_FLAT_X + ("s",), _FLAT_K + ("s",),
                     ("s", "f0", "f1", "f2", "f3"), (2,) * 10, (2,) * 6),
}


@pytest.mark.parametrize("name", sorted(RGF_CASES))
def test_rg_flat_plan_matches_jax(name):
    """The port's plan_rg_flat accepts and rejects exactly where the JAX
    planner does, with the same reject string; an accepted plan has the
    same H, K, F, W preparation and output dims, and its address table
    is the JAX kernel's two 0/1 digit maps (E: k -> addresses, M:
    address -> f) as one (F, K) table."""
    case = RGF_CASES[name]
    jgk.LAST_REJECT = pgk.LAST_REJECT = None
    jrow = jgk.plan_rg_flat(*case)
    prow = pgk.plan_rg_flat(*case)
    assert (prow is None) == (jrow is None), (jgk.LAST_REJECT,
                                               pgk.LAST_REJECT)
    assert (prow is not None) == (name in RGF_ACCEPTED), pgk.LAST_REJECT
    if jrow is None:
        assert pgk.LAST_REJECT == jgk.LAST_REJECT
        assert pgk.LAST_REJECT == "rgf:" + name.replace("_", "-")
        return
    assert (prow.H, prow.K, prow.F) == (jrow.H, jrow.K, max(jrow.F, 1))
    assert prow.xrow == jrow.view_x[0]
    assert (prow.dims_y, prow.w_is_j, prow.w_dims, prow.w_perm) \
        == (jrow.dims_y, jrow.w_is_j, jrow.w_dims, jrow.w_perm)
    np.testing.assert_array_equal(prow.wk_idx, jrow.wk_idx)
    e = np.zeros_like(jrow.e_mat)
    m = np.zeros_like(jrow.m_mat)
    f, k = np.indices(prow.addr.shape)
    e[k.ravel(), prow.addr.ravel()] = 1
    m[prow.addr.ravel(), f.ravel()] = 1
    np.testing.assert_array_equal(e, jrow.e_mat)
    np.testing.assert_array_equal(m, jrow.m_mat)


def test_ggk_rejection_names_all_three_row_forms(low_thresholds):
    """An aligned step that fits no row form names each form's reject
    reason, GK row, RGRow then RGFlat (the 10k plan's last gathered step
    class: a 16-element row)."""
    gi = np.arange(24) % 5
    gj = np.arange(24) % 4
    assert pgk.plan_ggk_step(("f0", "k0", "k1", "f1"), ("k0", "k1"),
                             ("f0", "f1"), (2, 2, 2, 2), (2, 2), gi, gj,
                             5, 4) is None
    assert pgk.LAST_REJECT == "ggk:row-no-f-run/rg:k-small/rgf:row-small"


def test_wrappers_validate_operands(low_thresholds):
    case = GK_CASES["scattered_contract"]
    _, plan = _plans(case)
    x = torch.zeros(plan.x_elems)
    w = torch.zeros(plan.H * plan.K)
    with pytest.raises(ValueError, match="shape"):
        pgk.gk_call(plan, x[:-1], x[:-1], w, w, False, False)
    with pytest.raises(TypeError, match="float32"):
        pgk.gk_call(plan, x.double(), x.double(), w, w, False, False)
    xs = torch.zeros(plan.x_elems, 2)[:, 0]     # strided view
    with pytest.raises(ValueError, match="contiguous"):
        pgk.gk_call(plan, xs, xs, w, w, False, False)
    before = pgk.gk_call.launches
    pgk.gk_call(plan, x, x, w, w, False, False)
    assert pgk.gk_call.launches == before   # CPU: plain version, no launch


@pytest.mark.parametrize("name", sorted(GK_CASES))
def test_gk_einsum_yardstick_matches_plain(low_thresholds, name):
    """The one-call ``torch.einsum`` that ``chip_smoke.py`` times beside
    the GK kernel (X in its logical shape from ``x_dims`` / ``x_roles``)
    computes what the plain GK version computes."""
    import chip_smoke

    _, plan = _plans(GK_CASES[name])
    assert plan is not None, pgk.LAST_REJECT
    assert len(plan.x_dims) == len(plan.x_roles)
    assert np.prod(plan.x_dims) == plan.x_elems
    gen = torch.Generator().manual_seed(5)
    W = 3
    x = [torch.randn((W, plan.x_elems), generator=gen) for _ in "ri"]
    w = [torch.randn((plan.H * plan.K,), generator=gen) for _ in "ri"]
    call, view, shape = chip_smoke.gk_library(plan, *x, *w, True, False)
    pr, pi = pgk.gk_plain(plan, *x, *w, True, False)
    np.testing.assert_allclose(call().reshape(shape).numpy(),
                               view(pr, pi).numpy(), **TOL)


# the GGK steps of the n30 paths as chip_smoke.py runs them (width 32):
# (K, H, F, G) -> the form gatherk.gk_form picks.  The 1k K 16 H 16 step
# runs on the tensor cores (wgmma: X slice-invariant, its N tile 16 wide
# and its K chunk 16 deep); the F 64 steps stream (no 128-row tile fits
# an outer index).
GGK_PATH_FORMS = {
    "1k": {(16, 16, 512, 1): "mma", (2, 2, 64, 64): "stream"},
    "10k": {(32, 2, 64, 1): "stream"},
}
# the same steps at the default form's widths (1k 64, 10k 128) and width
# 1, each with its own batching: (K, H, F, G) -> (x batched, w batched,
# form)
GGK_DEFAULT_WIDTH_FORMS = {
    ("1k", 64): {(16, 16, 512, 1): (False, True, "mma"),
                 (2, 2, 64, 64): (True, False, "stream")},
    ("10k", 128): {(32, 2, 64, 1): (True, True, "stream")},
    ("1k", 1): {(16, 16, 512, 1): (False, True, "mma"),
                (2, 2, 64, 64): (True, False, "stream")},
}


@pytest.mark.parametrize("name", sorted(GGK_PATH_FORMS))
def test_ggk_form_of_every_path_step(name):
    """``gk_form`` on each GGK step of the committed plans, with the
    step's operand batching: bytes against flops as for GK, counting only
    the rows the targets name, and stream wherever the f run does not
    fill the mma form's 128-wide tile or K is below ``GGK_MMA_K_MIN``."""
    import chip_smoke

    path = chip_smoke.compile_path(name, 32)
    got = {}
    for plan, bx, by in path["cases"]["ggk"]:
        xs, ws = (bx, by) if plan.w_is_j else (by, bx)
        row = plan.row
        got[(row.K, row.H, row.F, len(row.xoff))] = pgk.gk_form(
            plan, 32, xs, ws)
        assert pgk.gk_aligned(plan)
        if row.F % pgk.MMA_TILE_M or row.K < pgk.GGK_MMA_K_MIN:
            assert got[(row.K, row.H, row.F, len(row.xoff))] == "stream"
    assert got == GGK_PATH_FORMS[name]


@pytest.mark.parametrize("name,width", sorted(GGK_DEFAULT_WIDTH_FORMS))
def test_ggk_form_at_default_widths(name, width):
    """``gk_form`` on each GGK step at the default form's width (and at
    width 1, where ``chip_smoke.py`` also runs the largest step), with the
    step's real batching: the 1k K 16 H 16 step's X is slice-invariant and
    its W batched; bytes against flops then count X once.  The mma form
    is the faster one there at widths 1, 32 and 64 on the card
    (``scripts/ggk_wgmma_torch_port.py``)."""
    import chip_smoke

    path = chip_smoke.compile_path(name, width)
    got = {}
    for plan, bx, by in path["cases"]["ggk"]:
        xs, ws = (bx, by) if plan.w_is_j else (by, bx)
        row = plan.row
        got[(row.K, row.H, row.F, len(row.xoff))] = (
            xs, ws, pgk.gk_form(plan, width, xs, ws))
    assert got == GGK_DEFAULT_WIDTH_FORMS[(name, width)]


def test_ggk_form_rules(low_thresholds):
    """A GGK step goes to the mma form only where the GK rule would (bytes
    against flops) and its f run fills whole 128-row tiles and K is at
    least ``GGK_MMA_K_MIN`` (16, the narrow kernel's K chunk); otherwise
    it streams."""
    gi = np.repeat(np.arange(40), 2)
    gj = np.arange(80) % 8

    def form(k, h, f, x_batched):
        plan = pgk.plan_ggk_step(("k", "f"), ("k", "h"), ("h", "f"), (k, f),
                                 (k, h), gi, gj, 40, 8)
        return pgk.gk_form(plan, 32, x_batched, True)

    assert form(64, 64, 512, True) == "mma"
    assert form(64, 64, 512, False) == "mma"
    assert form(64, 64, 192, True) == "stream"      # F not a tile multiple
    assert form(16, 64, 512, False) == "mma"        # K at the floor
    assert form(16, 16, 512, False) == "mma"        # the 1k step's shape
    assert form(14, 64, 512, False) == "stream"     # K below the floor
    assert form(4, 4, 512, True) == "stream"        # bytes bound it



# -- the RGFlat kernel's index scheme, modelled in numpy ---------------------

def _rgf_model(plan, x, w, w_batched, x_aligned=True):
    """What ``csrc/rgflat.cu`` computes, block by block, from the tables
    and launch geometry the wrapper passes it (``rgf_tables``,
    ``rgf_geometry``): the staged route's runs of NS stages of T
    consecutive targets (a stage is T stored X rows), the direct route's
    item tiles of one target, items of V free cells at ``fgoff`` over
    ``koff``, W read at ``whoff + wkoff`` of its stored row, the k loop
    split over KS lanes and their partial sums added.  ``x``: (W, X)
    complex, ``w``: (W or 1, W rows) complex.  Asserts that every output
    is written exactly once."""
    g = pgk.rgf_geometry(plan, x_aligned)
    row = plan.row
    F, K, H, V, KS = row.F, row.K, row.H, g["V"], g["KS"]
    FG = F // V
    tab = pgk.rgf_tables(row, V)
    assert tab.dtype == np.int16 and len(tab) % 4 == 0
    tab = tab.astype(np.int64)
    koff, wkoff = tab[:K], tab[K:2 * K]
    fgoff, whoff = tab[2 * K:2 * K + FG], tab[2 * K + FG:2 * K + FG + H]
    cell = (koff[None, :, None] + fgoff[:, None, None]
            + np.arange(V)[None, None, :])                # (FG, K, V)
    widx = whoff[:, None] + wkoff[None, :]                 # (H, K)
    lanes = [np.arange(s, K, KS) for s in range(KS)]
    W = x.shape[0]
    y = np.zeros((W, plan.B * H * F), complex)
    hits = np.zeros(y.shape, int)

    def items(s, b0, nt, g0, gn, rows):
        b = b0 + np.arange(nt)
        ws = w[s if w_batched else 0].reshape(-1, H * K)[plan.gj[b]][:, widx]
        xs = rows[:, cell[g0:g0 + gn]]                     # (nt, gn, K, V)
        acc = sum(np.einsum("tgkv,thk->thgv", xs[:, :, k], ws[:, :, k])
                  for k in lanes)
        o = (b[:, None, None, None] * (H * F)
             + np.arange(H)[None, :, None, None] * F
             + (g0 + np.arange(gn))[None, None, :, None] * V
             + np.arange(V)[None, None, None, :])
        y[s, o.ravel()] = acc.ravel()
        np.add.at(hits[s], o.ravel(), 1)

    for s in range(W):
        xw = x[s].reshape(-1, F * K)
        for blk in range(g["blocks"]):
            if g["T"]:
                for st in range(g["NS"]):
                    b0 = (blk * g["NS"] + st) * g["T"]
                    nt = min(g["T"], plan.B - b0)
                    if nt <= 0:
                        break
                    items(s, b0, nt, 0, FG, xw[plan.gi[b0:b0 + nt]])
            else:
                per = pgk.RGF_THREADS // KS
                b, tile = divmod(blk, -(-FG // per))
                g0 = tile * per
                items(s, b, 1, g0, min(per, FG - g0), xw[plan.gi[b:b + 1]])
    assert (hits == 1).all()
    return y, g


def _rgf_check(plan, w_batched, x_aligned=True, width=2, seed=0):
    rng = np.random.default_rng(seed)
    row = plan.row
    x = _rand((width, plan.bi_rows * row.xrow), rng).astype(complex)
    w = _rand((width if w_batched else 1, plan.bj_rows * row.H * row.K),
              rng).astype(complex)
    got, g = _rgf_model(plan, x, w, w_batched, x_aligned)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    wa = w if w_batched else w[0]
    pr, pi = pgk.rgflat_plain(plan, t(x.real), t(x.imag), t(wa.real),
                              t(wa.imag), True, w_batched)
    want = pr.numpy() + 1j * pi.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
    return g


def _rcs15_rgflat(monkeypatch):
    """The RGFlat step of the committed small plan's port scheme (gates
    lowered as in tests/test_torch_sparse.py)."""
    import json
    import os

    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.runtime.sparse import kernel_kind

    monkeypatch.setattr(pgk, "MIN_X_ELEMS", 1 << 8)
    monkeypatch.setattr(pgk, "GGK_MIN_WORK", 1 << 8)
    with open(os.path.join(os.path.dirname(__file__), "data",
                           "torch_port_rcs15_rgflat_plan.json")) as f:
        plan = json.load(f)
    n, layers = random_circuit(3, 5, 8, seed=13)
    rng = np.random.default_rng(4)
    bits = [np.binary_repr(b, n)
            for b in rng.choice(2 ** n, 128, replace=False)]
    sim = TensorNetworkSimulation.from_circuit((n, layers), bits).load_plan(
        plan)
    (step,) = [s.lane for s in sim.steps if kernel_kind(s) == "rgflat"]
    return step


# the RGFlat steps of the paths: (H, K, F, B) -> the geometry rgf_geometry
# gives them with aligned buffers (the W rows of a slice instance staged)
RGF_PATH_GEOMETRY = {
    "10k": ((2, 16, 8, 9996), dict(V=4, T=32, NS=2, KS=4, cp16=True,
                                   wn=1024, blocks=157)),
    "1k-sc25": ((1, 32, 32, 1000), dict(V=4, T=4, NS=2, KS=8, cp16=True,
                                        wn=1024, blocks=125)),
}


@pytest.mark.parametrize("name", sorted(RGF_PATH_GEOMETRY) + ["rcs15"])
def test_rgflat_kernel_model_matches_plain(monkeypatch, name):
    """The numpy model of the RGFlat kernel's index scheme equals
    ``rgflat_plain`` on the RGFlat step of the 10k and 1k-sc25 paths (as
    ``chip_smoke.py`` compiles them) and of the committed small plan,
    with X batched and W as the path batches it; the path steps take
    the staged route with 16-byte copies, V = 4 and W staged."""
    import chip_smoke

    if name == "rcs15":
        plan, w_batched = _rcs15_rgflat(monkeypatch), True
    else:
        path = chip_smoke.compile_path(name, 32)
        ((plan, bx, by),) = path["cases"]["rgflat"]
        w_batched = by if plan.w_is_j else bx
        shape, geometry = RGF_PATH_GEOMETRY[name]
        row = plan.row
        assert (row.H, row.K, row.F, plan.B) == shape
        assert pgk.rgf_geometry(plan) == geometry
    g = _rgf_check(plan, w_batched)
    assert g["T"] > 0 and g["cp16"]


# (rx_i, rx_j, riy, rd_i, rd_j, B, bi_rows, bj_rows): a row of RG_ROW_CAP
# elements (the direct route), and a staged one whose W rows pass
# RGF_W_STAGE (read through L1)
RGF_ROUTES = {
    "cap_row": (("f0", "k0", "f1", "k1", "f2"), ("k1", "h", "k0"),
                ("h", "f0", "f1", "f2"), (8, 4, 16, 16, 4), (16, 2, 4),
                12, 7, 5),
    "w_unstaged": (("k0", "f0", "k1", "f1"), ("k1", "k0", "h"),
                   ("h", "f0", "f1"), (4, 3, 8, 8), (8, 4, 8), 73, 30, 40),
}


@pytest.mark.parametrize("x_aligned", [True, False])
@pytest.mark.parametrize("name", sorted(RGF_ROUTES))
def test_rgflat_kernel_model_routes(low_thresholds, name, x_aligned):
    """The model on the routes the paths do not take: the direct route of
    a 2^15-element row (V 1 where X is not 16-byte aligned), and a staged
    route with W read through L1 and 4-byte copies; a ragged last stage
    and targets repeating and skipping X rows."""
    *case, B, bi, bj = RGF_ROUTES[name]
    rng = np.random.default_rng(3)
    gi = np.sort(rng.integers(0, bi, B))
    gj = rng.integers(0, bj, B)
    plan = pgk.plan_ggk_step(*case, gi, gj, bi, bj)
    assert isinstance(plan.row, pgk.RGFlat), pgk.LAST_REJECT
    g = _rgf_check(plan, True, x_aligned)
    if name == "cap_row":
        assert plan.row.xrow == pgk.RG_ROW_CAP and g["T"] == 0
        assert g["V"] == (4 if x_aligned else 1)
    else:
        assert g["T"] > 0 and g["wn"] == 0 and g["cp16"] == x_aligned
        assert plan.B % (g["T"] * g["NS"])
