"""Pair steps: both-big complex products, their planner, the wrapper of the
pair CUDA kernel and its plain PyTorch version.

Port of the pair half of ``artensor_tpu/runtime/lanes.py`` (``PairPlan``,
``plan_pair_step``, ``apply_pair_step``).  The lane kernel, its planner
(``plan_lane_step``, ``schedule_step``) and ``prune_lane_plans`` are not
ported yet.

A pair step contracts two big operands whose contract legs can be brought
to the front of both: ``(K, M)^T . (K, N) -> (M, N)``.  The planner keeps
the JAX step-form logic (grouped output rows, ``re_i`` / ``re_j`` input
reorders to the (contract, rows) form, the ``v_perm`` row gather when only
j's contract-digit order differs) and drops the TPU limits: the 256-tile
and ``PAIR_K_CAP`` shape rules (the CUDA kernel masks ragged tiles and
walks any K) and the MXU roofline gate (every step that passes the
step-form checks runs the kernel).
"""

from dataclasses import dataclass
from functools import reduce
from operator import mul

import numpy as np
import torch

from .. import kernels
from .lowering import apply_reorder, physical_shape, plan_reorder

SMALL_W_ELEMS = 1 << 13  # "small operand" bound: such steps belong to GK

LAST_REJECT = None


def _prod(xs):
    return reduce(mul, xs, 1)


def _rej(msg):
    global LAST_REJECT
    LAST_REJECT = msg
    return None


@dataclass(frozen=True)
class PairPlan:
    """Fused complex product for steps where BOTH operands are big."""

    K: int
    M: int
    N: int
    v_perm: object       # int64 K-permutation of j's rows (or None)
    dims_y: tuple
    flops: int
    re_i: object = None  # input Reorder to (contract, rows) form (or None)
    re_j: object = None


def plan_pair_step(ix_i, ix_j, iy, dims_i, dims_j):
    """Build a PairPlan, or None if the step does not fit."""
    set_i, set_j, set_y = set(ix_i), set(ix_j), set(iy)
    if set_i & set_j & set_y:
        return _rej("pair-shared")
    if _prod(dims_i) <= SMALL_W_ELEMS or _prod(dims_j) <= SMALL_W_ELEMS:
        return _rej("pair-small")
    dim_of = {}
    for l, d in zip(ix_i, dims_i):
        dim_of[l] = int(d)
    for l, d in zip(ix_j, dims_j):
        dim_of[l] = int(d)
    contract = [l for l in ix_i if l in set_j and l not in set_y]
    nc = len(contract)
    if not nc:
        return _rej("pair-outer")
    rows_i = [l for l in ix_i if l not in set(contract)]
    rows_j = [l for l in ix_j if l not in set(contract)]
    if set(rows_i) & set_j or set(rows_j) & set_i:
        return _rej("pair-extra-shared")
    # iy must group i-rows then j-rows; within each group any order works
    # (the input reorders absorb it)
    if tuple(iy) != tuple([l for l in iy if l in set(rows_i)]
                          + [l for l in iy if l in set(rows_j)]):
        return _rej("pair-iy")
    rows_i = [l for l in iy if l in set(rows_i)]
    rows_j = [l for l in iy if l in set(rows_j)]

    def _pre(ix, rows):
        want = tuple(contract) + tuple(rows)
        if tuple(ix) == want:
            return None
        pos = {l: k for k, l in enumerate(ix)}
        return plan_reorder(tuple(dim_of[l] for l in ix),
                            tuple(pos[l] for l in want),
                            (_prod(dim_of[l] for l in contract),
                             _prod(dim_of[l] for l in rows)))

    re_i = _pre(ix_i, rows_i)
    K = _prod(dim_of[l] for l in contract)
    M = _prod(dim_of[l] for l in rows_i)
    N = _prod(dim_of[l] for l in rows_j)
    v_perm = None
    if set(ix_j[:nc]) == set(contract) and tuple(ix_j[nc:]) == tuple(rows_j):
        # only j's contract-digit order differs: align its K rows to i's
        # order with one row gather (whole contiguous rows) instead of a
        # full reorder
        re_j = None
        if tuple(ix_j[:nc]) != tuple(contract):
            strides = {}
            s = 1
            for l in reversed(ix_j[:nc]):
                strides[l] = s
                s *= dim_of[l]
            rem = np.arange(K, dtype=np.int64)
            digits = {}
            for l in reversed(contract):
                digits[l] = rem % dim_of[l]
                rem = rem // dim_of[l]
            v_perm = sum(digits[l] * strides[l] for l in contract)
    else:
        re_j = _pre(ix_j, rows_j)
    dims_y = tuple(dim_of[l] for l in iy)
    return PairPlan(K, M, N, v_perm, dims_y, 8 * M * N * K, re_i, re_j)


def pair_plain(plan, xr, xi, vr, vi, x_batched, v_batched):
    """Plain version of the pair kernel (same operands as ``pair_call``):
    the four real products of X^T . V with ``torch.matmul``."""
    K, M, N = plan.K, plan.M, plan.N
    lead = (kernels.slice_width(x_batched, v_batched, xr, vr),) \
        if (x_batched or v_batched) else ()
    xt = lambda c: c.reshape(((c.shape[0],) if x_batched else ())
                             + (K, M)).transpose(-1, -2)
    vv = lambda c: c.reshape(((c.shape[0],) if v_batched else ()) + (K, N))
    re = torch.matmul(xt(xr), vv(vr)) - torch.matmul(xt(xi), vv(vi))
    im = torch.matmul(xt(xr), vv(vi)) + torch.matmul(xt(xi), vv(vr))
    return (re.reshape(lead + (M * N,)).contiguous(),
            im.reshape(lead + (M * N,)).contiguous())


def pair_call(plan, xr, xi, vr, vi, x_batched, v_batched):
    """The pair kernel's wrapper.  ``xr``/``xi``: X as ``(K*M,)`` or
    ``(W, K*M)`` in (K, M) row-major form; ``vr``/``vi``: V as ``(K*N,)``
    or ``(W, K*N)``.  Returns Y ``(M*N,)`` or ``(W, M*N)``."""
    K, M, N = plan.K, plan.M, plan.N
    W = kernels.slice_width(x_batched, v_batched, xr, vr)
    xl = (W,) if x_batched else ()
    vl = (W,) if v_batched else ()
    dev = kernels.check_operands("pair", (xr, xi, vr, vi),
                                 (xl + (K * M,),) * 2 + (vl + (K * N,),) * 2)
    if dev.type == "cpu":
        return pair_plain(plan, xr, xi, vr, vi, x_batched, v_batched)
    lead = (W,) if (x_batched or v_batched) else ()
    yr = torch.empty(lead + (M * N,), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    lib = kernels.load()
    rc = lib.pair_launch(
        *map(kernels.ptr, (xr, xi, vr, vi, yr, yi)), K, M, N,
        K * M if x_batched else 0, K * N if v_batched else 0,
        M * N if lead else 0, W, kernels.stream_of(xr))
    kernels.check(rc, "pair")
    pair_call.launches += 1
    return yr, yi


pair_call.launches = 0


def apply_pair_step(field, x, y, plan, bx=False, by=False):
    """Execute a both-big pair step on SplitField pairs: the input reorders
    and the ``v_perm`` row gather, then the kernel.  ``bx``/``by``: the
    operand carries a leading slice-width axis."""
    xlead = (x[0].shape[0],) if bx else ()
    ylead = (y[0].shape[0],) if by else ()
    if plan.re_i is not None:
        x = apply_reorder(field, x, plan.re_i, xlead)
    if plan.re_j is not None:
        y = apply_reorder(field, y, plan.re_j, ylead)
    vs = field.reshape(y, ylead + (plan.K, plan.N))
    if plan.v_perm is not None:
        vs = field.take(vs, plan.v_perm, axis=len(ylead))
    xr, xi = (c.reshape(xlead + (-1,)).contiguous() for c in x)
    vr, vi = (c.reshape(ylead + (-1,)).contiguous() for c in vs)
    yr, yi = pair_call(plan, xr, xi, vr, vi, bx, by)
    return field.reshape((yr, yi), (xlead or ylead)
                         + physical_shape(plan.dims_y))
