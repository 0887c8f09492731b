"""Gather-K (GK), gathered gather-K (GGK), RGRow and RGFlat steps:
planners, wrappers of their CUDA kernels, and the kernels' plain PyTorch
versions.

Port of ``artensor_tpu/runtime/gatherk.py``.  The dominant step form of the
sparse scheme is

    Y[free..., new...] = sum_K  X[free..., K scattered ...] . W[K, new]

with a big X and a small W (K*H <= HK_CAP).  Every free X leg outside the
trailing free run is an outer index, the scattered contract legs become one
table of K row offsets, and the trailing free run f is contiguous in X and
in Y — so each outer index is one (H x K) . (K x F) product read straight
from X's storage, with no transpose.  Aligned (both-batched) steps run the
same product per gathered row (GGK), or the reduction forms for rows whose
free cells are too few for an f run: RGRow when the contract run is long,
else RGFlat over the row as stored.

The planners keep the JAX package's step-form logic: which legs are grid,
contract, fresh or free, the ``wk_idx`` / ``w_perm`` preparation of W, the
``pre`` / ``pre_perm`` reorders and the output placement.  They drop the
TPU cost model and Mosaic limits (``est_s``, ``SLACK``,
``xla_step_estimate``, the VMEM budget, ``VIEW_RANK_CAP``, the ``fm`` lane
split, ``gt`` grid blocking, ``qb`` MXU packing, ``use_mxu``, ``GRID_CAP``)
and take the CUDA kernels' own limits instead:

* the f run must hold a multiple of ``F_MIN`` = 32 elements (a warp's
  worth of coalesced columns) and be the suffix of the output order (the
  kernel stores it with stride 1); JAX asked for a 128/64/32-lane split;
  two JAX granule rules are kept so that the kernel steps are the JAX
  scheme's: an X above ``F_BIG_X`` elements needs a multiple of
  ``F_MIN_BIG`` = 128, and so does the pre-permuted form's run, whose X
  may hold at most ``PRE_MAX_ELEMS`` elements;
* every step that passes the step-form checks runs the kernel: there is no
  estimate against the dot fallback (``est_s`` decided that on the TPU);
* the RGFlat row form (``plan_rg_flat``) reads its stored row through an
  (F, K) address table in place of the JAX kernel's two 0/1 digit
  matrices (an MXU device); the table is separable (``foff[f] +
  koff[k]``), and its kernel takes it as int16 offsets;
* the RGRow row form keeps the JAX plan (``pre_perm`` and all); the
  RGRow and RGFlat kernels read X and W rows in their stored order
  through per-digit offset tables (``foff``/``koff``, ``wk_idx``), so
  their steps run no whole-buffer reorder of X and no transpose of W.

Kernel eligibility may therefore differ from the JAX scheme; the amplitudes
may not.

Every kernel wrapper (``gk_call``, ``ggk_call``, ``rgrow_call``,
``rgflat_call``) takes its plain PyTorch version only for CPU tensors; for
CUDA tensors it launches the kernel (on the operands' card, through
``kernels.launch``) or raises.  ``launches`` on each wrapper counts kernel
launches (none while a CUDA graph is captured: ``kernels.launch``).  The GK kernel runs GK and GGK steps in two forms, "stream"
(bound by bytes, float32 FMAs) and "mma" (3xTF32 on the tensor cores);
``gk_form`` picks one from the step's bytes and flops, and the wrapper
notes it on the open ``step`` span while tracing is enabled.
"""

from dataclasses import dataclass, field as dc_field
from functools import reduce
from operator import mul

import numpy as np
import torch

from .. import kernels
from ..ops import permute
from . import tracing
from .lanes import kernel_precision
from .lowering import apply_reorder, physical_shape, plan_reorder

MIN_X_ELEMS = 1 << 16    # below this the dot fallback's cost is irrelevant
HK_CAP = 1 << 14         # max W elements (= H*K)
H_CAP = 2048             # max fresh-leg product
F_MIN = 32               # f run granularity: one warp of coalesced columns
F_MIN_BIG = 128          # ... of an X above F_BIG_X elements, and of the
                         # pre-permuted form's run (the JAX rules)
F_BIG_X = 1 << 20
PRE_MAX_ELEMS = 1 << 24  # max X elements of the pre-permuted GK form
PRE_TAIL_F = 1 << 15     # the pre-permuted form's f run is cut to the
                         # shortest suffix of at least this many elements
GGK_MIN_WORK = MIN_X_ELEMS   # min B * row elements (whole-step size gate)
RG_ROW_CAP = 1 << 15     # max row elements of the reduction form
RG_H_CAP = 8             # fresh-leg bound of the reduction form (registers)
RG_K_MIN = 128           # min contract run of the reduction form

LAST_REJECT = None


def _prod(xs):
    return reduce(mul, xs, 1)


def _rej(msg):
    global LAST_REJECT
    LAST_REJECT = msg
    return None


def _strides(dims):
    out, s = [], 1
    for d in reversed(dims):
        out.append(s)
        s *= int(d)
    return out[::-1]


def _mixed_offsets(dims, strides):
    """Offsets sum_l digit_l * stride_l of every mixed-radix index over
    ``dims`` (row-major), as an int64 array."""
    off = np.zeros(1, dtype=np.int64)
    for d, s in zip(dims, strides):
        off = (off[:, None] + np.arange(int(d), dtype=np.int64)[None, :]
               * int(s)).reshape(-1)
    return off


def _wk_index(ix_w, dim_of, h_legs, k_legs):
    """(H, K) flat indices into W's stored row: H digits over ``h_legs``,
    K digits over ``k_legs`` (the JAX ``wk_idx``)."""
    ws = dict(zip(ix_w, _strides([dim_of[l] for l in ix_w])))
    h = _mixed_offsets([dim_of[l] for l in h_legs], [ws[l] for l in h_legs])
    k = _mixed_offsets([dim_of[l] for l in k_legs], [ws[l] for l in k_legs])
    return (h[:, None] + k[None, :]).astype(np.int32)


@dataclass(frozen=True)
class GKPlan:
    """Static metadata for one gather-K step (or one GGK row).

    The kernel's index scheme: outer index o over the grid legs with
    ``xoff[o]`` / ``yoff[o]``; ``koff[k]`` row offsets of the contract
    digits in X; the f run contiguous at the end of X and of Y; the H run
    contiguous in Y with stride ``hstride``."""

    w_is_j: bool
    K: int
    H: int
    F: int
    xoff: object         # (G,) int64
    yoff: object         # (G,) int64
    koff: object         # (K,) int64
    hstride: int
    x_elems: int
    y_elems: int
    dims_y: tuple        # logical output dims (iy order)
    wk_idx: object       # (H, K) int32 gather into W's stored row
    w_dims: tuple        # W's stored digit dims: wk is a digit transpose
    w_perm: tuple        # stored-digit positions in (H-digits, K-digits) order
    flops: int
    pre: object = None   # Reorder applied to X before the kernel
    px: object = None    # X leg order the pre reorder produces (labels)
    x_dims: tuple = ()   # X's stored dims as the kernel reads it
    x_roles: str = ""    # per X leg: 'g' grid, 'k' contract, 'f' f run
    _dev: dict = dc_field(default_factory=dict, repr=False, compare=False)


def _f_granule(x_elems):
    """The f run's granularity: ``F_MIN``, or ``F_MIN_BIG`` for an X above
    ``F_BIG_X`` elements.  The CUDA kernel needs only ``F_MIN``; the larger
    granule is the JAX planner's TPU rule (a sub-128 minor view of a big
    buffer forces a lane-padded copy there), kept so that the port's
    kernel steps are the JAX scheme's."""
    return F_MIN if x_elems <= F_BIG_X else F_MIN_BIG


def plan_gk_step(ix_i, ix_j, iy, dims_i, dims_j, pin=0, row_mode=False):
    """Build a GKPlan for the step with the GIVEN output order, or None.

    ``row_mode``: planning the per-row problem of a gathered (aligned)
    step — the size gate is skipped (the caller gates the whole batch).
    """
    iy = tuple(iy)
    if len(set(iy)) != len(iy):
        return _rej("iy-dup")
    big_is_i = _prod(dims_i) >= _prod(dims_j)
    if big_is_i:
        w_is_j, ix_x, dims_x, ix_w, dims_w = True, ix_i, dims_i, ix_j, dims_j
    else:
        w_is_j, ix_x, dims_x, ix_w, dims_w = False, ix_j, dims_j, ix_i, dims_i
    x_elems, w_elems = _prod(dims_x), _prod(dims_w)
    if x_elems < MIN_X_ELEMS and not row_mode:
        return _rej("x-small")
    if w_elems > HK_CAP:
        return _rej("w-big")
    set_x, set_w, set_y = set(ix_x), set(ix_w), set(iy)
    if set_x & set_w & set_y:
        return _rej("shared-batch")
    dim_of = {l: int(d) for l, d in zip(ix_x, dims_x)}
    for l, d in zip(ix_w, dims_w):
        dim_of[l] = int(d)
    contract = [l for l in ix_x if l in set_w and l not in set_y]
    n_legs_set = {l for l in ix_w if l in set_y}
    if set_w != set(contract) | n_legs_set or len(n_legs_set) + len(
            contract) != len(ix_w):
        return _rej("w-legs")
    if set_y != (set_x - set(contract)) | n_legs_set:
        return _rej("y-legs")
    if tuple(iy[:pin]) != tuple(ix_x[:pin]):
        return _rej("iy-pin")
    if any(l not in set_y for l in ix_x[:pin]):
        return _rej("pin-contracted")
    K = _prod(dim_of[l] for l in contract)
    H = _prod(dim_of[l] for l in n_legs_set)
    if H > H_CAP:
        return _rej("H-cap")
    cset = set(contract)

    # trailing free run of X = the f run
    f_legs = []
    for l in reversed(ix_x[pin:]):
        if l in cset:
            break
        f_legs.insert(0, l)
    F = _prod(dim_of[l] for l in f_legs)
    # shrink from the front until the run is a whole number of warps (of
    # 128 elements for a big X) and the suffix of iy (dropped legs become
    # grid legs)
    fm = _f_granule(x_elems)
    while f_legs and (F % fm
                      or tuple(iy[len(iy) - len(f_legs):]) != tuple(f_legs)):
        F //= dim_of[f_legs[0]]
        f_legs = f_legs[1:]
    if not f_legs:
        return _rej("no-f-run")
    f_set = set(f_legs)

    # the H run (fresh legs, iy order) must be contiguous in iy
    n_legs = [l for l in iy if l in n_legs_set]
    if n_legs:
        k = iy.index(n_legs[0])
        if tuple(iy[k:k + len(n_legs)]) != tuple(n_legs):
            return _rej("h-contig")

    dims_y = tuple(dim_of[l] for l in iy)
    xs = dict(zip(ix_x, _strides(dims_x)))
    ys = dict(zip(iy, _strides(dims_y)))
    g_legs = [l for l in ix_x if l not in cset and l not in f_set]
    xoff = _mixed_offsets([dim_of[l] for l in g_legs], [xs[l] for l in g_legs])
    yoff = _mixed_offsets([dim_of[l] for l in g_legs], [ys[l] for l in g_legs])
    koff = _mixed_offsets([dim_of[l] for l in contract],
                          [xs[l] for l in contract])
    hstride = ys[n_legs[-1]] if n_legs else 0
    wpos = {l: k for k, l in enumerate(ix_w)}
    return GKPlan(
        w_is_j, K, H, F, xoff, yoff, koff, int(hstride), x_elems,
        x_elems // max(K, 1) * H, dims_y,
        _wk_index(ix_w, dim_of, n_legs, contract),
        tuple(dim_of[l] for l in ix_w),
        tuple(wpos[l] for l in list(n_legs) + list(contract)),
        8 * (x_elems // max(K, 1)) * K * H,
        x_dims=tuple(dim_of[l] for l in ix_x),
        x_roles="".join("k" if l in cset else "f" if l in f_set else "g"
                        for l in ix_x))


def plan_gk_step_pre(ix_i, ix_j, iy, dims_i, dims_j, pin=0):
    """GK plan for a step whose STORED X order is kernel-hostile (contract
    legs inside the minor run -> 'no-f-run'): permute X once into an order
    built from iy, then run the kernel with iy UNCHANGED.

    The permuted order is [X free legs in stored order] + [contract legs] +
    [trailing iy-suffix of X free legs].  The JAX package gated this on an
    estimate of the extra transpose against its XLA fallback; here the
    pre-permuted kernel is always taken when it plans.  Its other gates
    are kept: the trailing run is trimmed to a multiple of ``F_MIN_BIG``
    elements and then to the shortest suffix of at least ``PRE_TAIL_F``
    elements, and X may hold at most ``PRE_MAX_ELEMS`` elements (above that
    the JAX reorder is an element gather, which the JAX planner refuses
    here).  The tail cap is the JAX rule: ``px`` becomes the layout
    request to X's producer (``runtime/sparse.py``), and a longer tail
    takes legs the producer needs free for its own H and f runs."""
    if pin:
        return None
    iy = tuple(iy)
    big_is_i = _prod(dims_i) >= _prod(dims_j)
    ix_x = tuple(ix_i if big_is_i else ix_j)
    dims_x = tuple(dims_i if big_is_i else dims_j)
    if _prod(dims_x) > PRE_MAX_ELEMS:
        return None
    ix_w = tuple(ix_j if big_is_i else ix_i)
    set_w, set_y, set_x = set(ix_w), set(iy), set(ix_x)
    if len(set_x) != len(ix_x):
        return None
    dim_of = {l: int(d) for l, d in zip(ix_x, dims_x)}
    contract = [l for l in ix_x if l in set_w and l not in set_y]
    frees = {l for l in ix_x if l in set_y}
    if not contract or not frees:
        return None
    tail = []
    for l in reversed(iy):
        if l not in frees:
            break
        tail.insert(0, l)
    F = _prod(dim_of[l] for l in tail)
    while tail and F % F_MIN_BIG:
        F //= dim_of[tail[0]]
        tail.pop(0)
    while (len(tail) > 1 and F // dim_of[tail[0]] >= PRE_TAIL_F
            and (F // dim_of[tail[0]]) % F_MIN_BIG == 0):
        F //= dim_of[tail[0]]
        tail.pop(0)
    if not tail:
        return None
    tset = set(tail)
    gpart = [l for l in ix_x if l in frees and l not in tset]
    px = tuple(gpart) + tuple(contract) + tuple(tail)
    if px == ix_x:
        return None         # the in-place planner already covers this form
    dims_px = tuple(dim_of[l] for l in px)
    if big_is_i:
        plan = plan_gk_step(px, ix_w, iy, dims_px, dims_j)
    else:
        plan = plan_gk_step(ix_w, px, iy, dims_i, dims_px)
    if plan is None:
        return None
    from dataclasses import replace

    pos = {l: k for k, l in enumerate(ix_x)}
    r = plan_reorder(dims_x, tuple(pos[l] for l in px), (_prod(dims_x),))
    return replace(plan, pre=r, px=px, _dev={})


F_PROTECT = 1 << 10      # min tail-run elements kept minor before a
                         # consumer-contract leg may stop its growth


def gk_output_order(ix_i, ix_j, iy_set, dims_i, dims_j, pin=0,
                    consumer_contract=()):
    """The GK-natural output order: pinned prefix, then the CONSUMER's
    contract legs, then X's remaining free legs in storage order with the
    fresh W legs inserted before the trailing free run (a copy of the JAX
    function; for a GK step every hoist is a grid-leg relabel)."""
    big_is_i = _prod(dims_i) >= _prod(dims_j)
    ix_x = ix_i if big_is_i else ix_j
    ix_w = ix_j if big_is_i else ix_i
    dims_x = dims_i if big_is_i else dims_j
    dim_of = {l: int(d) for l, d in zip(ix_x, dims_x)}
    set_w = set(ix_w)
    pinned = list(ix_x[:pin])
    free = [l for l in ix_x[pin:] if l in iy_set]
    new = [l for l in ix_w if l in iy_set and l not in set(ix_x)]
    cset = {l for l in ix_x if l in set_w and l not in iy_set}
    ccset = set(consumer_contract)
    n_f = 0
    F = 1
    for l in reversed(ix_x[pin:]):
        if l in cset or (F >= F_PROTECT and l in ccset):
            break
        n_f += 1
        F *= dim_of.get(l, 2)
    tail = [l for l in ix_x[len(ix_x) - n_f:] if l in iy_set] if n_f else []
    tset = set(tail)
    hoist = [l for l in free if l in ccset and l not in tset]
    rest = [l for l in free if l not in ccset and l not in tset]
    new_sorted = [l for l in new if l in ccset] \
        + [l for l in new if l not in ccset]
    if any(l in ccset for l in new):
        return tuple(pinned + hoist + new_sorted + rest + tail)
    return tuple(pinned + hoist + rest + new_sorted + tail)


# -- gathered gather-K (GGK): ALIGNED both-batched steps --------------------
#
# Aligned-step form (runtime/sparse.py): Y[b, ...] = sum_K X[gi[b], ...]
# . W[gj[b], ...].  The kernels read each gathered row straight from the
# source buffers by index — no gathered copy, no chunking.

@dataclass(frozen=True)
class RGRow:
    """Reduction-form row plan: aligned rows whose free legs are too few for
    an f run.  The kernel computes y[h, f] = sum_k x[f, k] * w[h, k] per
    gathered row over the canonical (F, K) layout — frees in riy order
    leading, the contract run minor — which is the JAX kernel's operand
    after its whole-buffer reorder ``pre_perm``.  The port reads the rows
    in their stored order instead: x[f, k] lies at ``foff[f] + koff[k]``
    of the stored X row and w[h, k] at ``wk_idx[h, k]`` of the stored W
    row, so neither operand is reordered or transposed."""

    view_x: tuple        # canonical (F, K) — or (K,) when no frees
    H: int
    K: int
    wk_idx: object       # (H, K) int32; K digits in x-stored contract order
    hy_first: bool       # fresh block leads the row output
    dims_y: tuple        # row output dims (riy order)
    w_is_j: bool
    row_dims: tuple      # stored row dims (for the pre reorder)
    pre_perm: tuple      # row-axis permutation to canonical, or None
    flops: int
    w_dims: tuple = None   # W's stored digit dims / transpose to (H, K)
    w_perm: tuple = None
    foff: object = None    # (F,) int64 stored offset of free cell f
    koff: object = None    # (K,) int64 stored offset of contract value k
    px: tuple = None       # canonical X leg order (frees in riy order, then
                           # the contract run): the layout request to X's
                           # producer, None when X is stored so already
    _dev: dict = dc_field(default_factory=dict, repr=False, compare=False)

    @property
    def F(self):
        return self.view_x[0] if len(self.view_x) == 2 else 1


def _reduction_legs(tag, rx_i, rx_j, riy, rdims_i, rdims_j):
    """Leg roles of a reduction-form row (RGRow, RGFlat): X is the larger
    side, every W leg is contracted with X or fresh, every output leg is a
    free X leg or a fresh one.  Returns ``(w_is_j, ix_x, dims_x, ix_w,
    dim_of, contract, fresh, frees)``, or None with LAST_REJECT set to
    ``tag:`` and the gate."""
    big_is_i = _prod(rdims_i) >= _prod(rdims_j)
    if big_is_i:
        w_is_j, ix_x, dims_x, ix_w, dims_w = True, rx_i, rdims_i, rx_j, rdims_j
    else:
        w_is_j, ix_x, dims_x, ix_w, dims_w = False, rx_j, rdims_j, rx_i, rdims_i
    riy = tuple(riy)
    set_x, set_w, set_y = set(ix_x), set(ix_w), set(riy)
    if len(set_x) != len(ix_x) or len(set_y) != len(riy):
        return _rej(f"{tag}:dup")
    if set_x & set_w & set_y:
        return _rej(f"{tag}:shared-batch")
    dim_of = {l: int(d) for l, d in zip(ix_x, dims_x)}
    for l, d in zip(ix_w, dims_w):
        dim_of[l] = int(d)
    contract = [l for l in ix_x if l in set_w and l not in set_y]
    fresh = [l for l in ix_w if l in set_y]
    frees = [l for l in ix_x if l in set_y]
    if set_w != set(contract) | set(fresh) \
            or len(fresh) + len(contract) != len(ix_w):
        return _rej(f"{tag}:w-legs")
    if set_y != set(frees) | set(fresh):
        return _rej(f"{tag}:y-legs")
    if not contract:
        return _rej(f"{tag}:no-contract")
    return w_is_j, ix_x, dims_x, ix_w, dim_of, contract, fresh, frees


def plan_rg_row(rx_i, rx_j, riy, rdims_i, rdims_j):
    """RGRow for the reduction form, or None (sets LAST_REJECT)."""
    legs = _reduction_legs("rg", rx_i, rx_j, riy, rdims_i, rdims_j)
    if legs is None:
        return None
    w_is_j, ix_x, dims_x, ix_w, dim_of, contract, fresh, frees = legs
    riy = tuple(riy)
    xrow = _prod(dims_x)
    if xrow > RG_ROW_CAP:
        return _rej("rg:row-big")
    K = _prod(dim_of[l] for l in contract)
    H = _prod(dim_of[l] for l in fresh)
    if K < RG_K_MIN:
        return _rej("rg:k-small")
    if H > RG_H_CAP:
        return _rej("rg:h-cap")
    if K * H > HK_CAP:
        return _rej("rg:hk-cap")
    # fresh block contiguous at the front or the back of riy (its digit
    # order is free — the wk gather absorbs it); frees in riy order
    fset = set(fresh)
    fresh_y = [l for l in riy if l in fset]
    frees_y = [l for l in riy if l not in fset]
    if fresh_y and riy[:len(fresh_y)] != tuple(fresh_y) \
            and riy[-len(fresh_y):] != tuple(fresh_y):
        return _rej("rg:h-contig")
    hy_first = bool(fresh_y) and riy[:len(fresh_y)] == tuple(fresh_y)
    px = tuple(frees_y) + tuple(contract)
    pos = {l: k for k, l in enumerate(ix_x)}
    pre_perm = None if px == tuple(ix_x) else tuple(pos[l] for l in px)
    F = _prod(dim_of[l] for l in frees_y)
    view_x = (F, K) if frees_y else (K,)
    wpos = {l: k for k, l in enumerate(ix_w)}
    xs = dict(zip(ix_x, _strides(dims_x)))
    return RGRow(view_x, H, K, _wk_index(ix_w, dim_of, fresh_y, contract),
                 hy_first, tuple(dim_of[l] for l in riy), w_is_j,
                 tuple(int(d) for d in dims_x), pre_perm, 8 * H * xrow,
                 tuple(dim_of[l] for l in ix_w),
                 tuple(wpos[l] for l in list(fresh_y) + list(contract)),
                 _mixed_offsets([dim_of[l] for l in frees_y],
                                [xs[l] for l in frees_y]),
                 _mixed_offsets([dim_of[l] for l in contract],
                                [xs[l] for l in contract]),
                 px if pre_perm is not None else None)


RGF_ROW_MIN = 128        # min row elements of the flat-row form (JAX gate)


@dataclass(frozen=True)
class RGFlat:
    """Flat-row reduction plan: aligned rows that fit neither the GK row
    nor RGRow — a small scattered contract run (K below ``RG_K_MIN``) and
    no f run, e.g. the 10k batch's (16 contract, 8 free) rows of 128
    elements.  The row is read in its stored order, without a reorder;
    ``addr`` maps each (free cell f, contract value k) to its stored
    address, and the kernel computes
    y[h, f] = sum_k x[addr[f, k]] * w[h, k] per gathered row, with the
    fresh block leading the flat output row (h-major, frees in stored
    order)."""

    H: int
    K: int
    F: int
    addr: object         # (F, K) int64 stored address of (f, k)
    wk_idx: object       # (H, K) int32; K digits in x-stored contract order
    dims_y: tuple        # row output dims (riy order)
    w_is_j: bool
    flops: int
    w_dims: tuple = None   # W's stored digit dims / transpose to (H, K)
    w_perm: tuple = None
    _dev: dict = dc_field(default_factory=dict, repr=False, compare=False)

    @property
    def xrow(self):
        return self.F * self.K

    # the address table is separable: addr[f, k] = foff[f] + koff[k] (each
    # the digits of its side; both increase with their index)
    @property
    def foff(self):
        return self.addr[:, 0]

    @property
    def koff(self):
        return self.addr[0, :]


def plan_rg_flat(rx_i, rx_j, riy, rdims_i, rdims_j):
    """RGFlat for a degenerate aligned row, or None (sets LAST_REJECT).

    The JAX planner's gates and reject strings, without its TPU parts: the
    two 0/1 digit matrices its kernel multiplies on the MXU (and their
    ``rgf:mat-cap`` VMEM gate) become the ``addr`` table, and ``est_s``
    goes.  One gate is the port's own: ``rgf:x-legs`` when X has a leg
    neither contracted with W nor kept (the sparse compiler never makes
    one; the table needs every stored address to be one (f, k))."""
    legs = _reduction_legs("rgf", rx_i, rx_j, riy, rdims_i, rdims_j)
    if legs is None:
        return None
    w_is_j, ix_x, dims_x, ix_w, dim_of, contract, fresh, frees = legs
    riy = tuple(riy)
    xrow = _prod(dims_x)
    if xrow < RGF_ROW_MIN:
        return _rej("rgf:row-small")
    if xrow > RG_ROW_CAP:
        return _rej("rgf:row-big")
    K = _prod(dim_of[l] for l in contract)
    H = _prod(dim_of[l] for l in fresh)
    F = _prod(dim_of[l] for l in frees)
    if H > RG_H_CAP:
        return _rej("rgf:h-cap")
    if K * H > HK_CAP:
        return _rej("rgf:hk-cap")
    # the flat output row is stored in x free-digit order: riy's frees
    # must match the stored order, and the fresh block must be contiguous
    # and leading (digit order free via the wk gather)
    fset = set(fresh)
    fresh_y = [l for l in riy if l in fset]
    frees_y = [l for l in riy if l not in fset]
    if frees_y != frees:
        return _rej("rgf:f-order")
    if fresh_y and riy[:len(fresh_y)] != tuple(fresh_y):
        return _rej("rgf:h-lead")
    if K * F != xrow:
        return _rej("rgf:x-legs")
    # stored address -> (f, k): each digit of the address goes to the
    # contract index or to the free index, with the digit order of X
    xs = dict(zip(ix_x, _strides(dims_x)))
    k_addr = _mixed_offsets([dim_of[l] for l in contract],
                            [xs[l] for l in contract])
    f_addr = _mixed_offsets([dim_of[l] for l in frees],
                            [xs[l] for l in frees])
    wpos = {l: k for k, l in enumerate(ix_w)}
    return RGFlat(H, K, F, f_addr[:, None] + k_addr[None, :],
                  _wk_index(ix_w, dim_of, fresh_y, contract),
                  tuple(dim_of[l] for l in riy), w_is_j, 8 * H * xrow,
                  tuple(dim_of[l] for l in ix_w),
                  tuple(wpos[l] for l in list(fresh_y) + list(contract)))


@dataclass(frozen=True)
class GGKPlan:
    """Static metadata for one gathered (aligned) step.  For a GK row the
    outer index o runs over (row b, row grid g), with per-o X/Y/W offsets
    (``xoff`` / ``yoff`` / ``woff``); an RGRow or RGFlat row needs only
    the gathers."""

    row: object          # GKPlan (row_mode), RGRow or RGFlat
    gi: object           # (B,) int64 rows into the big (X) side
    gj: object           # (B,) int64 rows into the small (W) side
    B: int
    bi_rows: int         # stored rows of the X-side operand
    bj_rows: int
    dims_y: tuple        # logical output dims incl. the leading batch
    flops: int
    xoff: object = None  # (B*G,) int64, GK row only
    yoff: object = None
    woff: object = None
    _dev: dict = dc_field(default_factory=dict, repr=False, compare=False)

    @property
    def w_is_j(self):
        return self.row.w_is_j

    @property
    def pre(self):       # uniform interface with GKPlan (no pre reorder)
        return None


def plan_ggk_step(rx_i, rx_j, riy, rdims_i, rdims_j, gi, gj,
                  bi_rows, bj_rows):
    """GGKPlan for an aligned step, or None.  ``rx_*``/``riy`` are the
    ROW-level label orders (shared batch label stripped); ``gi``/``gj``
    the UNCHUNKED per-target gather rows into operands i and j.  The GK
    row form is tried first, then RGRow, then RGFlat (the JAX order)."""
    B = len(gi)
    if B != len(gj):
        return _rej("ggk:gather-mismatch")
    big_is_i = _prod(rdims_i) >= _prod(rdims_j)
    xrow = _prod(rdims_i) if big_is_i else _prod(rdims_j)
    wrow = _prod(rdims_j) if big_is_i else _prod(rdims_i)
    if B * xrow < GGK_MIN_WORK:
        return _rej("ggk:small")
    if wrow > HK_CAP:
        return _rej("ggk:w-big")
    row = plan_gk_step(rx_i, rx_j, riy, rdims_i, rdims_j, row_mode=True)
    if row is None:
        note = LAST_REJECT
        row = plan_rg_row(rx_i, rx_j, riy, rdims_i, rdims_j)
        if row is None:
            note = f"{note}/{LAST_REJECT}"
            row = plan_rg_flat(rx_i, rx_j, riy, rdims_i, rdims_j)
        if row is None:
            return _rej(f"ggk:row-{note}/{LAST_REJECT}")
    gx = np.asarray(gi if big_is_i else gj, dtype=np.int64)
    gw = np.asarray(gj if big_is_i else gi, dtype=np.int64)
    yrow = _prod(row.dims_y)
    flops = B * row.flops
    if isinstance(row, (RGRow, RGFlat)):
        return GGKPlan(row, gx, gw, B,
                       bi_rows if big_is_i else bj_rows,
                       bj_rows if big_is_i else bi_rows,
                       (B, *row.dims_y), flops)
    xoff = (gx[:, None] * xrow + row.xoff[None, :]).reshape(-1)
    yoff = (np.arange(B, dtype=np.int64)[:, None] * yrow
            + row.yoff[None, :]).reshape(-1)
    woff = np.repeat(gw * (row.H * row.K), len(row.xoff))
    return GGKPlan(row, gx, gw, B,
                   bi_rows if big_is_i else bj_rows,
                   bj_rows if big_is_i else bi_rows,
                   (B, *row.dims_y), flops, xoff, yoff, woff)


# -- GK kernel forms ---------------------------------------------------------
#
# The GK kernel (csrc/gatherk.cu) runs a GK or GGK step in one of two
# forms, chosen here from the step's shape: "stream" (float32 FMAs, one
# thread per 4 f values) for steps whose bytes bound them at the FMA rate,
# "mma" (3xTF32 on the tensor cores, on wgmma: csrc/wgmma_core.cuh) for
# the others.

GK_FORMS = ("stream", "mma")  # gk_launch's form codes, in order
STREAM_W_CAP = 4096           # max complex W values (H chunk x K) the GK
                              # stream form stages in shared memory (32 KiB)
STREAM_FMA_SHARE = 0.6        # share of the FMA rate the stream form is
                              # held to when it is chosen (see gk_form)
MMA_TILE_M = 128              # the mma form's M tile (wg::Cfg::BM): a GGK
                              # step's f run is a multiple of it
GGK_MMA_K_MIN = 16            # min K of a GGK step in the mma form: its
                              # narrow kernel's K chunk (see gk_form)


def stream_hchunk(H):
    """The stream form's H chunk: the smallest of 4, 8, 16 that holds H,
    else 16 (as ``stream_hc`` in gatherk.cu)."""
    return 4 if H <= 4 else 8 if H <= 8 else 16


def _used_rows(plan):
    """(X rows, W rows) a gathered step's targets name: what it must read."""
    if "used_rows" not in plan._dev:
        plan._dev["used_rows"] = (len(np.unique(plan.gi)),
                                  len(np.unique(plan.gj)))
    return plan._dev["used_rows"]


def gk_bytes(plan, width=1, x_batched=True, w_batched=False):
    """Bytes a GK or GGK call must move: X and W read once, Y written once,
    at slice width ``width`` (an unbatched operand is read once; a GGK step
    reads only the rows its targets name)."""
    wx = width if x_batched else 1
    ww = width if w_batched else 1
    wy = width if (x_batched or w_batched) else 1
    if isinstance(plan, GGKPlan):
        row = plan.row
        nx, nw = _used_rows(plan)
        return 8 * (wx * nx * row.x_elems + ww * nw * row.H * row.K
                    + wy * plan.B * row.y_elems)
    return 8 * (wx * plan.x_elems + ww * plan.H * plan.K + wy * plan.y_elems)


def gk_flops(plan, width=1, x_batched=True, w_batched=False):
    return plan.flops * (width if (x_batched or w_batched) else 1)


def gk_form(plan, width=1, x_batched=True, w_batched=False):
    """"stream" when the step's bytes at the card's memory rate take at
    least as long as its flops at ``STREAM_FMA_SHARE`` of the float32 FMA
    rate, else "mma"; for a GK step (``GKPlan``) the stream form also
    needs its W chunk to fit shared memory, for a GGK step (``GGKPlan``)
    the mma form needs an f run that is a multiple of ``MMA_TILE_M`` (a
    tile holds one outer index's W) and at least ``GGK_MMA_K_MIN``
    contract values.  The share is measured, not derived
    (``scripts/gk_forms_torch_port.py``, every GK step of the three paths
    in both forms on an H100): the K 4 and K 8 steps ran 1.2-6.3x faster
    streamed, K 16 H 16 (H*K/(H+K) = 8 flop a byte) 1.55-1.65x and K 16
    H 32 (10.7) 1.10x; K 32 H 32 (16) ran 1.12-1.19x faster on the tensor
    cores and K 16 H 128 (14.2) 1.03x.  0.6 cuts between 10.7 and 14.2
    (1.0 would be 20 flop a byte), so every GK step of the paths takes its
    faster form.  GGK steps take the same test
    (``scripts/gk_forms_torch_port.py --kind ggk``,
    ``scripts/ggk_wgmma_torch_port.py``): the 1k path's K 16 H 16 F 512
    step (X slice-invariant, so 16 flop a byte; the mma form's narrow
    kernel: N tile 16, K chunk 16, X read once for all slice instances)
    ran 1.75 ms on the tensor cores against 3.17 streamed at width 64,
    0.89 against 1.60 at width 32 and 0.045 against 0.065 at width 1
    (H100); the F 64 steps (1k's K 2 H 2, 10k's K 32 H 2) fill no 128-row
    tile and stream.  ``GGK_MMA_K_MIN`` is the narrow kernel's K chunk:
    below it the chunk is part empty (and below K 12 the bytes already
    keep a step streamed)."""
    t_bytes = gk_bytes(plan, width, x_batched, w_batched) \
        / kernels.H100_HBM_BYTES_PER_S
    t_ops = gk_flops(plan, width, x_batched, w_batched) / (
        STREAM_FMA_SHARE * kernels.H100_FP32_FLOP_PER_S)
    if isinstance(plan, GGKPlan):
        stream_ok = True
        mma_ok = (plan.row.F % MMA_TILE_M == 0
                  and plan.row.K >= GGK_MMA_K_MIN)
    else:
        stream_ok = stream_hchunk(plan.H) * plan.K <= STREAM_W_CAP
        mma_ok = True
    if stream_ok and (t_bytes >= t_ops or not mma_ok):
        return "stream"
    return "mma"


def gk_aligned(plan):
    """Whether every X and Y offset of a GK or GGK step is a multiple of 4
    floats: F, the outer offsets xoff / yoff, the row offsets koff and
    hstride (the width strides are multiples of F).  Then, with 16-byte
    aligned buffers, both forms use 16-byte loads and stores; else they
    take their 4-byte variants."""
    row = plan.row if isinstance(plan, GGKPlan) else plan
    return (row.F % 4 == 0 and row.hstride % 4 == 0
            and all(int(np.count_nonzero(np.asarray(t) % 4)) == 0
                    for t in (plan.xoff, plan.yoff, row.koff)))


def rg_lanes(row):
    """How the RGRow kernel reads its free cells: ``(V, fgoff, fcan)``.
    The cells are taken in the order of their stored offsets (``fcan``:
    canonical index of each), in groups of ``V`` (4, 2 or 1) cells at
    consecutive stored offsets, each group one vector load starting at
    ``fgoff[g]``: the largest V for which every group is such a run and
    every group and contract offset is a multiple of V (so V-float loads
    are aligned wherever the buffers are)."""
    fcan = np.argsort(row.foff, kind="stable")
    so = np.asarray(row.foff)[fcan]
    koff = np.asarray(row.koff)
    for V in (4, 2):
        if row.F % V:
            continue
        g = so.reshape(-1, V)
        if (g - g[:, :1] == np.arange(V)).all() and not (g[:, 0] % V).any() \
                and not (koff % V).any():
            return V, g[:, 0].copy(), fcan
    return 1, so, fcan


# -- kernel wrappers --------------------------------------------------------

def _device_tables(plan, device, names):
    """The plan's index tables as int64 tensors on ``device``, uploaded
    once per plan and device."""
    key = (str(device), names)
    if key not in plan._dev:
        plan._dev[key] = {
            n: torch.as_tensor(np.ascontiguousarray(getattr(plan, n)),
                               dtype=torch.long).to(device)
            for n in names}
    return plan._dev[key]


PLAIN_GATHER_ELEMS = 1 << 24   # X elements the plain GK version gathers
                               # at once (a 2^30-element X of the dense
                               # path would not fit the card twice over)


def _gk_plain(xr, xi, wr, wi, xoff, yoff, woff, koff, H, K, F, hstride,
              y_elems, x_batched, w_batched, W, tf32=False):
    """Plain version of the GK / GGK kernels: the same index scheme as
    gatherk.cu, with gathers and a batched matmul, one slice instance and
    at most ``PLAIN_GATHER_ELEMS`` gathered X elements at a time.
    ``tf32``: the gathered operands rounded as the mma form's one-pass
    TF32 form rounds them (``kernels.tf32_round``), the products still in
    float32."""
    rnd = kernels.tf32_round if tf32 else (lambda c: c)
    dev = xr.device
    ar = lambda n: torch.arange(n, device=dev)
    wk = ar(H)[:, None] * K + ar(K)[None, :]
    rows = max(1, PLAIN_GATHER_ELEMS // (K * F))
    lead = (W,) if (x_batched or w_batched) else ()
    yr = torch.zeros(lead + (y_elems,), dtype=xr.dtype, device=dev)
    yi = torch.zeros_like(yr)
    for s in range(W):
        xs = [(c[s] if x_batched else c) for c in (xr, xi)]
        ws = [(c[s] if w_batched else c) for c in (wr, wi)]
        ys = [(c[s] if lead else c) for c in (yr, yi)]
        for o0 in range(0, xoff.shape[0], rows):
            o = slice(o0, o0 + rows)
            xidx = xoff[o, None, None] + koff[None, :, None] \
                + ar(F)[None, None, :]
            yidx = yoff[o, None, None] + hstride * ar(H)[None, :, None] \
                + ar(F)[None, None, :]
            widx = wk if woff is None else woff[o, None, None] + wk[None]
            xs_r, xs_i = (rnd(c[xidx]) for c in xs)    # (G, K, F)
            ws_r, ws_i = (rnd(c[widx]) for c in ws)    # (G|1, H, K)
            ys[0][yidx] = torch.matmul(ws_r, xs_r) - torch.matmul(ws_i, xs_i)
            ys[1][yidx] = torch.matmul(ws_r, xs_i) + torch.matmul(ws_i, xs_r)
    return yr, yi


def gk_plain(plan, xr, xi, wr, wi, x_batched, w_batched, tf32=False):
    """Plain version of the GK kernel (same operands as ``gk_call``;
    ``tf32``: its one-pass form's, ``_gk_plain``)."""
    W = kernels.slice_width(x_batched, w_batched, xr, wr)
    t = _device_tables(plan, xr.device, ("xoff", "yoff", "koff"))
    return _gk_plain(xr, xi, wr, wi, t["xoff"], t["yoff"], None, t["koff"],
                     plan.H, plan.K, plan.F, plan.hstride, plan.y_elems,
                     x_batched, w_batched, W, tf32)


def ggk_plain(plan, xr, xi, wr, wi, x_batched, w_batched, tf32=False):
    """Plain version of the GGK kernel (same operands as ``ggk_call``;
    ``tf32``: its one-pass form's, ``_gk_plain``)."""
    row = plan.row
    W = kernels.slice_width(x_batched, w_batched, xr, wr)
    t = _device_tables(plan, xr.device, ("xoff", "yoff", "woff"))
    koff = _device_tables(row, xr.device, ("koff",))["koff"]
    return _gk_plain(xr, xi, wr, wi, t["xoff"], t["yoff"], t["woff"], koff,
                     row.H, row.K, row.F, row.hstride, plan.B * row.y_elems,
                     x_batched, w_batched, W, tf32)


def gk_call(plan, xr, xi, wr, wi, x_batched, w_batched, passes=3):
    """The GK kernel's wrapper.  ``xr``/``xi``: X as ``(X,)`` or
    ``(W, X)``; ``wr``/``wi``: W pre-gathered to rows ``(H*K,)`` or
    ``(W, H*K)``.  Returns Y ``(Y,)`` or ``(W, Y)``.  The kernel runs in
    the form ``gk_form`` names, counted in ``gk_call.forms``; ``passes``:
    the mma form's tensor-core passes, 3 (3xTF32) or 1 (one TF32 pass,
    counted in ``gk_call.one_pass``).  The CPU's plain version multiplies
    in float32 at either."""
    W = kernels.slice_width(x_batched, w_batched, xr, wr)
    xl = (W,) if x_batched else ()
    wl = (W,) if w_batched else ()
    dev = kernels.check_operands("gk", (xr, xi, wr, wi),
                          (xl + (plan.x_elems,),) * 2
                          + (wl + (plan.H * plan.K,),) * 2)
    form = gk_form(plan, W, x_batched, w_batched)
    tracing.note(form=form)
    if dev.type == "cpu":
        return gk_plain(plan, xr, xi, wr, wi, x_batched, w_batched)
    t = _device_tables(plan, dev, ("xoff", "yoff", "koff"))
    lead = (W,) if (x_batched or w_batched) else ()
    yr = torch.empty(lead + (plan.y_elems,), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    vec = gk_aligned(plan) and all(c.data_ptr() % 16 == 0
                                   for c in (xr, xi, yr, yi))
    n = kernels.launch(
        "gk", kernels.load().gk_launch, dev,
        *map(kernels.ptr, (xr, xi, wr, wi, yr, yi,
                           t["xoff"], t["yoff"], t["koff"])),
        len(plan.xoff), plan.H, plan.K, plan.F, plan.hstride,
        plan.x_elems if x_batched else 0,
        plan.H * plan.K if w_batched else 0,
        plan.y_elems if lead else 0, W, GK_FORMS.index(form), int(vec),
        passes)
    gk_call.launches += n
    gk_call.forms[form] += n
    gk_call.one_pass += n if form == "mma" and passes == 1 else 0
    return yr, yi


gk_call.launches = 0
gk_call.forms = dict.fromkeys(GK_FORMS, 0)   # launches by form
gk_call.one_pass = 0                          # mma launches in one pass


def ggk_call(plan, xr, xi, wr, wi, x_batched, w_batched, passes=3):
    """The GGK kernel's wrapper (GK row of an aligned step).  ``xr``:
    X-side rows ``(Bi*xrow,)`` or ``(W, Bi*xrow)``; ``wr``: W-side rows
    pre-gathered to ``(Bj*H*K,)`` or ``(W, Bj*H*K)``.  Returns Y
    ``(B*yrow,)`` or ``(W, B*yrow)``.  The GK kernel runs it in the form
    ``gk_form`` names for the step, counted in ``ggk_call.forms``, with
    the W row of each outer index at ``woff``; ``passes`` as
    ``gk_call``'s (one-pass mma launches in ``ggk_call.one_pass``)."""
    row = plan.row
    W = kernels.slice_width(x_batched, w_batched, xr, wr)
    x_n = plan.bi_rows * row.x_elems
    w_n = plan.bj_rows * row.H * row.K
    y_n = plan.B * row.y_elems
    xl = (W,) if x_batched else ()
    wl = (W,) if w_batched else ()
    dev = kernels.check_operands("ggk", (xr, xi, wr, wi),
                          (xl + (x_n,),) * 2 + (wl + (w_n,),) * 2)
    form = gk_form(plan, W, x_batched, w_batched)
    tracing.note(form=form)
    if dev.type == "cpu":
        return ggk_plain(plan, xr, xi, wr, wi, x_batched, w_batched)
    t = _device_tables(plan, dev, ("xoff", "yoff", "woff"))
    koff = _device_tables(row, dev, ("koff",))["koff"]
    lead = (W,) if (x_batched or w_batched) else ()
    yr = torch.empty(lead + (y_n,), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    vec = gk_aligned(plan) and all(c.data_ptr() % 16 == 0
                                   for c in (xr, xi, yr, yi))
    n = kernels.launch(
        "ggk", kernels.load().ggk_launch, dev,
        *map(kernels.ptr, (xr, xi, wr, wi, yr, yi,
                           t["xoff"], t["yoff"], t["woff"], koff)),
        len(plan.xoff), row.H, row.K, row.F, row.hstride,
        x_n if x_batched else 0, w_n if w_batched else 0,
        y_n if lead else 0, W, GK_FORMS.index(form), int(vec), passes)
    ggk_call.launches += n
    ggk_call.forms[form] += n
    ggk_call.one_pass += n if form == "mma" and passes == 1 else 0
    return yr, yi


ggk_call.launches = 0
ggk_call.forms = dict.fromkeys(GK_FORMS, 0)   # launches by form
ggk_call.one_pass = 0                          # mma launches in one pass


def rgrow_plain(plan, xr, xi, wr, wi, x_batched, w_batched):
    """Plain version of the RGRow kernel (same operands as ``rgrow_call``):
    gather rows, pick each X row's (F, K) and each W row's (H, K) values
    through the offset tables, batched matmul."""
    row = plan.row
    W = kernels.slice_width(x_batched, w_batched, xr, wr)
    t = _device_tables(plan, xr.device, ("gi", "gj"))
    r = _device_tables(row, xr.device, ("foff", "koff", "wk_idx"))
    F, K, H = row.F, row.K, row.H
    xaddr = r["foff"][:, None] + r["koff"][None, :]
    lead = (W,) if (x_batched or w_batched) else ()
    xv = lambda c: c.reshape((W if x_batched else 1, -1, F * K))[:, t["gi"]][
        ..., xaddr]                                           # (W, B, F, K)
    wv = lambda c: c.reshape((W if w_batched else 1, -1, H * K))[:, t["gj"]][
        ..., r["wk_idx"]]                                     # (W, B, H, K)
    xr_, xi_, wr_, wi_ = xv(xr), xv(xi), wv(wr), wv(wi)
    tr = lambda c: c.transpose(-1, -2)
    re = torch.matmul(xr_, tr(wr_)) - torch.matmul(xi_, tr(wi_))  # (W,B,F,H)
    im = torch.matmul(xr_, tr(wi_)) + torch.matmul(xi_, tr(wr_))
    if row.hy_first:
        re, im = tr(re), tr(im)
    shape = lead + (plan.B * F * H,)
    return re.reshape(shape).contiguous(), im.reshape(shape).contiguous()


def _rg_tables(row, device, V):
    """The RGRow kernel's int32 row tables on ``device`` for vector width
    ``V`` (``rg_lanes``; V 1 takes the same cell order), uploaded once."""
    key = ("rg", str(device), V)
    if key not in row._dev:
        v, fgoff, fcan = rg_lanes(row)
        if V != v:
            fgoff = np.asarray(row.foff)[fcan]
        tabs = dict(fgoff=fgoff, fcan=fcan, koff=row.koff,
                    whoff=row.wk_idx[:, 0], wkoff=row.wk_idx[0, :])
        row._dev[key] = {n: torch.as_tensor(np.ascontiguousarray(a),
                                            dtype=torch.int32).to(device)
                         for n, a in tabs.items()}
    return row._dev[key]


def rgrow_call(plan, xr, xi, wr, wi, x_batched, w_batched):
    """The RGRow kernel's wrapper.  ``xr``: X-side rows in their stored
    order ``(Bi*F*K,)`` or ``(W, ...)``; ``wr``: W-side rows in their
    stored order ``(Bj*H*K,)`` or ``(W, ...)``.  Returns Y ``(B*yrow,)``
    or ``(W, B*yrow)``, the row (H, F) when ``hy_first`` else (F, H)."""
    row = plan.row
    W = kernels.slice_width(x_batched, w_batched, xr, wr)
    F, K, H = row.F, row.K, row.H
    x_n = plan.bi_rows * F * K
    w_n = plan.bj_rows * H * K
    y_n = plan.B * F * H
    xl = (W,) if x_batched else ()
    wl = (W,) if w_batched else ()
    dev = kernels.check_operands("rgrow", (xr, xi, wr, wi),
                          (xl + (x_n,),) * 2 + (wl + (w_n,),) * 2)
    if dev.type == "cpu":
        return rgrow_plain(plan, xr, xi, wr, wi, x_batched, w_batched)
    t = _device_tables(plan, dev, ("gi", "gj"))
    lead = (W,) if (x_batched or w_batched) else ()
    yr = torch.empty(lead + (y_n,), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    V = rg_lanes(row)[0]
    if any(c.data_ptr() % (4 * V) for c in (xr, xi)):
        V = 1
    r = _rg_tables(row, dev, V)
    # W[:, k] as vector loads: H a power of two at consecutive offsets
    vw = min(H, 4)
    wvec = (H & (H - 1) == 0
            and (row.wk_idx[:, 0] == np.arange(H)).all()
            and not (row.wk_idx[0, :] % vw).any()
            and not any(c.data_ptr() % (4 * vw) for c in (wr, wi)))
    n = kernels.launch(
        "rgrow", kernels.load().rgrow_launch, dev,
        *map(kernels.ptr, (xr, xi, wr, wi, yr, yi, t["gi"], t["gj"],
                           r["fgoff"], r["fcan"], r["koff"], r["whoff"],
                           r["wkoff"])),
        plan.B, F, K, H, V, int(row.hy_first), int(wvec), F * K, H * K,
        x_n if x_batched else 0, w_n if w_batched else 0,
        y_n if lead else 0, W)
    rgrow_call.launches += n
    return yr, yi


rgrow_call.launches = 0


def rgflat_plain(plan, xr, xi, wr, wi, x_batched, w_batched):
    """Plain version of the RGFlat kernel (same operands as
    ``rgflat_call``): gather rows, pick each X row's (F, K) values through
    the address table and each W row's (H, K) values through ``wk_idx``,
    complex multiply-and-sum over k."""
    row = plan.row
    W = kernels.slice_width(x_batched, w_batched, xr, wr)
    t = _device_tables(plan, xr.device, ("gi", "gj"))
    r = _device_tables(row, xr.device, ("addr", "wk_idx"))
    F, K, H = row.F, row.K, row.H
    lead = (W,) if (x_batched or w_batched) else ()
    xv = lambda c: c.reshape((W if x_batched else 1, -1, F * K))[:, t["gi"]][
        ..., r["addr"]]                                       # (W, B, F, K)
    wv = lambda c: c.reshape((W if w_batched else 1, -1, H * K))[:, t["gj"]][
        ..., r["wk_idx"]]                                     # (W, B, H, K)
    xr_, xi_, wr_, wi_ = xv(xr), xv(xi), wv(wr), wv(wi)
    tr = lambda c: c.transpose(-1, -2)
    re = torch.matmul(wr_, tr(xr_)) - torch.matmul(wi_, tr(xi_))  # (W,B,H,F)
    im = torch.matmul(wr_, tr(xi_)) + torch.matmul(wi_, tr(xr_))
    shape = lead + (plan.B * H * F,)
    return re.reshape(shape).contiguous(), im.reshape(shape).contiguous()


RGF_THREADS = 256        # threads of an RGFlat block (csrc/rgflat.cu)
RGF_STAGE_ELEMS = 4096   # X elements a stage holds (32 KiB, re + im): rows
                         # up to this size take the staged route
RGF_STAGES = 2           # stages a block of the staged route walks
RGF_W_STAGE = 4096       # max W elements of a slice instance staged a block


def rgf_tables(row, V):
    """The RGFlat kernel's int16 offset table for vector width ``V``:
    ``koff[K]``, ``wkoff[K]``, ``fgoff[F / V]``, ``whoff[H]``, then zeros
    to a multiple of 4.  x[f, k] lies at ``foff[f] + koff[k]`` of the
    stored X row, group g's V cells at ``fgoff[g]`` + 0..V-1, and w[h, k]
    at ``whoff[h] + wkoff[k]`` of the stored W row; every offset lies
    within a row of at most 2^15 elements."""
    offs = np.concatenate([row.koff, row.wk_idx[0, :],
                           np.asarray(row.foff)[::V], row.wk_idx[:, 0]])
    assert 0 <= offs.min() and offs.max() < RG_ROW_CAP
    tab = np.zeros(-(-len(offs) // 4) * 4, dtype=np.int16)
    tab[:len(offs)] = offs
    return tab


def rgf_geometry(plan, x_aligned=True):
    """The RGFlat launch geometry of an aligned step: ``dict(V, T, NS, KS,
    cp16, wn, blocks)``.  Rows of at most ``RGF_STAGE_ELEMS`` elements take
    the staged route: T targets a stage (T rows in shared memory), NS
    stages a block (its run of NS * T consecutive targets), 16-byte copies
    where the rows are a multiple of 4 floats and ``x_aligned`` (X's
    buffers 16-byte aligned), and all of a slice instance's W rows (``wn``
    elements) staged where they fit ``RGF_W_STAGE``.  Larger rows take the
    direct route (T = 0): one target a block, V free cells a load straight
    from X, so V falls to 1 unless ``x_aligned``.  V is ``rg_lanes``' vector
    width: the free cells are already in the order of their stored offsets
    (``foff`` increases with f), so a group of V is also V consecutive
    outputs, one V-wide store.  KS lanes split an item's k loop while the
    block has threads to spare (items are (target, group of V free
    cells)).  Computed once per plan and alignment."""
    key = ("rgf_geometry", bool(x_aligned))
    if key in plan._dev:
        return dict(plan._dev[key])
    row = plan.row
    F, K, H = row.F, row.K, row.H
    xrow = F * K
    V, _, fcan = rg_lanes(row)
    assert (fcan == np.arange(F)).all()
    if xrow <= RGF_STAGE_ELEMS:
        T = max(1, min(RGF_STAGE_ELEMS // xrow, plan.B))
        NS = RGF_STAGES
        items = T * (F // V)
        blocks = -(-plan.B // (T * NS))
        cp16 = bool(x_aligned and xrow % 4 == 0)
        wn = plan.bj_rows * H * K
        wn = wn if wn <= RGF_W_STAGE else 0
    else:
        if not x_aligned:
            V = 1
        T, NS, cp16, wn = 0, 0, False, 0
        items = min(F // V, RGF_THREADS)
    KS = 1
    while KS < 32 and 2 * KS * items <= RGF_THREADS and 2 * KS <= K:
        KS *= 2
    if T == 0:
        per = RGF_THREADS // KS
        blocks = plan.B * -(-(F // V) // per)
    plan._dev[key] = dict(V=V, T=T, NS=NS, KS=KS, cp16=cp16, wn=wn,
                          blocks=blocks)
    return dict(plan._dev[key])


def _rgf_table_dev(row, device, V):
    key = ("rgf", str(device), V)
    if key not in row._dev:
        row._dev[key] = torch.as_tensor(rgf_tables(row, V)).to(device)
    return row._dev[key]


def rgflat_call(plan, xr, xi, wr, wi, x_batched, w_batched):
    """The RGFlat kernel's wrapper.  ``xr``: X-side rows in their stored
    order ``(Bi*F*K,)`` or ``(W, ...)``; ``wr``: W-side rows in their
    stored order ``(Bj*H*K,)`` or ``(W, ...)``.  Returns Y ``(B*H*F,)`` or
    ``(W, B*H*F)``.  The launch geometry is ``rgf_geometry``'s."""
    row = plan.row
    W = kernels.slice_width(x_batched, w_batched, xr, wr)
    F, K, H = row.F, row.K, row.H
    x_n = plan.bi_rows * F * K
    w_n = plan.bj_rows * H * K
    y_n = plan.B * H * F
    xl = (W,) if x_batched else ()
    wl = (W,) if w_batched else ()
    dev = kernels.check_operands("rgflat", (xr, xi, wr, wi),
                          (xl + (x_n,),) * 2 + (wl + (w_n,),) * 2)
    if dev.type == "cpu":
        return rgflat_plain(plan, xr, xi, wr, wi, x_batched, w_batched)
    t = _device_tables(plan, dev, ("gi", "gj"))
    lead = (W,) if (x_batched or w_batched) else ()
    yr = torch.empty(lead + (y_n,), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    g = rgf_geometry(plan, all(c.data_ptr() % 16 == 0 for c in (xr, xi)))
    tab = _rgf_table_dev(row, dev, g["V"])
    n = kernels.launch(
        "rgflat", kernels.load().rgflat_launch, dev,
        *map(kernels.ptr, (xr, xi, wr, wi, yr, yi, t["gi"], t["gj"], tab)),
        plan.B, F, K, H, g["V"], g["T"], g["NS"], g["KS"], int(g["cp16"]),
        g["wn"], x_n if x_batched else 0, w_n if w_batched else 0,
        y_n if lead else 0, W)
    rgflat_call.launches += n
    return yr, yi


rgflat_call.launches = 0


# -- step execution ----------------------------------------------------------

def _wk_rows(w, row, rows, lead):
    """W's stored rows -> (lead, rows, H, K) flattened: a digit transpose
    (``wk_idx`` is built from digit strides, so it always is one), both
    components in one copy."""
    n = len(lead) + 1
    perm = tuple(range(n)) + tuple(n + p for p in row.w_perm)
    return permute.contiguous(permute.regroup(
        w, lead + (rows,) + tuple(row.w_dims), perm, lead + (-1,)))


def _flat(x, lead):
    return permute.contiguous(permute.reshape(x, lead + (-1,)))


def apply_gk_step(field, x, y, plan, bx=False, by=False):
    """Execute one gather-K step on SplitField pairs, at the field's
    precision (``lanes.kernel_precision``).  ``bx``/``by``: the operand
    carries a leading slice-width axis."""
    xv, wv, bxv, bwv = (x, y, bx, by) if plan.w_is_j else (y, x, by, bx)
    xlead = (xv[0].shape[0],) if bxv else ()
    wlead = (wv[0].shape[0],) if bwv else ()
    if plan.pre is not None:
        xv = apply_reorder(field, xv, plan.pre, xlead)
    xr, xi = _flat(xv, xlead)
    wr, wi = _wk_rows(wv, plan, 1, wlead)
    yr, yi = gk_call(plan, xr, xi, wr, wi, bxv, bwv,
                     kernels.tc_passes(kernel_precision(field)))
    lead = xlead or wlead
    return field.reshape((yr, yi), lead + physical_shape(plan.dims_y))


def apply_ggk_step(field, x, y, plan, bx=False, by=False):
    """Execute one aligned step via the GGK, RGRow or RGFlat kernel (GGK
    at the field's precision, ``lanes.kernel_precision``; RGRow and
    RGFlat are FMA kernels, float32 at every precision)."""
    row = plan.row
    xv, wv, bxv, bwv = (x, y, bx, by) if row.w_is_j else (y, x, by, bx)
    xlead = (xv[0].shape[0],) if bxv else ()
    wlead = (wv[0].shape[0],) if bwv else ()
    xr, xi = _flat(xv, xlead)
    if isinstance(row, (RGRow, RGFlat)):
        # RGRow and RGFlat read both rows in their stored order: no reorder
        # of X to the canonical (F, K) layout (the JAX kernels'
        # ``pre_perm``), no transpose of W
        wr, wi = _flat(wv, wlead)
    else:
        wr, wi = _wk_rows(wv, row, plan.bj_rows, wlead)
    if isinstance(row, (RGRow, RGFlat)):
        call = rgrow_call if isinstance(row, RGRow) else rgflat_call
        yr, yi = call(plan, xr, xi, wr, wi, bxv, bwv)
    else:
        yr, yi = ggk_call(plan, xr, xi, wr, wi, bxv, bwv,
                          kernels.tc_passes(kernel_precision(field)))
    lead = xlead or wlead
    return field.reshape((yr, yi), lead + physical_shape(plan.dims_y))
