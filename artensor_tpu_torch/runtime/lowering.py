"""Lower label-einsum steps onto one multi-dim dot over flat storage.

Port of ``artensor_tpu/runtime/lowering.py`` (``lower_step``,
``plan_reorder``, ``apply_reorder``, ``apply_lowered``).  Intermediates
live flat, physical shape ``(first_logical_dim, rest)``; operands are never
reordered before the dot: each step reshapes them to class-grouped dims and
runs one multi-dim dot whose natural output order (batch, lhs-free,
rhs-free) becomes the step's output order wherever the scheme allows.  The
dot runs as a permute/reshape plus ``torch.matmul`` (``ops/field.py``); the
JAX package leaves the same product to XLA.

The fused field's single-product plan (``FusedPlan``, ``_lower_fused``,
``fused_phys``, ``FUSED_W_MAX_ELEMS``) is attached to every ``Lowered``,
and ``apply_lowered`` hands a step to ``FusedField.contract_step`` when
the field is fused.

Differences from the JAX module: a reorder is always a permute of the
flat tensor's logical view (the fused field's with its re/im axis), never
the TPU's int32 element gather, which exists for the TPU's lane padding
and could not index the dense path's 2^31 folded floats.  The plans keep
the JAX package's choice between candidates, its cost of a reorder
included (``_jax_reorder_cost``), so that they are the JAX package's
plans.  Any operand may carry a leading slice-width axis, which
``apply_lowered`` threads through the dot as a batch or free dim.
"""

from dataclasses import dataclass, replace
from functools import reduce
from operator import mul


def _prod(xs):
    return reduce(mul, xs, 1)


def physical_shape(dims):
    """Storage shape for logical dims: () / (d,) / (d0, prod(rest))."""
    dims = tuple(dims)
    if len(dims) <= 1:
        return dims
    return (dims[0], _prod(dims[1:]))


def fused_phys(dims):
    """Fused-field storage shape: the implicit trailing c axis (dim 2) is
    folded into the flat minor dim (c varies fastest)."""
    p = physical_shape(dims)
    if not p:
        return (2,)
    return p[:-1] + (p[-1] * 2,)


def collapse_runs(dims, perm):
    """Collapse consecutive-axis runs of a transpose: reshape to one dim per
    run, permute runs.  (3,4,5,0,1,2) on [2]*6 becomes a rank-2 (8,8) swap."""
    runs = []
    for p in perm:
        if runs and p == runs[-1][-1] + 1:
            runs[-1].append(p)
        else:
            runs.append([p])
    src = sorted(runs, key=lambda r: r[0])
    index = {tuple(r): k for k, r in enumerate(src)}
    gdims = tuple(_prod(dims[a] for a in r) for r in src)
    gperm = tuple(index[tuple(r)] for r in runs)
    return gdims, gperm


@dataclass(frozen=True)
class Reorder:
    """One axis-permutation of a flat-stored tensor."""

    dims: tuple          # run-collapsed logical dims (source order)
    perm: tuple          # run-collapsed permutation
    final_shape: tuple   # reshape after the permutation


def plan_reorder(label_dims, perm_labels, final_shape):
    dims, perm = collapse_runs(tuple(label_dims), tuple(perm_labels))
    return Reorder(dims, perm, tuple(final_shape))


def apply_reorder(field, x, r, lead=()):
    """Permute ``x`` by ``r``; ``lead`` = leading dims (the slice width)
    that stay in front."""
    n = len(lead)
    return field.regroup(x, tuple(lead) + r.dims,
                         tuple(range(n)) + tuple(p + n for p in r.perm),
                         tuple(lead) + r.final_shape)


def preferred_output_order(ix_i, ix_j, iy_set, dims_i=None, dims_j=None):
    """Transpose-free output label order: batch + bigger-free +
    smaller-free (with dims given, the larger operand's free labels come
    first: the dot's natural order)."""
    set_i, set_j = set(ix_i), set(ix_j)
    if dims_i is not None and _prod(dims_j) > _prod(dims_i):
        ix_i, ix_j = ix_j, ix_i
        set_i, set_j = set_j, set_i
    batch = [l for l in ix_i if l in iy_set and l in set_j]
    free_i = [l for l in ix_i if l in iy_set and l not in set_j]
    free_j = [l for l in ix_j if l in iy_set and l not in set_i]
    return tuple(batch + free_i + free_j)


# above this element count the JAX package's reorders are element
# gathers, which it costs 8x a transpose (``_jax_reorder_cost``)
TRANSPOSE_MAX_ELEMS = 1 << 24


def _jax_reorder_cost(r, fused=False):
    """The JAX package's cost of a reorder when it chooses between
    candidate plans: its elements, times 8 where the JAX package would run
    it as an element gather (above ``TRANSPOSE_MAX_ELEMS``, unless a
    moving minor run on a >= 2^31-element buffer forces the transpose;
    for a fused plan also a transpose whose collapsed minor dim is below
    64).  The port runs every reorder as a permute; the cost only keeps
    its plan choices the JAX package's."""
    n = _prod(r.dims)
    gather = n > TRANSPOSE_MAX_ELEMS and not (
        r.perm[-1] != len(r.dims) - 1 and n >= (1 << 31))
    if fused and not gather and r.dims[r.perm[-1]] < 64:
        gather = True
    return (8 if gather else 1) * n


@dataclass(frozen=True)
class FusedPlan:
    """Single-product complex contraction (fused-field mode).

    The complex product runs as ONE real product by treating the re/im
    axis as a dim-2 tensor axis: the smaller operand W is expanded into
    W4[..., p, c] = R[c, p, q] . W[..., q] (R: the real 2x2x2
    representation of complex multiplication), and the product contracts
    p together with the bond dims.  The data operand is read once, where
    the split products read it twice.  The c axis is the trailing axis of
    every tensor (folded into the flat minor dim)."""

    w_is_j: bool         # operand j is the (smaller) W4-expanded side
    w4_lhs: bool         # W4 is the product's lhs (else the data operand)
    n_w: int             # rank of the W operand
    dims_w: tuple        # logical dims of W (c-free)
    shape_d: tuple       # grouped reshape for the folded data operand
    shape_w: tuple       # grouped reshape for W4
    dnums: tuple
    re_out: Reorder | None
    phys_y: tuple        # flat folded physical output shape


@dataclass(frozen=True)
class Lowered:
    swapped: bool        # operands passed to the dot as (y, x)
    shape_l: tuple       # class-grouped reshape dims for the lhs operand
    shape_r: tuple
    dnums: tuple         # dot_general dimension_numbers (multi-dim)
    re_out: Reorder | None  # output reorder to iy order (None if natural)
    dims_y: tuple        # logical output dims (iy order)
    phys_y: tuple        # physical output shape
    fused: FusedPlan | None = None  # the fused field's single product


def _grouping(ix, classes, mergeable):
    """Group adjacent same-class axes of one operand; batch/contract groups
    merge only when both operands agree (``mergeable``)."""
    groups = []
    for lab in ix:
        cls = classes[lab]
        if (groups and groups[-1][0] == cls
                and (cls == "free" or mergeable(groups[-1][1][-1], lab))):
            groups[-1][1].append(lab)
        else:
            groups.append((cls, [lab]))
    return groups


def _build(ix_l, ix_r, dims_l, dims_r, classes):
    dim_of = {}
    for lab, d in zip(ix_l, dims_l):
        dim_of[lab] = d
    for lab, d in zip(ix_r, dims_r):
        dim_of[lab] = d
    pos_l = {lab: k for k, lab in enumerate(ix_l)}
    pos_r = {lab: k for k, lab in enumerate(ix_r)}

    def mergeable(a, b):
        return (pos_l.get(b, -9) == pos_l.get(a, -7) + 1
                and pos_r.get(b, -9) == pos_r.get(a, -7) + 1)

    groups_l = _grouping(ix_l, classes, mergeable)
    groups_r = _grouping(ix_r, classes, mergeable)
    shape_l = tuple(_prod(dim_of[x] for x in labs) for _, labs in groups_l)
    shape_r = tuple(_prod(dim_of[x] for x in labs) for _, labs in groups_r)
    key_l = {tuple(labs): k for k, (cls, labs) in enumerate(groups_l)}
    key_r = {tuple(labs): k for k, (cls, labs) in enumerate(groups_r)}
    batch_groups = [labs for cls, labs in groups_l if cls == "batch"]
    contract_groups = [labs for cls, labs in groups_l if cls == "contract"]
    for labs in batch_groups + contract_groups:
        if tuple(labs) not in key_r:
            raise ValueError("operand groupings must agree")
    bx = tuple(key_l[tuple(g)] for g in batch_groups)
    by = tuple(key_r[tuple(g)] for g in batch_groups)
    cx = tuple(key_l[tuple(g)] for g in contract_groups)
    cy = tuple(key_r[tuple(g)] for g in contract_groups)
    dnums = ((cx, cy), (bx, by))
    produced = [x for g in batch_groups for x in g]
    produced += [x for cls, labs in groups_l if cls == "free" for x in labs]
    produced += [x for cls, labs in groups_r if cls == "free" for x in labs]
    return shape_l, shape_r, dnums, produced, dim_of


_P, _C = "#p", "#c"

# The W4 expansion quadruples the W operand (and a batched W's temporary
# multiplies by the slice width), so steps where both operands exceed
# this run the split products instead (``FusedField.contract_step``).
FUSED_W_MAX_ELEMS = 1 << 15


def _lower_fused(ix_i, ix_j, iy, dims_i, dims_j):
    """Plan the single-product fused execution of one step (or None)."""
    if min(_prod(dims_i), _prod(dims_j)) > FUSED_W_MAX_ELEMS:
        return None
    iy2 = tuple(iy) + (_C,)
    set_i, set_j, set_y = set(ix_i), set(ix_j), set(iy2)
    classes = {}
    for lab in set_i | set_j:
        if lab in set_y:
            classes[lab] = "batch" if (lab in set_i and lab in set_j) \
                else "free"
        else:
            classes[lab] = "contract"
    classes[_P] = "contract"
    classes[_C] = "free"

    best = None
    # both W-side choices (where admissible) x both product orientations;
    # a reorder-free produced order wins
    for w_is_j in (True, False):
        dims_w = dims_j if w_is_j else dims_i
        if _prod(dims_w) > FUSED_W_MAX_ELEMS:
            continue
        ix_d = tuple(ix_i if w_is_j else ix_j) + (_P,)
        dims_d = tuple(dims_i if w_is_j else dims_j) + (2,)
        ix_w4 = tuple(ix_j if w_is_j else ix_i) + (_P, _C)
        dims_w4 = tuple(dims_w) + (2, 2)
        for w4_lhs in (False, True):
            ix_l, ix_r = (ix_w4, ix_d) if w4_lhs else (ix_d, ix_w4)
            dims_l, dims_r = (dims_w4, dims_d) if w4_lhs \
                else (dims_d, dims_w4)
            shape_l, shape_r, dnums, produced, dim_of = _build(
                ix_l, ix_r, dims_l, dims_r, classes)
            dims_y = tuple(dim_of[lab] for lab in iy2)
            phys_y = fused_phys(dims_y[:-1])
            if tuple(produced) == iy2:
                re_out, cost = None, 0
            else:
                prod_pos = {lab: k for k, lab in enumerate(produced)}
                re_out = plan_reorder(
                    tuple(dim_of[lab] for lab in produced),
                    tuple(prod_pos[lab] for lab in iy2), phys_y)
                cost = _jax_reorder_cost(re_out, fused=True)
            # grouped shapes stored by ROLE (data vs W4), not by side
            cand = FusedPlan(w_is_j, w4_lhs, len(ix_w4) - 2, tuple(dims_w),
                             shape_r if w4_lhs else shape_l,
                             shape_l if w4_lhs else shape_r,
                             dnums, re_out, phys_y)
            if best is None or cost < best[0]:
                best = (cost, cand)
            if cost == 0:
                return best[1]
    return best[1]


def lower_step(ix_i, ix_j, iy, dims_i, dims_j):
    """Precompute the dot lowering of one step (host side).

    Tries both operand orientations; prefers one needing no output reorder,
    else the one with the smallest reorder.  Also attaches the fused
    field's single-product plan (``FusedPlan``).
    """
    iy = tuple(iy)
    set_i, set_j, set_y = set(ix_i), set(ix_j), set(iy)
    classes = {}
    for lab in {*ix_i, *ix_j}:
        if lab in set_y:
            classes[lab] = "batch" if (lab in set_i and lab in set_j) \
                else "free"
        else:
            classes[lab] = "contract"

    best = None
    for swapped in (False, True):
        ix_l, ix_r = (ix_j, ix_i) if swapped else (ix_i, ix_j)
        dims_l, dims_r = (dims_j, dims_i) if swapped else (dims_i, dims_j)
        shape_l, shape_r, dnums, produced, dim_of = _build(
            ix_l, ix_r, dims_l, dims_r, classes)
        dims_y = tuple(dim_of[lab] for lab in iy)
        phys_y = physical_shape(dims_y)
        if tuple(produced) == iy:
            re_out, cost = None, 0
        else:
            prod_pos = {lab: k for k, lab in enumerate(produced)}
            re_out = plan_reorder(
                tuple(dim_of[lab] for lab in produced),
                tuple(prod_pos[lab] for lab in iy), phys_y)
            cost = _prod(re_out.dims)
        cand = Lowered(swapped, shape_l, shape_r, dnums, re_out,
                       dims_y, phys_y)
        if best is None or cost < best[0]:
            best = (cost, cand)
        if cost == 0:
            break
    return replace(best[1], fused=_lower_fused(ix_i, ix_j, iy, dims_i,
                                               dims_j))


def width_dnums(dnums, rank_l, bl, br):
    """``(dnums, pos)`` of a product whose left / right operand (rank
    ``rank_l`` / any, without the width) carries a leading slice-width
    axis: both batched, the width is one more batch dim; one batched, it
    is a free dim of that operand.  ``pos``: the output axis it lands
    on."""
    (cl, cr), (bl_dims, br_dims) = dnums
    up = lambda t: tuple(d + 1 for d in t)
    if bl and br:
        return ((up(cl), up(cr)),
                ((0,) + up(bl_dims), (0,) + up(br_dims))), 0
    if bl:
        return ((up(cl), cr), (up(bl_dims), br_dims)), len(bl_dims)
    if br:
        return ((cl, up(cr)), (bl_dims, up(br_dims))), rank_l - len(cl)
    return dnums, 0


def batched_dnums(low, bl, br):
    """``width_dnums`` of ``apply_lowered``'s dot of ``low`` (``bl`` /
    ``br``: the left / right operand, after the swap, is batched)."""
    return width_dnums(low.dnums, len(low.shape_l), bl, br)


def apply_lowered(field, x, y, low, bx=False, by=False):
    """Execute one lowered step on physical (flat) field tensors.

    ``bx`` / ``by``: the operand carries a leading slice-width axis.  Both
    batched: the width is one more dot batch dim.  One batched: it is a
    free dim of that operand (the other is read once, never broadcast).
    The result leads with the width whenever an operand had one.  A
    fused field runs its own single product (``FusedField.contract_step``).
    """
    if field.mode == "fused":
        return field.contract_step(x, y, low, bx, by)
    l, r = (y, x) if low.swapped else (x, y)
    bl, br = (by, bx) if low.swapped else (bx, by)
    if not (bl or br):
        out = field.dot(field.reshape(l, low.shape_l),
                        field.reshape(r, low.shape_r), low.dnums)
        lead = ()
    else:
        w = field.leading(l if bl else r)
        lg = field.reshape(l, ((w,) if bl else ()) + low.shape_l)
        rg = field.reshape(r, ((w,) if br else ()) + low.shape_r)
        dn, pos = batched_dnums(low, bl, br)
        out = field.dot(lg, rg, dn)
        if pos:
            out = field.join(tuple(c.movedim(pos, 0)
                                   for c in field.buffers(out)))
        lead = (w,)
    if low.re_out is not None:
        return apply_reorder(field, out, low.re_out, lead)
    return field.reshape(out, lead + low.phys_y)
