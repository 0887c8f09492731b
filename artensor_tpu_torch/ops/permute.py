"""Reorders on the card: every permute-and-reshape copy of the port.

The fields' structural ops (``ops/field.py``: ``regroup``, ``reshape``,
``concat``, the dot fallback's matrix forms) and the kernel steps'
operand reorders (``runtime/gatherk.py``, ``runtime/lanes.py``) copy a
strided view into contiguous storage, or into a slice of it, here.
``reshape`` and ``regroup`` keep PyTorch's semantics to the letter -- a
view wherever ``Tensor.reshape`` gives a view, else a contiguous copy of
the same shape -- so the products that read the results get the same
layouts, and the same bits, as under PyTorch's own copy.  On a CPU
tensor they are the plain PyTorch calls; on a CUDA tensor the copy is
the hand-written kernel ``csrc/permute.cu`` (``permute_copy``), or it
raises: there is no fallback.

The kernel's host plan (``plan``), made once per layout: drop size-1
axes, merge the neighbours that stay runs, move a shared minor run in
units of up to 16 bytes (``unit_bytes``), then

  row   where the input's minor run stays minor and spans at least
        ``ROW_MIN_BYTES``: each unit is copied straight, the run (cut to
        about ``THREADS`` units) across the threads, grown along the
        output's axes to ``ROW_TILE_BYTES``;
  tile  otherwise: the input-minor group (the axes of least input stride,
        ``RUN_BYTES`` of them, an axis split where the group needs only
        its inner part) and the output-minor group (the output's minor
        axes, alike) span a tile, grown along the output's axes to
        ``TILE_BYTES`` (less where the kernel's shared memory is short);
        the kernel reads it along the input into shared memory (rows
        padded so that the warps meet the fewest bank conflicts) and
        writes it along the output.

The axes outside the tile are the outer axes: a tile index is split over
them by ``fast_divmod``'s constants, as the kernel does.  One launch
copies both components of a split pair where they share a layout.
``permute_copy.launches`` counts the launches made (none under a CUDA
graph's capture); ``tracing.count`` keeps ``permute.row`` /
``permute.tile`` (the reorders made, by mode: launched, or recorded into
a graph, which runs them at each replay) and ``permute.bytes`` (their
bytes read and written); the kernel counts the launches that ran on the
card by mode (``permute_runs``).
"""

import ctypes
import math
from dataclasses import dataclass

import torch

from .. import kernels
from ..runtime import tracing

ROW_MIN_BYTES = 128     # a shared minor run at least this long: row mode
RUN_BYTES = 128         # the least contiguous read and write of a tile
TILE_BYTES = 32768      # a tile (tile mode), before padding
ROW_TILE_BYTES = 32768  # a tile (row mode)
MAX_AXES = 32           # tile axes, and outer axes (csrc/permute.cu MAXA)
SMEM_MAX = 48 * 1024    # a block's tables and tile (csrc/permute.cu)
THREADS = 256
UNITS = (16, 8, 4, 2)   # bytes a unit: the kernel's instantiations


def _contiguous_strides(sizes):
    return tuple(math.prod(sizes[k + 1:]) for k in range(len(sizes)))


def collapse(sizes, strides, out_strides=None):
    """``(size, input stride, output stride)`` of a copy's axes (the
    output contiguous unless ``out_strides`` is given), size-1 axes
    dropped and each neighbour merged into the axis before it where the
    two make one run of the input and of the output (``stride[k] ==
    stride[k+1] * size[k+1]`` on both sides)."""
    if out_strides is None:
        out_strides = _contiguous_strides(sizes)
    out = []
    for n, s, o in zip(sizes, strides, out_strides):
        if n == 1:
            continue
        if out and out[-1][1] == s * n and out[-1][2] == o * n:
            out[-1] = (out[-1][0] * n, s, o)
        else:
            out.append((n, s, o))
    return out


def unit_bytes(axes, elem, align=16):
    """The bytes the kernel moves as one unit: where the input's minor run
    is the output's (stride 1 on both sides), the largest of ``UNITS``
    that divides the run's bytes, every other stride's bytes and
    ``align`` (the pointers' common alignment); else the element's
    size."""
    if not axes or axes[-1][1:] != (1, 1):
        return elem
    run = axes[-1][0] * elem
    for u in UNITS:
        if u < elem:
            break
        if (run % u == 0 and align % u == 0
                and all(s * elem % u == 0 and o * elem % u == 0
                        for _, s, o in axes[:-1])):
            return u
    return elem


def fast_divmod(d):
    """``(mul, shr)`` with ``n // d == (n * mul) >> (32 + shr)`` for every
    ``0 <= n < 2**31`` (CUTLASS's FastDivmod; d == 1 takes no multiply)."""
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()
    return ((1 << p) + d - 1) // d, p - 32


def _divisors(n):
    small = [d for d in range(1, math.isqrt(n) + 1) if n % d == 0]
    return sorted(set(small + [n // d for d in small]))


def _cut(n, need):
    """The extent a group takes of an axis of ``n`` when it needs ``need``
    more units: all of it if that is not more, else the least divisor
    that reaches ``need``, or the largest below it where that least
    divisor would overshoot fourfold."""
    if n <= need:
        return n
    divs = _divisors(n)
    up = next(d for d in divs if d >= need)
    if up <= 4 * need:
        return up
    return max(d for d in divs if d < need)


def _group(order, sizes, target):
    """Extents ``{axis: extent}`` of the shortest run of ``order`` whose
    product reaches ``target`` units, its last axis cut (``_cut``)."""
    ext, p = {}, 1
    for k in order:
        if p >= target:
            break
        e = _cut(sizes[k], -(-target // p))
        if e > 1:
            ext[k] = e
            p *= e
        if e < sizes[k]:
            break
    return ext


def _split(axes, k, c):
    """``axes`` with axis ``k`` of ``(n, s, o)`` split into ``(n // c,
    s * c, o * c)`` and its inner part ``(c, s, o)``."""
    n, s, o = axes[k]
    return (axes[:k] + [(n // c, s * c, o * c)] * (c < n) + [(c, s, o)]
            + axes[k + 1:])


def _in_order(axes):
    """The axes by input stride, least first (the input's minor axes)."""
    return sorted(range(len(axes)), key=lambda k: (axes[k][1], -k))


def _grow(ext, order, sizes, target, groups=()):
    """Widen the tile's axes along ``order`` in turn, each to the largest
    divisor of its size that keeps the tile within ``target`` units and
    every group of ``groups`` (sets of axes) within ``THREADS`` units, so
    that a thread keeps its lane for the whole pass."""
    for k in order:
        p = math.prod(ext.values())
        if p >= target:
            break
        cur = ext.get(k, 1)
        room = target * cur // p
        for g in groups:
            if k in g:
                room = min(room, THREADS * cur // math.prod(
                    ext.get(j, 1) for j in g))
        e = max(d for d in _divisors(sizes[k]) if d <= max(room, cur))
        if e > cur:
            ext[k] = e
    return ext


def _offsets(t_size, stride, axes, count):
    """Offsets of entries [0, count): coordinates over ``axes`` (the first
    the fastest), dotted with ``stride``: the kernel's ``tabulate``."""
    out = []
    for e in range(count):
        o = 0
        for k in axes:
            e, c = divmod(e, t_size[k])
            o += c * stride[k]
        out.append(o)
    return out


def _bank_conflicts(t_size, t_sm, order, n_lane, unit):
    """The shared-memory wavefronts beyond one a warp-wide access of the
    first warp of a pass in ``order`` (its first ``n_lane`` axes the
    lanes), over the tile's layout ``t_sm``: a warp's accesses go in
    groups of 128 bytes (32 lanes of up to 4 bytes, 16 of 8, 8 of 16),
    and a group costs the most distinct 4-byte words in one bank."""
    n = math.prod(t_size[k] for k in order[:n_lane])
    lane = _offsets(t_size, t_sm, order[:n_lane], min(n, 32))
    rows = _offsets(t_size, t_sm, order[n_lane:], -(-32 // n))
    addr = [lane[i % n] + rows[i // n] for i in range(min(32, n * len(rows)))]
    per = min(32, 128 // unit)
    extra = 0
    for g in range(0, len(addr), per):
        banks = {}
        for a in addr[g:g + per]:
            for w in range(max(1, unit // 4)):
                word = a * unit // 4 + w
                banks.setdefault(word % 32, set()).add(word)
        extra += max(len(v) for v in banks.values()) - 1
    return extra


@dataclass(frozen=True)
class Plan:
    """The kernel's plan for one layout (``plan``); every stride and
    offset in units of ``unit`` bytes.

    ``axes``: the collapsed ``(size, input stride, output stride)`` axes,
    in output order.
    Tile axes (``t_*``, in output order): their extent, input, output
    and shared-memory strides.  ``ld``: the load order's axes (indices into
    the tile axes), its first ``nld`` the lane part; ``st`` / ``nst``: the
    store order's (tile mode).  ``A`` x ``UA`` = ``B`` x ``UB`` = the
    tile's units.  ``o_*``: the outer axes, outermost first: size, input
    and output strides of one step, and the product of the sizes inside
    it (``o_div``).  ``n_tiles``: the tiles of one component."""

    mode: str
    unit: int
    axes: tuple
    t_size: tuple
    t_in: tuple
    t_out: tuple
    t_sm: tuple
    ld: tuple
    nld: int
    st: tuple
    nst: int
    A: int
    UA: int
    B: int
    UB: int
    smem_units: int
    o_size: tuple
    o_in: tuple
    o_out: tuple
    o_div: tuple
    n_tiles: int

    @property
    def smem_bytes(self):
        tables = (self.A + self.UA + self.B + self.UB) * 16
        return tables + self.smem_units * self.unit


def plan(sizes, strides, elem, align=16, out_strides=None):
    """The kernel's plan for copying the view of ``sizes`` and ``strides``
    (elements of ``elem`` bytes) into contiguous storage, or into the
    view of ``out_strides`` (non-overlapping, its strides falling along
    its axes, as a slice of contiguous storage has them); ``align``: the
    pointers' common alignment in bytes (at most 16).  A tile mode plan
    whose tables and tile would pass the kernel's shared memory takes a
    tile of half the bytes, and again."""
    for tile_bytes in (TILE_BYTES, TILE_BYTES // 2, TILE_BYTES // 4):
        p = _plan(sizes, strides, elem, align, out_strides, tile_bytes)
        if p.smem_bytes <= SMEM_MAX:
            break
    if (len(p.t_size) > MAX_AXES or len(p.o_size) > MAX_AXES
            or p.smem_bytes > SMEM_MAX or p.n_tiles >= 1 << 31):
        raise ValueError(f"permute: no plan for sizes {tuple(sizes)}, "
                         f"strides {tuple(strides)}")
    return p


def _plan(sizes, strides, elem, align, out_strides, tile_bytes):
    axes = collapse(sizes, strides, out_strides)
    unit = unit_bytes(axes, elem, align)
    f = unit // elem
    if f > 1:
        axes = [(n, s // f, o // f) for n, s, o in axes[:-1]] + [
            (axes[-1][0] // f, 1, 1)]
        if axes[-1][0] == 1:
            axes.pop()
    row = not axes or (axes[-1][1:] == (1, 1) and (
        axes[-1][0] * unit >= ROW_MIN_BYTES or len(axes) == 1))
    target = -(-RUN_BYTES // unit)
    if row and axes and axes[-1][0] > THREADS:
        # the run's lane part: a thread's lane stays put
        axes = _split(axes, len(axes) - 1, _cut(axes[-1][0], THREADS))
    while not row:
        # a group that takes part of an axis takes the whole of its inner
        # part: the axis is split, so each group's lanes are its own
        size = [a[0] for a in axes]
        for order in (_in_order(axes), range(len(axes) - 1, -1, -1)):
            cut = [(k, e) for k, e in _group(order, size, target).items()
                   if e < size[k]]
            if cut:
                axes = _split(axes, *cut[0])
                break
        else:
            break
    d = len(axes)
    size, inst, outst = ([a[i] for a in axes] for i in range(3))
    out_order = list(range(d - 1, -1, -1))        # output-minor first
    if row:
        ext = {d - 1: size[-1]} if d else {}
        lane_axes = list(ext)
        _grow(ext, out_order[1:], size, max(1, ROW_TILE_BYTES // unit))
        # the tile's axes in output order; the run is the lane part, the
        # rest (output-minor first) the uniform part
        tile = sorted(ext)
        ld = [tile.index(k) for k in lane_axes] + [
            tile.index(k) for k in out_order if k in ext
            and k not in lane_axes]
        st, nst, t_sm = (), 0, [0] * len(tile)
    else:
        in_order = _in_order(axes)
        g_in = _group(in_order, size, target)
        g_out = _group(out_order, size, target)
        ext = {**g_in, **g_out}
        _grow(ext, out_order, size, max(1, tile_bytes // unit),
              (set(g_in), set(g_out)))
        tile = sorted(ext)
        lane_in = [k for k in in_order if k in g_in]
        lane_out = [k for k in out_order if k in g_out]
        A = math.prod(ext[k] for k in lane_in)
        ld = [tile.index(k) for k in lane_in] + [
            tile.index(k) for k in in_order if k in ext and k not in g_in]
        st = [tile.index(k) for k in lane_out] + [
            tile.index(k) for k in out_order if k in ext
            and k not in g_out]
        nst = len(lane_out)
        lane_axes = lane_in
        # the tile's rows in shared memory: the load order's lane part
        # compact, the other axes (output-minor first) rows of ``pitch``
        # units, padded so that both passes' warps meet the fewest bank
        # conflicts (the store pass's lanes walk the tile across rows)
        rows = [k for k in out_order if k in ext and k not in g_in]

        def layout(pitch):
            t_sm, s = [0] * len(tile), 1
            for k in lane_in:
                t_sm[tile.index(k)] = s
                s *= ext[k]
            s = pitch
            for k in rows:
                t_sm[tile.index(k)] = s
                s *= ext[k]
            return t_sm

        t_ext = [ext[k] for k in tile]
        pitch = min(range(A, A + 33), key=lambda q: (
            _bank_conflicts(t_ext, layout(q), ld, len(lane_in), unit)
            + _bank_conflicts(t_ext, layout(q), st, nst, unit), q))
        t_sm = layout(pitch)
    units = math.prod(ext.values())
    A = math.prod(ext[k] for k in lane_axes)
    B = math.prod(ext[tile[i]] for i in st[:nst]) if not row else 0
    outer = [k for k in range(d) if size[k] // ext.get(k, 1) > 1]
    o_size = [size[k] // ext.get(k, 1) for k in outer]
    o_div = [math.prod(o_size[i + 1:]) for i in range(len(outer))]
    p = Plan(
        mode="row" if row else "tile", unit=unit, axes=tuple(axes),
        t_size=tuple(ext[k] for k in tile),
        t_in=tuple(inst[k] for k in tile),
        t_out=tuple(outst[k] for k in tile), t_sm=tuple(t_sm),
        ld=tuple(ld), nld=len(lane_axes), st=tuple(st), nst=nst,
        A=A, UA=units // A, B=B, UB=units // B if B else 0,
        smem_units=0 if row else pitch * (units // A),
        o_size=tuple(o_size),
        o_in=tuple(inst[k] * ext.get(k, 1) for k in outer),
        o_out=tuple(outst[k] * ext.get(k, 1) for k in outer),
        o_div=tuple(o_div), n_tiles=math.prod(o_size))
    return p


class Args(ctypes.Structure):
    """``PermuteArgs`` of ``csrc/permute.cu``, field for field."""

    _fields_ = (
        [(n, ctypes.c_longlong * MAX_AXES)
         for n in ("t_in", "t_out", "t_sm", "o_in", "o_out")]
        + [("t_size", ctypes.c_int * MAX_AXES)]
        + [(n, ctypes.c_uint * MAX_AXES)
           for n in ("o_size", "o_size_mul", "o_size_shr", "o_div",
                     "o_div_mul", "o_div_shr")]
        + [(n, ctypes.c_byte * MAX_AXES) for n in ("ld", "st")]
        + [(n, ctypes.c_int) for n in ("nt", "nld", "nst", "no", "A", "UA",
                                       "B", "UB", "smem_units", "n_tiles")])


def _args(p):
    a = Args()
    for name in ("t_in", "t_out", "t_sm", "o_in", "o_out", "t_size",
                 "o_size", "o_div", "ld", "st"):
        vals = getattr(p, name)
        getattr(a, name)[:len(vals)] = vals
    for src, mul, shr in (("o_size", "o_size_mul", "o_size_shr"),
                          ("o_div", "o_div_mul", "o_div_shr")):
        consts = [fast_divmod(v) for v in getattr(p, src)]
        getattr(a, mul)[:len(consts)] = [m for m, _ in consts]
        getattr(a, shr)[:len(consts)] = [s for _, s in consts]
    a.nt, a.nld, a.nst, a.no = len(p.t_size), p.nld, p.nst, len(p.o_size)
    a.A, a.UA, a.B, a.UB = p.A, p.UA, p.B, p.UB
    a.smem_units, a.n_tiles = p.smem_units, p.n_tiles
    return a


_PLANS = {}     # (sizes, strides, element bytes, alignment, out strides)
#               -> (Plan, Args)
_VIEWS = {}     # (sizes, strides, shape) -> whether reshape makes a view


def _align(ptrs):
    al = 16
    for q in ptrs:
        al = math.gcd(al, q)
    return al


def permute_copy(views, outs):
    """Copy each strided view of ``views`` (one or two, of one layout and
    dtype, on one CUDA device) into the tensor of ``outs`` at the same
    index (of one layout, ``copy`` checks it): one launch of the
    kernel."""
    v, o = views[0], outs[0]
    ptrs = [t.data_ptr() for t in (*views, *outs)]
    key = (tuple(v.shape), v.stride(), v.element_size(), _align(ptrs),
           None if o.is_contiguous() else o.stride())
    if key not in _PLANS:
        p = plan(*key)
        _PLANS[key] = (p, _args(p))
    p, args = _PLANS[key]
    ins = [kernels.ptr(t) for t in views]
    dst = [kernels.ptr(t) for t in outs]
    n = kernels.launch("permute", kernels.load().permute_launch, v.device,
                       ins[0], ins[-1], dst[0], dst[-1],
                       ctypes.addressof(args), p.unit, int(p.mode == "row"),
                       len(views))
    permute_copy.launches += n
    tracing.count(f"permute.{p.mode}")
    tracing.count("permute.bytes", 2 * v.numel() * v.element_size()
                  * len(views))


permute_copy.launches = 0


def _same_layout(ts):
    t = ts[0]
    return all(u.shape == t.shape and u.stride() == t.stride()
               and u.dtype == t.dtype and u.device == t.device
               for u in ts[1:])


def _writable(o):
    """Whether the kernel can write ``o``: its strides fall along its axes
    (those longer than 1) and no two of its elements share an address."""
    axes = [(n, s) for n, s in zip(o.shape, o.stride()) if n > 1]
    span = 1
    for n, s in reversed(axes):
        if s < span:
            return False
        span = s * (n - 1) + span
    return True


def copy(ts, outs):
    """``o.copy_(t)`` for each pair of ``ts`` and ``outs`` (one shape and
    dtype a pair).  On the card every copy is the kernel's, one launch for
    a pair of one layout; the destinations' strides must fall along their
    axes, as a slice of contiguous storage has them."""
    ts, outs = tuple(ts), tuple(outs)
    if ts[0].device.type != "cuda":
        for t, o in zip(ts, outs):
            o.copy_(t)
        return outs
    for t, o in zip(ts, outs):
        if (o.shape != t.shape or o.dtype != t.dtype
                or o.device != t.device or not _writable(o)):
            raise ValueError("permute: a destination must have the "
                             "source's shape, dtype and device, and "
                             "strides that fall along its axes")
    todo = [(t, o) for t, o in zip(ts, outs) if t.numel()]
    if (len(todo) == 2 and _same_layout([t for t, _ in todo])
            and _same_layout([o for _, o in todo])):
        permute_copy(*zip(*todo))
    else:
        for t, o in todo:
            permute_copy((t,), (o,))
    return outs


def contiguous(ts):
    """``tuple(t.contiguous() for t in ts)``: a tensor already contiguous
    is its own, the others are copied (on the card by the kernel, one
    launch for a pair of one layout)."""
    ts = tuple(ts)
    if ts[0].device.type != "cuda":
        return tuple(t.contiguous() for t in ts)
    out = tuple(t if t.is_contiguous() else
                torch.empty(t.shape, dtype=t.dtype, device=t.device)
                for t in ts)
    todo = [(t, o) for t, o in zip(ts, out) if o is not t]
    if todo:
        copy(*zip(*todo))
    return out


def concat(parts, axis):
    """``torch.cat`` along ``axis`` of each component of ``parts`` (tuples
    of the same components, e.g. split pairs): on the card each part is
    copied into its slice of the outputs, one launch a part."""
    parts = [tuple(p) for p in parts]
    if parts[0][0].device.type != "cuda":
        return tuple(torch.cat([p[i] for p in parts], dim=axis)
                     for i in range(len(parts[0])))
    shape = list(parts[0][0].shape)
    shape[axis] = sum(p[0].shape[axis] for p in parts)
    outs = tuple(torch.empty(shape, dtype=c.dtype, device=c.device)
                 for c in parts[0])
    at = 0
    for p in parts:
        n = p[0].shape[axis]
        copy(p, tuple(o.narrow(axis, at, n) for o in outs))
        at += n
    return outs


def _shape(shape, numel):
    shape = tuple(int(s) for s in shape)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape = tuple(numel // known if s == -1 else s for s in shape)
    return shape


def _viewable(t, shape):
    key = (tuple(t.shape), t.stride(), shape)
    if key not in _VIEWS:
        m = torch.empty_strided(t.shape, t.stride(), device="meta")
        _VIEWS[key] = m.reshape(shape)._is_view()
    return _VIEWS[key]


def reshape(ts, shape):
    """``tuple(t.reshape(shape) for t in ts)``: a view wherever PyTorch's
    reshape gives one, else a contiguous copy (on the card the kernel's)
    viewed as ``shape``."""
    ts = tuple(ts)
    if ts[0].device.type != "cuda":
        return tuple(t.reshape(shape) for t in ts)
    shape = _shape(shape, ts[0].numel())
    copy = [not _viewable(t, shape) for t in ts]
    copies = iter(contiguous([t for t, c in zip(ts, copy) if c])
                  if any(copy) else ())
    return tuple((next(copies) if c else t).view(shape)
                 for t, c in zip(ts, copy))


def regroup(ts, dims, perm, final_shape):
    """``reshape(dims)``, ``permute(perm)``, ``reshape(final_shape)`` of
    each tensor of ``ts``, as ``reshape`` makes them."""
    ts = reshape(ts, dims)
    if tuple(perm) != tuple(range(len(perm))):
        ts = tuple(t.permute(*perm) for t in ts)
    return reshape(ts, final_shape)


def permute_runs():
    """The kernel's launches that ran on the card so far, by mode
    (``{"row": n, "tile": n}``), as the kernel counts them
    (``csrc/runs.cuh``).  Waits for the card's work."""
    return dict(zip(("row", "tile"), kernels.read_runs("permute", 2)))
