"""The permute-copy kernel's host plan (``ops/permute.py``) on the CPU.

The kernel (``csrc/permute.cu``) runs only on the card; here its plan is
checked piece by piece, and a numpy emulation of the kernel's index
arithmetic (the tables, the fast divisions of a tile index over the outer
axes, each thread's walk through a pass) copies the plan's views and is
held to ``np.transpose``.  The card's tests hold the kernel itself to
``.permute(...).contiguous()`` (``tests/test_torch_cuda.py``).
"""

import functools
import math

import numpy as np
import pytest
import torch

from artensor_tpu_torch.ops import permute
from artensor_tpu_torch.runtime.lowering import collapse_runs

# Real reorders of the benchmark's cells, as the port's eager run of one
# batch hands them to the kernel on an H100 (each cell's frozen plan at the
# width the harness picks): (label, sizes, strides, components).  Each is
# the largest copy of its step; a split pair's two components are one
# launch.
REAL = [
    # sparse-1k-sc25 (width 32): dot steps 22 and 31 permute their larger
    # operand L, dot step 35 its output (re_out)
    ("sc25-22", (32, 2, 32, 524288), (33554432, 16777216, 1, 32), 2),
    ("sc25-31", (32, 4, 2, 8, 524288), (33554432, 8, 16777216, 1, 32), 2),
    ("sc25-35", (32, 4, 32, 2, 2, 2, 2, 2, 2, 2, 4, 2, 4, 2, 2, 4, 2, 2),
     (33554432, 8388608, 1, 4194304, 524288, 131072, 262144, 65536,
      2097152, 128, 2048, 256, 32, 1048576, 512, 16384, 1024, 8192), 2),
    # sparse-1k (width 64): GK step 24's pre
    ("1k-24", (64, 8, 2, 2, 2, 4, 4, 8, 2, 8, 4, 8, 4),
     (16777216, 524288, 32768, 512, 16, 1, 4194304, 1024, 32, 65536, 8192,
      64, 4), 2),
    # dense-state (width 1): dot step 30's 2^30-element operand, one
    # component at a time
    ("dense-30", (256, 8192, 64, 2, 2, 2),
     (2097152, 128, 1, 536870912, 1048576, 64), 1),
]


def _source(sizes, strides):
    """``(dims, perm)`` of a view that permutes a contiguous tensor."""
    order = sorted(range(len(sizes)), key=lambda k: -strides[k])
    dims = tuple(sizes[k] for k in order)
    return dims, tuple(order.index(k) for k in range(len(sizes)))


def _shrunk(sizes, strides, most):
    """The same permutation of a source whose largest dims are cut (by
    their least prime factors) until it holds at most ``most`` elements."""
    dims, perm = _source(sizes, strides)
    dims = list(dims)
    while math.prod(dims) > most:
        k = max(range(len(dims)), key=lambda i: dims[i])
        f = next(q for q in range(2, dims[k] + 1) if dims[k] % q == 0)
        dims[k] //= f
    return _perm_view(tuple(dims), perm)


# -- the kernel, in numpy --------------------------------------------------

def _fast_div(n, d):
    mul, shr = permute.fast_divmod(d)
    return n if d == 1 else (n * mul) >> 32 >> shr


def _tabulate(p, count, axes, gstride, sstride):
    """``tabulate`` of the kernel: entry e's coordinates over ``axes``
    (the first the fastest), dotted with the two stride lists."""
    g = np.zeros(count, np.int64)
    s = np.zeros(count, np.int64)
    for e in range(count):
        r = e
        for k in axes:
            c, r = r % p.t_size[k], r // p.t_size[k]
            g[e] += c * gstride[k]
            s[e] += c * sstride[k]
    return g, s


@functools.lru_cache(maxsize=None)
def _walk(count, n_lane):
    """Each thread's (lane, uniform) indices through one pass, as the
    kernel steps them; returns (lane, uniform) of every unit, in order,
    after checking that the walk visits each once."""
    step_l, step_u = permute.THREADS % n_lane, permute.THREADS // n_lane
    out = []
    for tid in range(permute.THREADS):
        l, u = tid % n_lane, tid // n_lane
        for L in range(tid, count, permute.THREADS):
            out.append((L, l, u))
            if step_l:
                l += step_l
                u += step_u
                if l >= n_lane:
                    l -= n_lane
                    u += 1
            else:
                u += step_u
    L, l, u = np.array(sorted(out), np.int64).reshape(-1, 3).T
    assert (L == np.arange(count)).all()
    assert (l == L % n_lane).all() and (u == L // n_lane).all()
    return l, u


def _pass(src, dst, count, n_lane, lg, ls, ug, us):
    """The kernel's ``pass``: unit L = lane + n_lane * u of the tile goes
    from ``src[lg[lane] + ug[u]]`` to ``dst[ls[lane] + us[u]]``, each
    thread walking its units as the kernel's thread does."""
    l, u = _walk(count, n_lane)
    dst[ls[l] + us[u]] = src[lg[l] + ug[u]]


def emulate(p, src):
    """The kernel's copy of ``src`` (a 1-D array of units, the view's
    storage from its first unit) under plan ``p``: the destination's
    storage from its first unit (units it does not hold stay 0), each
    tile's two passes called with the kernel's arguments."""
    count = p.A * p.UA
    second = p.t_out if p.mode == "row" else p.t_sm
    lg, ls = _tabulate(p, p.A, p.ld[:p.nld], p.t_in, second)
    ug, us = _tabulate(p, p.UA, p.ld[p.nld:], p.t_in, second)
    if p.mode == "tile":
        sg, ss = _tabulate(p, p.B, p.st[:p.nst], p.t_out, p.t_sm)
        vg, vs = _tabulate(p, p.UB, p.st[p.nst:], p.t_out, p.t_sm)
    out = np.zeros(1 + sum((n - 1) * o for n, _, o in p.axes), src.dtype)
    for t in range(p.n_tiles):
        bi = bo = 0
        for k in range(len(p.o_size)):      # one lane an outer axis
            q = _fast_div(t, p.o_div[k])
            c = q - _fast_div(q, p.o_size[k]) * p.o_size[k]
            assert c == (t // p.o_div[k]) % p.o_size[k]
            bi += c * p.o_in[k]
            bo += c * p.o_out[k]
        if p.mode == "row":
            _pass(src[bi:], out[bo:], count, p.A, lg, ls, ug, us)
            continue
        tile = np.zeros(p.smem_units, src.dtype)
        assert (ls[:, None] + us[None, :]).max() < p.smem_units
        _pass(src[bi:], tile, count, p.A, lg, ls, ug, us)
        _pass(tile, out[bo:], count, p.B, ss, sg, vs, vg)
    return out


def _units(arr, unit):
    b = np.ascontiguousarray(arr).view(np.uint8)
    return b.view(np.dtype((np.void, unit)))


def check_view(base, offset, sizes, strides, align=16, out_strides=None):
    """Plan and emulate the copy of the view of ``base`` (a 1-D array) at
    element ``offset`` with ``sizes`` and ``strides`` (into contiguous
    storage, or the view of ``out_strides``); hold it to numpy."""
    elem = base.itemsize
    p = permute.plan(sizes, strides, elem, align, out_strides)
    want = np.lib.stride_tricks.as_strided(
        base[offset:], sizes, [s * elem for s in strides])
    if p.unit * (base[offset:].nbytes // p.unit) != base[offset:].nbytes:
        pad = p.unit - base[offset:].nbytes % p.unit
        src = np.concatenate([base[offset:].view(np.uint8),
                              np.zeros(pad, np.uint8)])
    else:
        src = base[offset:].view(np.uint8)
    got = emulate(p, _units(src, p.unit)).view(np.uint8).view(base.dtype)
    if out_strides is None:
        out_strides = permute._contiguous_strides(sizes)
    got = np.concatenate([got, np.zeros(math.prod(sizes), got.dtype)])
    np.testing.assert_array_equal(np.lib.stride_tricks.as_strided(
        got, sizes, [s * elem for s in out_strides]), want)
    return p


def _perm_view(dims, perm):
    """Sizes and strides of ``np.arange(prod(dims)).reshape(dims)
    .transpose(perm)``."""
    st = [math.prod(dims[k + 1:]) for k in range(len(dims))]
    return tuple(dims[p] for p in perm), tuple(st[p] for p in perm)


# -- the tests -------------------------------------------------------------

@pytest.mark.parametrize("sizes, strides, out, want", [
    ((4, 1, 8), (8, 8, 1), None, [(32, 1, 1)]),           # contiguous
    ((2, 3, 4), (1, 6, 2), None,                          # no run survives
     [(2, 1, 12), (3, 6, 4), (4, 2, 1)]),
    ((5, 1, 1, 6), (6, 99, 7, 1), None, [(30, 1, 1)]),    # size-1 strides
    ((2, 2, 2, 2), (4, 2, 16, 8), None,                   # two runs swap
     [(4, 2, 4), (4, 8, 1)]),
    ((3, 4), (0, 1), None, [(3, 0, 4), (4, 1, 1)]),       # a broadcast axis
    ((2, 3, 4), (12, 4, 1), (24, 4, 1),                   # into a slice
     [(2, 12, 24), (12, 1, 1)]),
])
def test_collapse_merges_runs_and_drops_size_one(sizes, strides, out, want):
    assert permute.collapse(sizes, strides, out) == want


@pytest.mark.parametrize("seed", range(12))
def test_collapse_agrees_with_collapse_runs(seed):
    rng = np.random.default_rng(seed)
    dims = tuple(int(d) for d in rng.choice([1, 2, 3, 4], rng.integers(1, 9)))
    perm = tuple(int(p) for p in rng.permutation(len(dims)))
    gdims, gperm = collapse_runs(dims, perm)
    sizes, strides = _perm_view(gdims, gperm)
    runs = permute.collapse(*_perm_view(dims, perm))
    assert runs == permute.collapse(sizes, strides)
    assert len(runs) <= len(gdims)


@pytest.mark.parametrize("dims, perm, elem, align, mode, unit", [
    ((1024, 512), (1, 0), 4, 16, "tile", 4),       # a matrix transpose
    ((64, 8, 16), (1, 0, 2), 4, 16, "tile", 16),   # a 64-byte shared run
    ((64, 8, 32), (1, 0, 2), 4, 16, "row", 16),    # a 128-byte shared run
    ((64, 8, 32), (1, 0, 2), 4, 8, "row", 8),      # pointers 8 bytes apart
    ((64, 8, 32), (1, 0, 2), 2, 16, "tile", 16),   # 64 bytes of bf16
    ((64, 8, 7), (1, 0, 2), 4, 16, "tile", 4),     # a 28-byte run
    ((64, 8, 7), (1, 0, 2), 16, 16, "tile", 16),   # complex128's run
    ((8, 4096), (0, 1), 4, 16, "row", 16),         # a plain copy
    ((32,) + (2,) * 11, (0, 1, 3, 5, 7, 9, 11, 2, 4, 6, 8, 10), 4, 16,
     "tile", 4),                                   # a width over twos
])
def test_mode_and_unit_follow_the_permutation(dims, perm, elem, align,
                                              mode, unit):
    p = permute.plan(*_perm_view(dims, perm), elem, align)
    assert (p.mode, p.unit) == (mode, unit)


@pytest.mark.parametrize("label, sizes, strides, ncomp", REAL)
def test_minor_groups_read_and_write_runs(label, sizes, strides, ncomp):
    """A tile mode plan reads the tile's lane part as one run of the
    input of at least RUN_BYTES and writes its store lanes as one run of
    the output; the load pass's warps meet no bank conflict, the store
    pass's at most two-way ones (where the two groups share axes, no row
    pitch parts them all)."""
    p = permute.plan(sizes, strides, 4)
    assert p.mode == "tile"
    lg, _ = _tabulate(p, p.A, p.ld[:p.nld], p.t_in, p.t_out)
    sg, ss = _tabulate(p, p.B, p.st[:p.nst], p.t_out, p.t_sm)
    assert sorted(lg) == list(range(p.A))
    assert list(sg) == list(range(p.B))
    assert p.A * p.unit >= permute.RUN_BYTES
    assert p.B * p.unit >= permute.RUN_BYTES
    in_strides = sorted(a[1] for a in p.axes)
    assert sorted(p.t_in[k] for k in p.ld[:p.nld]) == \
        in_strides[:p.nld]
    ls, _ = _tabulate(p, p.A, p.ld[:p.nld], p.t_sm, p.t_sm)
    for offs, most in ((ls, 1), (ss, 2)):
        for w in range(0, len(offs), 32):       # one warp's lanes
            banks = np.bincount((offs[w:w + 32] * p.unit // 4) % 32)
            assert banks.max() <= most


def _cases():
    rng = np.random.default_rng(7)
    out = []
    for n in range(10):                         # random shapes
        dims = tuple(int(d) for d in rng.integers(1, 7, rng.integers(1, 6)))
        out.append((f"random{n}", dims,
                    tuple(int(p) for p in rng.permutation(len(dims))), 4))
    for n in range(6):                          # many size-2 axes
        k = int(rng.integers(6, 13))
        out.append((f"twos{n}", (2,) * k,
                    tuple(int(p) for p in rng.permutation(k)), 4))
    for n in range(4):                          # a leading width axis
        k = int(rng.integers(5, 10))
        rest = tuple(int(p) + 1 for p in rng.permutation(k))
        out.append((f"width{n}", (int(rng.choice([3, 32, 64])),) + (2,) * k,
                    (0,) + rest, 4))
    for elem in (2, 8, 16):                     # every element size
        out.append((f"elem{elem}", (6, 4, 5, 8), (2, 0, 3, 1), elem))
        out.append((f"elem{elem}-run", (6, 4, 32), (1, 0, 2), elem))
    for label, sizes, strides, _ in REAL:     # at 2^18 elements
        out.append((label,) + _source(*_shrunk(sizes, strides, 1 << 18))
                   + (4,))
    return out


@pytest.mark.parametrize("label, dims, perm, elem", _cases())
def test_emulated_kernel_matches_transpose(label, dims, perm, elem):
    dtype = {2: np.uint16, 4: np.uint32, 8: np.uint64,
             16: np.dtype((np.void, 16))}[elem]
    n = math.prod(dims)
    base = np.frombuffer(np.random.default_rng(n).bytes(n * elem + 64),
                         dtype)
    # a view that starts one element in (4, 8 or 16 byte aligned pointers)
    sizes, strides = _perm_view(dims, perm)
    check_view(base, 1, sizes, strides, align=math.gcd(16, elem))
    check_view(base, 0, sizes, strides)


@pytest.mark.parametrize("dims, perm, axis, total, elem", [
    ((6, 4, 32), (0, 1, 2), 0, 10, 4),      # a part of a concat on axis 0
    ((6, 4, 32), (1, 0, 2), 1, 9, 4),       # a reordered part, axis 1
    ((32, 5, 2, 2, 8), (0, 3, 1, 4, 2), 1, 7, 4),   # width-led, axis 1
    ((3, 6, 6), (2, 0, 1), 2, 11, 8),       # a part of complex64, axis 2
    ((4, 8, 16), (0, 2, 1), 1, 24, 2),      # bf16, axis 1
])
def test_emulated_kernel_into_a_slice(dims, perm, axis, total, elem):
    """The copy into a slice of contiguous storage (a part of a concat):
    the destination's strides are its parent's, its axis ``axis`` one of
    ``total``."""
    dtype = {2: np.uint16, 4: np.uint32, 8: np.uint64}[elem]
    n = math.prod(dims)
    base = np.frombuffer(np.random.default_rng(n).bytes(n * elem), dtype)
    sizes, strides = _perm_view(dims, perm)
    parent = list(sizes)
    parent[axis] = total
    p = check_view(base, 0, sizes, strides,
                   out_strides=permute._contiguous_strides(parent))
    assert p.n_tiles * p.A * p.UA == n * elem // p.unit


@pytest.mark.parametrize("label, sizes, strides, ncomp", REAL)
def test_real_reorders_plan_at_full_size(label, sizes, strides, ncomp):
    """Each real reorder's plan at its full size (2^29 to 2^30 elements a
    component): tile mode, every unit in one tile, and the tile as at the
    emulated size where both take the same groups."""
    p = permute.plan(sizes, strides, 4)
    assert p.mode == "tile"
    assert p.n_tiles * p.A * p.UA * p.unit == 4 * math.prod(sizes)
    assert p.smem_bytes <= permute.SMEM_MAX and len(p.o_size) <= 32


@pytest.mark.parametrize("sizes, strides, shape", [
    ((4, 6), (1, 4), (1, 4, 6)),           # a transposed matrix: a view
    ((4, 6), (1, 4), (24,)),               # flattened: a copy
    ((2, 3, 4), (12, 1, 3), (2, 12)),      # a copy
    ((2, 3, 4), (12, 4, 1), (6, 4)),       # contiguous: a view
    ((2, 3, 4), (1, 2, 6), (2, 3, 4)),     # its own shape: a view
])
def test_view_decisions_agree_with_torch(sizes, strides, shape):
    t = torch.empty_strided(sizes, strides)
    r = t.reshape(shape)
    assert permute._viewable(t, shape) == (
        r.untyped_storage().data_ptr() == t.untyped_storage().data_ptr())


def test_wrappers_on_the_cpu_are_plain_pytorch():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 4, 5, generator=gen)
    y = torch.randn(2, 3, 4, 5, generator=gen)
    before = permute.permute_copy.launches
    got = permute.regroup((x, y), (6, 20), (1, 0), (20, 6))
    for g, t in zip(got, (x, y)):
        assert torch.equal(g, t.reshape(6, 20).permute(1, 0).reshape(20, 6))
    got = permute.reshape((x.permute(3, 1, 0, 2),), (-1,))
    assert torch.equal(got[0], x.permute(3, 1, 0, 2).reshape(-1))
    out = torch.empty(120)
    permute.copy((x.permute(2, 0, 3, 1),), (out.view(4, 2, 5, 3),))
    assert torch.equal(out, x.permute(2, 0, 3, 1).reshape(-1))
    got = permute.concat([(x, y), (y, x)], 1)
    assert torch.equal(got[0], torch.cat([x, y], 1))
    assert torch.equal(got[1], torch.cat([y, x], 1))
    assert permute.permute_copy.launches == before


# card_paths.permute_held on counts as a run reports them: (reorders made,
# launches, runs on the card, captures, warm-up groups, replays, block
# walk, accepted)
HELD = [
    ("graph run", 24, 8, 8 + 8 * 15, 2, 1, 15, False, True),
    ("two replicas", 48, 24, 24 + 12 * 40, 2, 2, 40, False, True),
    ("block walk, steps run once", 13, 7, 7 + 6 * 63, 1, 1, 63, True, True),
    ("eager launches beside the groups", 13, 7, 7 + 6 * 63, 1, 1, 63,
     False, False),
    ("a replay's reorders not run", 24, 8, 8 + 8 * 14, 2, 1, 15, False,
     False),
    ("a replica recorded fewer", 47, 24, 24 + 12 * 40, 2, 2, 40, False,
     False),
]


@pytest.mark.parametrize("case", HELD, ids=[c[0] for c in HELD])
def test_chip_smoke_holds_permute_runs_to_the_groups(case):
    """A capture records a group's reorders without launching them, so
    (made - launched) / captures is a group's; the warm-up groups launch
    as many each (a block walk also its steps run once) and the card runs
    those launches and every replay's group."""
    import card_paths

    _, made, launches, ran, caps, warm, replays, once, ok = case
    perm = dict(made=made, launches=launches,
                runs={"row": ran // 3, "tile": ran - ran // 3})
    st = dict(captures=caps, warmup_groups=warm, replays=replays)
    if not ok:
        with pytest.raises(card_paths.CardCheckError):
            card_paths.permute_held("p", perm, st, once=once)
        return
    got = card_paths.permute_held("p", perm, st, once=once)
    per = (made - launches) // caps
    assert got["per_group"] == per and got["device_launches"] == ran
    assert got["once"] == launches - per * warm
