"""Number fields: how a complex tensor is held on the card.

Port of ``artensor_tpu/ops/field.py`` (``SplitField``, ``FusedField``,
``ComplexField``, ``make_field``).  Three forms, each value in the JAX
package's flat physical shape ``(d0, rest)``
(``runtime/lowering.py::physical_shape``):

  split    a tuple ``(re, im)`` of real tensors (the default).  The
           hand-written kernels take re and im as separate buffers, so
           every kernel step gets its operands without an interleave
           pass; the kernels run in this form only, at float32 storage
           (``supports_lanes``).  A complex product is four real products
           (``algo='naive'``) or three (``'karatsuba'``: t1 = ar.br, t2 =
           ai.bi, t3 = (ar+ai).(br+bi), re = t1 - t2, im = t3 - t1 - t2);
           on the card the dot fallback's naive products at float32
           storage and 3xTF32 precision run as one launch of the complex
           matmul kernel where ``pallas_mm.cmm_route`` sends them.
  complex  one native ``torch.complex64`` / ``complex128`` tensor; a
           product is one complex ``torch.matmul`` (cuBLAS's complex
           GEMM on the card).  No kernel runs, as in the JAX package.
  fused    one real tensor with the re/im axis folded into the flat minor
           dim (re, im adjacent); a step is ONE real product on the small
           operand's expansion ``[wr, wi, -wi, wr]``
           (``runtime/lowering.FusedPlan``).  No kernel runs.

``precision`` (``ops/einsum.py``): 'default' lets cuBLAS round the
operands of the dot fallback to TF32, 'high' and 'highest' keep float32;
the kernels read it through ``runtime/lanes.kernel_precision``.
``storage`` ('f32', 'bf16', 'f16'; split and fused only): the dtype that
intermediates are stored in between steps.  Each step's real products
are summed in the real dtype (float32 for complex64) and rounded to
storage once, as the JAX package's ``preferred_element_type`` does; the
slice accumulator (``sum0``, ``zeros``) stays in the real dtype.

A value may carry a leading slice-width axis (see ``runtime/executor.py``);
methods that take a ``shape`` or ``axis`` are given the full shape
including it (the fused field's shapes are the c-free logical ones).
Every field has ``buffers(x)`` (the tensors a value is made of), ``join``
(a value from them), ``clone``, ``device`` and ``leading``, so that the
executors handle any field's value alike.

Index arrays that a step takes (``take``) are int64 tensors on the
operand's device, made once per step and device before a run
(``runtime/sparse.step_tables``): a run uploads nothing from the host, so
a slice group can be captured as a CUDA graph.  The fused field needs no
tables of its own: it gathers re/im pairs through an ``(n, 2)`` view.
"""

import numpy as np
import torch

from . import pallas_mm, permute
from .einsum import as_precision, matmul_precision, pairwise_einsum
from ..runtime import tracing

_REAL = {np.dtype(np.complex64): torch.float32,
         np.dtype(np.complex128): torch.float64}
_COMPLEX = {np.dtype(np.complex64): torch.complex64,
            np.dtype(np.complex128): torch.complex128}
_STORAGE = {"bf16": torch.bfloat16, "f16": torch.float16}
_NP_REAL = {torch.float32: np.float32, torch.float64: np.float64}


def _real_dtype(dtype):
    dtype = np.dtype(dtype)
    if dtype not in _REAL:
        raise ValueError(f"unsupported dtype {dtype}")
    return _REAL[dtype]


def _storage_dtype(storage, rdtype):
    if storage == "f32":
        return rdtype
    if storage not in _STORAGE:
        raise ValueError(f"unknown storage {storage!r}: 'f32', 'bf16' or "
                         "'f16'")
    return _STORAGE[storage]


def _dims(shape_a, shape_b, dnums):
    """``(fa, fb, nb, m, k, n)`` of ``lax.dot_general``'s product of
    tensors of shapes ``shape_a`` and ``shape_b``: the free dims of each,
    then the product's batch, rows, contracted and column sizes."""
    (ca, cb), (ba, bb) = dnums
    fa = [d for d in range(len(shape_a)) if d not in ca and d not in ba]
    fb = [d for d in range(len(shape_b)) if d not in cb and d not in bb]
    size = lambda shape, ds: int(np.prod([shape[d] for d in ds]))
    return (fa, fb, size(shape_a, ba), size(shape_a, fa), size(shape_a, ca),
            size(shape_b, fb))


def product_dims(shape_a, shape_b, dnums):
    """``(B, M, K, N)`` of the matrix product that ``lax.dot_general`` of
    tensors of shapes ``shape_a`` and ``shape_b`` is (``_matrix_forms``)."""
    return _dims(shape_a, shape_b, dnums)[2:]


def _matrix_forms(a, b, dnums):
    """``(am, bm, shape)`` of ``lax.dot_general``'s product of tensors
    shaped like ``a`` and ``b``: ``am`` / ``bm`` permute and reshape the
    components of an operand (a tuple of tensors) into (batch, rows, k) /
    (batch, k, cols) form (``permute.reshape``: a copy, one for a pair of
    one layout, unless the permuted view reshapes as a view); ``shape``:
    the output's, batch dims, then a's free dims, then b's free dims, in
    stored order, as XLA's dot_general produces them."""
    (ca, cb), (ba, bb) = dnums
    fa, fb, nb, m, k, n = _dims(a.shape, b.shape, dnums)
    pa, pb = (*ba, *fa, *ca), (*bb, *cb, *fb)
    am = lambda cs: permute.reshape((c.permute(*pa) for c in cs), (nb, m, k))
    bm = lambda cs: permute.reshape((c.permute(*pb) for c in cs), (nb, k, n))
    return am, bm, (*(a.shape[d] for d in ba), *(a.shape[d] for d in fa),
                    *(b.shape[d] for d in fb))


def _gemm(t):
    """``t``, a matrix form on the card, as cuBLAS's batched GEMM reads it:
    where its two matrix dims (both longer than 1) both stride past one
    element, ``at::bmm`` copies it contiguous for the call; the copy is
    made here instead, by the permute kernel, for the one call (the same
    layout, so the same product, reaches cuBLAS either way)."""
    if (t.is_cuda and t.shape[-1] > 1 and t.shape[-2] > 1
            and t.stride(-1) != 1 and t.stride(-2) != 1):
        return permute.contiguous((t,))[0]
    return t


def _upcast(form, rdtype):
    """``form`` followed by a cast to ``rdtype`` where the operand is
    stored narrower (reduced storage: products in the real dtype), one
    component at a time."""
    if rdtype is None:
        return form
    cast = lambda c: c if c.dtype == rdtype else c.to(rdtype)
    return lambda cs: tuple(cast(form((c,))[0]) for c in cs)


def _dot(a, b, dnums, rdtype=None):
    """``lax.dot_general`` of two tensors (real or complex) as one
    ``torch.matmul`` on their matrix forms."""
    am, bm, shape = _matrix_forms(a, b, dnums)
    am, bm = _upcast(am, rdtype), _upcast(bm, rdtype)
    return torch.matmul(_gemm(am((a,))[0]), _gemm(bm((b,))[0])).reshape(
        shape)


def _split_dot(a, b, dnums, algo="naive", rdtype=None, sdtype=None):
    """``lax.dot_general`` on split pairs as permute/reshape + ``matmul``.

    Output axes as ``_matrix_forms``.  Each operand component is permuted
    into matrix form once.  ``naive``: the four real products accumulate
    in place into the output (``baddbmm_``); the smaller operand's two
    components are permuted together, the larger operand's one at a time,
    the second after the first's copy is dropped, so the step holds one
    component copy of it (``metrics.dot_copy_elems``).  ``karatsuba``:
    three products, the operand sums formed in the stored dtype, as the
    JAX package forms them.  ``rdtype``: the real dtype the products are
    summed in (where the operands are stored narrower); ``sdtype``: the
    dtype the result is stored in, rounded once."""
    am, bm, shape = _matrix_forms(a[0], b[0], dnums)
    am, bm = _upcast(am, rdtype), _upcast(bm, rdtype)
    am1, bm1 = (lambda c: am((c,))[0]), (lambda c: bm((c,))[0])
    mm = lambda x, y: torch.matmul(_gemm(x), _gemm(y))
    if algo == "karatsuba":
        yr = mm(am1(a[0]), bm1(b[0]))
        t2 = mm(am1(a[1]), bm1(b[1]))
        yi = mm(am1(a[0] + a[1]), bm1(b[0] + b[1]))
        yi.sub_(yr).sub_(t2)
        yr.sub_(t2)
        del t2
    elif a[0].numel() >= b[0].numel():
        br, bi = bm(b)
        x = am1(a[0])
        yr, yi = mm(x, br), mm(x, bi)
        del x
        x = am1(a[1])
        yr.baddbmm_(_gemm(x), _gemm(bi), alpha=-1.0)
        yi.baddbmm_(_gemm(x), _gemm(br))
    else:
        ar, ai = am(a)
        x = bm1(b[0])
        yr, yi = mm(ar, x), mm(ai, x)
        del x
        x = bm1(b[1])
        yr.baddbmm_(_gemm(ai), _gemm(x), alpha=-1.0)
        yi.baddbmm_(_gemm(ar), _gemm(x))
    out = yr.reshape(shape), yi.reshape(shape)
    if sdtype is not None and sdtype != yr.dtype:
        out = tuple(c.to(sdtype) for c in out)
    return out


def _row_major(pair):
    """A split pair of (B, rows, cols) matrix forms as the complex matmul
    kernel reads them: row-major matrices, each batch entry on from the
    last or all the same one (batch stride 0); others are copied
    contiguous, both components in one launch (``permute.contiguous``)."""
    t = pair[0]
    _, rows, cols = t.shape
    dense = lambda c: ((c.stride(2) == 1 or cols == 1)
                       and (c.stride(1) == cols or rows == 1)
                       and (c.shape[0] == 1
                            or c.stride(0) in (0, rows * cols)))
    if all(dense(c) for c in pair) and pair[0].stride() == pair[1].stride():
        return tuple(pair)
    return permute.contiguous(pair)


def _cmm_dot(a, b, dnums):
    """``lax.dot_general`` on split pairs as one launch of the complex
    matmul kernel (float32 class: 3xTF32, or the three-term split below
    K 16, ``pallas_mm.cmm_tile``) on their matrix forms: both components
    of each operand in matrix form at once (``_matrix_forms``: one reorder
    for a pair), no cuBLAS-layout copy (``_gemm``).  Output axes as
    ``_matrix_forms``."""
    am, bm, shape = _matrix_forms(a[0], b[0], dnums)
    yr, yi = pallas_mm.complex_batched_matmul(_row_major(am(a)),
                                              _row_major(bm(b)))
    return yr.reshape(shape), yi.reshape(shape)


# -- structural ops on one tensor, shared by the fields ----------------------

def _regroup1(c, dims, perm, final_shape):
    """reshape(dims) -> permute(perm) -> reshape(final_shape)
    (``permute.regroup``)."""
    return permute.regroup((c,), dims, perm, final_shape)[0]


def _index_logical1(c, dims, axis, idx, out_shape):
    """Index ``idx`` of logical ``axis`` of ``c`` (logical ``dims``).  An
    int ``idx`` gives ``out_shape``; a 1-D index tensor of length W takes
    one index per slice instance and gives ``(W,) + out_shape``, from
    ``c`` unbatched or already batched with ``(W,) + dims``."""
    dims = tuple(dims)
    if isinstance(idx, int):
        return c.reshape(dims).select(axis, idx).reshape(out_shape)
    w = idx.shape[0]
    if c.numel() == int(np.prod(dims)):
        v = c.reshape(dims).index_select(axis, idx).movedim(axis, 0)
    else:
        rows = torch.arange(w, device=c.device)
        v = c.reshape((w,) + dims)[(rows,) + (slice(None),) * axis + (idx,)]
    return v.reshape((w,) + tuple(out_shape))


def _as_index(indices, device):
    """The executor passes int64 tensors on the operand's device; numpy
    indices are uploaded on every call, which a captured run cannot do."""
    if not isinstance(indices, torch.Tensor):
        indices = torch.as_tensor(np.asarray(indices), dtype=torch.long)
    return indices.to(device)


def _index1(c, idx, axis):
    """Index ``idx`` (an int or a one-element tensor) of ``axis``, the
    axis dropped: ``lax.dynamic_index_in_dim(..., keepdims=False)``."""
    if isinstance(idx, torch.Tensor):
        return c.index_select(axis, idx.reshape(1).to(c.device)) \
            .squeeze(axis)
    return c.select(axis, int(idx))


class _Field:
    """What the executors ask of any field's value: the tensors it is
    made of (``buffers``), a value from them (``join``), a copy, its
    device and the size of its leading axis; and the multi-device
    collectives (``psum``, ``pvary``)."""

    def clone(self, x):
        return self.join(tuple(c.clone() for c in self.buffers(x)))

    def device(self, x):
        return self.buffers(x)[0].device

    def leading(self, x):
        return self.buffers(x)[0].shape[0]

    def psum(self, x, group=None):
        """``x`` summed over the processes of the ``torch.distributed``
        process ``group``: each stored tensor all-reduced in place (a
        complex one through its real view), ``x`` returned.  With no
        group, or a group of one process, ``x`` as it is."""
        import torch.distributed as dist

        if group is None or dist.get_world_size(group) == 1:
            return x
        for c in self.buffers(x):
            dist.all_reduce(torch.view_as_real(c) if c.is_complex() else c,
                            op=dist.ReduceOp.SUM, group=group)
        return x

    def pvary(self, x, axis_name=None):
        """``x``: JAX's ``pvary`` marks a value as varying over a
        ``shard_map`` axis, a type annotation with no counterpart here."""
        return x


class SplitField(_Field):
    """Complex tensors as (re, im) pairs of real torch tensors.

    ``supports_lanes``: eligible steps run the hand-written kernels --
    float32 storage of complex64 only, as in the JAX package
    (``field.py:51-52``).  ``cmm``: the dot fallback's products may run on
    the complex matmul kernel (``dot``); the fused field's split steps
    keep cuBLAS (False), as no port kernel runs in the fused mode."""

    mode = "split"

    def __init__(self, dtype=np.complex64, precision="highest", algo="naive",
                 storage="f32", cmm=True):
        self.dtype = np.dtype(dtype)
        self.rdtype = _real_dtype(self.dtype)
        self.precision = as_precision(precision)
        if algo not in ("naive", "karatsuba"):
            raise ValueError(f"unknown algo {algo!r}: 'naive' or "
                             "'karatsuba'")
        self.algo = algo
        self.storage = storage
        self.sdtype = _storage_dtype(storage, self.rdtype)
        self.supports_lanes = (storage == "f32"
                               and self.rdtype == torch.float32)
        self.cmm = cmm and self.supports_lanes

    def buffers(self, x):
        return tuple(x)

    def join(self, bufs):
        return tuple(bufs)

    # -- staging ----------------------------------------------------------
    def wrap(self, arr, device="cuda"):
        arr = np.asarray(arr).astype(self.dtype)
        rdt = _NP_REAL[self.rdtype]
        return tuple(torch.from_numpy(np.ascontiguousarray(c, rdt))
                     .to(device).to(self.sdtype)
                     for c in (arr.real, arr.imag))

    def unwrap(self, x):
        re, im = (c.to(self.rdtype).cpu().numpy() for c in x)
        return re + 1j * im

    # -- arithmetic -------------------------------------------------------
    def einsum(self, a, b, ix_a, ix_b, iy):
        """Label einsum on split pairs (naive or karatsuba)."""
        es = lambda x, y: pairwise_einsum(
            x.to(self.rdtype), y.to(self.rdtype), ix_a, ix_b, iy,
            self.precision)
        ar, ai = a
        br, bi = b
        if self.algo == "naive":
            out = (es(ar, br) - es(ai, bi), es(ar, bi) + es(ai, br))
        else:
            t1, t2 = es(ar, br), es(ai, bi)
            out = (t1 - t2, es(ar + ai, br + bi) - t1 - t2)
        return tuple(c.to(self.sdtype) for c in out)

    def add(self, x, y):
        return x[0] + y[0], x[1] + y[1]

    def sum0(self, x):
        """Sum over the leading axis, in the real dtype."""
        return tuple(c.sum(0, dtype=self.rdtype) for c in x)

    def zeros(self, shape, device="cuda"):
        return (torch.zeros(shape, dtype=self.rdtype, device=device),
                torch.zeros(shape, dtype=self.rdtype, device=device))

    def scale(self, x, s):
        return x[0] * s, x[1] * s

    def max_abs(self, x):
        """max(|re|, |im|) over every element, as a device scalar of the
        real dtype: within sqrt(2) of the largest complex modulus, enough
        for the rescaled run's renormalisation (``runtime/rescaled.py``)."""
        inf = float("inf")      # a fused reduction: no |x| copy is made
        return torch.maximum(torch.linalg.vector_norm(x[0], inf),
                             torch.linalg.vector_norm(x[1], inf)) \
            .to(self.rdtype)

    def matmul(self, a, b):
        """Batched matmul of (B, M, K) and (B, K, N) operands."""
        return self.dot(a, b, (((2,), (1,)), ((0,), (0,))))

    def dot(self, a, b, dnums):
        """General dot_general (multi-dim batch/contract) on split pairs:
        on the card one complex matmul launch where ``pallas_mm.
        cmm_route`` sends the product (``_cmm_dot``), else ``_split_dot``
        under the precision's TF32 setting (the caller's is given back).
        Each product made on the card counts ``dot.cmm`` or ``dot.cublas``
        (``runtime/tracing.count``), launched or recorded under a graph's
        capture."""
        narrow = self.sdtype != self.rdtype
        if a[0].is_cuda:
            routed = self.cmm and pallas_mm.cmm_route(
                *product_dims(a[0].shape, b[0].shape, dnums), a[0].device,
                self.precision, self.algo, self.storage)
            tracing.count("dot.cmm" if routed else "dot.cublas")
            if routed:
                return _cmm_dot(a, b, dnums)
        with matmul_precision(self.precision):
            return _split_dot(a, b, dnums, self.algo,
                              self.rdtype if narrow else None,
                              self.sdtype if narrow else None)

    # -- structural ops ---------------------------------------------------
    def regroup(self, x, dims, perm, final_shape):
        """reshape(dims) -> permute(perm) -> reshape(final_shape), both
        components in one copy (``permute.regroup``)."""
        return permute.regroup(x, dims, perm, final_shape)

    def index_logical(self, x, dims, axis, idx, out_shape):
        """Select index ``idx`` of logical ``axis`` on flat-stored ``x``
        (``_index_logical1``: an int, or one index per slice instance)."""
        return tuple(_index_logical1(c, dims, axis, idx, out_shape)
                     for c in x)

    def index(self, x, idx, axis):
        """Index ``idx`` of stored ``axis``, the axis dropped."""
        return tuple(_index1(c, idx, axis) for c in x)

    def take(self, x, indices, axis=0):
        """Select ``indices`` along ``axis``."""
        indices = _as_index(indices, x[0].device)
        return tuple(torch.index_select(c, axis, indices) for c in x)

    def reshape(self, x, shape):
        return permute.reshape(x, shape)

    def concat(self, parts, axis=0):
        return permute.concat(parts, axis)

    def transpose(self, x, perm):
        return tuple(c.permute(*perm) for c in x)


class ComplexField(_Field):
    """Native complex tensors (``torch.complex64`` / ``complex128``): the
    form the upstream artensor library runs (``torch.einsum`` on complex
    tensors).  ``algo`` is taken and ignored, as in the JAX package."""

    mode = "complex"
    supports_lanes = False

    def __init__(self, dtype=np.complex64, precision="highest", algo=None):
        self.dtype = np.dtype(dtype)
        self.rdtype = _real_dtype(self.dtype)
        self.cdtype = _COMPLEX[self.dtype]
        self.precision = as_precision(precision)
        self.algo = algo

    def buffers(self, x):
        return (x,)

    def join(self, bufs):
        (x,) = bufs
        return x

    def wrap(self, arr, device="cuda"):
        arr = np.ascontiguousarray(np.asarray(arr).astype(self.dtype))
        return torch.from_numpy(arr).to(device)

    def unwrap(self, x):
        return x.cpu().numpy()

    def einsum(self, a, b, ix_a, ix_b, iy):
        return pairwise_einsum(a, b, ix_a, ix_b, iy, self.precision)

    def add(self, x, y):
        return x + y

    def sum0(self, x):
        return x.sum(0)

    def zeros(self, shape, device="cuda"):
        return torch.zeros(shape, dtype=self.cdtype, device=device)

    def max_abs(self, x):
        """The largest complex modulus, a real device scalar."""
        return torch.linalg.vector_norm(x, float("inf"))

    def scale(self, x, s):
        return x * s

    def matmul(self, a, b):
        """Batched matmul of (B, M, K) and (B, K, N) operands."""
        return self.dot(a, b, (((2,), (1,)), ((0,), (0,))))

    def dot(self, a, b, dnums):
        """dot_general as one complex ``torch.matmul``, under the
        precision's TF32 setting."""
        with matmul_precision(self.precision):
            return _dot(a, b, dnums)

    def regroup(self, x, dims, perm, final_shape):
        return _regroup1(x, dims, perm, final_shape)

    def index_logical(self, x, dims, axis, idx, out_shape):
        return _index_logical1(x, dims, axis, idx, out_shape)

    def index(self, x, idx, axis):
        return _index1(x, idx, axis)

    def take(self, x, indices, axis=0):
        return torch.index_select(x, axis, _as_index(indices, x.device))

    def reshape(self, x, shape):
        return permute.reshape((x,), shape)[0]

    def concat(self, parts, axis=0):
        return permute.concat([(p,) for p in parts], axis)[0]

    def transpose(self, x, perm):
        return x.permute(*perm)


# real 2x2x2 representation of complex multiplication:
# out_c = sum_{p,q} R[c,p,q] * A_p * B_q
_R = np.zeros((2, 2, 2))
_R[0, 0, 0] = 1.0   # re: ar*br
_R[0, 1, 1] = -1.0  # re: -ai*bi
_R[1, 0, 1] = 1.0   # im: ar*bi
_R[1, 1, 0] = 1.0   # im: ai*br


def _fold(shape):
    """A c-free shape with the implicit trailing re/im axis folded into
    its last dim (c fastest)."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        return (2,)
    return shape[:-1] + (shape[-1] * 2,)


class FusedField(_Field):
    """Complex tensors as ONE real tensor with a trailing re/im axis (dim
    2) folded into the flat minor dim (c varies fastest).

    A contraction step runs as a SINGLE real product (``contract_step``):
    the smaller operand W is expanded into W4[..., p, c] =
    R[c, p, q] W[..., q] (the quad [wr, wi, -wi, wr] per element) and p
    is contracted together with the bond dims (``runtime/lowering.
    FusedPlan``), so the large operand is read once.  Steps where both
    operands exceed ``lowering.FUSED_W_MAX_ELEMS`` have no fused plan and
    run the split products on the two halves, as the JAX package plans
    them.  All structural methods take the same c-free shapes as
    ``SplitField``; a reorder is a permute of the ``dims + (2,)`` view.
    """

    mode = "fused"
    supports_lanes = False

    def __init__(self, dtype=np.complex64, precision="highest", algo="naive",
                 storage="f32"):
        self.dtype = np.dtype(dtype)
        self.rdtype = _real_dtype(self.dtype)
        self.precision = as_precision(precision)
        self.algo = algo
        self.storage = storage
        self.sdtype = _storage_dtype(storage, self.rdtype)

    def buffers(self, x):
        return (x,)

    def join(self, bufs):
        (x,) = bufs
        return x

    def _store(self, x):
        return x if x.dtype == self.sdtype else x.to(self.sdtype)

    # -- staging ----------------------------------------------------------
    def wrap(self, arr, device="cuda"):
        arr = np.asarray(arr).astype(self.dtype)
        stacked = np.stack([arr.real, arr.imag], axis=-1) \
            .astype(_NP_REAL[self.rdtype]).reshape(_fold(arr.shape))
        return torch.from_numpy(np.ascontiguousarray(stacked)).to(device) \
            .to(self.sdtype)

    def unwrap(self, x):
        a = x.to(self.rdtype).cpu().numpy()
        a = a.reshape(a.shape[:-1] + (a.shape[-1] // 2, 2))
        return a[..., 0] + 1j * a[..., 1]

    # -- the contraction step ---------------------------------------------
    @staticmethod
    def _pairs(x):
        """``x`` viewed with its folded minor dim as (n, 2)."""
        return x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2))

    def _unfold_pair(self, x):
        v = self._pairs(x)
        return v[..., 0], v[..., 1]

    @staticmethod
    def _interleave(re, im):
        return torch.stack([re, im], dim=-1).reshape(
            re.shape[:-1] + (re.shape[-1] * 2,))

    def _expand_w4(self, w):
        """Folded W ``(..., 2L)`` -> folded W4 ``(..., 4L)`` in the real
        dtype: per element the quad [wr, wi, -wi, wr] (labels (p, c), c
        fastest)."""
        v = self._pairs(w.to(self.rdtype))
        wr, wi = v[..., 0], v[..., 1]
        return torch.stack([wr, wi, -wi, wr], dim=-1).reshape(
            w.shape[:-1] + (w.shape[-1] * 2,))

    def contract_step(self, x, y, low, bx=False, by=False):
        """One lowered step on folded tensors.  ``bx`` / ``by``: the
        operand carries a leading slice-width axis, threaded through the
        product as ``lowering.batched_dnums`` threads it through the
        split dot; the result leads with it whenever an operand had
        one."""
        from ..runtime.lowering import apply_lowered, width_dnums

        plan = low.fused
        if plan is None:
            # both operands above FUSED_W_MAX_ELEMS: the split products
            # on the two halves, the result interleaved again
            helper = SplitField(self.dtype, self.precision, self.algo,
                                self.storage, cmm=False)
            re, im = apply_lowered(helper, self._unfold_pair(x),
                                   self._unfold_pair(y), low, bx, by)
            return self._interleave(re, im)
        d, w, bd, bw = (x, y, bx, by) if plan.w_is_j else (y, x, by, bx)
        width = d.shape[0] if bd else (w.shape[0] if bw else None)
        lead = () if width is None else (width,)
        w4 = self._expand_w4(w.reshape(((width,) if bw else ()) + (-1,)))
        dg = d.reshape(((width,) if bd else ()) + plan.shape_d)
        wg = w4.to(d.dtype).reshape(((width,) if bw else ()) + plan.shape_w)
        if plan.w4_lhs:
            l, r, bl, br, shape_l = wg, dg, bw, bd, plan.shape_w
        else:
            l, r, bl, br, shape_l = dg, wg, bd, bw, plan.shape_d
        dn, pos = width_dnums(plan.dnums, len(shape_l), bl, br)
        narrow = self.sdtype != self.rdtype
        with matmul_precision(self.precision):
            out = _dot(l, r, dn, self.rdtype if narrow else None)
        if pos:
            out = out.movedim(pos, 0)
        ro = plan.re_out
        if ro is not None:
            n = len(lead)
            out = _regroup1(out, lead + ro.dims,
                            tuple(range(n)) + tuple(p + n for p in ro.perm),
                            lead + ro.final_shape)
            return self._store(out)
        return self._store(permute.reshape((out,), lead + plan.phys_y)[0])

    def einsum(self, a, b, ix_a, ix_b, iy):
        """Label einsum on folded tensors: one product with R."""
        lab = {}
        for x in (*ix_a, *ix_b, *iy):
            lab.setdefault(x, len(lab))
        n = len(lab)
        q, p, c = n, n + 1, n + 2
        av = self._pairs(a.to(self.rdtype))
        bv = self._pairs(b.to(self.rdtype))
        r = torch.as_tensor(_R, dtype=self.rdtype, device=a.device)
        with matmul_precision(self.precision):
            out = torch.einsum(r, [c, p, q], av, [*(lab[x] for x in ix_a), p],
                               bv, [*(lab[x] for x in ix_b), q],
                               [*(lab[x] for x in iy), c])
        return self._store(out.reshape(_fold(out.shape[:-1])))

    # -- arithmetic / structure -------------------------------------------
    def add(self, x, y):
        return x + y

    def sum0(self, x):
        return x.sum(0, dtype=self.rdtype)

    def zeros(self, shape, device="cuda"):
        return torch.zeros(_fold(shape), dtype=self.rdtype, device=device)

    def max_abs(self, x):
        """max(|re|, |im|) over every element (a real device scalar)."""
        return torch.linalg.vector_norm(x, float("inf")).to(self.rdtype)

    def scale(self, x, s):
        return x * s

    def regroup(self, x, dims, perm, final_shape):
        """c-free logical regroup; the trailing c axis rides along."""
        dims = tuple(dims)
        return _regroup1(x, dims + (2,), tuple(perm) + (len(dims),),
                         _fold(final_shape))

    def index_logical(self, x, dims, axis, idx, out_shape):
        return _index_logical1(x, tuple(dims) + (2,), axis, idx,
                               _fold(out_shape))

    def index(self, x, idx, axis):
        """Index ``idx`` of stored ``axis`` (the folded minor axis holds
        the (re, im) pairs), the axis dropped."""
        return _index1(x, idx, axis)

    def take(self, x, indices, axis=0):
        """Select ``indices`` along ``axis`` (c-free): an axis before the
        folded one maps 1:1; on the folded axis whole (re, im) pairs are
        taken through an (n, 2) view."""
        indices = _as_index(indices, x.device)
        if axis < x.dim() - 1:
            return torch.index_select(x, axis, indices)
        v = torch.index_select(self._pairs(x), axis, indices)
        return v.reshape(v.shape[:-2] + (v.shape[-2] * 2,))

    def reshape(self, x, shape):
        return permute.reshape((x,), _fold(shape))[0]

    def concat(self, parts, axis=0):
        return permute.concat([(p,) for p in parts], axis)[0]


def make_field(dtype=np.complex64, precision="highest", mode="split",
               algo="naive", storage="f32"):
    """'split' (default), 'complex' or 'fused' (see the module's note).

    ``algo``: the split products -- 'naive' (4 real products, default)
    or 'karatsuba' (3 products and extra elementwise passes); the fused
    field uses it on the steps that fall back to split products, the
    complex field ignores it.

    ``storage``: 'f32' (default), 'bf16' or 'f16' -- intermediates stored
    at reduced precision, each step's products still summed in float32;
    split and fused modes only, and no kernel runs under it.  As the JAX
    package records (``field.py:458-464``): on deep contractions the
    per-step rounding is amplified by path cancellation, and bf16/f16
    storage fails the n30 5%-relative-error gate; it is a mode to ask for
    explicitly, not a default.
    """
    if mode == "split":
        return SplitField(dtype, precision, algo, storage)
    if mode == "fused":
        return FusedField(dtype, precision, algo, storage)
    if mode != "complex":
        raise ValueError(f"unknown mode {mode!r}: 'split', 'complex' or "
                         "'fused'")
    if storage != "f32":
        raise ValueError("reduced storage is a split and fused mode option")
    return ComplexField(dtype, precision, algo)
