"""Split-complex field: complex tensors as (re, im) pairs of real tensors.

Port of ``SplitField`` (``artensor_tpu/ops/field.py:31-173``).  A value is a
tuple ``(re, im)`` of float tensors in the JAX package's flat physical shape
``(d0, rest)`` (``runtime/lowering.py::physical_shape``).  The hand-written
kernels take re and im as separate buffers, so keeping the pair (instead of
a native complex tensor) lets every step hand its operands to a kernel
without an interleave pass.

Products accumulate in full float32: ``dot`` runs its products with
``torch.backends.cuda.matmul.allow_tf32`` False, because the JAX package's
dots run at HIGHEST precision, and gives the caller's setting back after
them.  A value may carry a leading slice-width axis (see
``runtime/executor.py``); methods that take a ``shape`` or ``axis`` are
given the full shape including it.

Index arrays that a step takes (``take``) are int64 tensors on the
operand's device, made once per step and device before a run
(``runtime/sparse.step_tables``): a run uploads nothing from the host, so
a slice group can be captured as a CUDA graph.

``FusedField`` and ``ComplexField`` are not ported yet.
"""

import numpy as np
import torch

_REAL = {np.dtype(np.complex64): torch.float32,
         np.dtype(np.complex128): torch.float64}


def _split_dot(a, b, dnums):
    """``lax.dot_general`` on split pairs as permute/reshape + ``matmul``.

    Output axes: batch dims, then a's free dims, then b's free dims (in
    their stored order), as XLA's dot_general produces them.  Each
    operand component is permuted into (batch, rows, k) / (batch, k,
    cols) form once (a copy unless the permutation is the identity), and
    the four real products accumulate in place into the output
    (``baddbmm_``).  The larger operand's components are permuted one at a
    time, the second after the first's copy is dropped, so the step holds
    one component copy of it (``metrics.dot_copy_elems``)."""
    (ca, cb), (ba, bb) = dnums
    fa = [d for d in range(a[0].dim()) if d not in ca and d not in ba]
    fb = [d for d in range(b[0].dim()) if d not in cb and d not in bb]
    bsz = [a[0].shape[d] for d in ba]
    fa_sz = [a[0].shape[d] for d in fa]
    fb_sz = [b[0].shape[d] for d in fb]
    nb = int(np.prod(bsz)) if bsz else 1
    k = int(np.prod([a[0].shape[d] for d in ca])) if ca else 1
    m = int(np.prod(fa_sz)) if fa_sz else 1
    n = int(np.prod(fb_sz)) if fb_sz else 1
    am = lambda c: c.permute(*ba, *fa, *ca).reshape(nb, m, k)
    bm = lambda c: c.permute(*bb, *cb, *fb).reshape(nb, k, n)
    if a[0].numel() >= b[0].numel():
        br, bi = bm(b[0]), bm(b[1])
        x = am(a[0])
        yr, yi = torch.matmul(x, br), torch.matmul(x, bi)
        del x
        x = am(a[1])
        yr.baddbmm_(x, bi, alpha=-1.0)
        yi.baddbmm_(x, br)
    else:
        ar, ai = am(a[0]), am(a[1])
        x = bm(b[0])
        yr, yi = torch.matmul(ar, x), torch.matmul(ai, x)
        del x
        x = bm(b[1])
        yr.baddbmm_(ai, x, alpha=-1.0)
        yi.baddbmm_(ar, x)
    shape = (*bsz, *fa_sz, *fb_sz)
    return yr.reshape(shape), yi.reshape(shape)


class SplitField:
    """Complex tensors as (re, im) pairs of real torch tensors.

    ``supports_lanes``: eligible steps run the hand-written kernels — the
    f32 (complex64) path only, as in the JAX package (``field.py:51-52``).
    """

    def __init__(self, dtype=np.complex64):
        self.dtype = np.dtype(dtype)
        if self.dtype not in _REAL:
            raise ValueError(f"unsupported dtype {dtype}")
        self.rdtype = _REAL[self.dtype]
        self.supports_lanes = self.rdtype == torch.float32

    # -- staging ----------------------------------------------------------
    def wrap(self, arr, device="cuda"):
        arr = np.asarray(arr).astype(self.dtype)
        rdt = np.float32 if self.rdtype == torch.float32 else np.float64
        return (torch.from_numpy(np.ascontiguousarray(arr.real, rdt))
                .to(device),
                torch.from_numpy(np.ascontiguousarray(arr.imag, rdt))
                .to(device))

    def unwrap(self, x):
        re, im = x
        return re.cpu().numpy() + 1j * im.cpu().numpy()

    # -- arithmetic -------------------------------------------------------
    def add(self, x, y):
        return x[0] + y[0], x[1] + y[1]

    def sum0(self, x):
        """Sum over the leading axis."""
        return tuple(c.sum(0) for c in x)

    def zeros(self, shape, device="cuda"):
        return (torch.zeros(shape, dtype=self.rdtype, device=device),
                torch.zeros(shape, dtype=self.rdtype, device=device))

    def scale(self, x, s):
        return x[0] * s, x[1] * s

    def max_abs(self, x):
        """max(|re|, |im|) over every element, as a device scalar: within
        sqrt(2) of the largest complex modulus, enough for the rescaled
        run's renormalisation (``runtime/rescaled.py``)."""
        inf = float("inf")      # a fused reduction: no |x| copy is made
        return torch.maximum(torch.linalg.vector_norm(x[0], inf),
                             torch.linalg.vector_norm(x[1], inf))

    def dot(self, a, b, dnums):
        """General dot_general (multi-dim batch/contract) on split pairs:
        the naive four real products (``_split_dot``)."""
        # full-f32 products (PyTorch's default, pinned for the call: a
        # caller that turned TF32 on would otherwise round these to ~3
        # digits); the caller's setting is given back
        flags = torch.backends.cuda.matmul
        caller = flags.allow_tf32
        flags.allow_tf32 = False
        try:
            return _split_dot(a, b, dnums)
        finally:
            flags.allow_tf32 = caller

    # -- structural ops ---------------------------------------------------
    def regroup(self, x, dims, perm, final_shape):
        """reshape(dims) -> permute(perm) -> reshape(final_shape)."""
        identity = tuple(perm) == tuple(range(len(perm)))

        def one(c):
            c = c.reshape(dims)
            if not identity:
                c = c.permute(*perm)
            return c.reshape(final_shape)

        return tuple(one(c) for c in x)

    def index_logical(self, x, dims, axis, idx, out_shape):
        """Select index ``idx`` of logical ``axis`` on flat-stored ``x``.

        ``idx`` is an int (the JAX method's form) or a 1-D index tensor of
        length W: then one index per slice instance is taken, and the
        result carries a leading width axis ``(W,) + out_shape``.  ``x``
        itself is unbatched with logical ``dims``, or already batched with
        ``(W,) + dims`` (a later sliced bond on the same tensor)."""
        if isinstance(idx, int):
            return tuple(c.reshape(dims).select(axis, idx).reshape(out_shape)
                         for c in x)
        w = idx.shape[0]

        def one(c):
            if c.numel() == int(np.prod(dims)):
                v = c.reshape(dims).index_select(axis, idx).movedim(axis, 0)
            else:
                rows = torch.arange(w, device=c.device)
                sel = (rows,) + (slice(None),) * axis + (idx,)
                v = c.reshape((w,) + tuple(dims))[sel]
            return v.reshape((w,) + tuple(out_shape))

        return tuple(one(c) for c in x)

    def take(self, x, indices, axis=0):
        """Select ``indices`` along ``axis``.  The executor passes int64
        tensors on ``x``'s device; numpy indices are uploaded on every
        call, which a captured run cannot do."""
        if not isinstance(indices, torch.Tensor):
            indices = torch.as_tensor(np.asarray(indices), dtype=torch.long)
        indices = indices.to(x[0].device)
        return tuple(torch.index_select(c, axis, indices) for c in x)

    def reshape(self, x, shape):
        return tuple(c.reshape(shape) for c in x)

    def concat(self, parts, axis=0):
        return (torch.cat([p[0] for p in parts], dim=axis),
                torch.cat([p[1] for p in parts], dim=axis))

    def transpose(self, x, perm):
        return tuple(c.permute(*perm) for c in x)

