"""Pairwise tensor contraction and the ``precision`` option on the H100.

Port of ``artensor_tpu/ops/einsum.py`` (``PRECISIONS``,
``pairwise_einsum``).  The JAX package maps ``precision`` onto MXU pass
counts; this module maps it onto what the H100 runs, as the port's
decision:

  'highest'  float32 products: cuBLAS with
             ``torch.backends.cuda.matmul.allow_tf32`` False, the FMA
             kernels at FP32, and the tensor-core kernel forms (Pair, GK
             and GGK "mma", the complex matmul) at 3xTF32 (hi.hi + hi.lo
             + lo.hi, ``csrc/tc_core.cuh``).  What the port has run since
             its first slice.  The dot fallback's split products run on
             the complex matmul where ``pallas_mm.cmm_route`` sends them
             (3xTF32, or below K 16 the three-term split), else on
             cuBLAS.
  'high'     the same as 'highest'.  The JAX kernels clamp HIGH to
             HIGHEST (``kernel_precision``), and the TPU's HIGH is bf16x3,
             whose H100 counterpart is the 3xTF32 the kernels already
             run; cuBLAS has no 3xTF32 product.
  'default'  single-pass TF32: ``allow_tf32`` True around the dot
             fallback's products (set and given back per call), and the
             one-pass form of the tensor-core kernels (hi.hi, operands
             rounded to TF32 by dropping their low 13 mantissa bits).
             The FMA kernels (GK and GGK "stream", RGRow, RGFlat, Lane)
             stay at FP32: more exact there than the TPU's one bf16 pass.

On the CPU every precision computes at full float32 / float64, as the JAX
package's CPU backend does: the CPU has no TF32.
"""

from contextlib import contextmanager
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Precision:
    """One ``precision`` setting: ``tf32`` -- cuBLAS products may round
    their operands to TF32; ``passes`` -- tensor-core passes of the
    kernels' tensor-core forms (3: 3xTF32, 1: one TF32 pass)."""

    name: str
    tf32: bool
    passes: int


PRECISIONS = {
    "default": Precision("default", True, 1),
    "high": Precision("high", False, 3),
    "highest": Precision("highest", False, 3),
}


def as_precision(precision):
    """A ``Precision`` from its name (or itself)."""
    if isinstance(precision, Precision):
        return precision
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of "
                         f"{sorted(PRECISIONS)}")
    return PRECISIONS[precision]


@contextmanager
def matmul_precision(precision):
    """cuBLAS's TF32 switch set for ``precision`` inside the block, the
    caller's setting given back after it."""
    flags = torch.backends.cuda.matmul
    caller = flags.allow_tf32
    flags.allow_tf32 = as_precision(precision).tf32
    try:
        yield
    finally:
        flags.allow_tf32 = caller


def _compact(*label_lists):
    """Relabel arbitrary hashable labels to 0..n-1 (``torch.einsum``'s
    sublist form takes ints below 52)."""
    ids = {}
    for labs in label_lists:
        for lab in labs:
            ids.setdefault(lab, len(ids))
    if len(ids) > 52:
        raise ValueError(f"{len(ids)} distinct labels: torch.einsum takes "
                         "at most 52")
    return [[ids[lab] for lab in labs] for labs in label_lists]


def pairwise_einsum(a, b, ix_a, ix_b, iy, precision="highest"):
    """Contract two tensors: ``ix_a`` / ``ix_b`` / ``iy`` are label lists
    (any hashable labels); ``iy`` may repeat labels of both inputs
    (hyperedge / batch semantics)."""
    la, lb, ly = _compact(ix_a, ix_b, iy)
    with matmul_precision(precision):
        return torch.einsum(a, la, b, lb, ly)
