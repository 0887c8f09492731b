"""Fused split-complex batched matmul: (B, M, K) . (B, K, N) -> (B, M, N).

Port of ``artensor_tpu/ops/pallas_mm.py``.  One complex product in split
representation is four real products (re = ar.br - ai.bi, im = ar.bi +
ai.br); the kernel (``cmm_launch`` in ``csrc/pair.cu``: the pair kernel's
wgmma product with A stored (M, K), ``csrc/wgmma_core.cuh``) fuses all
four per output tile, reading each operand tile once for both its
products, at 3xTF32 (or one TF32 pass).  The batch is the product's width
axis.  Unlike the TPU kernel it takes any M, N and K (ragged tiles are
masked) rather than raising when its tiles do not divide them.

The port's dot fallback runs its split products on it where
``cmm_route`` sends them (``ops/field.SplitField.dot``), as the JAX
package's dot fallback does not (XLA's dot there).  The tile is picked
from the product's shape alone (``cmm_tile``).  The wrapper takes its
plain PyTorch version (``complex_batched_matmul_plain``) only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
``complex_batched_matmul.launches`` counts kernel launches (none while a
CUDA graph is captured: ``kernels.launch``).
"""

import torch

from .. import kernels
from .einsum import as_precision


def complex_batched_matmul_plain(a, b, tf32=False):
    """Plain version: the four real products with ``torch.matmul``.
    ``tf32``: the operands rounded as the kernel's one-pass form rounds
    them (``kernels.tf32_round``), the products still in float32."""
    ar, ai = a
    br, bi = b
    if tf32:
        ar, ai, br, bi = map(kernels.tf32_round, (ar, ai, br, bi))
    return (torch.matmul(ar, br) - torch.matmul(ai, bi),
            torch.matmul(ar, bi) + torch.matmul(ai, br))


# the kernel's M tile (wgmma_core.cuh: Cfg::BM) and its largest batch (the
# core's slice width, wg::launch)
TILE_M = 128
MAX_BATCH = 65535
# Below K 16 the 3xTF32 product's largest error against float64 came out
# more than twice cuBLAS's float32 product's on some inputs (its operands
# carry 22 of float32's 24 bits, which a short sum does not hide), so
# those products take the three-term split (six products a real product).
SPLIT3_BELOW_K = 16
# The route's constants, from the kernel against four cuBLAS products at
# every product shape of the benchmark's four cells (an H100, PERF.md):
# below K 8 even the three-term split's error passed twice cuBLAS's on
# some inputs (the tensor cores' sums round toward zero, cuBLAS's short
# sums to nearest); the kernel's 3xTF32 product ran at 50-54% of the TF32
# peak at the compute-bound shapes, cuBLAS's FP32 products at 52-63% of
# the FMA peak; a launch-bound product took the kernel 7 us and cuBLAS
# 15-29 us, a gain too small to pay for the error each product on the
# tensor cores adds along a contraction (their sums round toward zero):
# with those routed too, sparse-1k-sc25's amplitudes came out 2.7e-6 from
# the reference (relative l2) against 7.6e-7 on cuBLAS, 9.8e-7 without
# them.  So products below LAUNCH_S of work stay on cuBLAS.
ROUTE_MIN_K = 8
CMM_TC_SHARE = 0.5
CUBLAS_FP32_SHARE = 0.5
LAUNCH_S = 10e-6


def cmm_tile(B, M, K, N):
    """The float32-class kernel's tile for a (B, M, K) . (B, K, N)
    product: ``(bn, bk, swap, passes)``.

    ``swap``: where M is below the 128-row M tile and N is not, the kernel
    computes Y^T = B^T . A^T, so that the long side fills the M tile.
    ``bn``: the N tile, the narrowest of 16, 32 and 64 that holds the
    (swapped) N side, so that a narrow product pays for few padded columns
    (16 multiplies re and im side by side in one 32-wide instruction).
    ``bk``: the K chunk, 16 for K <= 16 (a 32-deep chunk would copy and
    split half a chunk of zeros), else 32.  ``passes``: 3 (3xTF32), or 6,
    the three-term split, below K ``SPLIT3_BELOW_K``."""
    swap = M < TILE_M <= N
    n = M if swap else N
    bn = 16 if n <= 16 else 32 if n <= 32 else 64
    bk = 16 if K <= 16 else 32
    return bn, bk, swap, 6 if K < SPLIT3_BELOW_K else 3


def cmm_route(B, M, K, N, device, precision, algo, storage):
    """Whether the dot fallback's split product (B, M, K) . (B, K, N) runs
    on this kernel (else four cuBLAS products, ``field._split_dot``): on a
    CUDA device, float32 storage, the naive algorithm, at a precision of
    3xTF32 ('highest' or 'high'), a batch the kernel takes, K at least
    ``ROUTE_MIN_K`` (float32 accuracy), at least ``LAUNCH_S`` of work (the
    larger of the operands' bytes at the card's bandwidth and the products
    at ``CUBLAS_FP32_SHARE`` of the FP32 peak), and where the kernel's
    padded tensor-core work (``cmm_tile``'s tiles, at ``CMM_TC_SHARE`` of
    the TF32 peak) takes no longer than that: a product whose padding
    would make the kernel compute-bound beyond cuBLAS stays there.  A pure
    function of its arguments."""
    if torch.device(device).type != "cuda" or storage != "f32" \
            or algo != "naive" or as_precision(precision).passes != 3 \
            or B > MAX_BATCH or K < ROUTE_MIN_K:
        return False
    bn, _, swap, passes = cmm_tile(B, M, K, N)
    m, n = (N, M) if swap else (M, N)
    pad = lambda x, t: -(-x // t) * t
    tc_s = passes * 8 * B * pad(m, TILE_M) * pad(K, 8) * pad(n, bn) / (
        CMM_TC_SHARE * kernels.H100_TF32_FLOP_PER_S)
    bytes_s = 8 * B * (M * K + K * N + M * N) / kernels.H100_HBM_BYTES_PER_S
    fp32_s = 8 * B * M * K * N / (CUBLAS_FP32_SHARE
                                   * kernels.H100_FP32_FLOP_PER_S)
    return LAUNCH_S <= max(bytes_s, fp32_s) and tc_s <= max(bytes_s, fp32_s)


def _batch_stride(t, rows, cols):
    """The batch stride of a (B, rows, cols) operand whose matrices are
    row-major: rows * cols, or 0 for one matrix read by every entry."""
    if t.stride(-1) != 1 and cols > 1 or t.stride(-2) != cols and rows > 1:
        raise ValueError("complex_mm: operand matrices must be row-major")
    if t.shape[0] > 1 and t.stride(0) not in (0, rows * cols):
        raise ValueError(f"complex_mm: batch stride {t.stride(0)}, "
                         f"expected {rows * cols} or 0")
    return 0 if t.shape[0] > 1 and t.stride(0) == 0 else rows * cols


def complex_batched_matmul(a, b, passes=3):
    """``(re, im)`` of the batched product of A = ``(ar, ai)`` (each
    ``(B, M, K)`` float32) and B = ``(br, bi)`` (each ``(B, K, N)``).
    ``passes``: 3 (float32 class: 3xTF32 or the three-term split, at
    ``cmm_tile``'s tile) or 1 (one TF32 pass, precision 'default':
    ``kernels.tc_passes``; the 128 x 64 x 32 tile);
    the CPU's plain version multiplies in float32 at either.  On the card
    an operand may be an expanded view of one matrix (batch stride 0),
    which is read once for every batch entry."""
    ar, ai = a
    br, bi = b
    if ar.dim() != 3 or br.dim() != 3:
        raise ValueError("complex_batched_matmul: operands must be 3-D")
    B, M, K = ar.shape
    N = br.shape[2]
    dev = kernels.check_operands("complex_mm", (ar, ai, br, bi),
                                 ((B, M, K),) * 2 + ((B, K, N),) * 2,
                                 contiguous=False)
    if dev.type == "cpu":
        return complex_batched_matmul_plain(a, b)
    a_ws = _batch_stride(ar, M, K)
    b_ws = _batch_stride(br, K, N)
    if (_batch_stride(ai, M, K), _batch_stride(bi, K, N)) != (a_ws, b_ws):
        raise ValueError("complex_mm: re and im strides differ")
    bn, bk, swap, passes = cmm_tile(B, M, K, N) if passes == 3 \
        else (64, 32, False, 1)
    yr = torch.empty((B, M, N), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    n = kernels.launch("complex_mm", kernels.load().cmm_launch, dev,
                       *map(kernels.ptr, (ar, ai, br, bi, yr, yi)), B, M, K, N,
                       a_ws, b_ws, bn, bk, int(swap), passes)
    complex_batched_matmul.launches += n
    complex_batched_matmul.one_pass += n if passes == 1 else 0
    return yr, yi


complex_batched_matmul.launches = 0
complex_batched_matmul.one_pass = 0     # launches in one TF32 pass
