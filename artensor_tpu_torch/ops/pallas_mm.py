"""Fused split-complex batched matmul: (B, M, K) . (B, K, N) -> (B, M, N).

Port of ``artensor_tpu/ops/pallas_mm.py``.  One complex product in split
representation is four real products (re = ar.br - ai.bi, im = ar.bi +
ai.br); the kernel (``cmm_launch`` in ``csrc/pair.cu``: the pair kernel's
wgmma product with A stored (M, K), ``csrc/wgmma_core.cuh``) fuses all
four per output tile, reading each operand tile once for both its
products, at 3xTF32 (or one TF32 pass).  The batch is the product's width
axis.  Unlike the TPU kernel it takes any M, N and K (ragged tiles are
masked) rather than raising when its tiles do not divide them.

No path of the port calls it, as no path of the JAX package does.  The
wrapper takes its plain PyTorch version (``complex_batched_matmul_plain``)
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
``complex_batched_matmul.launches`` counts kernel launches (none while a
CUDA graph is captured: ``kernels.launch``).
"""

import torch

from .. import kernels


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


def complex_batched_matmul(a, b, passes=3):
    """``(re, im)`` of the batched product of A = ``(ar, ai)`` (each
    ``(B, M, K)`` float32) and B = ``(br, bi)`` (each ``(B, K, N)``).
    ``passes``: 3 (3xTF32) or 1 (one TF32 pass, precision 'default':
    ``kernels.tc_passes``); the CPU's plain version multiplies in float32
    at either."""
    ar, ai = a
    br, bi = b
    if ar.dim() != 3 or br.dim() != 3:
        raise ValueError("complex_batched_matmul: operands must be 3-D")
    B, M, K = ar.shape
    N = br.shape[2]
    dev = kernels.check_operands("complex_mm", (ar, ai, br, bi),
                                 ((B, M, K),) * 2 + ((B, K, N),) * 2)
    if dev.type == "cpu":
        return complex_batched_matmul_plain(a, b)
    yr = torch.empty((B, M, N), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    n = kernels.launch("complex_mm", kernels.load().cmm_launch, dev,
                       *map(kernels.ptr, (ar, ai, br, bi, yr, yi)), B, M, K, N,
                       passes)
    complex_batched_matmul.launches += n
    complex_batched_matmul.one_pass += n if passes == 1 else 0
    return yr, yi


complex_batched_matmul.launches = 0
complex_batched_matmul.one_pass = 0     # launches in one TF32 pass
