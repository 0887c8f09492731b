// The tensor-core operands' split and the cp.async copies: the pieces the
// port's tensor-core product (wgmma_core.cuh) and the RGFlat kernel
// (rgflat.cu) share.
//
// 3xTF32 (PASSES 3, precision "highest" and "high"): each operand is split
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi); a real product sums
// hi.hi + hi.lo + lo.hi (the lo.lo term, below 2^-22 of |a||b|, is
// dropped).  The relative error of a product is about 2^-21, near
// float32's 2^-24: the JAX kernels' Precision.HIGHEST products are
// multi-pass bf16 on the MXU at float32 accuracy, and this is the Hopper
// counterpart.  The one-pass form (PASSES 1, precision "default",
// ops/einsum.py) multiplies hi.hi alone, hi the operand with its low 13
// mantissa bits cleared (10 mantissa bits kept): the counterpart of the
// TPU's one bf16 pass, held on the card against a plain version whose
// operands are rounded the same way and multiplied in float32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t to_tf32(float x)
{
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo, both TF32; with one pass hi = x with its low 13 mantissa
// bits cleared (lo unused)
template <int PASSES>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo)
{
    if (PASSES == 1) {
        hi = __float_as_uint(x) & 0xffffe000u;
        lo = 0u;
    } else {
        hi = to_tf32(x);
        lo = to_tf32(x - __uint_as_float(hi));
    }
}

// x = hi + mid + lo, all TF32 (the three-term split: float32's 24 bits
// and more, where hi + lo above keeps 22)
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo)
{
    hi = to_tf32(x);
    const float r = x - __uint_as_float(hi);
    mid = to_tf32(r);
    lo = to_tf32(r - __uint_as_float(mid));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes)
{
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes)
{
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 4 consecutive floats s[0..3] -> d[0..3] asynchronously; elements at
// index >= lim read as 0.  ``base`` is a valid address for empty copies.
__device__ __forceinline__ void copy4(float* d, const float* s, int lim,
                                      bool vec, const float* base)
{
    if (vec) {
        const int n = lim < 0 ? 0 : (lim > 4 ? 4 : lim);
        cp16(d, n ? s : base, 4 * n);
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            cp4(d + e, e < lim ? s + e : base, e < lim ? 4 : 0);
    }
}

// a pass count the C entry points take (their kernels are instantiated
// for these)
inline bool passes_ok(int passes)
{
    return passes == 1 || passes == 3;
}

inline bool aligned16(const void* a)
{
    return ((uintptr_t)a & 15) == 0;
}

}  // namespace tc
