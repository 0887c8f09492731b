// Pair kernel: both-big split-complex product (K, M)^T . (K, N) -> (M, N),
// for the port's sparse executor; and the same product with A stored
// (M, K), the fused complex batched matmul of ops/pallas_mm.py.
//
// pair_launch replaces the Pallas kernels
// artensor_tpu/runtime/lanes.py::_pair_kernel and _pair_kernel_b
// (apply_pair_step, pallas_call :931 and :953).  The wrapper has already
// applied the plan's re_i / re_j reorders and the v_perm row gather, so
// both operands are dense row-major (K, M) and (K, N).  A width stride of
// 0 reads a slice-invariant operand once for every instance.
//
// cmm_launch replaces artensor_tpu/ops/pallas_mm.py::_kernel
// (complex_batched_matmul, pallas_call :61): (B, M, K) . (B, K, N) -> (B, M,
// N), the batch the width axis of the product.  The TPU kernel raised unless
// its 256-tiles divided M and N; this one masks the ragged tiles.  It is on
// no path of the port (nor of the JAX package).
//
// Bound: operations.  With K = 256..1024 and M, N in the hundreds to
// thousands a step does 8*M*N*K flop on 8*(M*K + K*N + M*N) bytes, far
// above the card's balance.  The JAX kernels multiply at Precision.HIGHEST
// (float32 accuracy from multi-pass bf16 on the MXU); here the product
// runs on the tensor cores as 3xTF32: 3 x 8*M*N*K flop at 495 TFLOP/s
// TF32, a bound 2.5x below the 67 TFLOP/s float32 FMA rate that capped
// the earlier register-tiled FMA kernel (and cuBLAS's complex64 product).
// Both run on wgmma (wgmma_core.cuh: 128 x 64 tiles, a producer and two
// consumer warpgroups, a cp.async ring of 16-byte copies where the rows
// and buffers allow, else 4-byte, a persistent grid): Pair as
// pair_wgmma_kernel, X (K, M) read as [k][m] tiles; the complex matmul as
// cmm_wgmma_kernel, A (M, K) read as [m][k] tiles (the core's A_MK), B
// (K, N) as Pair's V.  ``passes`` 1 runs the one-pass TF32 form
// (precision "default").

#include "runs.cuh"
#include "tc_core.cuh"
#include "wgmma_core.cuh"

namespace {

// launches that ran on the card (runs.cuh): Pair, the complex matmul
__device__ unsigned long long g_runs[2];

template <int PASSES, bool VEC>
__global__ void __launch_bounds__(384, 1)   // wgmma_core.cuh: wg::gemm
pair_wgmma_kernel(wg::Operands p)
{
    runs::count(&g_runs[0]);
    wg::gemm<wg::Cfg<false, 64, PASSES, VEC>>(p);
}

template <int PASSES, bool VEC>
__global__ void __launch_bounds__(384, 1)   // wgmma_core.cuh: wg::gemm
cmm_wgmma_kernel(wg::Operands p)
{
    runs::count(&g_runs[1]);
    wg::gemm<wg::Cfg<false, 64, PASSES, VEC, 32, true>>(p);
}

// Pair (A_MK false) or the complex matmul (true) in ``PASSES`` passes,
// 16-byte copies (VEC) where the rows, width strides and buffers lie on 16
// bytes
template <bool A_MK, int PASSES, bool VEC>
int wgmma_kernel(const wg::Operands& p, int W, cudaStream_t s)
{
    using C = wg::Cfg<false, 64, PASSES, VEC, 32, A_MK>;
    static unsigned attr = 0;    // wg::launch: the kernel's devices
    if constexpr (A_MK)
        return wg::launch<C>(cmm_wgmma_kernel<PASSES, VEC>, attr, p, W, s);
    else
        return wg::launch<C>(pair_wgmma_kernel<PASSES, VEC>, attr, p, W, s);
}

template <bool A_MK>
int wgmma(const wg::Operands& p, int W, int passes, bool vec, cudaStream_t s)
{
    if (passes == 1)
        return vec ? wgmma_kernel<A_MK, 1, true>(p, W, s)
                   : wgmma_kernel<A_MK, 1, false>(p, W, s);
    return vec ? wgmma_kernel<A_MK, 3, true>(p, W, s)
               : wgmma_kernel<A_MK, 3, false>(p, W, s);
}

bool aligned16(const float* a, const float* b, const float* c,
               const float* d, const float* e, const float* f)
{
    return tc::aligned16(a) && tc::aligned16(b) && tc::aligned16(c) &&
           tc::aligned16(d) && tc::aligned16(e) && tc::aligned16(f);
}

}  // namespace

extern "C" int pair_launch(const float* xr, const float* xi, const float* vr,
                           const float* vi, float* yr, float* yi, int K,
                           int M, int N, long long x_ws, long long v_ws,
                           long long y_ws, int W, int passes, void* stream)
{
    if (!tc::passes_ok(passes))
        return (int)cudaErrorInvalidValue;
    wg::Operands p{};
    p.xr = xr; p.xi = xi; p.vr = vr; p.vi = vi; p.yr = yr; p.yi = yi;
    p.M = M; p.N = N; p.K = K;
    p.x_ws = x_ws; p.v_ws = v_ws; p.y_ws = y_ws;
    p.ldy = N; p.F = 1;
    const bool vec = M % 4 == 0 && N % 4 == 0 && x_ws % 4 == 0 &&
                     v_ws % 4 == 0 && y_ws % 4 == 0 &&
                     aligned16(xr, xi, vr, vi, yr, yi);
    p.vec_v = vec;
    return wgmma<false>(p, W, passes, vec, (cudaStream_t)stream);
}

// (B, M, K) . (B, K, N) -> (B, M, N); A = (ar, ai), B = (br, bi); the
// batch is the core's width axis
extern "C" int cmm_launch(const float* ar, const float* ai, const float* br,
                          const float* bi, float* yr, float* yi, int B,
                          int M, int K, int N, int passes, void* stream)
{
    if (!tc::passes_ok(passes))
        return (int)cudaErrorInvalidValue;
    wg::Operands p{};
    p.xr = ar; p.xi = ai; p.vr = br; p.vi = bi; p.yr = yr; p.yi = yi;
    p.M = M; p.N = N; p.K = K;
    p.x_ws = (long long)M * K; p.v_ws = (long long)K * N;
    p.y_ws = (long long)M * N;
    p.ldy = N; p.F = 1;
    // A's rows (k) and B's and Y's (n) on the 4-float grid: then every
    // width stride is too
    const bool vec = K % 4 == 0 && N % 4 == 0 &&
                     aligned16(ar, ai, br, bi, yr, yi);
    p.vec_v = vec;
    return wgmma<true>(p, B, passes, vec, (cudaStream_t)stream);
}

// the launches that ran on the card, by slot (g_runs)
extern "C" int pair_runs(unsigned long long* out)
{
    return (int)cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs));
}
