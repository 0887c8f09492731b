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
// (complex_batched_matmul, pallas_call :61): (B, M, K) . (B, K, N) ->
// (B, M, N), the batch a grid axis.  The TPU kernel raised unless its
// 256-tiles divided M and N; this one masks the ragged tiles.  It is on no
// path of the port (nor of the JAX package).
//
// Bound: operations.  With K = 256..1024 and M, N in the hundreds to
// thousands a step does 8*M*N*K flop on 8*(M*K + K*N + M*N) bytes, far
// above the card's balance.  The JAX kernels multiply at Precision.HIGHEST
// (float32 accuracy from multi-pass bf16 on the MXU); here the product
// runs on the tensor cores as 3xTF32: 3 x 8*M*N*K flop at 495 TFLOP/s
// TF32, a bound 2.5x below the 67 TFLOP/s float32 FMA rate that capped
// the earlier register-tiled FMA kernel (and cuBLAS's complex64 product).
// Pair runs on wgmma (wgmma_core.cuh, pair_wgmma_kernel: 128 x 64 tiles,
// a producer and two consumer warpgroups, a cp.async ring of 16-byte
// copies where M, N and the buffers allow, else 4-byte, a persistent
// grid); the complex matmul on
// mma.sync (tc_core.cuh, cmm_kernel: 128 x 128 tiles, 8 warps of 64 x 32,
// K in chunks of 16 through a 4-stage cp.async ring, each k8 step's
// products of a warp's row of 4 output tiles formed at once, one block an
// SM at up to 255 registers).  ``passes`` 1 runs the one-pass TF32 form
// (precision "default").

#include "runs.cuh"
#include "tc_core.cuh"
#include "wgmma_core.cuh"

namespace {

// 128 x 128 tiles, 8 warps of 64 x 32, 4 stages of K 16
using CmmTile = tc::Tile<4, 4, 2, 4>;

// launches that ran on the card (runs.cuh): Pair, the complex matmul
__device__ unsigned long long g_runs[2];

template <int PASSES>
__global__ void __launch_bounds__(CmmTile::THREADS, 1)
cmm_kernel(tc::Operands p, int n_mtiles)
{
    runs::count(&g_runs[1]);
    tc::cgemm<CmmTile, true, false, true, PASSES>(p, n_mtiles);
}

template <int PASSES, bool VEC>
__global__ void __launch_bounds__(384, 1)   // wgmma_core.cuh: wg::gemm
pair_wgmma_kernel(wg::Operands p)
{
    runs::count(&g_runs[0]);
    wg::gemm<false, 64, PASSES, VEC>(p);
}

// Pair on wgmma: X (K, M), V (K, N) rows; 16-byte copies (VEC) where M,
// N, the width strides and the buffers lie on 16 bytes
template <bool VEC>
int pair_wgmma(const wg::Operands& p, int W, int passes, cudaStream_t s)
{
    return passes == 1
        ? wg::launch<false, 64, 1, VEC>(pair_wgmma_kernel<1, VEC>, p, W, s)
        : wg::launch<false, 64, 3, VEC>(pair_wgmma_kernel<3, VEC>, p, W, s);
}

tc::Operands operands(const float* ar, const float* ai, const float* br,
                      const float* bi, float* yr, float* yi, int M, int N,
                      int K, long long lda, long long a_ws, long long b_ws,
                      long long y_ws)
{
    tc::Operands p{};
    p.ar = ar; p.ai = ai; p.br = br; p.bi = bi; p.yr = yr; p.yi = yi;
    p.M = M; p.N = N; p.K = K;
    p.lda = lda; p.ldb = N; p.ldy = N;
    p.a_ws = a_ws; p.b_ws = b_ws; p.y_ws = y_ws;
    p.F = 1;
    const bool ptrs = tc::aligned16(ar) && tc::aligned16(ai) &&
                      tc::aligned16(br) && tc::aligned16(bi) &&
                      tc::aligned16(yr) && tc::aligned16(yi);
    p.vec_a = ptrs && lda % 4 == 0 && a_ws % 4 == 0;
    p.vec = ptrs && N % 4 == 0 && b_ws % 4 == 0 && y_ws % 4 == 0;
    return p;
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
                     v_ws % 4 == 0 && y_ws % 4 == 0 && tc::aligned16(xr) &&
                     tc::aligned16(xi) && tc::aligned16(vr) &&
                     tc::aligned16(vi) && tc::aligned16(yr) &&
                     tc::aligned16(yi);
    p.vec_v = vec;
    return vec ? pair_wgmma<true>(p, W, passes, (cudaStream_t)stream)
               : pair_wgmma<false>(p, W, passes, (cudaStream_t)stream);
}

// (B, M, K) . (B, K, N) -> (B, M, N); A = (ar, ai), B = (br, bi)
extern "C" int cmm_launch(const float* ar, const float* ai, const float* br,
                          const float* bi, float* yr, float* yi, int B,
                          int M, int K, int N, int passes, void* stream)
{
    if (!tc::passes_ok(passes))
        return (int)cudaErrorInvalidValue;
    const tc::Operands p = operands(ar, ai, br, bi, yr, yi, M, N, K, K,
                                    (long long)M * K, (long long)K * N,
                                    (long long)M * N);
    return tc::launch<CmmTile, true>(
        passes == 1 ? cmm_kernel<1> : cmm_kernel<3>, p, B,
        (cudaStream_t)stream);
}

// the launches that ran on the card, by slot (g_runs)
extern "C" int pair_runs(unsigned long long* out)
{
    return (int)cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs));
}
