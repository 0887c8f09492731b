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
// its 256-tiles divided M and N; this one masks the ragged tiles.  The
// port's dot fallback runs its split products on it (ops/field.py,
// SplitField.dot, where ops/pallas_mm.cmm_route sends them), at the tile
// ops/pallas_mm.cmm_tile picks from the product's shape: the N tile
// (64, 32 or 16), the K chunk (32 or 16), the role swap (Y^T = B^T . A^T
// where M is below the 128-row tile and N above it) and the passes.
// An operand of batch stride 0 is read once for every batch entry.
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

// the complex matmul: A (M, K) in the A role (A_MK), or, SWAP, B (K, N)
template <int PASSES, bool VEC, int BN = 64, int BK = 32, bool SWAP = false>
__global__ void __launch_bounds__(384, 1)   // wgmma_core.cuh: wg::gemm
cmm_wgmma_kernel(wg::Operands p)
{
    runs::count(&g_runs[1]);
    wg::gemm<wg::Cfg<false, BN, PASSES, VEC, BK, !SWAP, SWAP>>(p);
}

// Pair (A_MK false) or the complex matmul (true) in ``PASSES`` passes,
// 16-byte copies (VEC) where the rows, width strides and buffers lie on 16
// bytes; the complex matmul at N tile BN, K chunk BK, maybe swapped
template <bool A_MK, int PASSES, bool VEC, int BN = 64, int BK = 32,
          bool SWAP = false>
int wgmma_kernel(const wg::Operands& p, int W, cudaStream_t s)
{
    using C = wg::Cfg<false, BN, PASSES, VEC, BK, A_MK && !SWAP, SWAP>;
    static unsigned attr = 0;    // wg::launch: the kernel's devices
    if constexpr (A_MK)
        return wg::launch<C>(cmm_wgmma_kernel<PASSES, VEC, BN, BK, SWAP>,
                             attr, p, W, s);
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

// the complex matmul's float32-class tiles: N tile bn, K chunk bk, swapped
// or not, in PASSES 3 (3xTF32) or 6 (the three-term split)
template <bool VEC, int BN, int BK, int PASSES>
int cmm_tile(const wg::Operands& p, int W, bool swap, cudaStream_t s)
{
    return swap ? wgmma_kernel<true, PASSES, VEC, BN, BK, true>(p, W, s)
                : wgmma_kernel<true, PASSES, VEC, BN, BK, false>(p, W, s);
}

// passes 6 runs the 16-deep K chunk alone (its products are K < 16)
template <bool VEC>
int cmm_tiles(const wg::Operands& p, int W, int bn, int bk, bool swap,
              int passes, cudaStream_t s)
{
    if (passes == 6)
        return bn == 16 ? cmm_tile<VEC, 16, 16, 6>(p, W, swap, s)
             : bn == 32 ? cmm_tile<VEC, 32, 16, 6>(p, W, swap, s)
                        : cmm_tile<VEC, 64, 16, 6>(p, W, swap, s);
    if (bk == 16)
        return bn == 16 ? cmm_tile<VEC, 16, 16, 3>(p, W, swap, s)
             : bn == 32 ? cmm_tile<VEC, 32, 16, 3>(p, W, swap, s)
                        : cmm_tile<VEC, 64, 16, 3>(p, W, swap, s);
    return bn == 16 ? cmm_tile<VEC, 16, 32, 3>(p, W, swap, s)
         : bn == 32 ? cmm_tile<VEC, 32, 32, 3>(p, W, swap, s)
                    : cmm_tile<VEC, 64, 32, 3>(p, W, swap, s);
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

// (B, M, K) . (B, K, N) -> (B, M, N); A = (ar, ai), B = (br, bi), each
// batch entry a_ws / b_ws floats on (M K / K N, or 0: the same matrix for
// every entry); the batch is the core's width axis.  The tile: N tile bn
// (64, 32, 16) and K chunk bk (32, 16), the role swap (swap: X = B, V = A,
// Y^T stored); passes 3 (3xTF32), 6 (the
// three-term split, K chunk 16) or 1 (one pass: the 128 x 64 x 32 tile
// unswapped alone)
extern "C" int cmm_launch(const float* ar, const float* ai, const float* br,
                          const float* bi, float* yr, float* yi, int B,
                          int M, int K, int N, long long a_ws, long long b_ws,
                          int bn, int bk, int swap, int passes, void* stream)
{
    if ((!tc::passes_ok(passes) && passes != 6) ||
        (bn != 16 && bn != 32 && bn != 64) || (bk != 16 && bk != 32) ||
        (passes == 1 && (bn != 64 || bk != 32 || swap)) ||
        (passes == 6 && bk != 16))
        return (int)cudaErrorInvalidValue;
    wg::Operands p{};
    p.F = 1;
    p.K = K;
    p.y_ws = (long long)M * N;
    const cudaStream_t s = (cudaStream_t)stream;
    const bool ok16 = aligned16(ar, ai, br, bi, yr, yi) && a_ws % 4 == 0 &&
                      b_ws % 4 == 0;
    if (swap) {
        // Y^T (N, M) = B^T . A^T: X is B, (K, N) rows as Pair's (K, M); V
        // is A, (M, K) rows as GK's W; Y^T's column m at m N
        p.xr = br; p.xi = bi; p.vr = ar; p.vi = ai; p.yr = yr; p.yi = yi;
        p.M = N; p.N = M;
        p.x_ws = b_ws; p.v_ws = a_ws;
        p.ldy = N;
        const bool vec = N % 4 == 0 && ok16;
        p.vec_v = K % 4 == 0 && ok16;
        return vec ? cmm_tiles<true>(p, B, bn, bk, true, passes, s)
                   : cmm_tiles<false>(p, B, bn, bk, true, passes, s);
    }
    p.xr = ar; p.xi = ai; p.vr = br; p.vi = bi; p.yr = yr; p.yi = yi;
    p.M = M; p.N = N;
    p.x_ws = a_ws; p.v_ws = b_ws;
    p.ldy = N;
    // A's rows (k) and B's and Y's (n) on the 4-float grid, and the batch
    // strides
    const bool vec = K % 4 == 0 && N % 4 == 0 && ok16;
    p.vec_v = vec;
    if (passes == 1)
        return wgmma<true>(p, B, passes, vec, s);
    return vec ? cmm_tiles<true>(p, B, bn, bk, false, passes, s)
               : cmm_tiles<false>(p, B, bn, bk, false, passes, s);
}

// the launches that ran on the card, by slot (g_runs)
extern "C" int pair_runs(unsigned long long* out)
{
    return (int)cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs));
}
