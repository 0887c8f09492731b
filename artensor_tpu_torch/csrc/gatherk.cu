// Gather-K (GK) and gathered gather-K (GGK) kernels: split-complex f32
// products with scattered contract legs, for the port's sparse executor.
//
// Replaces the Pallas kernels of artensor_tpu/runtime/gatherk.py:
//   gk_launch   <- _gk_kernel / _gk_unbatched (pallas_call :1789) and the
//                  slice-batched _gk_kernel_bd / _gk_batched (:1869)
//   ggk_launch  <- _ggk_kernel via _ggk_call (pallas_call :1372), GK row
//
// Both compute, per slice instance w and outer index o,
//   Y[yb + h*hstride + f] = sum_k W[wb + h*K + k] * X[xb + koff[k] + f]
// with xb = w*x_ws + xoff[o], yb = w*y_ws + yoff[o] and
// wb = w*w_ws (+ woff[o] for GGK, where o runs over gathered rows and
// their grid legs).  The wrapper derives xoff / yoff / woff / koff from the
// plan: every free X leg outside the trailing run is an outer index with
// one X and one Y stride, the scattered contract legs are one table of K
// row offsets, and the trailing free run f is contiguous in X and in Y.
// W arrives pre-gathered to (H, K) rows.  A width stride of 0 reads a
// slice-invariant operand once for every instance.
//
// Bound: per outer index this is a (H x K) . (K x F) complex product with
// X read once and Y written once.  Arithmetic intensity is about
// K*H/(K+H) flop per byte, so small K*H steps (gate merges, K,H <= 16)
// are bound by device-memory bytes and the K = H = 64..128 steps by
// FP32 FMA throughput (no TF32: the JAX kernels run at HIGHEST precision).
// Design: a block owns a BH x BF output tile of one (w, o); K is walked in
// BK chunks staged in shared memory (X rows coalesced along f, W rows
// along k); each thread keeps RH x RF complex accumulators in registers.
// One of five tile shapes (4 x 256, 4 x 64, 16 x 128, 32 x 32, 64 x 64) is
// picked from H and F, so that a step with a small H or F (a GGK row with
// H = 2, F = 64; a GK step with H = F = 32) does not leave most of each
// tile idle.  No wgmma/TMA yet: a simple, correct kernel first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;

template <int RH, int RF, int TPH, int TPF>
__global__ void __launch_bounds__(TPH * TPF)
gk_tile_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               const float* __restrict__ wr, const float* __restrict__ wi,
               float* __restrict__ yr, float* __restrict__ yi,
               const long long* __restrict__ xoff,
               const long long* __restrict__ yoff,
               const long long* __restrict__ woff,
               const long long* __restrict__ koff,
               int H, int K, int F, long long hstride,
               long long x_ws, long long w_ws, long long y_ws,
               int n_htiles, int n_ftiles)
{
    constexpr int BH = RH * TPH;
    constexpr int BF = RF * TPF;
    constexpr int NT = TPH * TPF;
    __shared__ float a_r[BK][BH], a_i[BK][BH];
    __shared__ float b_r[BK][BF], b_i[BK][BF];
    __shared__ long long k_off[BK];

    long long bid = blockIdx.x;
    const int ft = (int)(bid % n_ftiles);
    bid /= n_ftiles;
    const int ht = (int)(bid % n_htiles);
    const long long o = bid / n_htiles;
    const long long w = blockIdx.y;

    const int tid = threadIdx.x;
    const int tx = tid % TPF;
    const int ty = tid / TPF;
    const int h0 = ht * BH;
    const int f0 = ft * BF;
    const long long xb = w * x_ws + xoff[o];
    const long long wb = w * w_ws + (woff ? woff[o] : 0);
    const long long yb = w * y_ws + yoff[o];

    float acc_r[RH][RF], acc_i[RH][RF];
#pragma unroll
    for (int i = 0; i < RH; ++i)
#pragma unroll
        for (int j = 0; j < RF; ++j) {
            acc_r[i][j] = 0.f;
            acc_i[i][j] = 0.f;
        }

    for (int k0 = 0; k0 < K; k0 += BK) {
        if (tid < BK)
            k_off[tid] = (k0 + tid < K) ? koff[k0 + tid] : 0;
        for (int e = tid; e < BH * BK; e += NT) {
            const int hh = e / BK, kk = e % BK;
            const int h = h0 + hh, k = k0 + kk;
            float vr = 0.f, vi = 0.f;
            if (h < H && k < K) {
                const long long a = wb + (long long)h * K + k;
                vr = wr[a];
                vi = wi[a];
            }
            a_r[kk][hh] = vr;
            a_i[kk][hh] = vi;
        }
        __syncthreads();
        for (int e = tid; e < BK * BF; e += NT) {
            const int kk = e / BF, ff = e % BF;
            const int k = k0 + kk, f = f0 + ff;
            float vr = 0.f, vi = 0.f;
            if (k < K && f < F) {
                const long long a = xb + k_off[kk] + f;
                vr = xr[a];
                vi = xi[a];
            }
            b_r[kk][ff] = vr;
            b_i[kk][ff] = vi;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float ar[RH], ai[RH], br[RF], bi[RF];
#pragma unroll
            for (int i = 0; i < RH; ++i) {
                ar[i] = a_r[kk][ty + i * TPH];
                ai[i] = a_i[kk][ty + i * TPH];
            }
#pragma unroll
            for (int j = 0; j < RF; ++j) {
                br[j] = b_r[kk][tx + j * TPF];
                bi[j] = b_i[kk][tx + j * TPF];
            }
#pragma unroll
            for (int i = 0; i < RH; ++i)
#pragma unroll
                for (int j = 0; j < RF; ++j) {
                    acc_r[i][j] = fmaf(ar[i], br[j], acc_r[i][j]);
                    acc_r[i][j] = fmaf(-ai[i], bi[j], acc_r[i][j]);
                    acc_i[i][j] = fmaf(ar[i], bi[j], acc_i[i][j]);
                    acc_i[i][j] = fmaf(ai[i], br[j], acc_i[i][j]);
                }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < RH; ++i) {
        const int h = h0 + ty + i * TPH;
        if (h >= H) continue;
#pragma unroll
        for (int j = 0; j < RF; ++j) {
            const int f = f0 + tx + j * TPF;
            if (f < F) {
                const long long a = yb + (long long)h * hstride + f;
                yr[a] = acc_r[i][j];
                yi[a] = acc_i[i][j];
            }
        }
    }
}

template <int RH, int RF, int TPH, int TPF>
int launch_tile(const float* xr, const float* xi, const float* wr,
                const float* wi, float* yr, float* yi,
                const long long* xoff, const long long* yoff,
                const long long* woff, const long long* koff,
                long long O, int H, int K, int F, long long hstride,
                long long x_ws, long long w_ws, long long y_ws, int W,
                cudaStream_t stream)
{
    constexpr int BH = RH * TPH, BF = RF * TPF;
    const int n_htiles = (H + BH - 1) / BH;
    const int n_ftiles = (F + BF - 1) / BF;
    const long long nblk = O * n_htiles * n_ftiles;
    if (nblk <= 0 || nblk > 0x7fffffffLL || W <= 0 || W > 65535)
        return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)nblk, (unsigned)W);
    gk_tile_kernel<RH, RF, TPH, TPF><<<grid, TPH * TPF, 0, stream>>>(
        xr, xi, wr, wi, yr, yi, xoff, yoff, woff, koff, H, K, F, hstride,
        x_ws, w_ws, y_ws, n_htiles, n_ftiles);
    return (int)cudaGetLastError();
}

int launch_any(const float* xr, const float* xi, const float* wr,
               const float* wi, float* yr, float* yi,
               const long long* xoff, const long long* yoff,
               const long long* woff, const long long* koff,
               long long O, int H, int K, int F, long long hstride,
               long long x_ws, long long w_ws, long long y_ws, int W,
               void* stream)
{
    cudaStream_t s = (cudaStream_t)stream;
    if (H <= 4 && F >= 256)        // 4 x 256 tiles: gate-merge steps
        return launch_tile<4, 1, 1, 256>(xr, xi, wr, wi, yr, yi, xoff, yoff,
                                         woff, koff, O, H, K, F, hstride,
                                         x_ws, w_ws, y_ws, W, s);
    if (H <= 4)                    // 4 x 64 tiles: F is 32..224
        return launch_tile<4, 1, 1, 64>(xr, xi, wr, wi, yr, yi, xoff, yoff,
                                        woff, koff, O, H, K, F, hstride,
                                        x_ws, w_ws, y_ws, W, s);
    if (H <= 16 && F >= 128)       // 16 x 128 tiles
        return launch_tile<4, 2, 4, 64>(xr, xi, wr, wi, yr, yi, xoff, yoff,
                                        woff, koff, O, H, K, F, hstride,
                                        x_ws, w_ws, y_ws, W, s);
    if (H <= 32 || F <= 32)        // 32 x 32 tiles
        return launch_tile<2, 2, 16, 16>(xr, xi, wr, wi, yr, yi, xoff, yoff,
                                         woff, koff, O, H, K, F, hstride,
                                         x_ws, w_ws, y_ws, W, s);
    return launch_tile<4, 4, 16, 16>(xr, xi, wr, wi, yr, yi, xoff, yoff,  // 64 x 64
                                     woff, koff, O, H, K, F, hstride,
                                     x_ws, w_ws, y_ws, W, s);
}

}  // namespace

extern "C" int gk_launch(const float* xr, const float* xi, const float* wr,
                         const float* wi, float* yr, float* yi,
                         const long long* xoff, const long long* yoff,
                         const long long* koff, long long O, int H, int K,
                         int F, long long hstride, long long x_ws,
                         long long w_ws, long long y_ws, int W, void* stream)
{
    return launch_any(xr, xi, wr, wi, yr, yi, xoff, yoff, nullptr, koff, O,
                      H, K, F, hstride, x_ws, w_ws, y_ws, W, stream);
}

extern "C" int ggk_launch(const float* xr, const float* xi, const float* wr,
                          const float* wi, float* yr, float* yi,
                          const long long* xoff, const long long* yoff,
                          const long long* woff, const long long* koff,
                          long long O, int H, int K, int F, long long hstride,
                          long long x_ws, long long w_ws, long long y_ws,
                          int W, void* stream)
{
    return launch_any(xr, xi, wr, wi, yr, yi, xoff, yoff, woff, koff, O, H,
                      K, F, hstride, x_ws, w_ws, y_ws, W, stream);
}
