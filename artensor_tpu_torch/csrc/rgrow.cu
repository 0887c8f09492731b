// RGRow kernel: the reduction form of an aligned (gathered) step, for the
// port's sparse executor.
//
// Replaces the Pallas kernel artensor_tpu/runtime/gatherk.py::_rg_kernel
// (RGRow row of _ggk_call, pallas_call :1372).  Per gathered row b and
// slice instance w it computes
//   y[b, h, f] = sum_k x[gi[b], f, k] * w[gj[b], h, k]
// with F < 32 free cells, K >= 128 contract values and H <= 8 fresh legs,
// after the wrapper's optional canonical (F, K) reorder of X.  The output
// row is (H, F) when the fresh block leads, else (F, H).
//
// Bound: device-memory bytes.  Each gathered X row (F*K complex) is read
// once per row and does 8*H flop per element, far below the card's
// flop/byte balance.  Design: one block per (b, w); each warp takes one
// free cell f at a time and its 32 lanes stride over k, so every X and W
// read is a coalesced 128-byte line; the 2*H partial sums stay in
// registers and are reduced with warp shuffles.  The W row (H*K) is
// re-read per f from L1/L2, which F < 32 keeps cheap.  Rows are read by
// index straight from the source buffers: no gathered copy exists.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_H = 8;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rgrow_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
             const float* __restrict__ wr, const float* __restrict__ wi,
             float* __restrict__ yr, float* __restrict__ yi,
             const long long* __restrict__ gi,
             const long long* __restrict__ gj,
             int F, int K, int H, int hy_first,
             long long x_ws, long long w_ws, long long y_ws)
{
    const long long b = blockIdx.x;
    const long long w = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long xrow = (long long)F * K;
    const long long xb = w * x_ws + gi[b] * xrow;
    const long long wb = w * w_ws + gj[b] * (long long)H * K;
    const long long yb = w * y_ws + b * (long long)H * F;

    for (int f = warp; f < F; f += THREADS / 32) {
        float sr[MAX_H], si[MAX_H];
#pragma unroll
        for (int h = 0; h < MAX_H; ++h) {
            sr[h] = 0.f;
            si[h] = 0.f;
        }
        const long long xf = xb + (long long)f * K;
        for (int k = lane; k < K; k += 32) {
            const float ar = xr[xf + k], ai = xi[xf + k];
#pragma unroll
            for (int h = 0; h < MAX_H; ++h) {
                if (h < H) {
                    const long long a = wb + (long long)h * K + k;
                    const float br = wr[a], bi = wi[a];
                    sr[h] = fmaf(ar, br, sr[h]);
                    sr[h] = fmaf(-ai, bi, sr[h]);
                    si[h] = fmaf(ar, bi, si[h]);
                    si[h] = fmaf(ai, br, si[h]);
                }
            }
        }
#pragma unroll
        for (int h = 0; h < MAX_H; ++h) {
#pragma unroll
            for (int d = 16; d > 0; d >>= 1) {
                sr[h] += __shfl_down_sync(0xffffffffu, sr[h], d);
                si[h] += __shfl_down_sync(0xffffffffu, si[h], d);
            }
        }
        if (lane == 0) {
            for (int h = 0; h < H; ++h) {
                const long long a = yb + (hy_first ? (long long)h * F + f
                                                   : (long long)f * H + h);
                yr[a] = sr[h];
                yi[a] = si[h];
            }
        }
    }
}

}  // namespace

extern "C" int rgrow_launch(const float* xr, const float* xi, const float* wr,
                            const float* wi, float* yr, float* yi,
                            const long long* gi, const long long* gj,
                            long long B, int F, int K, int H, int hy_first,
                            long long x_ws, long long w_ws, long long y_ws,
                            int W, void* stream)
{
    if (B <= 0 || B > 0x7fffffffLL || W <= 0 || W > 65535 || H < 1
        || H > MAX_H || F < 1 || K < 1)
        return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)B, (unsigned)W);
    rgrow_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        xr, xi, wr, wi, yr, yi, gi, gj, F, K, H, hy_first, x_ws, w_ws, y_ws);
    return (int)cudaGetLastError();
}
