// RGFlat kernel: the flat-row reduction form of an aligned (gathered) step,
// for the port's sparse executor.
//
// Replaces the Pallas kernel artensor_tpu/runtime/gatherk.py::_rgflat_kernel
// (RGFlat row of _ggk_call, pallas_call :1372).  Per gathered row b and
// slice instance w it computes
//   y[b, h, f] = sum_k x[gi[b], addr[f, k]] * w[gj[b], h, k]
// where the X row is read in its stored order (F*K complex elements, at
// most 2^15) and addr maps each (free cell f, contract value k) to its
// stored address; H <= 8 fresh legs, the output row is (H, F), h-major.
//
// Bound: device-memory bytes.  A row of the 10k batch is 128 complex
// elements (1 KB) and does 8*H flop per element.  The TPU kernel spread
// the row over its lanes with two 0/1 digit matrices on the MXU; here the
// digit bookkeeping is one address table, and the design is a warp per
// (row b, slice w): lane (o, q) owns output o = h*F + f and sums the k
// with k % KL == q (KL lanes per output, the shuffle tree adds them), so a
// row of H*F < 32 outputs still keeps every lane busy.  The row's loads
// stay within its few cache lines, which L1 serves after the first touch;
// targets are lexsorted by X row, so a repeated row lands in neighbouring
// warps of one block.  Rows are read by index straight from the source
// buffers: no gathered copy exists.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_H = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
rgflat_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              const float* __restrict__ wr, const float* __restrict__ wi,
              float* __restrict__ yr, float* __restrict__ yi,
              const long long* __restrict__ gi,
              const long long* __restrict__ gj,
              const long long* __restrict__ addr,
              long long B, int F, int K, int H, int KL,
              long long x_ws, long long w_ws, long long y_ws)
{
    const long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B)
        return;                  // warp-uniform: the shuffles below see
                                 // either the whole warp or none of it
    const long long w = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const int q = lane & (KL - 1);
    const int per_pass = 32 / KL;
    const int HF = H * F;
    const long long xb = w * x_ws + gi[b] * ((long long)F * K);
    const long long wb = w * w_ws + gj[b] * ((long long)H * K);
    const long long yb = w * y_ws + b * (long long)HF;

    for (int o0 = 0; o0 < HF; o0 += per_pass) {
        const int o = o0 + lane / KL;
        float sr = 0.f, si = 0.f;
        if (o < HF) {
            const int h = o / F;
            const long long* ad = addr + (long long)(o - h * F) * K;
            const long long wh = wb + (long long)h * K;
            for (int k = q; k < K; k += KL) {
                const long long a = xb + __ldg(ad + k);
                const float ar = xr[a], ai = xi[a];
                const float br = wr[wh + k], bi = wi[wh + k];
                sr = fmaf(ar, br, sr);
                sr = fmaf(-ai, bi, sr);
                si = fmaf(ar, bi, si);
                si = fmaf(ai, br, si);
            }
        }
        for (int d = KL >> 1; d > 0; d >>= 1) {
            sr += __shfl_xor_sync(0xffffffffu, sr, d);
            si += __shfl_xor_sync(0xffffffffu, si, d);
        }
        if (o < HF && q == 0) {
            yr[yb + o] = sr;
            yi[yb + o] = si;
        }
    }
}

}  // namespace

extern "C" int rgflat_launch(const float* xr, const float* xi,
                             const float* wr, const float* wi,
                             float* yr, float* yi,
                             const long long* gi, const long long* gj,
                             const long long* addr,
                             long long B, int F, int K, int H,
                             long long x_ws, long long w_ws, long long y_ws,
                             int W, void* stream)
{
    if (B <= 0 || W <= 0 || W > 65535 || H < 1 || H > MAX_H || F < 1
        || K < 1 || (B + WARPS - 1) / WARPS > 0x7fffffffLL)
        return (int)cudaErrorInvalidConfiguration;
    // lanes per output: as many as the warp has left over when H*F < 32
    // (a power of two, so the shuffle tree adds exactly KL partial sums)
    int KL = 1;
    while (KL < 32 && (long long)H * F * KL * 2 <= 32 && KL < K)
        KL *= 2;
    dim3 grid((unsigned)((B + WARPS - 1) / WARPS), (unsigned)W);
    rgflat_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        xr, xi, wr, wi, yr, yi, gi, gj, addr, B, F, K, H, KL,
        x_ws, w_ws, y_ws);
    return (int)cudaGetLastError();
}
