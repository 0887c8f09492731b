// Lane kernel: one big-by-small step whose contract legs sit at one end of
// the big operand's storage, for the port's sparse executor.
//
// Replaces the Pallas kernel artensor_tpu/runtime/lanes.py::_kernel
// (apply_lane_step, pallas_call :701).  For every grid point o (the plan's
// 'g' legs), output lane h and free-run index f it computes
//   y[yoff[o] + h*y_hs + f*y_fs] =
//       sum_t x[xoff[o] + doff[xd[t, h]] + f*x_fs] * w[wi[t, h]]
// over complex float32 values held as separate re / im planes.  The D =
// n_combos * L "lane rows" d of X (a combo and a lane value) sit at offset
// doff[d]; the table (xd, wi) lists only the nonzero entries of the plan's
// lane matrix Wp = w[wp_idx] * wp_sign: T terms per output, each a lane
// row and the W element it meets.  Both orientations are this one form:
// they differ only in the strides (head: f minor in X and Y; tail: the lane
// run minor in X and h minor in Y).
//
// Bound: device-memory bytes.  On the TPU the block-diagonal Wp fed the MXU
// at full width; its product does L / T times the real work (16x on the
// n30 sc25 path's step: T = 8 of L = 128), which on this card's float32
// FMA rate would cost 3x the time of moving the operands.  The table form
// does 8 flop per term, 8*T flop per output against 16 bytes of X read and
// Y written.  Design: a block owns one grid point and a tile of FT free-run
// values, and first stages the tile's D x FT X elements in shared memory
// (coalesced along whichever of f and the lane rows is contiguous), so
// every X element is read from device memory once; then each thread sums
// the T terms of R = 4 outputs out of shared memory (the table, with the W
// values gathered, staged beside the tile when it fits), and stores them
// with the output's unit stride across the warp (h for tail, f for head).

#include <cuda_runtime.h>
#include <stdint.h>

#include "runs.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int R = 4;                     // outputs per thread along f
constexpr int U = 8;                     // tile loads in flight per thread
constexpr int FT_MAX = 256;              // free-run values per tile
constexpr size_t SMEM_TARGET = 48 * 1024;    // four blocks per SM
constexpr size_t SMEM_MAX = 227 * 1024;
constexpr size_t TABLE_STAGE_MAX = 16 * 1024;

// launches that ran on the card (runs.cuh)
__device__ unsigned long long g_runs[1];

template <bool H_FAST, bool STAGED>
__global__ void __launch_bounds__(THREADS)
lane_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
            const float* __restrict__ wr, const float* __restrict__ wi,
            float* __restrict__ yr, float* __restrict__ yi,
            const int* __restrict__ xd, const int* __restrict__ wix,
            const long long* __restrict__ doff,
            const long long* __restrict__ xoff,
            const long long* __restrict__ yoff,
            int D, int H, int T, long long F, int FT, int n_ftiles,
            long long x_fs, long long y_fs, long long y_hs,
            long long x_ws, long long w_ws, long long y_ws)
{
    runs::count(&g_runs[0]);
    extern __shared__ __align__(16) unsigned char smem[];
    const int FTP = FT + 1;                 // padded tile row (banks)
    const int HT = H * T;
    float2* tile = reinterpret_cast<float2*>(smem);
    float2* s_w = tile + (size_t)D * FTP;
    int* s_row = reinterpret_cast<int*>(s_w + (STAGED ? HT : 0));

    const long long o = blockIdx.x / n_ftiles;
    const long long f0 = (long long)(blockIdx.x % n_ftiles) * FT;
    const long long w = blockIdx.y;
    const float* __restrict__ wrw = wr + w * w_ws;
    const float* __restrict__ wiw = wi + w * w_ws;
    const long long xb = w * x_ws + xoff[o];
    const long long yb = w * y_ws + yoff[o];

    if (STAGED) {
        for (int q = threadIdx.x; q < HT; q += THREADS) {
            const int k = wix[q];
            s_w[q] = make_float2(wrw[k], wiw[k]);
            s_row[q] = xd[q] * FTP;
        }
    }
    // the X tile: lane rows x free-run values, zero past the run's end;
    // U loads in flight per thread before their stores
    const bool f_fast = x_fs == 1;
    const int n_tile = D * FT;
    for (int e0 = threadIdx.x; e0 < n_tile; e0 += THREADS * U) {
        float2 v[U];
        int at[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int e = e0 + u * THREADS;
            const int d = f_fast ? e / FT : e % D;
            const int fl = f_fast ? e % FT : e / D;
            const long long f = f0 + fl;
            at[u] = e < n_tile ? d * FTP + fl : -1;
            v[u] = make_float2(0.f, 0.f);
            if (e < n_tile && f < F) {
                const long long a = xb + __ldg(doff + d) + f * x_fs;
                v[u] = make_float2(xr[a], xi[a]);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (at[u] >= 0)
                tile[at[u]] = v[u];
    }
    __syncthreads();

    const int FG = FT / R;
    for (int e = threadIdx.x; e < H * FG; e += THREADS) {
        // H_FAST: a thread's R outputs are consecutive f of one h, and the
        // warp's threads consecutive h; else the warp's threads are
        // consecutive f and a thread's R outputs FG apart
        const int h = H_FAST ? e % H : e / FG;
        const int fb = H_FAST ? (e / H) * R : e % FG;
        const int fstep = H_FAST ? 1 : FG;
        float sr[R], si[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            sr[r] = 0.f;
            si[r] = 0.f;
        }
        for (int t = 0; t < T; ++t) {
            const int q = t * H + h;
            int row;
            float br, bi;
            if (STAGED) {
                const float2 v = s_w[q];
                row = s_row[q];
                br = v.x;
                bi = v.y;
            } else {
                const int k = __ldg(wix + q);
                row = __ldg(xd + q) * FTP;
                br = __ldg(wrw + k);
                bi = __ldg(wiw + k);
            }
            const float2* tr = tile + row + fb;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float2 a = tr[r * fstep];
                sr[r] = fmaf(a.x, br, sr[r]);
                sr[r] = fmaf(-a.y, bi, sr[r]);
                si[r] = fmaf(a.x, bi, si[r]);
                si[r] = fmaf(a.y, br, si[r]);
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const long long f = f0 + fb + r * fstep;
            if (f < F) {
                const long long ya = yb + (long long)h * y_hs + f * y_fs;
                yr[ya] = sr[r];
                yi[ya] = si[r];
            }
        }
    }
}

template <bool H_FAST, bool STAGED>
int launch(dim3 grid, size_t smem, cudaStream_t stream,
           const float* xr, const float* xi, const float* wr,
           const float* wi, float* yr, float* yi, const int* xd,
           const int* wix, const long long* doff, const long long* xoff,
           const long long* yoff, int D, int H, int T, long long F, int FT,
           int n_ftiles, long long x_fs, long long y_fs, long long y_hs,
           long long x_ws, long long w_ws, long long y_ws)
{
    const cudaError_t err = cudaFuncSetAttribute(
        lane_kernel<H_FAST, STAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess)
        return (int)err;
    lane_kernel<H_FAST, STAGED><<<grid, THREADS, smem, stream>>>(
        xr, xi, wr, wi, yr, yi, xd, wix, doff, xoff, yoff, D, H, T, F, FT,
        n_ftiles, x_fs, y_fs, y_hs, x_ws, w_ws, y_ws);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lane_launch(const float* xr, const float* xi,
                           const float* wr, const float* wi,
                           float* yr, float* yi,
                           const int* xd, const int* wix,
                           const long long* doff, const long long* xoff,
                           const long long* yoff,
                           long long G, int D, int H, int T, long long F,
                           long long x_fs, long long y_fs, long long y_hs,
                           long long x_ws, long long w_ws, long long y_ws,
                           int W, void* stream)
{
    if (G < 1 || D < 1 || H < 1 || T < 1 || F < 1 || W < 1 || W > 65535
        || (long long)H * T > 0x7fffffffLL / 16)
        return (int)cudaErrorInvalidConfiguration;
    // the output's unit stride goes to the warp's threads: h when Y stores
    // h minor (tail), else f (head)
    const bool h_fast = y_hs == 1 && y_fs != 1;
    const size_t table = (size_t)H * T * (sizeof(float2) + sizeof(int));
    const bool staged = table <= TABLE_STAGE_MAX;
    const size_t fixed = staged ? table : 0;
    // the tile: a power of two of free-run values, no longer than the run
    // needs, halved while the block's shared memory is above its target
    // and the block keeps a thread busy for each R outputs
    int FT = R;
    while (FT < FT_MAX && FT < F)
        FT *= 2;
    while (FT > R && fixed + (size_t)D * (FT + 1) * sizeof(float2)
           > SMEM_TARGET && (long long)H * (FT / 2) / R >= THREADS)
        FT /= 2;
    const size_t smem = fixed + (size_t)D * (FT + 1) * sizeof(float2);
    if (smem > SMEM_MAX)
        return (int)cudaErrorInvalidConfiguration;
    const long long n_ftiles = (F + FT - 1) / FT;
    const long long nblk = G * n_ftiles;
    if (nblk > 0x7fffffffLL || (long long)H * FT > 0x7fffffffLL)
        return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)nblk, (unsigned)W);
    const cudaStream_t s = (cudaStream_t)stream;
#define LANE_ARGS grid, smem, s, xr, xi, wr, wi, yr, yi, xd, wix, doff, \
        xoff, yoff, D, H, T, F, FT, (int)n_ftiles, x_fs, y_fs, y_hs, \
        x_ws, w_ws, y_ws
    int rc;
    if (h_fast && staged)
        rc = launch<true, true>(LANE_ARGS);
    else if (h_fast)
        rc = launch<true, false>(LANE_ARGS);
    else if (staged)
        rc = launch<false, true>(LANE_ARGS);
    else
        rc = launch<false, false>(LANE_ARGS);
#undef LANE_ARGS
    return rc;
}

// the launches that ran on the card (g_runs)
extern "C" int lane_runs(unsigned long long* out)
{
    return (int)cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs));
}
