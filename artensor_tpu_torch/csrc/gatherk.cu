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
// X read once and Y written once: 8*H*K flop per f value on 8*(K + H)
// bytes.  GK takes one of two forms, chosen by the wrapper from the step's
// shape (gatherk.gk_form):
//
// * "stream", for steps whose bytes at 3.35 TB/s take at least as long as
//   their flops at 0.6 of the 67 TFLOP/s float32 FMA rate (K, H <= 16, and
//   K 16 H 32, on the paths).  Bound by bytes.  Each thread owns 4 consecutive f values of one
//   (w, o), loads them with 16-byte loads from each of the K gathered rows
//   (re and im planes), keeps an H chunk of at most 16 outputs x 4 f in
//   registers and stores them with 16-byte stores, f unit-stride across
//   the warp.  The block's W chunk sits in shared memory, read as a
//   broadcast.  The K loop has no barrier, so a thread's row loads are
//   independent and in flight together.  The H chunks of one f range are
//   adjacent in block order, so the second reads X from L2.  Offsets that
//   are not 16-byte aligned take the 4-byte variant.
// * "mma", for the other steps (K, H = 32..512): the product on the
//   tensor cores at float32 accuracy (3xTF32, tc_core.cuh), W as the
//   (H x K) operand and the X rows of all outer indices as one flat
//   (K x G*F) operand staged by cp.async, so that short f runs (F 64)
//   still fill 128-wide tiles.  Bound by operations at the 3xTF32 rate
//   or, for most such steps, by bytes.
//
// GGK keeps the register-tiled FMA template below (launch_any): a block
// owns a BH x BF output tile of one (w, o); K is walked in BK chunks
// staged in shared memory; each thread keeps RH x RF complex accumulators.
// One of five tile shapes (4 x 256, 4 x 64, 16 x 128, 32 x 32, 64 x 64) is
// picked from H and F, so that a step with a small H or F (a GGK row with
// H = 2, F = 64) does not leave most of each tile idle.

#include "tc_core.cuh"

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

// -- GK "stream" form ---------------------------------------------------------

constexpr int STREAM_THREADS = 128;

template <int HC, bool VEC>
__global__ void __launch_bounds__(STREAM_THREADS)
gk_stream_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 const float* __restrict__ wr, const float* __restrict__ wi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 const long long* __restrict__ xoff,
                 const long long* __restrict__ yoff,
                 const long long* __restrict__ koff,
                 int H, int K, int F, long long hstride, long long x_ws,
                 long long w_ws, long long y_ws, long long nflat, int n_hchunks)
{
    extern __shared__ __align__(16) float2 sw[];   // [K][HC] (re, im)
    long long* sk = reinterpret_cast<long long*>(sw + (size_t)K * HC);

    const int hc = blockIdx.x % n_hchunks;
    const long long qb = blockIdx.x / n_hchunks;
    const long long w = blockIdx.y;
    const int h0 = hc * HC;
    const long long wb = w * w_ws;
    for (int e = threadIdx.x; e < HC * K; e += STREAM_THREADS) {
        const int h = e / K, k = e % K;
        float2 v = make_float2(0.f, 0.f);
        if (h0 + h < H) {
            const long long a = wb + (long long)(h0 + h) * K + k;
            v = make_float2(wr[a], wi[a]);
        }
        sw[k * HC + h] = v;
    }
    for (int k = threadIdx.x; k < K; k += STREAM_THREADS)
        sk[k] = koff[k];
    __syncthreads();

    const long long n = 4 * (qb * STREAM_THREADS + threadIdx.x);
    if (n >= nflat)     // n: the first of this thread's 4 flat (o, f) values
        return;
    // X and Y offsets of the 4 values (one outer index when VEC)
    long long xo[VEC ? 1 : 4], yo[VEC ? 1 : 4];
#pragma unroll
    for (int e = 0; e < (VEC ? 1 : 4); ++e) {
        const long long ne = n + e < nflat ? n + e : n;
        const long long o = ne / F, f = ne % F;
        xo[e] = w * x_ws + xoff[o] + f;
        yo[e] = w * y_ws + yoff[o] + f + (long long)h0 * hstride;
    }

    float acc_r[HC][4], acc_i[HC][4];
#pragma unroll
    for (int h = 0; h < HC; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc_r[h][e] = 0.f;
            acc_i[h][e] = 0.f;
        }

#pragma unroll 4
    for (int k = 0; k < K; ++k) {
        const long long ko = sk[k];
        float vr[4], vi[4];
        if (VEC) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(xr + xo[0] + ko));
            const float4 b = __ldg(reinterpret_cast<const float4*>(xi + xo[0] + ko));
            vr[0] = a.x; vr[1] = a.y; vr[2] = a.z; vr[3] = a.w;
            vi[0] = b.x; vi[1] = b.y; vi[2] = b.z; vi[3] = b.w;
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool ok = n + e < nflat;
                vr[e] = ok ? __ldg(xr + xo[VEC ? 0 : e] + ko) : 0.f;
                vi[e] = ok ? __ldg(xi + xo[VEC ? 0 : e] + ko) : 0.f;
            }
        }
        const float2* wk = sw + k * HC;
#pragma unroll
        for (int h = 0; h < HC; ++h) {
            const float2 c = wk[h];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                acc_r[h][e] = fmaf(c.x, vr[e], acc_r[h][e]);
                acc_r[h][e] = fmaf(-c.y, vi[e], acc_r[h][e]);
                acc_i[h][e] = fmaf(c.x, vi[e], acc_i[h][e]);
                acc_i[h][e] = fmaf(c.y, vr[e], acc_i[h][e]);
            }
        }
    }

    const int hn = min(HC, H - h0);
#pragma unroll
    for (int h = 0; h < HC; ++h) {
        if (h >= hn)
            break;
        const long long hs = (long long)h * hstride;
        if (VEC) {
            *reinterpret_cast<float4*>(yr + yo[0] + hs) = make_float4(
                acc_r[h][0], acc_r[h][1], acc_r[h][2], acc_r[h][3]);
            *reinterpret_cast<float4*>(yi + yo[0] + hs) = make_float4(
                acc_i[h][0], acc_i[h][1], acc_i[h][2], acc_i[h][3]);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (n + e < nflat) {
                    yr[yo[VEC ? 0 : e] + hs] = acc_r[h][e];
                    yi[yo[VEC ? 0 : e] + hs] = acc_i[h][e];
                }
        }
    }
}

template <int HC, bool VEC>
int launch_stream(const float* xr, const float* xi, const float* wr,
                  const float* wi, float* yr, float* yi,
                  const long long* xoff, const long long* yoff,
                  const long long* koff, long long O, int H, int K, int F,
                  long long hstride, long long x_ws, long long w_ws,
                  long long y_ws, int W, cudaStream_t stream)
{
    const long long nflat = O * F;
    if (VEC && nflat % 4)
        return (int)cudaErrorInvalidValue;
    const long long nq = (nflat + 3) / 4;
    const int n_hchunks = (H + HC - 1) / HC;
    const long long nblk = (nq + STREAM_THREADS - 1) / STREAM_THREADS
                           * n_hchunks;
    const size_t smem = (size_t)K * HC * sizeof(float2)
                        + (size_t)K * sizeof(long long);
    if (K < 1 || nblk <= 0 || nblk > 0x7fffffffLL || W <= 0 || W > 65535)
        return (int)cudaErrorInvalidConfiguration;
    auto kern = gk_stream_kernel<HC, VEC>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess)
            return (int)e;
    }
    dim3 grid((unsigned)nblk, (unsigned)W);
    kern<<<grid, STREAM_THREADS, smem, stream>>>(
        xr, xi, wr, wi, yr, yi, xoff, yoff, koff, H, K, F, hstride, x_ws,
        w_ws, y_ws, nflat, n_hchunks);
    return (int)cudaGetLastError();
}

template <bool VEC>
int stream_any(const float* xr, const float* xi, const float* wr,
               const float* wi, float* yr, float* yi, const long long* xoff,
               const long long* yoff, const long long* koff, long long O,
               int H, int K, int F, long long hstride, long long x_ws,
               long long w_ws, long long y_ws, int W, cudaStream_t s)
{
    // H chunk: the smallest of 4, 8, 16 that holds H (16 above that)
    if (H <= 4)
        return launch_stream<4, VEC>(xr, xi, wr, wi, yr, yi, xoff, yoff, koff,
                                     O, H, K, F, hstride, x_ws, w_ws, y_ws,
                                     W, s);
    if (H <= 8)
        return launch_stream<8, VEC>(xr, xi, wr, wi, yr, yi, xoff, yoff, koff,
                                     O, H, K, F, hstride, x_ws, w_ws, y_ws,
                                     W, s);
    return launch_stream<16, VEC>(xr, xi, wr, wi, yr, yi, xoff, yoff, koff,
                                  O, H, K, F, hstride, x_ws, w_ws, y_ws, W,
                                  s);
}

// -- GK "mma" form ------------------------------------------------------------
//
// H <= 32: 32 x 128 tiles, 4 warps of 32 x 32, a row of outputs at a time.
// Else 64 x 128 tiles, 8 warps of 32 x 32, one output at a time within 128
// registers, so that two blocks share an SM: K is only 32..128, a block's
// ring is short, and the second block's loads fill its gaps.  On the
// paths' K 64 steps (H 64 and 256) that beats the same tiles a row at a
// time at one block an SM (255 registers) by 11-22%, and the 32 x 128
// tiles by 17-28% (H100, scripts/gk_forms_torch_port.py; PERF.md).

using GkNarrow = tc::Tile<2, 4, 1, 4>;
using GkWide = tc::Tile<2, 4, 2, 4>;

template <class T, int MIN_BLOCKS, bool ROW>
__global__ void __launch_bounds__(T::THREADS, MIN_BLOCKS)
gk_mma_kernel(tc::Operands p, int n_mtiles)
{
    tc::cgemm<T, true, true, ROW>(p, n_mtiles);
}

int gk_mma(const float* xr, const float* xi, const float* wr,
           const float* wi, float* yr, float* yi, const long long* xoff,
           const long long* yoff, const long long* koff, long long O, int H,
           int K, int F, long long hstride, long long x_ws, long long w_ws,
           long long y_ws, int W, bool vec, cudaStream_t s)
{
    if (O * F > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    tc::Operands p{};
    p.ar = wr; p.ai = wi; p.br = xr; p.bi = xi; p.yr = yr; p.yi = yi;
    p.M = H; p.N = (int)(O * F); p.K = K;
    p.lda = K; p.ldb = 0; p.ldy = hstride;
    p.a_ws = w_ws; p.b_ws = x_ws; p.y_ws = y_ws;
    p.koff = koff; p.xoff = xoff; p.yoff = yoff; p.F = F;
    p.vec_a = tc::aligned16(wr) && tc::aligned16(wi) && K % 4 == 0 &&
              w_ws % 4 == 0;
    p.vec = vec;
    if (H <= 32)
        return tc::launch<GkNarrow, true>(gk_mma_kernel<GkNarrow, 1, true>,
                                          p, W, s);
    return tc::launch<GkWide, true>(gk_mma_kernel<GkWide, 2, false>, p, W,
                                    s);
}

}  // namespace

// form: 0 "stream", 1 "mma" (gatherk.GK_FORMS); vec: the X / Y offsets,
// strides and pointers are 16-byte aligned (gatherk.gk_aligned)
extern "C" int gk_launch(const float* xr, const float* xi, const float* wr,
                         const float* wi, float* yr, float* yi,
                         const long long* xoff, const long long* yoff,
                         const long long* koff, long long O, int H, int K,
                         int F, long long hstride, long long x_ws,
                         long long w_ws, long long y_ws, int W, int form,
                         int vec, void* stream)
{
    cudaStream_t s = (cudaStream_t)stream;
    if (form == 1)
        return gk_mma(xr, xi, wr, wi, yr, yi, xoff, yoff, koff, O, H, K, F,
                      hstride, x_ws, w_ws, y_ws, W, vec != 0, s);
    if (form != 0)
        return (int)cudaErrorInvalidValue;
    if (vec)
        return stream_any<true>(xr, xi, wr, wi, yr, yi, xoff, yoff, koff, O,
                                H, K, F, hstride, x_ws, w_ws, y_ws, W, s);
    return stream_any<false>(xr, xi, wr, wi, yr, yi, xoff, yoff, koff, O, H,
                             K, F, hstride, x_ws, w_ws, y_ws, W, s);
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
