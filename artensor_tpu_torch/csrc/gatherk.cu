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
// bytes.  GK and GGK run the same two forms, chosen by the wrapper from the
// step's bytes and flops (gatherk.gk_form):
//
// * "stream", for steps whose bytes at 3.35 TB/s take at least as long as
//   their flops at 0.6 of the 67 TFLOP/s float32 FMA rate (GK's K, H <= 16,
//   and K 16 H 32, on the paths), and every GGK step whose f run is not a
//   multiple of the mma tile's 128 rows (the paths' F 64 steps).  Bound by
//   bytes.  Each thread owns 4 consecutive f values of one (w, o), loads them
//   with 16-byte loads from each of the K gathered rows (re and im planes),
//   keeps an H chunk of at most 16 outputs x 4 f in registers and stores them
//   with 16-byte stores, f unit-stride across the warp.  GK's W chunk sits in
//   shared memory, read as a broadcast; a GGK block's threads span several
//   outer indices, each with its own W row (woff[o], at most 16 x 32 complex
//   on the paths), so they read W[h, k] through L1, the same address across
//   the threads of one o.  The K loop has no barrier, so a thread's row loads
//   are independent and in flight together.  The H chunks of one f range are
//   adjacent in block order, so the second reads X from L2.  Offsets that are
//   not 16-byte aligned take the 4-byte variant.
// * "mma", for the other steps (K, H = 16..512): the product on the
//   tensor cores at float32 accuracy (3xTF32), on wgmma (wgmma_core.cuh):
//   X in the A role, the X rows of all outer indices one flat operand of
//   M = G*F rows, so that short f runs (F 64) still fill whole tiles; W's
//   (H, K) rows the K-major B operand, N = H, in tiles of 64, or 32 for
//   H <= 32; 16-byte copies where the offsets and buffers allow, else
//   4-byte.  GK runs it as gk_wgmma_kernel.  GGK (ggk_wgmma_kernel) reads
//   the W rows of a tile's outer index at woff[o], so its f run must be a
//   multiple of the 128-row M tile (a tile never spans two outer indices);
//   its N tile is 16 wide for H <= 16 and its K chunk 16 deep for K <= 16
//   (the 1k path's K 16 H 16 step fills both; there the core also reads X
//   once for all slice instances of a tile and stores Y through shared
//   memory: wgmma_core.cuh's STACK, REUSE_X, STAGE_Y).  Bound by
//   operations at the 3xTF32 rate or, for most such steps, by bytes.
//   ``passes`` 1 runs the one-pass TF32 form (precision "default"); the
//   stream form keeps float32 FMAs at every precision.

#include "runs.cuh"
#include "tc_core.cuh"
#include "wgmma_core.cuh"

namespace {

// -- GK "stream" form ---------------------------------------------------------

constexpr int STREAM_THREADS = 128;

// Where a thread finds W[h, k]:
enum WSource {
    W_SHARED = 0,   // GK: the block's (K x HC) chunk, staged in shared memory
    W_STAGED = 1,   // GGK: the rows of the outer indices the block spans,
                    //   staged in shared memory ([o][k][h])
    W_GLOBAL = 2,   // GGK rows too large to stage: W[woff[o] + h K + k]
                    //   through L1 (the same address for the threads of an o)
};
constexpr int STAGE_CAP = 64 * 1024;   // max bytes of staged GGK W rows

template <int HC, bool VEC, int WS>
__device__ __forceinline__ void
stream_body(const float* __restrict__ xr, const float* __restrict__ xi,
            const float* __restrict__ wr, const float* __restrict__ wi,
            float* __restrict__ yr, float* __restrict__ yi,
            const long long* __restrict__ xoff,
            const long long* __restrict__ yoff,
            const long long* __restrict__ woff,
            const long long* __restrict__ koff,
            int H, int K, int F, long long hstride, long long x_ws,
            long long w_ws, long long y_ws, long long nflat, int n_hchunks)
{
    extern __shared__ __align__(16) long long sk[];   // [K] koff, then W
    float2* sw = reinterpret_cast<float2*>(sk + K);
    constexpr int NV = VEC ? 1 : 4;   // outer indices of a thread's values
    constexpr int NW = (WS == W_SHARED || VEC) ? 1 : 4;

    const int hc = blockIdx.x % n_hchunks;
    const long long qb = blockIdx.x / n_hchunks;
    const long long w = blockIdx.y;
    const int h0 = hc * HC;
    const long long wb = w * w_ws;
    // the block's flat (o, f) values and the outer indices they span
    const long long nb = 4 * qb * STREAM_THREADS;
    const long long o0 = nb / F;
    const int n_o = (int)((min(nflat, nb + 4 * STREAM_THREADS) - 1) / F - o0
                          + 1);
    if (WS != W_GLOBAL) {
        const int n_w = (WS == W_STAGED ? n_o : 1) * HC * K;
        for (int e = threadIdx.x; e < n_w; e += STREAM_THREADS) {
            const int oi = e / (HC * K), h = e / K % HC, k = e % K;
            float2 v = make_float2(0.f, 0.f);
            if (h0 + h < H) {
                const long long a = wb + (long long)(h0 + h) * K + k
                    + (WS == W_STAGED ? woff[o0 + oi] : 0);
                v = make_float2(wr[a], wi[a]);
            }
            sw[((long long)oi * K + k) * HC + h] = v;
        }
    }
    for (int k = threadIdx.x; k < K; k += STREAM_THREADS)
        sk[k] = koff[k];
    __syncthreads();

    const long long n = nb + 4 * threadIdx.x;
    if (n >= nflat)     // n: the first of this thread's 4 flat (o, f) values
        return;
    // X and Y offsets of the 4 values (one outer index when VEC), and
    // where their W rows are
    long long xo[NV], yo[NV], wo[NW];
#pragma unroll
    for (int e = 0; e < NV; ++e) {
        const long long ne = n + e < nflat ? n + e : n;
        const long long o = ne / F, f = ne % F;
        xo[e] = w * x_ws + xoff[o] + f;
        yo[e] = w * y_ws + yoff[o] + f + (long long)h0 * hstride;
        if (e < NW)
            wo[e] = WS == W_STAGED ? (o - o0) * K * HC
                  : WS == W_GLOBAL ? wb + woff[o] + (long long)h0 * K : 0;
    }

    float acc_r[HC][4], acc_i[HC][4];
#pragma unroll
    for (int h = 0; h < HC; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            acc_r[h][e] = 0.f;
            acc_i[h][e] = 0.f;
        }

    // W values read from global memory take registers: unroll less
    constexpr int UNROLL = WS == W_GLOBAL ? (VEC ? 2 : 1) : 4;
#pragma unroll UNROLL
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
#pragma unroll
        for (int h = 0; h < HC; ++h) {
            float2 c[NW];
#pragma unroll
            for (int e = 0; e < NW; ++e) {
                if (WS != W_GLOBAL) {
                    c[e] = sw[wo[e] + k * HC + h];
                } else if (h0 + h < H) {
                    const long long a = wo[e] + (long long)h * K + k;
                    c[e] = make_float2(__ldg(wr + a), __ldg(wi + a));
                } else {
                    c[e] = make_float2(0.f, 0.f);
                }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 ce = c[NW == 1 ? 0 : e];
                acc_r[h][e] = fmaf(ce.x, vr[e], acc_r[h][e]);
                acc_r[h][e] = fmaf(-ce.y, vi[e], acc_r[h][e]);
                acc_i[h][e] = fmaf(ce.x, vi[e], acc_i[h][e]);
                acc_i[h][e] = fmaf(ce.y, vr[e], acc_i[h][e]);
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

// GK and GGK launch the body from kernels of their own names, so that a
// profile tells them apart
#define STREAM_PARAMS                                                        \
    const float* xr, const float* xi, const float* wr, const float* wi,      \
        float* yr, float* yi, const long long* xoff, const long long* yoff,  \
        const long long* woff, const long long* koff, int H, int K, int F,   \
        long long hstride, long long x_ws, long long w_ws, long long y_ws,   \
        long long nflat, int n_hchunks
#define STREAM_ARGS xr, xi, wr, wi, yr, yi, xoff, yoff, woff, koff, H, K, F, \
    hstride, x_ws, w_ws, y_ws, nflat, n_hchunks

// launches that ran on the card (runs.cuh): GK stream, GK mma, GGK
// stream, GGK mma
__device__ unsigned long long g_runs[4];

template <int HC, bool VEC>
__global__ void __launch_bounds__(STREAM_THREADS)
gk_stream_kernel(STREAM_PARAMS)
{
    runs::count(&g_runs[0]);
    stream_body<HC, VEC, W_SHARED>(STREAM_ARGS);
}

template <int HC, bool VEC, int WS>
__global__ void __launch_bounds__(STREAM_THREADS)
ggk_stream_kernel(STREAM_PARAMS)
{
    runs::count(&g_runs[2]);
    stream_body<HC, VEC, WS>(STREAM_ARGS);
}

template <int HC, bool VEC, int WS>
int launch_stream(const float* xr, const float* xi, const float* wr,
                  const float* wi, float* yr, float* yi,
                  const long long* xoff, const long long* yoff,
                  const long long* woff, const long long* koff, long long O,
                  int H, int K, int F, long long hstride, long long x_ws,
                  long long w_ws, long long y_ws, int W, cudaStream_t stream)
{
    const long long nflat = O * F;
    if (VEC && nflat % 4)
        return (int)cudaErrorInvalidValue;
    const long long nq = (nflat + 3) / 4;
    const int n_hchunks = (H + HC - 1) / HC;
    const long long nblk = (nq + STREAM_THREADS - 1) / STREAM_THREADS
                           * n_hchunks;
    const size_t smem = (size_t)K * sizeof(long long)
                        + (size_t)K * HC * sizeof(float2)
                          * (WS == W_SHARED ? 1 : WS == W_STAGED
                             ? (4 * STREAM_THREADS - 1) / F + 2 : 0);
    if (K < 1 || nblk <= 0 || nblk > 0x7fffffffLL || W <= 0 || W > 65535)
        return (int)cudaErrorInvalidConfiguration;
    void (*kern)(STREAM_PARAMS);
    if constexpr (WS == W_SHARED)
        kern = gk_stream_kernel<HC, VEC>;
    else
        kern = ggk_stream_kernel<HC, VEC, WS>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess)
            return (int)e;
    }
    dim3 grid((unsigned)nblk, (unsigned)W);
    kern<<<grid, STREAM_THREADS, smem, stream>>>(
        xr, xi, wr, wi, yr, yi, xoff, yoff, woff, koff, H, K, F, hstride,
        x_ws, w_ws, y_ws, nflat, n_hchunks);
    return (int)cudaGetLastError();
}
#undef STREAM_PARAMS
#undef STREAM_ARGS

template <bool VEC, int WS>
int stream_hc(const float* xr, const float* xi, const float* wr,
              const float* wi, float* yr, float* yi, const long long* xoff,
              const long long* yoff, const long long* woff,
              const long long* koff, long long O, int H, int K, int F,
              long long hstride, long long x_ws, long long w_ws,
              long long y_ws, int W, cudaStream_t s)
{
#define ST_ARGS xr, xi, wr, wi, yr, yi, xoff, yoff, woff, koff, O, H, K, F, \
    hstride, x_ws, w_ws, y_ws, W, s
    // H chunk: the smallest of 4, 8, 16 that holds H (16 above that)
    if (H <= 4)
        return launch_stream<4, VEC, WS>(ST_ARGS);
    if (H <= 8)
        return launch_stream<8, VEC, WS>(ST_ARGS);
    return launch_stream<16, VEC, WS>(ST_ARGS);
#undef ST_ARGS
}

int stream_any(const float* xr, const float* xi, const float* wr,
               const float* wi, float* yr, float* yi, const long long* xoff,
               const long long* yoff, const long long* woff,
               const long long* koff, long long O, int H, int K, int F,
               long long hstride, long long x_ws, long long w_ws,
               long long y_ws, int W, bool vec, cudaStream_t s)
{
#define ST_ARGS xr, xi, wr, wi, yr, yi, xoff, yoff, woff, koff, O, H, K, F, \
    hstride, x_ws, w_ws, y_ws, W, s
    if (!woff)
        return vec ? stream_hc<true, W_SHARED>(ST_ARGS)
                   : stream_hc<false, W_SHARED>(ST_ARGS);
    // GGK: stage the W rows a block spans where they fit
    const int hc = H <= 4 ? 4 : H <= 8 ? 8 : 16;
    const long long staged = (long long)((4 * STREAM_THREADS - 1) / F + 2)
                             * K * hc * (long long)sizeof(float2);
    if (staged <= STAGE_CAP)
        return vec ? stream_hc<true, W_STAGED>(ST_ARGS)
                   : stream_hc<false, W_STAGED>(ST_ARGS);
    return vec ? stream_hc<true, W_GLOBAL>(ST_ARGS)
               : stream_hc<false, W_GLOBAL>(ST_ARGS);
#undef ST_ARGS
}

// -- GK and GGK "mma" forms, on wgmma (wgmma_core.cuh) -----------------------

// GK's: a 128 x 64 tile, or 128 x 32 for H <= 32; K in chunks of 32
template <int BN, int PASSES, bool VEC>
__global__ void __launch_bounds__(384, 1)   // wgmma_core.cuh: wg::gemm
gk_wgmma_kernel(wg::Operands p)
{
    runs::count(&g_runs[1]);
    wg::gemm<wg::Cfg<true, BN, PASSES, VEC>>(p);
}

// GGK's: as GK's with W's rows at woff[o]; also a 128 x 16 tile for
// H <= 16, and K in chunks of 16 for K <= 16 (H 16 K 16 on the 1k path)
template <int BN, int BK, int PASSES, bool VEC>
__global__ void __launch_bounds__(384, 1)   // wgmma_core.cuh: wg::gemm
ggk_wgmma_kernel(wg::Operands p)
{
    runs::count(&g_runs[3]);
    wg::gemm<wg::Cfg<true, BN, PASSES, VEC, BK>>(p);
}

// the GK (GGK) kernel of tile width BN, K chunk BK, ``PASSES`` passes and
// X's 16-byte copies (VEC)
template <bool GGK, int BN, int BK, int PASSES, bool VEC>
int mma_kernel(const wg::Operands& p, int W, cudaStream_t s)
{
    using C = wg::Cfg<true, BN, PASSES, VEC, BK>;
    static unsigned attr = 0;    // wg::launch: the kernel's devices
    if constexpr (GGK)
        return wg::launch<C>(ggk_wgmma_kernel<BN, BK, PASSES, VEC>, attr, p,
                             W, s);
    else
        return wg::launch<C>(gk_wgmma_kernel<BN, PASSES, VEC>, attr, p, W,
                             s);
}

template <bool GGK, int BN, int BK>
int mma_tile(const wg::Operands& p, int W, int passes, bool vec,
             cudaStream_t s)
{
    if (passes == 1)
        return vec ? mma_kernel<GGK, BN, BK, 1, true>(p, W, s)
                   : mma_kernel<GGK, BN, BK, 1, false>(p, W, s);
    return vec ? mma_kernel<GGK, BN, BK, 3, true>(p, W, s)
               : mma_kernel<GGK, BN, BK, 3, false>(p, W, s);
}

int gk_mma(const float* xr, const float* xi, const float* wr,
           const float* wi, float* yr, float* yi, const long long* xoff,
           const long long* yoff, const long long* woff,
           const long long* koff, long long O, int H, int K, int F,
           long long hstride, long long x_ws, long long w_ws,
           long long y_ws, int W, bool vec, int passes, cudaStream_t s)
{
    if (O * F > 0x7fffffffLL || !tc::passes_ok(passes))
        return (int)cudaErrorInvalidValue;
    wg::Operands p{};
    p.xr = xr; p.xi = xi; p.vr = wr; p.vi = wi; p.yr = yr; p.yi = yi;
    p.M = (int)(O * F); p.N = H; p.K = K;
    p.x_ws = x_ws; p.v_ws = w_ws; p.y_ws = y_ws; p.ldy = hstride;
    p.koff = koff; p.xoff = xoff; p.yoff = yoff; p.woff = woff; p.F = F;
    // W's (H, K) rows: 16-byte copies apart from X's (vec); GGK's row
    // offsets woff[o] are multiples of H K
    p.vec_v = tc::aligned16(wr) && tc::aligned16(wi) && K % 4 == 0 &&
              w_ws % 4 == 0;
    if (!woff)
        return H <= 32 ? mma_tile<false, 32, 32>(p, W, passes, vec, s)
                       : mma_tile<false, 64, 32>(p, W, passes, vec, s);
    if (H <= 16)
        return K <= 16 ? mma_tile<true, 16, 16>(p, W, passes, vec, s)
                       : mma_tile<true, 16, 32>(p, W, passes, vec, s);
    return H <= 32 ? mma_tile<true, 32, 32>(p, W, passes, vec, s)
                   : mma_tile<true, 64, 32>(p, W, passes, vec, s);
}

int gk_any(const float* xr, const float* xi, const float* wr,
           const float* wi, float* yr, float* yi, const long long* xoff,
           const long long* yoff, const long long* woff,
           const long long* koff, long long O, int H, int K, int F,
           long long hstride, long long x_ws, long long w_ws,
           long long y_ws, int W, int form, int vec, int passes,
           cudaStream_t s)
{
    if (form == 1)
        return gk_mma(xr, xi, wr, wi, yr, yi, xoff, yoff, woff, koff, O, H,
                      K, F, hstride, x_ws, w_ws, y_ws, W, vec != 0, passes,
                      s);
    if (form != 0)
        return (int)cudaErrorInvalidValue;
    return stream_any(xr, xi, wr, wi, yr, yi, xoff, yoff, woff, koff, O, H,
                      K, F, hstride, x_ws, w_ws, y_ws, W, vec != 0, s);
}

}  // namespace

// form: 0 "stream", 1 "mma" (on wgmma; gatherk.GK_FORMS); vec: the X / Y
// offsets, strides and pointers are 16-byte aligned (gatherk.gk_aligned);
// passes: the mma form's tensor-core passes, 3 or 1 (the stream form
// ignores it)
extern "C" int gk_launch(const float* xr, const float* xi, const float* wr,
                         const float* wi, float* yr, float* yi,
                         const long long* xoff, const long long* yoff,
                         const long long* koff, long long O, int H, int K,
                         int F, long long hstride, long long x_ws,
                         long long w_ws, long long y_ws, int W, int form,
                         int vec, int passes, void* stream)
{
    return gk_any(xr, xi, wr, wi, yr, yi, xoff, yoff, nullptr, koff, O, H,
                  K, F, hstride, x_ws, w_ws, y_ws, W, form, vec, passes,
                  (cudaStream_t)stream);
}

// GGK: as gk_launch, with W's (H, K) row of outer index o at woff[o]
// (its mma form needs F % 128 == 0)
extern "C" int ggk_launch(const float* xr, const float* xi, const float* wr,
                          const float* wi, float* yr, float* yi,
                          const long long* xoff, const long long* yoff,
                          const long long* woff, const long long* koff,
                          long long O, int H, int K, int F, long long hstride,
                          long long x_ws, long long w_ws, long long y_ws,
                          int W, int form, int vec, int passes,
                          void* stream)
{
    if (woff == nullptr)
        return (int)cudaErrorInvalidValue;
    return gk_any(xr, xi, wr, wi, yr, yi, xoff, yoff, woff, koff, O, H, K,
                  F, hstride, x_ws, w_ws, y_ws, W, form, vec, passes,
                  (cudaStream_t)stream);
}

// the launches that ran on the card, by slot (g_runs)
extern "C" int gatherk_runs(unsigned long long* out)
{
    return (int)cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs));
}
