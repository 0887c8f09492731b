// RGFlat kernel: the flat-row reduction form of an aligned (gathered) step,
// for the port's sparse executor.
//
// Replaces the Pallas kernel artensor_tpu/runtime/gatherk.py::_rgflat_kernel
// (RGFlat row of _ggk_call, pallas_call :1372).  Per gathered row b and
// slice instance w it computes
//   y[b, h, f] = sum_k x[gi[b], foff[f] + koff[k]]
//                      * w[gj[b], whoff[h] + wkoff[k]]
// with the X row (F*K complex elements, at most 2^15) and the W row (H*K,
// H <= 8) both read in their STORED digit order: the (F, K) address table
// of the plan is foff[f] + koff[k] (its free and contract digits), and
// W's (H, K) layout is whoff[h] + wkoff[k], so W is not transposed around
// the kernel.  The output row is (H, F), h-major, f in stored order.
//
// Bound: device-memory bytes.  An X element does 8*H <= 64 flop on 8
// bytes, and at slice width 32 the step streams nearly the whole X buffer
// once (326 MB on the 10k path, 262 MB on 1k-sc25), so the design is a
// streaming copy with the arithmetic done out of shared memory:
//
// * Staged route (rows of at most gatherk.RGF_STAGE_ELEMS elements): a
//   block of 256 threads owns one slice instance w and a run of NS * T
//   consecutive targets (sorted by X row: the rows of a run are, on the
//   paths, one contiguous stretch of X).  It copies the X rows of T targets at a time
//   into shared memory with cp.async (16-byte copies where rows and
//   pointers allow, else 4-byte ones), two stages in flight, so the next
//   rows load while the current ones are summed.  The W rows of the slice
//   instance (all of them, when they fit; a slice-invariant W is the same
//   rows for every w) and the int16 offset tables are staged once per
//   block.
// * Direct route (larger rows): one target a block, X read from device
//   memory through L1 at the same offsets, W through L1.
//
// In both routes a thread sums one item (target t, group g of V free cells
// at consecutive stored offsets, all H) over k; V = 4 makes every X read a
// 16-byte load and every output store a 16-byte store.  When a stage holds
// too few items for the block, KS neighbouring lanes split the k loop and
// a warp-shuffle butterfly adds their sums.  Stages of 4096 elements and 2
// stages a block: among 2048-8192 elements and 1-8 stages the fastest on
// the 10k step and within 1% of the fastest (1 stage) on 1k-sc25
// (scripts/rgflat_torch_port.py --sweep, H100; PERF.md).  Index
// arithmetic within a row is 32-bit; row and slice offsets are 64-bit.
// The geometry (T, NS, KS, V, staged W) is chosen on the host
// (gatherk.rgf_geometry), which a CPU test models in numpy.

#include <cuda_runtime.h>
#include <stdint.h>

#include "runs.cuh"

#include "tc_core.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROW_CAP = 1 << 15;   // gatherk.RG_ROW_CAP

template <int V>
struct Vec;
template <>
struct Vec<1> {
    template <bool G>
    static __device__ __forceinline__ void load(const float* p, float* v)
    {
        v[0] = G ? __ldg(p) : *p;
    }
    static __device__ __forceinline__ void store(float* p, const float* v)
    {
        *p = v[0];
    }
};
template <>
struct Vec<2> {
    template <bool G>
    static __device__ __forceinline__ void load(const float* p, float* v)
    {
        const float2* q = reinterpret_cast<const float2*>(p);
        const float2 a = G ? __ldg(q) : *q;
        v[0] = a.x; v[1] = a.y;
    }
    static __device__ __forceinline__ void store(float* p, const float* v)
    {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    }
};
template <>
struct Vec<4> {
    template <bool G>
    static __device__ __forceinline__ void load(const float* p, float* v)
    {
        const float4* q = reinterpret_cast<const float4*>(p);
        const float4 a = G ? __ldg(q) : *q;
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    }
    static __device__ __forceinline__ void store(float* p, const float* v)
    {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};

struct Args {
    const float *xr, *xi, *wr, *wi;
    float *yr, *yi;
    const long long *gi, *gj;
    const short* tabs;      // koff[K], wkoff[K], fgoff[F / V], whoff[H]
    int B, F, K, H, T, NS, KS, cp16, wn;
    long long x_ws, w_ws, y_ws;
    int n_tiles;            // direct route: item tiles per target
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int n_tabs(int K, int F, int V, int H)
{
    return round4(2 * K + F / V + H);
}

// Sum items [0, n_items) of targets b0 ... : item it is target t = it / gn,
// free group g = g0 + it % gn.  ``xsr``/``xsi``: the staged rows (t * row
// apart) when STAGED, else unused; ``wsr``/``wsi``: the staged W rows of
// this slice instance when WST.
template <int HC, int V, bool STAGED, bool WST>
__device__ __forceinline__ void sum_items(
    const Args& a, const short* __restrict__ tab, const float* xsr,
    const float* xsi, const float* wsr, const float* wsi, int b0, int nt,
    int g0, int gn, long long w)
{
    const int K = a.K, F = a.F, H = a.H, KS = a.KS, row = F * K;
    const short* koff = tab;
    const short* wkoff = tab + K;
    const short* fgoff = tab + 2 * K;
    const short* whoff = tab + 2 * K + F / V;
    const int tid = threadIdx.x;
    const int sub = tid & (KS - 1);
    const int per = THREADS / KS;
    const int n_items = nt * gn;
    for (int base = 0; base < n_items; base += per) {
        const int it = base + tid / KS;
        const bool valid = it < n_items;
        const int t = valid ? it / gn : 0;
        const int g = g0 + (valid ? it - t * gn : 0);
        const long long b = (long long)b0 + t;
        float ar[HC][V], ai[HC][V];
#pragma unroll
        for (int h = 0; h < HC; ++h)
#pragma unroll
            for (int e = 0; e < V; ++e)
                ar[h][e] = ai[h][e] = 0.f;
        if (valid) {
            const long long j = a.gj[b];
            const float *xr_, *xi_, *wr_, *wi_;
            if constexpr (STAGED) {
                xr_ = xsr + t * row;
                xi_ = xsi + t * row;
            } else {
                const long long xo = w * a.x_ws + a.gi[b] * row;
                xr_ = a.xr + xo;
                xi_ = a.xi + xo;
            }
            if constexpr (WST) {
                wr_ = wsr + j * (H * K);
                wi_ = wsi + j * (H * K);
            } else {
                const long long wo = w * a.w_ws + j * (H * K);
                wr_ = a.wr + wo;
                wi_ = a.wi + wo;
            }
            const int fo = fgoff[g];
            int ho[HC];
#pragma unroll
            for (int h = 0; h < HC; ++h)
                ho[h] = h < H ? whoff[h] : 0;
#pragma unroll 4
            for (int k = sub; k < K; k += KS) {
                const int xo = koff[k] + fo, wk = wkoff[k];
                float xv[V], yv[V];
                Vec<V>::template load<!STAGED>(xr_ + xo, xv);
                Vec<V>::template load<!STAGED>(xi_ + xo, yv);
#pragma unroll
                for (int h = 0; h < HC; ++h) {
                    float cr = 0.f, ci = 0.f;
                    if (h < H) {
                        if constexpr (WST) {
                            cr = wr_[ho[h] + wk];
                            ci = wi_[ho[h] + wk];
                        } else {
                            cr = __ldg(wr_ + ho[h] + wk);
                            ci = __ldg(wi_ + ho[h] + wk);
                        }
                    }
#pragma unroll
                    for (int e = 0; e < V; ++e) {
                        ar[h][e] = fmaf(xv[e], cr, ar[h][e]);
                        ar[h][e] = fmaf(-yv[e], ci, ar[h][e]);
                        ai[h][e] = fmaf(xv[e], ci, ai[h][e]);
                        ai[h][e] = fmaf(yv[e], cr, ai[h][e]);
                    }
                }
            }
        }
        // KS lanes of one item are neighbours in a warp: add their sums
        // (every lane of the block runs this: the loop bound is uniform)
        for (int d = KS >> 1; d > 0; d >>= 1)
#pragma unroll
            for (int h = 0; h < HC; ++h)
#pragma unroll
                for (int e = 0; e < V; ++e) {
                    ar[h][e] += __shfl_xor_sync(0xffffffffu, ar[h][e], d);
                    ai[h][e] += __shfl_xor_sync(0xffffffffu, ai[h][e], d);
                }
        if (valid && sub == 0) {
            const long long yo = w * a.y_ws + b * (long long)(H * F) + g * V;
#pragma unroll
            for (int h = 0; h < HC; ++h)
                if (h < H) {
                    Vec<V>::store(a.yr + yo + h * F, ar[h]);
                    Vec<V>::store(a.yi + yo + h * F, ai[h]);
                }
        }
    }
}

// Issue the cp.async copies of the X rows of targets [b0, b0 + nt) into
// one stage buffer (rows ``row`` floats apart) and commit them as a group.
__device__ __forceinline__ void stage_rows(const Args& a, float* dr, float* di,
                                           int b0, int nt, long long w)
{
    const int row = a.F * a.K;
    const float* xr = a.xr + w * a.x_ws;
    const float* xi = a.xi + w * a.x_ws;
    if (a.cp16) {
        const int rq = row >> 2, n = nt * rq;
        for (int p = threadIdx.x; p < n; p += THREADS) {
            const int t = p / rq, q = 4 * (p - t * rq);
            const long long s = a.gi[b0 + t] * row + q;
            tc::cp16(dr + t * row + q, xr + s, 16);
            tc::cp16(di + t * row + q, xi + s, 16);
        }
    } else {
        const int n = nt * row;
        for (int p = threadIdx.x; p < n; p += THREADS) {
            const int t = p / row, q = p - t * row;
            const long long s = a.gi[b0 + t] * row + q;
            tc::cp4(dr + p, xr + s, 4);
            tc::cp4(di + p, xi + s, 4);
        }
    }
    tc::cp_commit();
}

// launches that ran on the card (runs.cuh)
__device__ unsigned long long g_runs[1];

template <int HC, int V, bool STAGED, bool WST>
__global__ void __launch_bounds__(THREADS)
rgflat_kernel(const Args a)
{
    runs::count(&g_runs[0]);
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const long long w = blockIdx.y;
    const int ntab = n_tabs(a.K, a.F, V, a.H);
    const int sb = STAGED ? round4(a.T * a.F * a.K) : 0;   // stage buffer
    float* xs = smem;                                      // [re|im][2][sb]
    float* ws = smem + 4 * sb;                             // [re|im][wn]
    short* tab = reinterpret_cast<short*>(ws + (WST ? 2 * round4(a.wn) : 0));

    int b0 = 0, ns = 0;
    if constexpr (STAGED) {
        b0 = blockIdx.x * a.NS * a.T;
        ns = (min(a.B - b0, a.NS * a.T) + a.T - 1) / a.T;
        stage_rows(a, xs, xs + 2 * sb, b0, min(a.T, a.B - b0), w);
    }
    for (int i = threadIdx.x; i < ntab; i += THREADS)
        tab[i] = a.tabs[i];
    if constexpr (WST) {
        const float* wr = a.wr + w * a.w_ws;
        const float* wi = a.wi + w * a.w_ws;
        const int wp = round4(a.wn);
        for (int i = threadIdx.x; i < a.wn; i += THREADS) {
            ws[i] = __ldg(wr + i);
            ws[wp + i] = __ldg(wi + i);
        }
    }
    if constexpr (!STAGED) {
        __syncthreads();
        const int b = blockIdx.x / a.n_tiles;
        const int g0 = (blockIdx.x - b * a.n_tiles) * (THREADS / a.KS);
        sum_items<HC, V, false, false>(a, tab, nullptr, nullptr, nullptr,
                                       nullptr, b, 1, g0,
                                       min(THREADS / a.KS, a.F / V - g0), w);
        return;
    }
    const int wp = round4(a.wn);
    for (int s = 0; s < ns; ++s) {
        const int bs = b0 + s * a.T;
        if (s + 1 < ns) {
            const int bn = bs + a.T;
            float* d = xs + ((s + 1) & 1) * sb;
            stage_rows(a, d, d + 2 * sb, bn, min(a.T, a.B - bn), w);
            tc::cp_wait<1>();
        } else {
            tc::cp_wait<0>();
        }
        __syncthreads();
        const float* d = xs + (s & 1) * sb;
        sum_items<HC, V, true, WST>(a, tab, d, d + 2 * sb, ws, ws + wp, bs,
                                    min(a.T, a.B - bs), 0, a.F / V, w);
        __syncthreads();
    }
}

template <int HC, int V>
int launch(const Args& a, int W, cudaStream_t s)
{
    const int row = a.F * a.K;
    const size_t tab_bytes = sizeof(short) * n_tabs(a.K, a.F, V, a.H);
    void (*kern)(const Args);
    size_t smem;
    dim3 grid;
    if (a.T > 0) {
        const long long per_block = (long long)a.T * a.NS;
        grid = dim3((unsigned)((a.B + per_block - 1) / per_block), W);
        smem = sizeof(float) * (4 * (size_t)round4(a.T * row)
                                + (a.wn ? 2 * (size_t)round4(a.wn) : 0))
               + tab_bytes;
        kern = a.wn ? rgflat_kernel<HC, V, true, true>
                    : rgflat_kernel<HC, V, true, false>;
    } else {
        const long long nblk = (long long)a.B * a.n_tiles;
        if (nblk > 0x7fffffffLL)
            return (int)cudaErrorInvalidConfiguration;
        grid = dim3((unsigned)nblk, W);
        smem = tab_bytes;
        kern = rgflat_kernel<HC, V, false, false>;
    }
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess)
            return (int)e;
    }
    kern<<<grid, THREADS, smem, s>>>(a);
    return (int)cudaGetLastError();
}

template <int V>
int launch_h(const Args& a, int W, cudaStream_t s)
{
    if (a.H <= 1)
        return launch<1, V>(a, W, s);
    if (a.H <= 2)
        return launch<2, V>(a, W, s);
    if (a.H <= 4)
        return launch<4, V>(a, W, s);
    return launch<8, V>(a, W, s);
}

}  // namespace

// tabs: int16 koff[K], wkoff[K], fgoff[F / V], whoff[H] (gatherk.rgf_tables;
// every offset lies within a row of at most 2^15 elements).  T > 0: the
// staged route, T targets a stage, NS stages a block, cp16 for 16-byte
// copies (rows a multiple of 4 floats, X 16-byte aligned), wn W elements of
// a slice instance staged (0: W read through L1); T == 0: the direct route
// (V > 1 needs X aligned to V floats).  KS: lanes that split an item's k
// loop (a power of two, at most 32).
extern "C" int rgflat_launch(const float* xr, const float* xi,
                             const float* wr, const float* wi,
                             float* yr, float* yi,
                             const long long* gi, const long long* gj,
                             const short* tabs, long long B, int F, int K,
                             int H, int V, int T, int NS, int KS, int cp16,
                             int wn, long long x_ws, long long w_ws,
                             long long y_ws, int W, void* stream)
{
    if (V != 1 && V != 2 && V != 4)
        return (int)cudaErrorInvalidValue;
    if (B <= 0 || B > 0x7fffffffLL || W <= 0 || W > 65535 || H < 1
        || H > 8 || F < 1 || K < 1 || F % V || (long long)F * K > ROW_CAP
        || KS < 1 || KS > 32 || (KS & (KS - 1)) || T < 0
        || (T > 0 && (NS < 1 || (long long)T * NS > 0x7fffffffLL
                      || (cp16 && (F * K) % 4)))
        || wn < 0 || (wn && T == 0))
        return (int)cudaErrorInvalidConfiguration;
    Args a{xr, xi, wr, wi, yr, yi, gi, gj, tabs, (int)B, F, K, H, T, NS, KS,
           cp16, wn, x_ws, w_ws, y_ws, 0};
    a.n_tiles = (F / V + THREADS / KS - 1) / (THREADS / KS);
    cudaStream_t s = (cudaStream_t)stream;
    if (V == 4)
        return launch_h<4>(a, W, s);
    if (V == 2)
        return launch_h<2>(a, W, s);
    return launch_h<1>(a, W, s);
}

// the launches that ran on the card (g_runs)
extern "C" int rgflat_runs(unsigned long long* out)
{
    return (int)cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs));
}
