// RGRow kernel: the reduction form of an aligned (gathered) step, for the
// port's sparse executor.
//
// Replaces the Pallas kernel artensor_tpu/runtime/gatherk.py::_rg_kernel
// (RGRow row of _ggk_call, pallas_call :1372).  Per gathered row b and
// slice instance w it computes
//   y[b, h, f] = sum_k x[gi[b], foff[f] + koff[k]] * w[gj[b], whoff[h] + wkoff[k]]
// with F <= 256 free cells, K >= 128 contract values and H <= 8 fresh
// legs.  Both rows are read in their STORED digit order: the canonical
// (F, K) layout of X and the (H, K) layout of W are digit permutations of
// the stored rows, so each is a sum of an f (h) offset and a k offset, and
// the tables replace the whole-buffer reorder of X and the transpose of W
// that earlier ran around the kernel.  The output row is (H, F) when the
// fresh block leads (hy_first), else (F, H), f in canonical order.
//
// Bound: device-memory bytes.  Each element of an X row does 8*H <= 64 flop
// on 8 bytes, below the card's 20 flop a byte, so the design reads every X
// and W element of a block's row once.  A block of 128 threads owns one
// (b, w) and one tile of FT free cells; thread t takes contract values
// k = t, t + 128, ...  For each k it loads its W[h, k] values once and
// the tile's X[f, k] values as V-wide vector loads: the wrapper orders
// the free cells by stored offset, so that where the stored-minor digits
// of the row are free (the 1k path's row: three of its four free digits),
// V = 4 consecutive cells are one 16-byte load and a warp's 32 threads
// read 32 neighbouring k.  Each thread keeps 2*HC*FT = ACC <= 64 partial
// sums in registers (HC: H rounded up to a power of two; FT = min(32 / HC,
// 16 V)); 64 ran 3.6% faster on the 1k step than 128 with twice the cells
// a tile (H100, scripts/gk_forms_torch_port.py --kind rgrow; PERF.md), the
// W row then read once a tile.
// The block then sums them over its 128 threads: a butterfly of warp
// shuffles leaves each lane ACC/32 of its warp's sums (ACC - ACC/32
// shuffles a thread, not 5 ACC), and the 4 warps' sums meet in shared
// memory.  Targets are lexsorted by X row and are the fastest grid index,
// so the targets that share a row run next to each other and read it from
// L2.  Rows are read by index straight from the source buffers: no
// gathered or reordered copy exists.

#include <cuda_runtime.h>
#include <stdint.h>

#include "runs.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

template <int V>
struct Vec;
template <>
struct Vec<1> {
    static __device__ __forceinline__ void load(const float* p, float* v)
    {
        v[0] = __ldg(p);
    }
};
template <>
struct Vec<2> {
    static __device__ __forceinline__ void load(const float* p, float* v)
    {
        const float2 a = __ldg(reinterpret_cast<const float2*>(p));
        v[0] = a.x; v[1] = a.y;
    }
};
template <>
struct Vec<4> {
    static __device__ __forceinline__ void load(const float* p, float* v)
    {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    }
};

// One butterfly level over a warp: the lane keeps the half of its HALF * 2
// values that its bit S selects and adds its partner's copy of them.
template <int HALF, int S, int N>
__device__ __forceinline__ void fold(float (&v)[N], bool up)
{
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
        const float send = up ? v[i] : v[i + HALF];
        const float keep = up ? v[i + HALF] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
    }
}

// launches that ran on the card (runs.cuh)
__device__ unsigned long long g_runs[1];

template <int HC, int V>
__global__ void __launch_bounds__(THREADS)
rgrow_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
             const float* __restrict__ wr, const float* __restrict__ wi,
             float* __restrict__ yr, float* __restrict__ yi,
             const long long* __restrict__ gi,
             const long long* __restrict__ gj,
             const int* __restrict__ fgoff, const int* __restrict__ fcan,
             const int* __restrict__ koff, const int* __restrict__ whoff,
             const int* __restrict__ wkoff,
             int F, int K, int H, int hy_first, int wvec, long long xrow,
             long long wrow, long long x_ws, long long w_ws, long long y_ws,
             int n_ft)
{
    runs::count(&g_runs[0]);
    constexpr int FT = (32 / HC < 16 * V) ? 32 / HC : 16 * V;
    constexpr int FG = FT / V;          // vector groups a thread owns
    constexpr int ACC = 2 * HC * FT;    // partial sums: [re|im][h][f]
    static_assert(ACC % 32 == 0 && ACC <= THREADS, "ACC");
    __shared__ float red[WARPS][ACC];

    const long long b = blockIdx.x / n_ft;
    const int ft = (int)(blockIdx.x % n_ft);
    const long long w = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* __restrict__ xrb = xr + w * x_ws + gi[b] * xrow;
    const float* __restrict__ xib = xi + w * x_ws + gi[b] * xrow;
    const float* __restrict__ wrb = wr + w * w_ws + gj[b] * wrow;
    const float* __restrict__ wib = wi + w * w_ws + gj[b] * wrow;

    const int ng = min(FG, F / V - ft * FG);   // groups of this tile
    int fo[FG], ho[HC];
#pragma unroll
    for (int g = 0; g < FG; ++g)
        fo[g] = g < ng ? fgoff[ft * FG + g] : 0;
#pragma unroll
    for (int h = 0; h < HC; ++h)
        ho[h] = h < H ? whoff[h] : 0;

    float v[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i)
        v[i] = 0.f;

#pragma unroll 2
    for (int k = tid; k < K; k += THREADS) {
        const int xk = __ldg(koff + k), wk = __ldg(wkoff + k);
        float cr[HC], ci[HC];
        if (wvec) {     // H == HC values at consecutive offsets
            constexpr int VW = HC < 4 ? HC : 4;
#pragma unroll
            for (int h = 0; h < HC; h += VW) {
                Vec<VW>::load(wrb + wk + h, cr + h);
                Vec<VW>::load(wib + wk + h, ci + h);
            }
        } else {
#pragma unroll
            for (int h = 0; h < HC; ++h) {
                cr[h] = h < H ? __ldg(wrb + wk + ho[h]) : 0.f;
                ci[h] = h < H ? __ldg(wib + wk + ho[h]) : 0.f;
            }
        }
#pragma unroll
        for (int g = 0; g < FG; ++g) {
            if (g >= ng)
                break;
            float ar[V], ai[V];
            Vec<V>::load(xrb + xk + fo[g], ar);
            Vec<V>::load(xib + xk + fo[g], ai);
#pragma unroll
            for (int e = 0; e < V; ++e)
#pragma unroll
                for (int h = 0; h < HC; ++h) {
                    float& sr = v[h * FT + g * V + e];
                    float& si = v[(HC + h) * FT + g * V + e];
                    sr = fmaf(ar[e], cr[h], sr);
                    sr = fmaf(-ai[e], ci[h], sr);
                    si = fmaf(ar[e], ci[h], si);
                    si = fmaf(ai[e], cr[h], si);
                }
        }
    }

    // the warp's sums: lane keeps ACC/32 of them, from index `base`
    fold<ACC / 2, 16>(v, lane & 16);
    fold<ACC / 4, 8>(v, lane & 8);
    fold<ACC / 8, 4>(v, lane & 4);
    fold<ACC / 16, 2>(v, lane & 2);
    fold<ACC / 32, 1>(v, lane & 1);
    const int base = ((lane & 16) ? ACC / 2 : 0) + ((lane & 8) ? ACC / 4 : 0)
                     + ((lane & 4) ? ACC / 8 : 0) + ((lane & 2) ? ACC / 16 : 0)
                     + ((lane & 1) ? ACC / 32 : 0);
#pragma unroll
    for (int j = 0; j < ACC / 32; ++j)
        red[warp][base + j] = v[j];
    __syncthreads();
    if (tid >= ACC)
        return;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q)
        s += red[q][tid];
    const int im = tid / (HC * FT);
    const int h = (tid / FT) % HC;
    const int fk = ft * FT + tid % FT;
    if (h >= H || fk >= F)
        return;
    const int f = fcan[fk];
    const long long a = w * y_ws + b * (long long)F * H
                        + (hy_first ? (long long)h * F + f : (long long)f * H + h);
    (im ? yi : yr)[a] = s;
}

template <int HC, int V>
int launch(const float* xr, const float* xi, const float* wr, const float* wi,
           float* yr, float* yi, const long long* gi, const long long* gj,
           const int* fgoff, const int* fcan, const int* koff,
           const int* whoff, const int* wkoff, long long B, int F, int K,
           int H, int hy_first, int wvec, long long xrow, long long wrow,
           long long x_ws, long long w_ws, long long y_ws, int W,
           cudaStream_t s)
{
    constexpr int FT = (32 / HC < 16 * V) ? 32 / HC : 16 * V;
    const int n_ft = (F + FT - 1) / FT;
    const long long nblk = B * n_ft;
    if (nblk <= 0 || nblk > 0x7fffffffLL)
        return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)nblk, (unsigned)W);
    rgrow_kernel<HC, V><<<grid, THREADS, 0, s>>>(
        xr, xi, wr, wi, yr, yi, gi, gj, fgoff, fcan, koff, whoff, wkoff, F,
        K, H, hy_first, wvec, xrow, wrow, x_ws, w_ws, y_ws, n_ft);
    return (int)cudaGetLastError();
}

template <int V>
int launch_h(const float* xr, const float* xi, const float* wr,
             const float* wi, float* yr, float* yi, const long long* gi,
             const long long* gj, const int* fgoff, const int* fcan,
             const int* koff, const int* whoff, const int* wkoff,
             long long B, int F, int K, int H, int hy_first, int wvec,
             long long xrow,
             long long wrow, long long x_ws, long long w_ws, long long y_ws,
             int W, cudaStream_t s)
{
#define RG_ARGS xr, xi, wr, wi, yr, yi, gi, gj, fgoff, fcan, koff, whoff, \
    wkoff, B, F, K, H, hy_first, wvec, xrow, wrow, x_ws, w_ws, y_ws, W, s
    if (H <= 1)
        return launch<1, V>(RG_ARGS);
    if (H <= 2)
        return launch<2, V>(RG_ARGS);
    if (H <= 4)
        return launch<4, V>(RG_ARGS);
    return launch<8, V>(RG_ARGS);
#undef RG_ARGS
}

}  // namespace

// V: free cells a vector load covers (1, 2 or 4; gatherk.rg_lanes); wvec:
// H is a power of two, whoff[h] = h and the W loads are aligned to
// min(H, 4) floats (then a thread's W[:, k] is one or two vector loads);
// the tables are int32 offsets within a row.
extern "C" int rgrow_launch(const float* xr, const float* xi, const float* wr,
                            const float* wi, float* yr, float* yi,
                            const long long* gi, const long long* gj,
                            const int* fgoff, const int* fcan,
                            const int* koff, const int* whoff,
                            const int* wkoff, long long B, int F, int K,
                            int H, int V, int hy_first, int wvec,
                            long long xrow,
                            long long wrow, long long x_ws, long long w_ws,
                            long long y_ws, int W, void* stream)
{
    if (V != 1 && V != 2 && V != 4)
        return (int)cudaErrorInvalidValue;
    if (B <= 0 || W <= 0 || W > 65535 || H < 1 || H > 8 || F < 1 || K < 1
        || F % V || (wvec && (H & (H - 1))))
        return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = (cudaStream_t)stream;
#define RG_ARGS xr, xi, wr, wi, yr, yi, gi, gj, fgoff, fcan, koff, whoff, \
    wkoff, B, F, K, H, hy_first, wvec, xrow, wrow, x_ws, w_ws, y_ws, W, s
    if (V == 4)
        return launch_h<4>(RG_ARGS);
    if (V == 2)
        return launch_h<2>(RG_ARGS);
    return launch_h<1>(RG_ARGS);
#undef RG_ARGS
}

// the launches that ran on the card (g_runs)
extern "C" int rgrow_runs(unsigned long long* out)
{
    return (int)cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs));
}
