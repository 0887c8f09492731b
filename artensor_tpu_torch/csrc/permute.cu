// Permute-copy kernel: a contiguous copy of any strided view, for every
// reorder of the port's operands and outputs (ops/permute.py).
//
// Replaces no Pallas kernel: the JAX package leaves these reorders to
// XLA's transposes.  It was added because PyTorch's generic strided copy
// has no tiled path: on the steps' many-axis permutes the output's minor
// axis lies strided in the input, every warp's reads scatter, and the
// copies ran at 16-63% of the card's 3.35 TB/s.
//
// Bound: device-memory bytes, each element read once and written once.
// The host plan (ops/permute.py) drops size-1 axes, merges the axes that
// stay runs, and re-expresses the copy in units of UNIT bytes (2, 4, 8 or
// 16: a shared minor run is moved in 16-byte pieces where the strides and
// pointers allow), then picks one of two modes:
//
//   row   the input's minor run stays the output's minor run and spans at
//         least 128 bytes: each unit goes straight from device memory to
//         device memory, both sides read and written along the run.
//   tile  otherwise.  A tile is the sub-tensor over the union of the
//         input-minor group (the axes of least input stride, at least 128
//         bytes of them) and the output-minor group (the same for the
//         output), grown along the output's axes to about 32 KiB.  The
//         block reads it along the input into shared memory, padded so
//         that the write pass's lanes fall in different banks, and writes
//         it along the output.
//
// Either way a tile's units are split in two: a lane part (the minor
// group, whose offsets each thread keeps) and a uniform part (the rest of
// the tile, one offset a warp row).  Both parts' offsets are tabulated in
// shared memory once a block; the grid is persistent and walks the tiles
// (the axes outside the tile, the outer axes), one warp lane an outer
// axis, the offsets summed across the warp.  Offsets are 64-bit.  One
// launch copies one or two components of the same layout (a split pair).

#include <cuda_runtime.h>
#include <stdint.h>

#include "runs.cuh"

namespace {

constexpr int MAXA = 32;         // tile axes, and outer axes (one a lane)
constexpr int THREADS = 256;
constexpr int UNROLL = 4;        // units in flight per thread and pass
constexpr size_t SMEM_MAX = 48 * 1024;

// the plan (ops/permute.py ``Args`` mirrors it field for field); strides
// and offsets in units
struct PermuteArgs {
    long long t_in[MAXA];        // tile axis: input stride
    long long t_out[MAXA];       //            output stride
    long long t_sm[MAXA];        //            shared-memory stride (tile)
    long long o_in[MAXA];        // outer axis: input stride of one step
    long long o_out[MAXA];       //             output stride of one step
    int t_size[MAXA];            // tile axis: extent in the tile
    unsigned o_size[MAXA], o_size_mul[MAXA], o_size_shr[MAXA];
    unsigned o_div[MAXA], o_div_mul[MAXA], o_div_shr[MAXA];
    signed char ld[MAXA];        // load order: lane axes, then uniform axes
    signed char st[MAXA];        // store order (tile mode), likewise
    int nt, nld, nst, no;        // tile axes; lane axes of ld / st; outer
    int A, UA, B, UB;            // lane / uniform counts, load and store
    int smem_units;              // the tile's buffer (tile mode)
    int n_tiles;                 // tiles a component
};

// launches that ran on the card (runs.cuh): row mode, tile mode
__device__ unsigned long long g_runs[2];

template <int BYTES> struct Unit;
template <> struct Unit<2> { using T = unsigned short; };
template <> struct Unit<4> { using T = unsigned int; };
template <> struct Unit<8> { using T = uint2; };
template <> struct Unit<16> { using T = uint4; };

// n / d for n < 2^31 (mul, shr from the host: CUTLASS's FastDivmod)
__device__ __forceinline__ unsigned fast_div(unsigned n, unsigned d,
                                             unsigned mul, unsigned shr)
{
    return d == 1 ? n : (__umulhi(n, mul) >> shr);
}

// offsets of entries [0, count): an entry's coordinates over the axes
// ax[0..n) (the first the fastest), dotted with two stride lists
__device__ void tabulate(long long* g, long long* s, int count,
                         const signed char* ax, int n, const int* size,
                         const long long* gstride, const long long* sstride)
{
    for (int e = threadIdx.x; e < count; e += THREADS) {
        long long go = 0, so = 0;
        int r = e;
        for (int j = 0; j < n; ++j) {
            const int k = ax[j];
            const int c = r % size[k];
            r /= size[k];
            go += c * gstride[k];
            so += c * sstride[k];
        }
        g[e] = go;
        s[e] = so;
    }
}

// one pass over a tile's `count` units: unit L = lane + n_lane * u goes
// from src[lg[lane] + ug[u]] to dst[ls[lane] + us[u]].  A thread starts at
// L = threadIdx.x and steps by THREADS; when n_lane divides THREADS its
// lane is fixed and its lane offsets stay in registers.
template <typename S, typename D>
__device__ __forceinline__ void pass(const S* __restrict__ src,
                                     D* __restrict__ dst, int count,
                                     int n_lane, const long long* lg,
                                     const long long* ls,
                                     const long long* ug,
                                     const long long* us)
{
    const int step_l = THREADS % n_lane, step_u = THREADS / n_lane;
    int l = threadIdx.x % n_lane, u = threadIdx.x / n_lane;
    if (step_l == 0) {
        const long long g0 = lg[l], s0 = ls[l];
        for (int L = threadIdx.x; L < count; L += THREADS * UNROLL) {
            S v[UNROLL];
#pragma unroll
            for (int j = 0; j < UNROLL; ++j)
                if (L + j * THREADS < count)
                    v[j] = src[g0 + ug[u + j * step_u]];
#pragma unroll
            for (int j = 0; j < UNROLL; ++j)
                if (L + j * THREADS < count)
                    dst[s0 + us[u + j * step_u]] = v[j];
            u += UNROLL * step_u;
        }
        return;
    }
    // a lane that moves: both halves walk the same units from (l, u)
    auto advance = [&](int& l, int& u) {
        l += step_l;
        u += step_u;
        if (l >= n_lane) {
            l -= n_lane;
            ++u;
        }
    };
    for (int L = threadIdx.x; L < count; L += THREADS * UNROLL) {
        S v[UNROLL];
        int l1 = l, u1 = u;
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
            if (L + j * THREADS < count)
                v[j] = src[lg[l] + ug[u]];
            advance(l, u);
        }
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
            if (L + j * THREADS < count)
                dst[ls[l1] + us[u1]] = v[j];
            advance(l1, u1);
        }
    }
}

template <typename T, bool ROW>
__global__ void __launch_bounds__(THREADS)
permute_copy_kernel(const __grid_constant__ PermuteArgs a,
                    const T* __restrict__ in0, const T* __restrict__ in1,
                    T* __restrict__ out0, T* __restrict__ out1, int ncomp)
{
    runs::count(&g_runs[ROW ? 0 : 1]);
    extern __shared__ __align__(16) unsigned char smem[];
    long long* lg = reinterpret_cast<long long*>(smem);  // load: lanes
    long long* ls = lg + a.A;
    long long* ug = ls + a.A;                           // load: uniform
    long long* us = ug + a.UA;
    long long* sg = us + a.UA;                          // store: lanes
    long long* ss = sg + a.B;
    long long* vg = ss + a.B;                           // store: uniform
    long long* vs = vg + a.UB;
    T* tile = reinterpret_cast<T*>(vs + a.UB);

    // load order: input offsets, and the tile's (tile) or the output's
    // (row) offsets; store order: output and tile offsets
    const long long* second = ROW ? a.t_out : a.t_sm;
    tabulate(lg, ls, a.A, a.ld, a.nld, a.t_size, a.t_in, second);
    tabulate(ug, us, a.UA, a.ld + a.nld, a.nt - a.nld, a.t_size, a.t_in,
             second);
    if (!ROW) {
        tabulate(sg, ss, a.B, a.st, a.nst, a.t_size, a.t_out, a.t_sm);
        tabulate(vg, vs, a.UB, a.st + a.nst, a.nt - a.nst, a.t_size,
                 a.t_out, a.t_sm);
    }
    // this lane's outer axis, if any: a tile index's coordinate on it is
    // (t / o_div) % o_size
    const int lane = threadIdx.x & 31;
    const bool mine = lane < a.no;
    const unsigned osz = mine ? a.o_size[lane] : 1;
    const unsigned osm = mine ? a.o_size_mul[lane] : 0;
    const unsigned oss = mine ? a.o_size_shr[lane] : 0;
    const unsigned odv = mine ? a.o_div[lane] : 1;
    const unsigned odm = mine ? a.o_div_mul[lane] : 0;
    const unsigned ods = mine ? a.o_div_shr[lane] : 0;
    const long long oin = mine ? a.o_in[lane] : 0;
    const long long oout = mine ? a.o_out[lane] : 0;
    __syncthreads();

    const int count = a.A * a.UA;
    const long long total = (long long)ncomp * a.n_tiles;
    for (long long tt = blockIdx.x; tt < total; tt += gridDim.x) {
        const bool second_comp = tt >= a.n_tiles;
        const unsigned t = (unsigned)(tt - (second_comp ? a.n_tiles : 0));
        const unsigned q = fast_div(t, odv, odm, ods);
        const unsigned c = q - fast_div(q, osz, osm, oss) * osz;
        long long bi = c * oin, bo = c * oout;
#pragma unroll
        for (int m = 16; m; m >>= 1) {
            bi += __shfl_xor_sync(0xffffffffu, bi, m);
            bo += __shfl_xor_sync(0xffffffffu, bo, m);
        }
        const T* src = (second_comp ? in1 : in0) + bi;
        T* dst = (second_comp ? out1 : out0) + bo;
        if (ROW) {
            pass(src, dst, count, a.A, lg, ls, ug, us);
        } else {
            __syncthreads();        // the last tile's store pass is done
            pass(src, tile, count, a.A, lg, ls, ug, us);
            __syncthreads();
            pass(static_cast<const T*>(tile), dst, count, a.B, ss, sg, vs,
                 vg);
        }
    }
}

template <int BYTES, bool ROW>
int launch(const PermuteArgs& a, const void* in0, const void* in1,
           void* out0, void* out1, int ncomp, size_t smem,
           cudaStream_t stream)
{
    using T = typename Unit<BYTES>::T;
    auto kernel = permute_copy_kernel<T, ROW>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          THREADS, smem);
    if (e != cudaSuccess)
        return (int)e;
    const long long total = (long long)ncomp * a.n_tiles;
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const unsigned grid = (unsigned)(total < resident ? total : resident);
    kernel<<<grid, THREADS, smem, stream>>>(
        a, static_cast<const T*>(in0), static_cast<const T*>(in1),
        static_cast<T*>(out0), static_cast<T*>(out1), ncomp);
    return (int)cudaGetLastError();
}

}  // namespace

// Copy the strided view(s) described by ``a`` of in0 (and in1) into the
// contiguous out0 (and out1).  ``unit``: bytes a unit (2, 4, 8, 16);
// ``row``: row mode; ``ncomp``: 1 or 2 components.
extern "C" int permute_launch(const void* in0, const void* in1, void* out0,
                              void* out1, const void* args, int unit,
                              int row, int ncomp, void* stream)
{
    const PermuteArgs* a = static_cast<const PermuteArgs*>(args);
    if (ncomp < 1 || ncomp > 2 || a->n_tiles < 1 || a->A < 1
        || a->UA < 1 || a->nt > MAXA || a->no > MAXA
        || (long long)ncomp * a->n_tiles > 0x7fffffffLL
        || (!row && (a->B < 1 || a->UB < 1
                     || (long long)a->A * a->UA != (long long)a->B * a->UB)))
        return (int)cudaErrorInvalidConfiguration;
    const size_t tables = (size_t)(a->A + a->UA + (row ? 0 : a->B + a->UB))
                          * 2 * sizeof(long long);
    // the store pass's tables follow the load pass's in row mode too (the
    // kernel's pointers), but are empty there
    const size_t smem = tables + (row ? 0 : (size_t)a->smem_units * unit);
    if (smem > SMEM_MAX)
        return (int)cudaErrorInvalidConfiguration;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (unit * 2 + (row ? 1 : 0)) {
    case 4: return launch<2, false>(*a, in0, in1, out0, out1, ncomp, smem, s);
    case 5: return launch<2, true>(*a, in0, in1, out0, out1, ncomp, smem, s);
    case 8: return launch<4, false>(*a, in0, in1, out0, out1, ncomp, smem, s);
    case 9: return launch<4, true>(*a, in0, in1, out0, out1, ncomp, smem, s);
    case 16: return launch<8, false>(*a, in0, in1, out0, out1, ncomp, smem, s);
    case 17: return launch<8, true>(*a, in0, in1, out0, out1, ncomp, smem, s);
    case 32: return launch<16, false>(*a, in0, in1, out0, out1, ncomp, smem, s);
    case 33: return launch<16, true>(*a, in0, in1, out0, out1, ncomp, smem, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

// the launches that ran on the card (g_runs)
extern "C" int permute_runs(unsigned long long* out)
{
    return (int)cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs));
}
