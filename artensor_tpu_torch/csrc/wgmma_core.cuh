// Split-complex product on Hopper's warpgroup tensor-core instruction
// (wgmma) at float32 accuracy (3xTF32), under the pair kernel (pair.cu)
// and the GK kernel's "mma" form (gatherk.cu).  GGK's mma form and the
// complex matmul keep tc_core.cuh's mma.sync product.
//
// Computes, per slice instance w,
//   Y[m, n] = sum_k X[m, k] . V[n, k]        (complex, split re/im planes)
// with X in wgmma's A role (registers) and V in its B role (shared memory):
//   * Pair (GATHER false): X^T . V with X stored (K, M) and V (K, N), both
//     row-major (m and n contiguous), Y (M, N) row-major;
//   * GK (GATHER true): Y = W . X per outer index, transposed so that the
//     big side is M: m runs over the flat (outer index o, f) values, M =
//     G * F, X[m, k] at xoff[o] + koff[k] + f; V is W, (H, K) rows (k
//     contiguous), N = H; Y[m, n] at yoff[o] + f + n * ldy (ldy: hstride).
// A width stride of 0 reads a slice-invariant operand once for every
// instance.  Ragged M, N and K are zero-filled on load and masked on store.
//
// Why this shape.  TF32 wgmma takes both shared-memory operands K-major
// and cannot transpose them, and neither operand here is K-major in
// memory (X is m-contiguous; Pair's V is n-contiguous).  The register
// form (A in registers) ends half of that: each thread loads its A
// fragment from a raw [k][m] tile and splits it into hi and lo there.  V
// goes through one pass per K chunk that reads the raw tile ([k][n] for
// Pair, [n][k] for GK) and writes hi and lo planes in the K-major
// core-matrix layout the descriptors name (no swizzle: 8 rows of 16 bytes
// a core matrix, the two k halves of a k8 slice 128 bytes apart, the
// 8-row groups 256 bytes apart).  The 3xTF32 split needs that pass anyway.
//
// Arithmetic (tc_core.cuh's): x = hi + lo, hi = tf32(x), lo = tf32(x -
// hi); a complex product per k8 slice is 12 wgmma (6 into re, 6 into im:
// lo.hi, hi.lo, hi.hi; re -= Ai.Bi through the instruction's negation of
// A, imm-scale-a -1, which is exact), or 4 in the one-pass form (PASSES 1,
// precision "default": hi.hi, hi the operand with its low 13 mantissa bits
// cleared).  The sums inside the tensor cores do not round to nearest
// (tc_core.cuh: all of K 1024 added inside them came out 12x as far from
// float64 as cuBLAS).  So every PROMOTE k8 slices a window starts a fresh
// tensor-core accumulator (scale-d 0), and at its end the warpgroup waits
// for its wgmma and adds that accumulator into float32 registers (round to
// nearest); meanwhile the other warpgroup's wgmma keep the tensor cores
// busy.  The 3xTF32 form promotes after every slice (PROMOTE_3XTF32,
// below); the one-pass form, TF32 class anyway, takes a chunk's four
// slices a window.  (Two sets of
// tensor-core accumulators, a window queued before the last one drains,
// ran slower on the card: ptxas serialises wgmma whose accumulators other
// instructions read while a group is in flight.)
//
// Kernel shape.  A block is three warpgroups, one block an SM
// (__launch_bounds__(384, 1)): a producer and two consumers of 64 output
// rows each (a 128 x BN tile, BN 64, or 32 for narrow N).  The producer
// gives registers back (setmaxnreg.dec 40); it walks K in chunks of BK =
// 32, copying each chunk's raw X and V into a ring of STAGES (3-4)
// shared-memory stages by cp.async, STAGES - 2 chunks ahead, and splits
// V into the hi/lo planes of one of two plane buffers.  The consumers take
// registers (setmaxnreg.inc 232) for two sets of (re, im) accumulators,
// the tensor cores' and the float32 ones, declared inside their branch so
// that ptxas allocates them there; they read the A fragments from the raw
// stage (the next k8 slice's while a slice's wgmma run), issue the wgmma
// and promote.  Chunks are handed over on mbarriers: "full" (the
// producer's 128 threads arrive once a chunk's copies have landed and its
// planes are written) and "empty" (the consumers' 256 threads arrive once
// its wgmma have completed).  The grid is persistent (walking tiles
// blockIdx.x, + gridDim.x, ...; tile_at orders them), and the chunks of a
// block's tiles are one sequence through the ring, so the next tile's
// first chunks load while the last one finishes.  Against the earlier
// shape, two warpgroups sharing the copies and the split between their
// products (256 threads, two barriers a chunk), this one was 16-19% faster
// at the 1k and 10k Pair steps, with the same output
// (scripts/wgmma_ws_torch_port.cu, PERF.md).
//
// The ring copies 16 bytes a cp.async where every row and offset lies on
// a 4-float grid and the buffers on 16 bytes (VEC: Pair, M and N multiples
// of 4; GK, gatherk.gk_aligned; V's rows apart, Operands::vec_v), else 4
// bytes a cp.async, as gatherk.cu's stream form does.
//
// Under CUDA-graph capture (runtime/executor.GroupRunner) a launch's
// arguments, pointers included, are baked into the graph; that is right
// because the runner's buffers are static.  The shared-memory attribute is
// set once per kernel and device, on its first (eager) launch: the warm-up
// group runs before any capture.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_core.cuh"

namespace wg {

// k8 slices a promotion window in the 3xTF32 form.  1, from the error
// against float64 on an H100 (scripts/wgmma_promote_torch_port.py,
// PERF.md): at 1 the 1k and 10k Pair steps and the 1k GK step are
// 0.43-0.60x the plain version's; at 2 the GK step is 1.05x, at 4 2.04x,
// and longer windows ran slower (two slices' A fragments live in flight).
constexpr int PROMOTE_3XTF32 = 1;
// the one-pass form's window: a whole chunk's four slices
template <int PASSES>
constexpr int PROMOTE = PASSES == 3 ? PROMOTE_3XTF32 : 4;

struct Operands {
    const float *xr, *xi;   // A role: Pair's X (K, M); GK's X
    const float *vr, *vi;   // B role: Pair's V (K, N); GK's W (H, K)
    float *yr, *yi;
    int M, N, K;
    long long x_ws, v_ws, y_ws;   // slice-width strides (0: invariant)
    long long ldy;                // GK: Y's stride between columns n
    const long long *koff, *xoff, *yoff;   // GK's tables
    int F;                        // GK: f run length
    bool vec_v;                   // V's rows and buffers on 16 bytes
    int n_mtiles, n_ntiles, n_kchunks;
    long long n_tiles;            // W * n_ntiles * n_mtiles
};

template <bool GATHER, int BN_, int PASSES>
struct Cfg {
    static constexpr int BM = 128, BN = BN_, BK = 32;
    static constexpr int THREADS = 384;         // three warpgroups
    static constexpr int PRODUCER = 128;        // the first of them
    static constexpr int LDA = BM + 8;          // raw X rows [k][m]: 8 mod 32
    static constexpr int B_ROWS = GATHER ? BN : BK;
    static constexpr int LDB = GATHER ? BK + 4 : BN + 8;   // [n][k] / [k][n]
    static constexpr int A_PART = BK * LDA, B_PART = B_ROWS * LDB;
    static constexpr int STAGE = 2 * A_PART + 2 * B_PART;  // floats
    static constexpr int NPLANES = PASSES == 3 ? 4 : 2;    // re/im hi (lo)
    static constexpr int PLANE = BK * BN;                  // floats
    static constexpr int PLANES = NPLANES * PLANE;         // one buffer
    static constexpr int CAP = 232448;          // the H100's block maximum
    static constexpr int BARS = 64;             // bytes: the mbarriers
    static constexpr int FIXED = 2 * PLANES * 4 + BARS;
    static constexpr int STAGES_FIT = (CAP - FIXED) / (STAGE * 4);
    static constexpr int STAGES = STAGES_FIT > 4 ? 4 : STAGES_FIT;
    static constexpr int AHEAD = STAGES - 2;    // chunks copied ahead
    static constexpr int SMEM = FIXED + STAGES * STAGE * 4;
    static_assert(STAGES >= 3, "shared memory");
    static_assert(BN == 32 || BN == 64, "BN");
};

// -- PTX ----------------------------------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

// the producer warpgroup's 128 threads (named barrier 1, beside
// __syncthreads' 0)
__device__ __forceinline__ void producer_sync()
{
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(saddr(b)), "r"(count) : "memory");
}

// release: the thread's earlier writes (and, after cp.async.wait_group,
// the copies it waited for) are seen by whoever waits for the phase
__device__ __forceinline__ void mbar_arrive(uint64_t* b)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(saddr(b)) : "memory");
}

// wait until phase ``parity`` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity)
{
    asm volatile(
        "{\n.reg .pred p;\nLAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n"
        :: "r"(saddr(b)), "r"(parity) : "memory");
}

__device__ __forceinline__ void wg_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups of the warpgroup are pending
template <int N>
__device__ __forceinline__ void wg_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N)
                 : "memory");
}

// keep the compiler from moving reads or writes of ``r`` across a wgmma
// fence or wait
template <int N>
__device__ __forceinline__ void pin(float* r)
{
#pragma unroll
    for (int i = 0; i < N; ++i)
        asm volatile("" : "+f"(r[i]) :: "memory");
}

// descriptor of a K-major, unswizzled operand: 8-row core matrices of 16 B
// rows, the two k halves LBO = 128 B apart, 8-row groups SBO = 256 B apart
__device__ __forceinline__ uint64_t desc(const float* p)
{
    return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16)
           | ((uint64_t)(256 >> 4) << 32);
}

#define WG_D8(i) "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])

// d (+)= SA A . B for a 64 x BN x 8 tile: A's fragment in ``a`` (SA -1
// negates it, exactly), B at descriptor ``b``; ``acc`` 0 starts the
// accumulator afresh (scale-d)
template <int BN, int SA>
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b,
                                    int acc)
{
    static_assert(SA == 1 || SA == -1, "imm-scale-a");
    static_assert(BN == 32 || BN == 64, "BN");
    if constexpr (BN == 32) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
            "%14, %15"
            "}, {%16, %17, %18, %19}, %20, p, %22, 1;\n}\n"
            : WG_D8(0), WG_D8(8)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
              "n"(SA));
    } else if constexpr (BN == 64) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
            "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
            "%26, %27, %28, %29, %30, %31"
            "}, {%32, %33, %34, %35}, %36, p, %38, 1;\n}\n"
            : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
              "n"(SA));
    }
}
#undef WG_D8

// -- the block ----------------------------------------------------------------

struct TileAt {
    long long w;
    int m0, n0;
};

// Tile t: Pair runs the M tiles of one N tile next to each other; GK the
// N tiles (H) of one M tile, which read the same X rows (from L2 for all
// but the first), W being small
template <bool GATHER>
__device__ __forceinline__ TileAt tile_at(const Operands& p, long long t,
                                          int BM, int BN)
{
    const long long per_w = (long long)p.n_mtiles * p.n_ntiles;
    const long long r = t % per_w;
    const int fast = GATHER ? p.n_ntiles : p.n_mtiles;
    const int mt = (int)(GATHER ? r / fast : r % fast);
    const int nt = (int)(GATHER ? r % fast : r / fast);
    return TileAt{t / per_w, mt * BM, nt * BN};
}

// Copy chunk ``kc`` of tile ``at`` (X rows k0 .. k0 + BK of the tile's
// BM m values, V's BK x BN values) into ``stage``, 16 bytes a cp.async
// (X: VEC; V: p.vec_v), else 4; each of the producer's threads (``tid``)
// copies its share.  Rows and columns past M, N and K read as zeros.
template <bool GATHER, int BN, int PASSES, bool VEC>
__device__ __forceinline__ void load(const Operands& p, const TileAt& at,
                                     int kc, float* stage, int tid)
{
    using C = Cfg<GATHER, BN, PASSES>;
    constexpr int BM = C::BM, BK = C::BK, LDA = C::LDA, LDB = C::LDB;
    constexpr int T = C::PRODUCER;
    const float* xr = p.xr + at.w * p.x_ws;
    const float* xi = p.xi + at.w * p.x_ws;
    const float* vr = p.vr + at.w * p.v_ws;
    const float* vi = p.vi + at.w * p.v_ws;
    const int k0 = kc * BK;
    // X: a fixed 4-float column chunk ac of rows ar0 + RA q
    constexpr int A_CH = BM / 4, RA = T / A_CH;
    const int ac = tid % A_CH, ar0 = tid / A_CH;
    const int m = at.m0 + 4 * ac;
    if constexpr (VEC) {
        const bool m_ok = m < p.M;   // M % 4 == 0: a chunk is whole or out
        const long long xcol = !m_ok ? 0
            : GATHER ? p.xoff[m / p.F] + m % p.F : (long long)m;
#pragma unroll
        for (int q = 0; q < BK / RA; ++q) {
            const int r = ar0 + RA * q, k = k0 + r;
            const bool ok = m_ok && k < p.K;
            const long long off = !ok ? 0
                : (GATHER ? p.koff[k] : (long long)k * p.M) + xcol;
            float* d = stage + r * LDA + 4 * ac;
            tc::cp16(d, xr + off, ok ? 16 : 0);
            tc::cp16(d + C::A_PART, xi + off, ok ? 16 : 0);
        }
    } else {   // each of the 4 m values on its own (GK: maybe two outer
               // indices)
        long long xcol[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            xcol[e] = m + e >= p.M ? -1
                : GATHER ? p.xoff[(m + e) / p.F] + (m + e) % p.F
                         : (long long)(m + e);
#pragma unroll
        for (int q = 0; q < BK / RA; ++q) {
            const int r = ar0 + RA * q, k = k0 + r;
            const long long row = k >= p.K ? 0
                : GATHER ? p.koff[k] : (long long)k * p.M;
            float* d = stage + r * LDA + 4 * ac;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool ok = k < p.K && xcol[e] >= 0;
                const long long off = ok ? row + xcol[e] : 0;
                tc::cp4(d + e, xr + off, ok ? 4 : 0);
                tc::cp4(d + C::A_PART + e, xi + off, ok ? 4 : 0);
            }
        }
    }
    // V: Pair, a column chunk bc of rows [k] br0 + RB q; GK, a k chunk bc
    // of rows [n] br0 + RB q
    constexpr int B_CH = GATHER ? BK / 4 : BN / 4, RB = T / B_CH;
    constexpr int B_ITERS = (GATHER ? BN : BK) / RB;
    static_assert(B_ITERS >= 1 && (GATHER ? BN : BK) % RB == 0, "V tile");
    const int bc = tid % B_CH, br0 = tid / B_CH;
    float* sb = stage + 2 * C::A_PART;
#pragma unroll
    for (int q = 0; q < B_ITERS; ++q) {
        const int r = br0 + RB * q;
        // Pair: row k = k0 + r, columns n0 + 4 bc; GK: row n = n0 + r,
        // k = k0 + 4 bc; the 4 values along the row, ``lim`` of them in
        // range (with vec_v: 4 or 0, K % 4 == 0 for GK, N % 4 for Pair)
        const int k = GATHER ? k0 + 4 * bc : k0 + r;
        const int n = GATHER ? at.n0 + r : at.n0 + 4 * bc;
        const bool ok = k < p.K && n < p.N;
        const int lim = !ok ? 0 : GATHER ? p.K - k : p.N - n;
        const long long off = !ok ? 0
            : GATHER ? (long long)n * p.K + k : (long long)k * p.N + n;
        float* d = sb + r * LDB + 4 * bc;
        tc::copy4(d, vr + off, lim, p.vec_v, vr);
        tc::copy4(d + C::B_PART, vi + off, lim, p.vec_v, vi);
    }
}

// the tile of the block's ``q``-th tile slot, and its first chunk's item
template <bool GATHER>
__device__ __forceinline__ TileAt my_tile(const Operands& p, long long q,
                                          int BM, int BN)
{
    return tile_at<GATHER>(p, blockIdx.x + q * gridDim.x, BM, BN);
}

// Split chunk ``item``'s raw V (stage s) into the hi (and lo) planes of
// buffer ``pl``: plane order re hi, im hi, re lo, im lo; element (n, k) of
// k8 slice j at j*BN*8 + (n/8)*64 + ((k%8)/4)*32 + (n%8)*4 + k%4 floats.
template <bool GATHER, int BN, int PASSES>
__device__ __forceinline__ void split_v(const float* sb, float* pl, int ct)
{
    using C = Cfg<GATHER, BN, PASSES>;
    constexpr int BK = C::BK, LDB = C::LDB, PLANE = C::PLANE;
    constexpr int T = C::PRODUCER;
    constexpr int TASKS = BN * BK / 4;    // (n, 4 k) chunks, re and im each
    static_assert(TASKS % T == 0, "split tasks");
#pragma unroll
    for (int q = 0; q < TASKS / T; ++q) {
        const int id = ct + T * q;
        const int n = id % BN, k = 4 * (id / BN);
        float r[4], i[4];
        if (GATHER) {    // raw [n][k]
            const float4 a = *reinterpret_cast<const float4*>(sb + n * LDB + k);
            const float4 b = *reinterpret_cast<const float4*>(
                sb + C::B_PART + n * LDB + k);
            r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
            i[0] = b.x; i[1] = b.y; i[2] = b.z; i[3] = b.w;
        } else {         // raw [k][n]
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                r[e] = sb[(k + e) * LDB + n];
                i[e] = sb[C::B_PART + (k + e) * LDB + n];
            }
        }
        uint32_t rh[4], rl[4], ih[4], il[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            tc::split<PASSES>(r[e], rh[e], rl[e]);
            tc::split<PASSES>(i[e], ih[e], il[e]);
        }
        const int off = (k / 8) * BN * 8 + (n / 8) * 64 + ((k % 8) / 4) * 32
                        + (n % 8) * 4;
        *reinterpret_cast<uint4*>(pl + off) = make_uint4(rh[0], rh[1], rh[2],
                                                         rh[3]);
        *reinterpret_cast<uint4*>(pl + PLANE + off) =
            make_uint4(ih[0], ih[1], ih[2], ih[3]);
        if (PASSES == 3) {
            *reinterpret_cast<uint4*>(pl + 2 * PLANE + off) =
                make_uint4(rl[0], rl[1], rl[2], rl[3]);
            *reinterpret_cast<uint4*>(pl + 3 * PLANE + off) =
                make_uint4(il[0], il[1], il[2], il[3]);
        }
    }
    // the planes are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <bool GATHER, int BN, bool VEC>
__device__ __forceinline__ void store(const Operands& p, const TileAt& at,
                                      int row0, const float* ar,
                                      const float* ai, int g, int t)
{
    float* yr = p.yr + at.w * p.y_ws;
    float* yi = p.yi + at.w * p.y_ws;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int m = at.m0 + row0 + g + 8 * h;
        if (m >= p.M)
            continue;
        const long long base = GATHER
            ? p.yoff[m / p.F] + m % p.F : (long long)m * p.N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int n = at.n0 + 8 * j + 2 * t;
            if (n >= p.N)
                continue;
            const float* vr = ar + 4 * j + 2 * h;
            const float* vi = ai + 4 * j + 2 * h;
            if (GATHER || !VEC) {
                const long long ldy = GATHER ? p.ldy : 1;
                yr[base + n * ldy] = vr[0];
                yi[base + n * ldy] = vi[0];
                if (n + 1 < p.N) {
                    yr[base + (n + 1) * ldy] = vr[1];
                    yi[base + (n + 1) * ldy] = vi[1];
                }
            } else {   // N % 4 == 0: n + 1 < N too
                *reinterpret_cast<float2*>(yr + base + n) =
                    make_float2(vr[0], vr[1]);
                *reinterpret_cast<float2*>(yi + base + n) =
                    make_float2(vi[0], vi[1]);
            }
        }
    }
}

// The producer warpgroup: item j (chunk j % nks of the block's tile slot
// j / nks) copied into raw stage j % STAGES, AHEAD items before it is
// split into plane buffer j % 2.  Item j - 2, the last user of both that
// buffer and raw stage (j + AHEAD) % STAGES, must be done first.
template <bool GATHER, int BN, int PASSES, bool VEC>
__device__ __forceinline__ void producer(const Operands& p, float* planes,
                                         float* raw, uint64_t* full,
                                         uint64_t* empty, int total)
{
    using C = Cfg<GATHER, BN, PASSES>;
    const int tid = threadIdx.x;          // 0 .. 127
    const int nks = p.n_kchunks;
    int kc = 0;
    long long q = 0;
    TileAt at = my_tile<GATHER>(p, 0, C::BM, BN);
    auto copy_next = [&](int i) {         // item i, the items in order
        if (i < total) {
            load<GATHER, BN, PASSES, VEC>(
                p, at, kc, raw + (i % C::STAGES) * C::STAGE, tid);
            if (++kc == nks) {
                kc = 0;
                at = my_tile<GATHER>(p, ++q, C::BM, BN);
            }
        }
        tc::cp_commit();
    };
#pragma unroll
    for (int i = 0; i < C::AHEAD; ++i)
        copy_next(i);
    for (int j = 0; j < total; ++j) {
        if (j >= 2)
            mbar_wait(&empty[j % 2], ((j - 2) / 2) & 1);
        copy_next(j + C::AHEAD);
        tc::cp_wait<C::AHEAD>();          // item j's copies, this thread's
        producer_sync();                  // and the other producers'
        split_v<GATHER, BN, PASSES>(
            raw + (j % C::STAGES) * C::STAGE + 2 * C::A_PART,
            planes + (j % 2) * C::PLANES, tid);
        mbar_arrive(&full[j % 2]);
    }
    tc::cp_wait<0>();
}

// A consumer warpgroup (``wgc`` 0 or 1: output rows 64 wgc ..): per item,
// per k8 slice, the A fragment from the raw stage, 12 wgmma (4 in one
// pass) into the tensor-core accumulators d, and at a window's end d added
// into the float32 accumulators acc; a tile's last item stores acc.
template <bool GATHER, int BN, int PASSES, bool VEC>
__device__ __forceinline__ void consumer(const Operands& p,
                                         const float* planes,
                                         const float* raw, uint64_t* full,
                                         uint64_t* empty, int total)
{
    using C = Cfg<GATHER, BN, PASSES>;
    constexpr int BK = C::BK, LDA = C::LDA, PLANE = C::PLANE, NR = BN / 2;
    constexpr int P = PROMOTE<PASSES>;
    // A fragment slots: two at a window of one slice (a slice's wgmma
    // read one while the next slice's is written), else one a slice of
    // the chunk (a window's slices run without a wait between them)
    constexpr int FR = P == 1 ? 2 : BK / 8;
    const int lt = threadIdx.x % 128, wgc = threadIdx.x / 128 - 1;
    const int warp = lt / 32, lane = lt % 32, g = lane / 4, t = lane % 4;
    const int row0 = 64 * wgc + 16 * warp;    // the warp's 16 rows of 128
    const int nks = p.n_kchunks;
    const int nk8_all = (p.K + 7) / 8;
    float acc_r[NR], acc_i[NR], d_r[NR], d_i[NR];
#pragma unroll
    for (int e = 0; e < NR; ++e) {
        acc_r[e] = 0.f; acc_i[e] = 0.f; d_r[e] = 0.f; d_i[e] = 0.f;
    }
    uint32_t ar_h[FR][4], ar_l[FR][4], ai_h[FR][4], ai_l[FR][4];
    // slice j's fragment (rows row0 + g (+8), columns t (+4)) into slot f
    auto frag = [&](const float* sa, int j, int f) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int a = (8 * j + t + 4 * (c >> 1)) * LDA + row0 + g
                          + 8 * (c & 1);
            tc::split<PASSES>(sa[a], ar_h[f][c], ar_l[f][c]);
            tc::split<PASSES>(sa[C::A_PART + a], ai_h[f][c], ai_l[f][c]);
        }
    };
    int kc = -1;                 // the item's chunk within its tile
    long long tile_q = 0;        // its tile slot
    for (int it = 0; it < total; ++it) {
        if (++kc == nks) {
            kc = 0;
            ++tile_q;
        }
        mbar_wait(&full[it % 2], (it / 2) & 1);
        const float* sa = raw + (it % C::STAGES) * C::STAGE;
        const float* pl = planes + (it % 2) * C::PLANES;
        const int nk8 = min(BK / 8, nk8_all - kc * (BK / 8));
        frag(sa, 0, 0);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
            if (j >= nk8)
                break;
            const int f = j % FR;
            const int kk = kc * (BK / 8) + j;     // k8 slice of the tile
            const int go = kk % P ? 1 : 0;        // 0: a fresh window
            const float* b = pl + j * BN * 8;
            const uint64_t brh = desc(b), bih = desc(b + PLANE);
            wg_fence();
            pin<NR>(d_r);
            pin<NR>(d_i);
            if (PASSES == 3) {
                const uint64_t brl = desc(b + 2 * PLANE);
                const uint64_t bil = desc(b + 3 * PLANE);
                // small terms first: lo.hi, hi.lo, then hi.hi; re
                // subtracts Ai.Bi through imm-scale-a -1
                mma<BN, 1>(d_r, ar_l[f], brh, go);
                mma<BN, 1>(d_i, ar_l[f], bih, go);
                mma<BN, -1>(d_r, ai_l[f], bih, 1);
                mma<BN, 1>(d_i, ai_l[f], brh, 1);
                mma<BN, 1>(d_r, ar_h[f], brl, 1);
                mma<BN, 1>(d_i, ar_h[f], bil, 1);
                mma<BN, -1>(d_r, ai_h[f], bil, 1);
                mma<BN, 1>(d_i, ai_h[f], brl, 1);
                mma<BN, 1>(d_r, ar_h[f], brh, 1);
                mma<BN, 1>(d_i, ar_h[f], bih, 1);
                mma<BN, -1>(d_r, ai_h[f], bih, 1);
                mma<BN, 1>(d_i, ai_h[f], brh, 1);
            } else {
                mma<BN, 1>(d_r, ar_h[f], brh, go);
                mma<BN, 1>(d_i, ar_h[f], bih, go);
                mma<BN, -1>(d_r, ai_h[f], bih, 1);
                mma<BN, 1>(d_i, ai_h[f], brh, 1);
            }
            wg_commit();
            if (j + 1 < nk8)
                frag(sa, j + 1, (j + 1) % FR);
            if (kk % P == P - 1 || kk == nk8_all - 1) {
                // the window is done: into float32
                wg_wait<0>();
                pin<NR>(d_r);
                pin<NR>(d_i);
#pragma unroll
                for (int e = 0; e < NR; ++e) {
                    acc_r[e] += d_r[e];
                    acc_i[e] += d_i[e];
                }
            }
        }
        wg_wait<0>();
        pin<NR>(d_r);
        pin<NR>(d_i);
        mbar_arrive(&empty[it % 2]);
        if (kc == nks - 1) {
            store<GATHER, BN, VEC>(p, my_tile<GATHER>(p, tile_q, C::BM, BN),
                                   row0, acc_r, acc_i, g, t);
#pragma unroll
            for (int e = 0; e < NR; ++e) {
                acc_r[e] = 0.f;
                acc_i[e] = 0.f;
            }
        }
    }
}

// One block's work: its tiles blockIdx.x, + gridDim.x, ..., each in
// chunks of BK, the chunks of all its tiles one sequence of items through
// the ring.  Each user calls it from a __global__ kernel of its own
// (pair.cu's pair_wgmma_kernel, gatherk.cu's gk_wgmma_kernel), with
// __launch_bounds__(384, 1): the kernel is compiled at 168 registers a
// thread, which the producer lowers to 40 and the consumers raise to 232
// (128 x 40 + 256 x 232 registers fit an SM's 65536).
template <bool GATHER, int BN, int PASSES, bool VEC>
__device__ __forceinline__ void gemm(const Operands& p)
{
    using C = Cfg<GATHER, BN, PASSES>;
    extern __shared__ __align__(128) float smem[];
    float* planes = smem;                        // 2 buffers
    float* raw = smem + 2 * C::PLANES;           // STAGES stages
    uint64_t* bars = reinterpret_cast<uint64_t*>(raw + C::STAGES * C::STAGE);
    uint64_t* full = bars;                       // 2, by plane buffer
    uint64_t* empty = bars + 2;                  // 2
    if (threadIdx.x == 0) {
        mbar_init(&full[0], C::PRODUCER);
        mbar_init(&full[1], C::PRODUCER);
        mbar_init(&empty[0], C::THREADS - C::PRODUCER);
        mbar_init(&empty[1], C::THREADS - C::PRODUCER);
    }
    __syncthreads();
    // items: chunk i % nks of the block's tile slot i / nks (fewer than
    // 2^31 a block: the launch checks)
    const int total = (int)((p.n_tiles - blockIdx.x + gridDim.x - 1)
                            / gridDim.x) * p.n_kchunks;
    if (threadIdx.x < C::PRODUCER) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        producer<GATHER, BN, PASSES, VEC>(p, planes, raw, full, empty, total);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        consumer<GATHER, BN, PASSES, VEC>(p, planes, raw, full, empty,
                                          total);
    }
}

// Launch ``kern`` (a kernel running gemm<GATHER, BN, PASSES, VEC>) over an
// M x N product at slice width W: one block an SM, at most one a tile.
// The shared-memory attribute is set per instantiation (one kernel each).
template <bool GATHER, int BN, int PASSES, bool VEC>
int launch(void (*kern)(Operands), Operands p, int W, cudaStream_t stream)
{
    using C = Cfg<GATHER, BN, PASSES>;
    static unsigned attr = 0;    // devices whose attribute is set (bit)
    if (p.K < 1 || p.M < 1 || p.N < 1 || W <= 0 || W > 65535)
        return (int)cudaErrorInvalidConfiguration;
    p.n_mtiles = (p.M + C::BM - 1) / C::BM;
    p.n_ntiles = (p.N + BN - 1) / BN;
    p.n_kchunks = (p.K + C::BK - 1) / C::BK;
    p.n_tiles = (long long)W * p.n_mtiles * p.n_ntiles;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && dev < 32 && !(attr >> dev & 1u)) {
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
        if (e == cudaSuccess)
            attr |= 1u << dev;
    }
    if (e != cudaSuccess)
        return (int)e;
    const long long grid = p.n_tiles < sms ? p.n_tiles : sms;
    if ((p.n_tiles + grid - 1) / grid * p.n_kchunks > 0x7fffffffLL)
        return (int)cudaErrorInvalidConfiguration;
    kern<<<(unsigned)grid, C::THREADS, C::SMEM, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace wg
