// Split-complex product on Hopper's warpgroup tensor-core instruction
// (wgmma) at float32 accuracy (3xTF32): the port's one tensor-core core,
// under the pair kernel and the complex matmul (pair.cu) and the "mma"
// form of the GK and GGK kernels (gatherk.cu).
//
// Computes, per slice instance w,
//   Y[m, n] = sum_k X[m, k] . V[n, k]        (complex, split re/im planes)
// with X in wgmma's A role (registers) and V in its B role (shared memory):
//   * Pair (GATHER false): X^T . V with X stored (K, M) and V (K, N), both
//     row-major (m and n contiguous), Y (M, N) row-major;
//   * the complex matmul (GATHER false, A_MK): as Pair with X stored
//     (M, K), k contiguous; its batch is the width axis.  Its role swap
//     (SWAP, for M below the 128-row tile and N above it) computes
//     Y^T = B^T . A^T: X is B stored (K, N), read as Pair's X, V is A
//     stored (M, K), read as GK's W ([n][k] rows), and Y^T[m, n] lies at
//     m + n * ldy;
//   * GK (GATHER true): Y = W . X per outer index, transposed so that the
//     big side is M: m runs over the flat (outer index o, f) values, M =
//     G * F, X[m, k] at xoff[o] + koff[k] + f; V is W, (H, K) rows (k
//     contiguous), N = H; Y[m, n] at yoff[o] + f + n * ldy (ldy: hstride).
//     GGK (woff set) reads the W rows of outer index o at woff[o]: F is a
//     multiple of the 128-row M tile, so that a tile lies in one outer
//     index and its producer reads one W row set.
// A width stride of 0 reads a slice-invariant operand once for every
// instance.  Ragged M, N and K are zero-filled on load and masked on store.
//
// Why this shape.  TF32 wgmma takes both shared-memory operands K-major
// and cannot transpose them, and X and Pair's V are not K-major in memory
// (X is m-contiguous; Pair's V is n-contiguous).  The register form (A in
// registers) ends half of that: each thread loads its A fragment from a
// raw [k][m] tile ([m][k] for A_MK) and splits it into hi and lo there.
// V goes through one pass per K chunk that reads the raw tile ([k][n] for
// Pair and the complex matmul, [n][k] for GK) and writes hi and lo planes
// in the K-major core-matrix layout the descriptors name (no swizzle: 8
// rows of 16 bytes a core matrix, the two k halves of a k8 slice 128 bytes
// apart, the 8-row groups 256 bytes apart).  The 3xTF32 split needs that
// pass anyway.
//
// Arithmetic (tc_core.cuh's split): x = hi + lo, hi = tf32(x), lo =
// tf32(x - hi); a complex product per k8 slice is 12 wgmma (6 into re, 6
// into im: lo.hi, hi.lo, hi.hi, the lo.lo term below 2^-22 of |a||b|
// dropped; re -= Ai.Bi through the instruction's negation of A,
// imm-scale-a -1, which is exact), or 4 in the one-pass form (PASSES 1,
// precision "default": hi.hi, hi the operand with its low 13 mantissa
// bits cleared).  The complex matmul's short products (K below 16, where
// a sum of few terms does not hide 3xTF32's 22-bit operands) run the
// three-term split (PASSES 6: x = hi + mid + lo, tc_core.cuh's split3; per
// real product lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi, 24 wgmma a k8
// slice, the terms below 2^-33 of |a||b| dropped).  The sums inside the
// tensor cores do not round to
// nearest: with all of K 1024 added inside them the pair step came out
// 12x as far from float64 as cuBLAS's float32 product (H100).  So every
// PROMOTE k8 slices a window starts a fresh tensor-core accumulator
// (scale-d 0), and at its end the warpgroup waits for its wgmma and adds
// that accumulator into float32 registers (round to nearest); meanwhile
// the other warpgroup's wgmma keep the tensor cores busy.  The 3xTF32
// form promotes after every slice (PROMOTE_3XTF32, below); the one-pass
// form, TF32 class anyway, takes four slices a window.  (Two sets of
// tensor-core accumulators, a window queued before the last one drains,
// ran slower on the card: ptxas serialises wgmma whose accumulators other
// instructions read while a group is in flight.)
//
// Kernel shape.  A block is three warpgroups, one block an SM
// (__launch_bounds__(384, 1)): a producer and two consumers of 64 output
// rows each (a 128 x BN tile; BN 64, 32 or 16, the N side's width).  The
// producer gives registers back (setmaxnreg.dec 40); it walks K in chunks
// of BK (32, or 16 for GGK steps of K <= 16, which a 32-deep chunk would
// leave half empty), copying each chunk's raw X and V into a ring of
// STAGES (3-4) shared-memory stages by cp.async, STAGES - 2 chunks ahead,
// and splits V into the hi/lo planes of one of two plane buffers.  The
// consumers take registers (setmaxnreg.inc 232) for two sets of (re, im)
// accumulators, the tensor cores' and the float32 ones, declared inside
// their branch so that ptxas allocates them there; they read the A
// fragments from the raw stage (the next k8 slice's while a slice's wgmma
// run), issue the wgmma and promote.  Chunks are handed over on
// mbarriers: "full" (the producer's 128 threads arrive once a chunk's
// copies have landed and its planes are written) and "empty" (the
// consumers' 256 threads arrive once its wgmma have completed).  The grid
// is persistent (walking tiles blockIdx.x, + gridDim.x, ...; Tiles
// orders them), and the chunks of a block's tiles are one sequence
// through the ring, so the next tile's first chunks load while the last
// one finishes and its outputs are stored.  GGK's 1k step (K 16 H 16, X
// slice-invariant) is one chunk a tile: there a block takes a run of
// tiles, the slice instance fastest, and copies an M tile's X, and its
// consumers read and split their A fragments, once for all its slice
// instances (REUSE_X); its outputs go out through shared memory in 16-byte
// stores (STAGE_Y).  Against the earlier shape, two
// warpgroups sharing the copies and the split between their products (256
// threads, two barriers a chunk), this one was 16-19% faster at the 1k
// and 10k Pair steps, with the same output (scripts/wgmma_ws_torch_port.cu,
// PERF.md).
//
// The ring copies 16 bytes a cp.async where every row and offset lies on
// a 4-float grid and the buffers on 16 bytes (VEC: Pair, M and N multiples
// of 4; the complex matmul, K and N; GK and GGK, gatherk.gk_aligned; V's
// rows apart, Operands::vec_v), else 4 bytes a cp.async.
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
// the one-pass form's window: four slices
template <int PASSES>
constexpr int PROMOTE = PASSES == 1 ? 4 : PROMOTE_3XTF32;

struct Operands {
    const float *xr, *xi;   // A role: Pair's X (K, M); the complex
                            // matmul's A (M, K); GK's X
    const float *vr, *vi;   // B role: Pair's V (K, N); GK's W (H, K)
    float *yr, *yi;
    int M, N, K;
    long long x_ws, v_ws, y_ws;   // slice-width strides (0: invariant)
    long long ldy;                // GK: Y's stride between columns n
    const long long *koff, *xoff, *yoff;   // GK's tables
    const long long* woff;        // GGK: W's rows of outer index o, or null
    int F;                        // GK: f run length
    bool vec_v;                   // V's rows and buffers on 16 bytes
    int n_mtiles, n_ntiles, n_kchunks;
    int W;                        // slice width
    long long n_tiles;            // W * n_ntiles * n_mtiles
};

// A kernel's compile-time shape: GATHER (GK, GGK) or not (Pair, the
// complex matmul, with A_MK, or its role swap, SWAP); the N tile BN; the K
// chunk BK; the passes; VEC, X's 16-byte copies (and Pair's 8-byte Y
// stores).
template <bool GATHER_, int BN_, int PASSES_, bool VEC_, int BK_ = 32,
          bool A_MK_ = false, bool SWAP_ = false>
struct Cfg {
    static constexpr bool GATHER = GATHER_, VEC = VEC_, A_MK = A_MK_;
    static constexpr bool SWAP = SWAP_;
    // V stored [n][k] (GK's W, the swap's A) rather than [k][n]; Y stored
    // through ldy, column n ldy apart (GK, the swap)
    static constexpr bool V_NK = GATHER || SWAP;
    static constexpr int BM = 128, BN = BN_, BK = BK_, PASSES = PASSES_;
    static constexpr int THREADS = 384;         // three warpgroups
    static constexpr int PRODUCER = 128;        // the first of them
    // raw X rows: [k][m] (8 mod 32 floats) or, A_MK, [m][k] (4 mod 32),
    // so that the consumers' fragment reads hit 32 distinct banks
    static constexpr int LDA = A_MK ? BK + 4 : BM + 8;
    static constexpr int A_ROWS = A_MK ? BM : BK;
    static constexpr int B_ROWS = V_NK ? BN : BK;
    static constexpr int LDB = V_NK ? BK + 4 : BN + 8;     // [n][k] / [k][n]
    static constexpr int A_PART = A_ROWS * LDA, B_PART = B_ROWS * LDB;
    static constexpr int STAGE = 2 * A_PART + 2 * B_PART;  // floats
    // The 16-wide N tile (GGK, H <= 16; the complex matmul, N <= 16)
    // multiplies re and im side by side:
    // its B planes are [Vr | Vi] and [-Vi | Vr], 32 wide, so that a complex
    // product is 2 wgmma of n32 (6 in 3xTF32) into one accumulator [re |
    // im], where 16-wide planes take 4 of n16 (12): an n16 wgmma costs the
    // tensor cores nearly what an n32 one does (2-3% on the 1k K 16 H 16
    // step, scripts/ggk_wgmma_torch_port.py; the same sums in the same
    // order, so the same result).
    static constexpr bool STACK = BN == 16;
    static constexpr int PW = STACK ? 2 * BN : BN;         // plane width
    static constexpr int NPLANES = 2 * (PASSES == 6 ? 3 : PASSES == 3 ? 2 : 1);
                                   // hi (lo; mid, lo) planes
    static constexpr int PLANE = BK * PW;                  // floats
    static constexpr int PLANES = NPLANES * PLANE;         // one buffer
    // The narrow N tile (GGK, H <= 16) stores a finished tile through
    // shared memory: each consumer warpgroup's 64 x 16 outputs as [n][m]
    // rows (64 + 4 floats: the fragment writes hit 32 banks), written out
    // along m in 16-byte stores (VEC), where its fragments would take a
    // thread 16 scattered 4-byte stores.
    static constexpr bool STAGE_Y = GATHER && VEC && BN == 16;
    static constexpr int LDY = 64 + 4;
    static constexpr int Y_PART = STAGE_Y ? BN * LDY : 0;  // a plane's
    static constexpr int Y_STAGE = 2 * 2 * Y_PART;         // floats: 2 warp-
                                                           // groups, re, im
    static constexpr int CAP = 232448;          // the H100's block maximum
    static constexpr int BARS = 64;             // bytes: the mbarriers
    static constexpr int FIXED = (2 * PLANES + Y_STAGE) * 4 + BARS;
    static constexpr int STAGES_FIT = (CAP - FIXED) / (STAGE * 4);
    static constexpr int STAGES = STAGES_FIT > 4 ? 4 : STAGES_FIT;
    static constexpr int AHEAD = STAGES - 2;    // chunks copied ahead
    static constexpr int SMEM = FIXED + STAGES * STAGE * 4;
    // A K chunk of 16 (GGK, K <= 16) is its tile's only chunk, and its two
    // k8 slices' A fragments fit the consumers' fragment slots: where X is
    // slice-invariant, a block walks the slice instances of one M tile in
    // turn, copying the tile's X and reading its fragments once (reuse).
    static constexpr bool REUSE_X = GATHER && BK == 16;
    static_assert(STAGES >= 3, "shared memory");
    static_assert(BN == 16 || BN == 32 || BN == 64, "BN");
    static_assert(BK == 16 || BK == 32, "BK");
    static_assert(PASSES == 1 || PASSES == 3 || PASSES == 6, "PASSES");
    static_assert(!(GATHER && A_MK), "A_MK is a form of the plain product");
    static_assert(!(SWAP && (GATHER || A_MK)), "SWAP reads X as Pair does");
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
    static_assert(BN == 16 || BN == 32 || BN == 64, "BN");
    if constexpr (BN == 16) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
            "{%0, %1, %2, %3, %4, %5, %6, %7}, "
            "{%8, %9, %10, %11}, %12, p, %14, 1;\n}\n"
            : WG_D8(0)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
              "n"(SA));
    } else if constexpr (BN == 32) {
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

// Whether the block walks its tiles in the reuse order (Cfg::REUSE_X): X
// slice-invariant, one K chunk and one N tile a tile.
template <class C>
__device__ __forceinline__ bool reuse(const Operands& p)
{
    return C::REUSE_X && p.x_ws == 0 && p.n_kchunks == 1 && p.n_ntiles == 1;
}

// The block's first tile in the reuse order: each block takes a run of
// consecutive tiles, the slice instance fastest
__device__ __forceinline__ long long first_tile(const Operands& p, int b)
{
    return (long long)b * p.n_tiles / gridDim.x;
}

// The block's tiles in turn: ``at`` is the current one, ``next`` steps to
// the next.  The order: tile blockIdx.x + q gridDim.x of the slice
// instances' tiles, Pair and the complex matmul running the M tiles of
// one N tile next to each other, GK the N tiles (H) of one M tile, which
// read the same X rows (from L2 for all but the first), W being small; or
// the reuse order.  Stepped without 64-bit divisions (software routines:
// a few a tile cost as much as the rest of a tile's hand-over when a tile
// is one chunk, as GGK's and GK's K <= 32 tiles are).
template <class C>
struct Tiles {
    const Operands& p;
    const bool reusing;
    long long per_w;     // tiles a slice instance
    long long r;         // the tile within its instance
    long long step_w, step_r;    // gridDim.x tiles on, in instances and r
    TileAt at;

    __device__ __forceinline__ explicit Tiles(const Operands& p_)
        : p(p_), reusing(reuse<C>(p_)),
          per_w((long long)p_.n_mtiles * p_.n_ntiles)
    {
        long long w;
        if (reusing) {
            const long long t = first_tile(p, blockIdx.x);
            w = t % p.W;
            r = t / p.W;     // the M tile (one N tile)
        } else {
            w = blockIdx.x / per_w;
            r = blockIdx.x % per_w;
            step_w = gridDim.x / per_w;
            step_r = gridDim.x % per_w;
        }
        set(w);
    }

    // at = slice instance w, tile r of it (GK: N tiles fastest)
    __device__ __forceinline__ void set(long long w)
    {
        const int fast = C::GATHER ? p.n_ntiles : p.n_mtiles;
        const int ri = (int)r;
        const int a = fast == 1 ? ri : ri / fast;
        const int b = fast == 1 ? 0 : ri % fast;
        at = TileAt{w, (C::GATHER ? a : b) * C::BM,
                    (C::GATHER ? b : a) * C::BN};
    }

    __device__ __forceinline__ void next()
    {
        if (reusing) {
            if (++at.w == p.W) {
                at.w = 0;
                at.m0 += C::BM;
            }
            return;
        }
        long long w = at.w + step_w;
        r += step_r;
        if (r >= per_w) {
            r -= per_w;
            ++w;
        }
        set(w);
    }
};

// Copy chunk ``kc`` of tile ``at`` (X's BK x BM values, V's BK x BN) into
// ``stage``, 16 bytes a cp.async (X: VEC; V: p.vec_v), else 4; each of the
// producer's threads (``tid``) copies its share.  Rows and columns past M,
// N and K read as zeros.  ``x_too`` false: V alone (the reuse order's
// consumers hold the tile's X already).
template <class C>
__device__ __forceinline__ void load(const Operands& p, const TileAt& at,
                                     int kc, float* stage, int tid,
                                     bool x_too)
{
    constexpr int BM = C::BM, BN = C::BN, BK = C::BK;
    constexpr int LDA = C::LDA, LDB = C::LDB, T = C::PRODUCER;
    const float* xr = p.xr + at.w * p.x_ws;
    const float* xi = p.xi + at.w * p.x_ws;
    // GGK: the W rows of the tile's outer index (a tile lies in one)
    const long long vb = at.w * p.v_ws
        + (C::GATHER && p.woff ? p.woff[at.m0 / p.F] : 0);
    const float* vr = p.vr + vb;
    const float* vi = p.vi + vb;
    const int k0 = kc * BK;
    if (!x_too) {
    } else if constexpr (C::A_MK) {
        // X (M, K) rows: a fixed 4-float k chunk ac of rows ar0 + RA q
        constexpr int A_CH = BK / 4, RA = T / A_CH;
        static_assert(T % A_CH == 0 && BM % RA == 0, "X tile");
        const int ac = tid % A_CH, ar0 = tid / A_CH;
        const int k = k0 + 4 * ac;
#pragma unroll
        for (int q = 0; q < BM / RA; ++q) {
            const int r = ar0 + RA * q, m = at.m0 + r;
            // with VEC (K % 4 == 0) a chunk is whole or out
            const int lim = m < p.M ? p.K - k : 0;
            const long long off = lim > 0 ? (long long)m * p.K + k : 0;
            float* d = stage + r * LDA + 4 * ac;
            tc::copy4(d, xr + off, lim, C::VEC, xr);
            tc::copy4(d + C::A_PART, xi + off, lim, C::VEC, xi);
        }
    } else {
        // X [k][m]: a fixed 4-float m chunk ac of rows ar0 + RA q
        constexpr int A_CH = BM / 4, RA = T / A_CH;
        static_assert(T % A_CH == 0 && BK % RA == 0, "X tile");
        const int ac = tid % A_CH, ar0 = tid / A_CH;
        const int m = at.m0 + 4 * ac;
        if constexpr (C::VEC) {
            const bool m_ok = m < p.M;   // M % 4 == 0: a chunk is whole or out
            const long long xcol = !m_ok ? 0
                : C::GATHER ? p.xoff[m / p.F] + m % p.F : (long long)m;
#pragma unroll
            for (int q = 0; q < BK / RA; ++q) {
                const int r = ar0 + RA * q, k = k0 + r;
                const bool ok = m_ok && k < p.K;
                const long long off = !ok ? 0
                    : (C::GATHER ? p.koff[k] : (long long)k * p.M) + xcol;
                float* d = stage + r * LDA + 4 * ac;
                tc::cp16(d, xr + off, ok ? 16 : 0);
                tc::cp16(d + C::A_PART, xi + off, ok ? 16 : 0);
            }
        } else {   // each of the 4 m values on its own (GK: maybe two
                   // outer indices)
            long long xcol[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                xcol[e] = m + e >= p.M ? -1
                    : C::GATHER ? p.xoff[(m + e) / p.F] + (m + e) % p.F
                                : (long long)(m + e);
#pragma unroll
            for (int q = 0; q < BK / RA; ++q) {
                const int r = ar0 + RA * q, k = k0 + r;
                const long long row = k >= p.K ? 0
                    : C::GATHER ? p.koff[k] : (long long)k * p.M;
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
    }
    // V: Pair and the complex matmul, a column chunk bc of rows [k] br0 +
    // RB q; GK and the swap, a k chunk bc of rows [n] br0 + RB q (a narrow
    // tile leaves some threads without a row)
    constexpr int B_CH = C::V_NK ? BK / 4 : BN / 4, RB = T / B_CH;
    constexpr int B_ITERS = (C::B_ROWS + RB - 1) / RB;
    static_assert(T % B_CH == 0 && (C::B_ROWS % RB == 0 || B_ITERS == 1),
                  "V tile");
    const int bc = tid % B_CH, br0 = tid / B_CH;
    float* sb = stage + 2 * C::A_PART;
#pragma unroll
    for (int q = 0; q < B_ITERS; ++q) {
        const int r = br0 + RB * q;
        if (C::B_ROWS % RB && r >= C::B_ROWS)
            break;
        // Pair: row k = k0 + r, columns n0 + 4 bc; GK: row n = n0 + r,
        // k = k0 + 4 bc; the 4 values along the row, ``lim`` of them in
        // range (with vec_v: 4 or 0, K % 4 == 0 for GK, N % 4 for Pair)
        const int k = C::V_NK ? k0 + 4 * bc : k0 + r;
        const int n = C::V_NK ? at.n0 + r : at.n0 + 4 * bc;
        const bool ok = k < p.K && n < p.N;
        const int lim = !ok ? 0 : C::V_NK ? p.K - k : p.N - n;
        const long long off = !ok ? 0
            : C::V_NK ? (long long)n * p.K + k : (long long)k * p.N + n;
        float* d = sb + r * LDB + 4 * bc;
        tc::copy4(d, vr + off, lim, p.vec_v, vr);
        tc::copy4(d + C::B_PART, vi + off, lim, p.vec_v, vi);
    }
}

// Split chunk ``item``'s raw V (stage s) into the hi (and lo) planes of
// buffer ``pl``: plane order re hi, im hi, re lo, im lo (STACK: [re | im]
// hi, [-im | re] hi, then lo; PASSES 6: hi, mid, lo); element (n, k) of
// k8 slice j at j*PW*8 + (n/8)*64 + ((k%8)/4)*32 + (n%8)*4 + k%4 floats.
template <class C>
__device__ __forceinline__ void split_v(const float* sb, float* pl, int ct)
{
    constexpr int BN = C::BN, LDB = C::LDB, PLANE = C::PLANE, PW = C::PW;
    constexpr int T = C::PRODUCER;
    constexpr int TASKS = BN * C::BK / 4;  // (n, 4 k) chunks, re and im each
    static_assert(TASKS % T == 0 || TASKS < T, "split tasks");
#pragma unroll
    for (int q = 0; q < (TASKS + T - 1) / T; ++q) {
        const int id = ct + T * q;
        if (TASKS < T && id >= TASKS)
            break;
        const int n = id % BN, k = 4 * (id / BN);
        float r[4], i[4];
        if (C::V_NK) {      // raw [n][k]
            const float4 a = *reinterpret_cast<const float4*>(sb + n * LDB + k);
            const float4 b = *reinterpret_cast<const float4*>(
                sb + C::B_PART + n * LDB + k);
            r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
            i[0] = b.x; i[1] = b.y; i[2] = b.z; i[3] = b.w;
        } else {            // raw [k][n]
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                r[e] = sb[(k + e) * LDB + n];
                i[e] = sb[C::B_PART + (k + e) * LDB + n];
            }
        }
        uint32_t rh[4], rl[4], ih[4], il[4], rx[4], ix[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if constexpr (C::PASSES == 6) {
                tc::split3(r[e], rh[e], rl[e], rx[e]);
                tc::split3(i[e], ih[e], il[e], ix[e]);
            } else {
                tc::split<C::PASSES>(r[e], rh[e], rl[e]);
                tc::split<C::PASSES>(i[e], ih[e], il[e]);
            }
        }
        const int off = (k / 8) * PW * 8 + (n / 8) * 64 + ((k % 8) / 4) * 32
                        + (n % 8) * 4;
        auto put = [&](int plane, int at, const uint32_t* v, bool neg) {
            const uint32_t s = neg ? 0x80000000u : 0u;   // exact negation
            *reinterpret_cast<uint4*>(pl + plane * PLANE + at) =
                make_uint4(v[0] ^ s, v[1] ^ s, v[2] ^ s, v[3] ^ s);
        };
        // column n + BN of a stacked plane: 8-column groups BN / 8 on
        constexpr int HI = (BN / 8) * 64;
        if (C::STACK) {
            put(0, off, rh, false);
            put(0, off + HI, ih, false);
            put(1, off, ih, true);
            put(1, off + HI, rh, false);
        } else {
            put(0, off, rh, false);
            put(1, off, ih, false);
        }
        if (C::PASSES != 1 && C::STACK) {
            put(2, off, rl, false);
            put(2, off + HI, il, false);
            put(3, off, il, true);
            put(3, off + HI, rl, false);
        } else if (C::PASSES != 1) {
            put(2, off, rl, false);
            put(3, off, il, false);
        }
        if (C::PASSES == 6 && C::STACK) {
            put(4, off, rx, false);
            put(4, off + HI, ix, false);
            put(5, off, ix, true);
            put(5, off + HI, rx, false);
        } else if (C::PASSES == 6) {
            put(4, off, rx, false);
            put(5, off, ix, false);
        }
    }
    // the planes are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the consumer warpgroup ``wgc``'s 128 threads (named barriers 2 and 3)
__device__ __forceinline__ void consumer_sync(int wgc)
{
    asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wgc) : "memory");
}

// A warp's 16 rows of a finished tile, from the accumulator fragments:
// thread (g, t) holds rows g and g + 8, columns 8 j + 2 t (+ 1); with
// STAGE_Y through the warpgroup's [n][m] rows in ``sy``
template <class C>
__device__ __forceinline__ void store(const Operands& p, const TileAt& at,
                                      int wgc, float* sy, const float* ar,
                                      const float* ai)
{
    const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = 64 * wgc + 16 * warp;
    float* yr = p.yr + at.w * p.y_ws;
    float* yi = p.yi + at.w * p.y_ws;
    if constexpr (C::STAGE_Y) {
        constexpr int LDY = C::LDY, PART = C::Y_PART;
        sy += wgc * 2 * PART;
        consumer_sync(wgc);          // the last tile's rows are read
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int a = (8 * j + 2 * t + e) * LDY + 16 * warp + g
                                  + 8 * h;
                    sy[a] = ar[4 * j + 2 * h + e];
                    sy[PART + a] = ai[4 * j + 2 * h + e];
                }
        consumer_sync(wgc);
        // (n, 4 m) chunks: 16 a column, consecutive threads along m;
        // F % 4 == 0 (VEC), so a chunk lies in one outer index
        constexpr int TASKS = C::BN * 16;
        static_assert(TASKS % 128 == 0, "staged Y");
#pragma unroll
        for (int q = 0; q < TASKS / 128; ++q) {
            const int id = lt + 128 * q, n = id / 16, c = id % 16;
            const int m = at.m0 + 64 * wgc + 4 * c;
            if (m >= p.M || at.n0 + n >= p.N)
                continue;
            const long long a = p.yoff[m / p.F] + m % p.F
                                + (long long)(at.n0 + n) * p.ldy;
            *reinterpret_cast<float4*>(yr + a) =
                *reinterpret_cast<const float4*>(sy + n * LDY + 4 * c);
            *reinterpret_cast<float4*>(yi + a) =
                *reinterpret_cast<const float4*>(sy + PART + n * LDY + 4 * c);
        }
    } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = at.m0 + row0 + g + 8 * h;
            if (m >= p.M)
                continue;
            const long long base = C::GATHER ? p.yoff[m / p.F] + m % p.F
                : C::SWAP ? (long long)m : (long long)m * p.N;
#pragma unroll
            for (int j = 0; j < C::BN / 8; ++j) {
                const int n = at.n0 + 8 * j + 2 * t;
                if (n >= p.N)
                    continue;
                const float* vr = ar + 4 * j + 2 * h;
                const float* vi = ai + 4 * j + 2 * h;
                if (C::V_NK || !C::VEC) {
                    const long long ldy = C::V_NK ? p.ldy : 1;
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
}

// The producer warpgroup: item j (chunk j % nks of the block's tile slot
// j / nks) copied into raw stage j % STAGES, AHEAD items before it is
// split into plane buffer j % 2.  Item j - 2, the last user of both that
// buffer and raw stage (j + AHEAD) % STAGES, must be done first.
template <class C>
__device__ __forceinline__ void producer(const Operands& p, float* planes,
                                         float* raw, uint64_t* full,
                                         uint64_t* empty, int total)
{
    const int tid = threadIdx.x;          // 0 .. 127
    const int nks = p.n_kchunks;
    Tiles<C> tiles(p);
    int kc = 0, m_last = -1;
    auto copy_next = [&](int i) {         // item i, the items in order
        if (i < total) {
            const TileAt& at = tiles.at;
            load<C>(p, at, kc, raw + (i % C::STAGES) * C::STAGE, tid,
                    !tiles.reusing || at.m0 != m_last);
            m_last = at.m0;
            if (++kc == nks) {
                kc = 0;
                tiles.next();
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
        split_v<C>(raw + (j % C::STAGES) * C::STAGE + 2 * C::A_PART,
                   planes + (j % 2) * C::PLANES, tid);
        mbar_arrive(&full[j % 2]);
    }
    tc::cp_wait<0>();
}

// A consumer warpgroup (``wgc`` 0 or 1: output rows 64 wgc ..): per item,
// per k8 slice, the A fragment from the raw stage, 12 wgmma (4 in one
// pass, 24 in six; STACK 6, 2 and 12) into the tensor-core accumulators d, and at a
// window's end d added into the float32 accumulators acc; a tile's last
// item stores acc.  acc and d hold re then im (STACK: the [re | im]
// columns of one n32 accumulator, which is the same order).
template <class C>
__device__ __forceinline__ void consumer(const Operands& p,
                                         const float* planes,
                                         const float* raw, float* sy,
                                         uint64_t* full, uint64_t* empty,
                                         int total)
{
    constexpr int BN = C::BN, BK = C::BK, LDA = C::LDA, PLANE = C::PLANE;
    constexpr int NR = BN / 2, PASSES = C::PASSES;
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
    float acc[2 * NR], d[2 * NR];
#pragma unroll
    for (int e = 0; e < 2 * NR; ++e) {
        acc[e] = 0.f;
        d[e] = 0.f;
    }
    // hi and lo (PASSES 6: hi, mid and lo) of the A fragments
    constexpr int XF = PASSES == 6 ? FR : 1;
    uint32_t ar_h[FR][4], ar_l[FR][4], ai_h[FR][4], ai_l[FR][4];
    uint32_t ar_x[XF][4], ai_x[XF][4];
    // slice j's fragment (rows row0 + g (+8), columns t (+4)) into slot f
    auto frag = [&](const float* sa, int j, int f) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int m = row0 + g + 8 * (c & 1), k = 8 * j + t + 4 * (c >> 1);
            const int a = C::A_MK ? m * LDA + k : k * LDA + m;
            if constexpr (PASSES == 6) {
                tc::split3(sa[a], ar_h[f][c], ar_l[f][c], ar_x[f][c]);
                tc::split3(sa[C::A_PART + a], ai_h[f][c], ai_l[f][c],
                           ai_x[f][c]);
            } else {
                tc::split<PASSES>(sa[a], ar_h[f][c], ar_l[f][c]);
                tc::split<PASSES>(sa[C::A_PART + a], ai_h[f][c],
                                  ai_l[f][c]);
            }
        }
    };
    Tiles<C> tiles(p);
    int kc = 0;                  // the item's chunk within its tile
    int m_last = -1;             // the last tile's M tile
    for (int it = 0; it < total; ++it) {
        const TileAt& at = tiles.at;
        // the reuse order's next slice instance of an M tile: its A
        // fragments are in their slots already
        const bool keep = tiles.reusing && at.m0 == m_last;
        mbar_wait(&full[it % 2], (it / 2) & 1);
        const float* sa = raw + (it % C::STAGES) * C::STAGE;
        const float* pl = planes + (it % 2) * C::PLANES;
        const int nk8 = min(BK / 8, nk8_all - kc * (BK / 8));
        if (!keep)
            frag(sa, 0, 0);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
            if (j >= nk8)
                break;
            const int f = j % FR;
            const int kk = kc * (BK / 8) + j;     // k8 slice of the tile
            const int go = kk % P ? 1 : 0;        // 0: a fresh window
            const float* b = pl + j * C::PW * 8;
            // planes 0 and 1 (2 and 3: lo): re and im, or STACK's
            // [re | im] and [-im | re]
            const uint64_t b0h = desc(b), b1h = desc(b + PLANE);
            wg_fence();
            pin<2 * NR>(d);
            if constexpr (C::STACK) {
                // d = [re | im] += Ar [Vr | Vi] + Ai [-Vi | Vr]: small
                // terms first (lo.hi, hi.lo), then hi.hi
                constexpr int N2 = 2 * BN;
                if constexpr (PASSES == 6) {
                    // lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi
                    const uint64_t b0m = desc(b + 2 * PLANE);
                    const uint64_t b1m = desc(b + 3 * PLANE);
                    const uint64_t b0x = desc(b + 4 * PLANE);
                    const uint64_t b1x = desc(b + 5 * PLANE);
                    mma<N2, 1>(d, ar_x[f], b0h, go);
                    mma<N2, 1>(d, ai_x[f], b1h, 1);
                    mma<N2, 1>(d, ar_h[f], b0x, 1);
                    mma<N2, 1>(d, ai_h[f], b1x, 1);
                    mma<N2, 1>(d, ar_l[f], b0m, 1);
                    mma<N2, 1>(d, ai_l[f], b1m, 1);
                    mma<N2, 1>(d, ar_l[f], b0h, 1);
                    mma<N2, 1>(d, ai_l[f], b1h, 1);
                    mma<N2, 1>(d, ar_h[f], b0m, 1);
                    mma<N2, 1>(d, ai_h[f], b1m, 1);
                    mma<N2, 1>(d, ar_h[f], b0h, 1);
                    mma<N2, 1>(d, ai_h[f], b1h, 1);
                } else if (PASSES == 3) {
                    const uint64_t b0l = desc(b + 2 * PLANE);
                    const uint64_t b1l = desc(b + 3 * PLANE);
                    mma<N2, 1>(d, ar_l[f], b0h, go);
                    mma<N2, 1>(d, ai_l[f], b1h, 1);
                    mma<N2, 1>(d, ar_h[f], b0l, 1);
                    mma<N2, 1>(d, ai_h[f], b1l, 1);
                    mma<N2, 1>(d, ar_h[f], b0h, 1);
                    mma<N2, 1>(d, ai_h[f], b1h, 1);
                } else {
                    mma<N2, 1>(d, ar_h[f], b0h, go);
                    mma<N2, 1>(d, ai_h[f], b1h, 1);
                }
            } else if constexpr (PASSES == 6) {
                float* dr = d;
                float* di = d + NR;
                const uint64_t b0m = desc(b + 2 * PLANE);
                const uint64_t b1m = desc(b + 3 * PLANE);
                const uint64_t b0x = desc(b + 4 * PLANE);
                const uint64_t b1x = desc(b + 5 * PLANE);
                // lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi, each as
                // re += Ar.Vr - Ai.Vi, im += Ar.Vi + Ai.Vr
                auto term = [&](const uint32_t* xr, const uint32_t* xi,
                                uint64_t vr, uint64_t vi, int fresh) {
                    mma<BN, 1>(dr, xr, vr, fresh);
                    mma<BN, 1>(di, xr, vi, fresh);
                    mma<BN, -1>(dr, xi, vi, 1);
                    mma<BN, 1>(di, xi, vr, 1);
                };
                term(ar_x[f], ai_x[f], b0h, b1h, go);
                term(ar_h[f], ai_h[f], b0x, b1x, 1);
                term(ar_l[f], ai_l[f], b0m, b1m, 1);
                term(ar_l[f], ai_l[f], b0h, b1h, 1);
                term(ar_h[f], ai_h[f], b0m, b1m, 1);
                term(ar_h[f], ai_h[f], b0h, b1h, 1);
            } else if (PASSES == 3) {
                float* dr = d;
                float* di = d + NR;
                const uint64_t b0l = desc(b + 2 * PLANE);
                const uint64_t b1l = desc(b + 3 * PLANE);
                // small terms first: lo.hi, hi.lo, then hi.hi; re
                // subtracts Ai.Bi through imm-scale-a -1
                mma<BN, 1>(dr, ar_l[f], b0h, go);
                mma<BN, 1>(di, ar_l[f], b1h, go);
                mma<BN, -1>(dr, ai_l[f], b1h, 1);
                mma<BN, 1>(di, ai_l[f], b0h, 1);
                mma<BN, 1>(dr, ar_h[f], b0l, 1);
                mma<BN, 1>(di, ar_h[f], b1l, 1);
                mma<BN, -1>(dr, ai_h[f], b1l, 1);
                mma<BN, 1>(di, ai_h[f], b0l, 1);
                mma<BN, 1>(dr, ar_h[f], b0h, 1);
                mma<BN, 1>(di, ar_h[f], b1h, 1);
                mma<BN, -1>(dr, ai_h[f], b1h, 1);
                mma<BN, 1>(di, ai_h[f], b0h, 1);
            } else {
                float* dr = d;
                float* di = d + NR;
                mma<BN, 1>(dr, ar_h[f], b0h, go);
                mma<BN, 1>(di, ar_h[f], b1h, go);
                mma<BN, -1>(dr, ai_h[f], b1h, 1);
                mma<BN, 1>(di, ai_h[f], b0h, 1);
            }
            wg_commit();
            if (j + 1 < nk8 && !keep)
                frag(sa, j + 1, (j + 1) % FR);
            if (kk % P == P - 1 || kk == nk8_all - 1) {
                // the window is done: into float32
                wg_wait<0>();
                pin<2 * NR>(d);
#pragma unroll
                for (int e = 0; e < 2 * NR; ++e)
                    acc[e] += d[e];
            }
        }
        wg_wait<0>();
        pin<2 * NR>(d);
        mbar_arrive(&empty[it % 2]);
        if (kc == nks - 1) {
            store<C>(p, at, wgc, sy, acc, acc + NR);
#pragma unroll
            for (int e = 0; e < 2 * NR; ++e)
                acc[e] = 0.f;
        }
        if (++kc == nks) {
            kc = 0;
            m_last = at.m0;
            tiles.next();
        }
    }
}

// One block's work: its tiles blockIdx.x, + gridDim.x, ..., each in
// chunks of BK, the chunks of all its tiles one sequence of items through
// the ring.  Each user calls it from a __global__ kernel of its own
// (pair.cu's pair_wgmma_kernel and cmm_wgmma_kernel, gatherk.cu's
// gk_wgmma_kernel and ggk_wgmma_kernel), with __launch_bounds__(384, 1):
// the kernel is compiled at 168 registers a thread, which the producer
// lowers to 40 and the consumers raise to 232 (128 x 40 + 256 x 232
// registers fit an SM's 65536).
template <class C>
__device__ __forceinline__ void gemm(const Operands& p)
{
    extern __shared__ __align__(128) float smem[];
    float* planes = smem;                        // 2 buffers
    float* raw = smem + 2 * C::PLANES;           // STAGES stages
    float* sy = raw + C::STAGES * C::STAGE;      // STAGE_Y: Y's rows
    uint64_t* bars = reinterpret_cast<uint64_t*>(sy + C::Y_STAGE);
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
    const int total = (int)(reuse<C>(p)
        ? first_tile(p, blockIdx.x + 1) - first_tile(p, blockIdx.x)
        : (p.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x)
        * p.n_kchunks;
    if (threadIdx.x < C::PRODUCER) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        producer<C>(p, planes, raw, full, empty, total);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        consumer<C>(p, planes, raw, sy, full, empty, total);
    }
}

// Launch ``kern`` (a kernel running gemm<C>) over an M x N product at
// slice width W: one block an SM, at most one a tile.  ``attr``, the
// caller's for this kernel (one Cfg may serve two kernels: GK's and
// GGK's), holds a bit for each device whose shared-memory attribute the
// kernel has.
template <class C>
int launch(void (*kern)(Operands), unsigned& attr, Operands p, int W,
           cudaStream_t stream)
{
    if (p.K < 1 || p.M < 1 || p.N < 1 || W <= 0 || W > 65535)
        return (int)cudaErrorInvalidConfiguration;
    // GGK: an M tile lies in one outer index
    if (C::GATHER && p.woff && p.F % C::BM)
        return (int)cudaErrorInvalidValue;
    p.n_mtiles = (p.M + C::BM - 1) / C::BM;
    p.n_ntiles = (p.N + C::BN - 1) / C::BN;
    p.n_kchunks = (p.K + C::BK - 1) / C::BK;
    p.W = W;
    p.n_tiles = (long long)W * p.n_mtiles * p.n_ntiles;
    if ((long long)p.n_mtiles * p.n_ntiles > 0x7fffffffLL)   // Tiles::set
        return (int)cudaErrorInvalidConfiguration;
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
