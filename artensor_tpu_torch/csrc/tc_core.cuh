// Split-complex product on the tensor cores at float32 accuracy (3xTF32)
// with mma.sync: GGK's "mma" form (gatherk.cu) and the complex matmul
// (pair.cu); Pair and GK's "mma" form run wgmma_core.cuh.
//
// Computes, per slice instance w (grid axis y),
//   Y[m, n] = sum_k A[m, k] . B[k, n]        (complex, split re/im planes)
// with A read as (M, K) rows (A_MK: GK's W, the complex matmul's A) or as
// (K, M) rows (the pair kernel's X), and B read as (K, N) rows.  In the
// GATHER variant (GK) B's row k starts at koff[k] and column n is element
// n % F of outer index n / F, at xoff[n / F] in X and yoff[n / F] in Y, so
// that all outer indices of a GK step form one flat N = G * F.  With
// ``aoff`` (GGK) A of outer index o starts at aoff[o]; then F is a
// multiple of BN, so that an N tile lies in one outer index.
//
// 3xTF32 (PASSES 3, precision "highest" and "high"): each operand is split
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi); a real product sums
// hi.hi + hi.lo + lo.hi (the lo.lo term, below 2^-22 of |a||b|, is
// dropped).  The relative error of a product is about 2^-21, near
// float32's 2^-24: the JAX kernels' Precision.HIGHEST products are
// multi-pass bf16 on the MXU at float32 accuracy, and this is the Hopper
// counterpart.  A complex product is four real ones, 12 mma.sync.m16n8k8
// per 16 x 8 x 8 tile, re and im accumulators kept in registers.  The one-
// pass form (PASSES 1, precision "default", ops/einsum.py) multiplies hi.hi
// alone, hi the operand with its low 13 mantissa bits cleared (10 mantissa
// bits kept), 4 mma per tile: the counterpart of the TPU's one bf16 pass,
// held on the card against a plain version whose operands are rounded the
// same way and multiplied in float32.  The sums inside the tensor cores do not round to nearest:
// with all of K added into the mma accumulators the pair step at K 1024
// came out 12x as far from float64 as cuBLAS's float32 product (H100).
// So each k8 step's products go into zeroed tiles (at most 6 terms each),
// and those are added into the accumulators with float32 adds, which do;
// the error then stays below the float32 product's.
//
// Bound: 3 x 8 flop per complex multiply-add at the card's 495 TFLOP/s TF32
// rate (165 TFLOP/s effective), or the bytes at 3.35 TB/s.  Design: a block
// of WM x WN warps owns a BM x BN output tile and walks K in BK chunks
// through a ring of STAGES shared-memory buffers filled by cp.async (16 B
// where operand strides and pointers are 16-byte aligned, else 4 B), so
// the next chunks load while the current one multiplies; one barrier per
// chunk.  Shared rows are padded (row length = 8 mod 32 floats for [k][m]
// and [k][n] tiles, 4 mod 32 for [m][k]) so that fragment reads hit 32
// distinct banks.  Operands are split as the fragments are read.  Ragged
// M, N and K are zero-filled on load and masked on store.  Block order
// runs the M tiles of one N tile next to each other (they share B in L2).
// wgmma takes TF32 operands only K-major, and these are K-slow:
// wgmma_core.cuh adds the transposing stage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t to_tf32(float x)
{
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo, both TF32; with one pass hi = x with its low 13 mantissa
// bits cleared (lo unused)
template <int PASSES>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo)
{
    if (PASSES == 1) {
        hi = __float_as_uint(x) & 0xffffe000u;
        lo = 0u;
    } else {
        hi = to_tf32(x);
        lo = to_tf32(x - __uint_as_float(hi));
    }
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b)
{
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes)
{
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes)
{
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 4 consecutive floats s[0..3] -> d[0..3] asynchronously; elements at
// index >= lim read as 0.  ``base`` is a valid address for empty copies.
__device__ __forceinline__ void copy4(float* d, const float* s, int lim,
                                      bool vec, const float* base)
{
    if (vec) {
        const int n = lim < 0 ? 0 : (lim > 4 ? 4 : lim);
        cp16(d, n ? s : base, 4 * n);
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            cp4(d + e, e < lim ? s + e : base, e < lim ? 4 : 0);
    }
}

struct Operands {
    const float *ar, *ai, *br, *bi;
    float *yr, *yi;
    int M, N, K;
    long long lda, ldb, ldy;   // row strides: A (m or k rows), B (k rows), Y (m rows)
    long long a_ws, b_ws, y_ws;   // slice-width strides (0: slice-invariant)
    const long long *koff, *xoff, *yoff;   // GATHER tables
    const long long* aoff;     // GATHER, or null: A of outer index o at aoff[o]
    int F;                     // GATHER: f run length
    int vec_a, vec;            // 16-byte copies of A; of B and 8-byte Y stores
};

template <bool GATHER>
__device__ __forceinline__ long long bcol(const Operands& p, int n)
{
    return GATHER ? p.xoff[n / p.F] + n % p.F : (long long)n;
}

template <bool GATHER>
__device__ __forceinline__ long long ycol(const Operands& p, int n)
{
    return GATHER ? p.yoff[n / p.F] + n % p.F : (long long)n;
}

// A block's tile: WM x WN warps, each owning MT x NT mma tiles of 16 x 8
// outputs; K walked in BK chunks through a ring of STAGES buffers.
template <int MT_, int NT_, int WM_, int WN_, int BK_ = 16, int STAGES_ = 4>
struct Tile {
    static constexpr int MT = MT_, NT = NT_, WM = WM_, WN = WN_;
    static constexpr int BK = BK_, STAGES = STAGES_;
    static constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
    static constexpr int THREADS = WM * WN * 32;
};

// shared-memory layout of a tile's stage
template <class T, bool A_MK>
struct Shape {
    static constexpr int LDA = A_MK ? T::BK + 4 : T::BM + 8;
    static constexpr int A_ROWS = A_MK ? T::BM : T::BK;
    static constexpr int LDB = T::BN + 8;
    static constexpr int A_PART = A_ROWS * LDA, B_PART = T::BK * LDB;
    static constexpr int STAGE = 2 * A_PART + 2 * B_PART;
    static constexpr int SMEM = STAGE * T::STAGES * (int)sizeof(float);
};

// One block's product.  Each user calls it from a __global__ kernel of its
// own (gatherk.cu's gk_mma_kernel, pair.cu's pair_mma_kernel), so that a
// profile tells them apart by name.  ROW: the products of a k8 step go
// into tiles for a whole row of NT outputs at once (more independent mma,
// more live registers) rather than one output at a time.  PASSES: 3
// (3xTF32) or 1 (one TF32 pass).
template <class T, bool A_MK, bool GATHER, bool ROW, int PASSES>
__device__ __forceinline__ void cgemm(const Operands& p, int n_mtiles)
{
    static_assert(PASSES == 1 || PASSES == 3, "PASSES");
    using S = Shape<T, A_MK>;
    constexpr int MT = T::MT, NT = T::NT, WM = T::WM, BK = T::BK;
    constexpr int STAGES = T::STAGES;
    constexpr int BM = T::BM, BN = T::BN, THREADS = T::THREADS;
    constexpr int LDA = S::LDA, LDB = S::LDB;
    constexpr int A_PART = S::A_PART, B_PART = S::B_PART;
    // 16-byte chunks per shared row, and rows one pass of the block covers
    constexpr int A_CH = A_MK ? BK / 4 : BM / 4;
    constexpr int A_PASS = THREADS / A_CH;
    constexpr int B_CH = BN / 4;
    constexpr int B_PASS = THREADS / B_CH;
    static_assert(THREADS % A_CH == 0 && S::A_ROWS % A_PASS == 0, "A tile");
    static_assert(THREADS % B_CH == 0 && BK % B_PASS == 0, "B tile");
    static_assert(BK % 8 == 0, "BK");

    extern __shared__ __align__(16) float smem[];

    const int mt = blockIdx.x % n_mtiles;
    const int nt = blockIdx.x / n_mtiles;
    const long long w = blockIdx.y;
    const int m0 = mt * BM, n0 = nt * BN;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp % WM, wn = warp / WM;
    const int g = lane >> 2, t = lane & 3;

    // GGK: each outer index has its own A; an N tile lies in one index
    const long long a0 = w * p.a_ws
                         + ((GATHER && p.aoff) ? p.aoff[n0 / p.F] : 0);
    const float* __restrict__ ar = p.ar + a0;
    const float* __restrict__ ai = p.ai + a0;
    const float* __restrict__ br = p.br + w * p.b_ws;
    const float* __restrict__ bi = p.bi + w * p.b_ws;
    const bool vec_a = p.vec_a, vec = p.vec;

    // each thread copies one fixed column chunk of every A and B row it
    // touches: its B column offset is found once
    const int ac = tid % A_CH, ar0 = tid / A_CH;
    const int bc = tid % B_CH, br0 = tid / B_CH;
    const int bn = n0 + 4 * bc;
    const long long bcol0 = (bn < p.N) ? bcol<GATHER>(p, bn) : 0;

    auto load = [&](int stage, int k0) {
        float* sa = smem + stage * S::STAGE;
        float* sb = sa + 2 * A_PART;
#pragma unroll
        for (int q = 0; q < S::A_ROWS / A_PASS; ++q) {
            const int r = ar0 + q * A_PASS;
            const int m = A_MK ? m0 + r : m0 + 4 * ac;
            const int k = A_MK ? k0 + 4 * ac : k0 + r;
            const int lim = A_MK ? (m < p.M ? p.K - k : 0)
                                 : (k < p.K ? p.M - m : 0);
            const long long off = lim > 0 ? (A_MK ? m * p.lda + k
                                                  : k * p.lda + m) : 0;
            float* d = sa + r * LDA + 4 * ac;
            copy4(d, ar + off, lim, vec_a, ar);
            copy4(d + A_PART, ai + off, lim, vec_a, ai);
        }
#pragma unroll
        for (int q = 0; q < BK / B_PASS; ++q) {
            const int r = br0 + q * B_PASS;
            const int k = k0 + r;
            float* d = sb + r * LDB + 4 * bc;
            const int lim = (k < p.K) ? p.N - bn : 0;
            if (lim <= 0) {
                copy4(d, br, 0, vec, br);
                copy4(d + B_PART, bi, 0, vec, bi);
                continue;
            }
            const long long row = GATHER ? p.koff[k] : k * p.ldb;
            if (!GATHER || vec) {
                copy4(d, br + row + bcol0, lim, vec, br);
                copy4(d + B_PART, bi + row + bcol0, lim, vec, bi);
            } else {   // unaligned f run: a chunk may cross outer indices
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool ok = e < lim;
                    const long long a = ok ? row + bcol<GATHER>(p, bn + e) : 0;
                    cp4(d + e, br + a, ok ? 4 : 0);
                    cp4(d + B_PART + e, bi + a, ok ? 4 : 0);
                }
            }
        }
    };

    float acc_r[MT][NT][4], acc_i[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                acc_r[i][j][c] = 0.f;
                acc_i[i][j][c] = 0.f;
            }

    const int nk = (p.K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk)
            load(s, s * BK);
        cp_commit();
    }

    for (int kt = 0; kt < nk; ++kt) {
        cp_wait<STAGES - 2>();
        __syncthreads();
        const int nxt = kt + STAGES - 1;
        if (nxt < nk)
            load(nxt % STAGES, nxt * BK);
        cp_commit();

        const float* sa = smem + (kt % STAGES) * S::STAGE;
        const float* sb = sa + 2 * A_PART;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 8) {
            uint32_t bhr[NT][2], blr[NT][2], bhi[NT][2], bli[NT][2];
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int n = wn * NT * 8 + j * 8 + g;
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const int k = kk + t + 4 * q;
                    split<PASSES>(sb[k * LDB + n], bhr[j][q], blr[j][q]);
                    split<PASSES>(sb[B_PART + k * LDB + n], bhi[j][q],
                                  bli[j][q]);
                }
            }
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const int m = wm * MT * 16 + i * 16 + g;
                uint32_t ahr[4], alr[4], ahi[4], ali[4];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int mm = m + 8 * (c & 1);
                    const int k = kk + t + 4 * (c >> 1);
                    const int a = A_MK ? mm * LDA + k : k * LDA + mm;
                    split<PASSES>(sa[a], ahr[c], alr[c]);
                    split<PASSES>(sa[A_PART + a], ahi[c], ali[c]);
                }
                // each k8 step's products go into zeroed tiles (see the
                // note at the top), then into the float32 accumulators
                if (ROW) {
                    // two tiles per output (re with -ai), the NT outputs of
                    // the row at once: 2 NT mma between dependent ones
                    uint32_t nhi[4], nli[4];
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        nhi[c] = ahi[c] ^ 0x80000000u;
                        nli[c] = ali[c] ^ 0x80000000u;
                    }
                    float tr[NT][4], ti[NT][4];
#pragma unroll
                    for (int j = 0; j < NT; ++j)
#pragma unroll
                        for (int c = 0; c < 4; ++c) {
                            tr[j][c] = 0.f;
                            ti[j][c] = 0.f;
                        }
#pragma unroll
                    for (int q = 3 - PASSES; q < 3; ++q) {
                        // lo.hi, hi.lo, hi.hi (one pass: hi.hi alone)
                        const uint32_t* xr = q == 0 ? alr : ahr;
                        const uint32_t* xi = q == 0 ? ali : ahi;
                        const uint32_t* xn = q == 0 ? nli : nhi;
#pragma unroll
                        for (int j = 0; j < NT; ++j) {
                            const uint32_t* yr = q == 1 ? blr[j] : bhr[j];
                            mma(tr[j], xr, yr);
                            mma(ti[j], xi, yr);
                        }
#pragma unroll
                        for (int j = 0; j < NT; ++j) {
                            const uint32_t* yi = q == 1 ? bli[j] : bhi[j];
                            mma(tr[j], xn, yi);
                            mma(ti[j], xr, yi);
                        }
                    }
#pragma unroll
                    for (int j = 0; j < NT; ++j)
#pragma unroll
                        for (int c = 0; c < 4; ++c) {
                            acc_r[i][j][c] += tr[j][c];
                            acc_i[i][j][c] += ti[j][c];
                        }
                    continue;
                }
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    // one output at a time, its four real products in
                    // four tiles (fewer live registers)
                    float rr[4] = {0.f, 0.f, 0.f, 0.f};
                    float ii[4] = {0.f, 0.f, 0.f, 0.f};
                    float ri[4] = {0.f, 0.f, 0.f, 0.f};
                    float ir[4] = {0.f, 0.f, 0.f, 0.f};
                    if (PASSES == 3) {
                        mma(rr, alr, bhr[j]);
                        mma(ii, ali, bhi[j]);
                        mma(ri, alr, bhi[j]);
                        mma(ir, ali, bhr[j]);
                        mma(rr, ahr, blr[j]);
                        mma(ii, ahi, bli[j]);
                        mma(ri, ahr, bli[j]);
                        mma(ir, ahi, blr[j]);
                    }
                    mma(rr, ahr, bhr[j]);
                    mma(ii, ahi, bhi[j]);
                    mma(ri, ahr, bhi[j]);
                    mma(ir, ahi, bhr[j]);
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        acc_r[i][j][c] += rr[c] - ii[c];
                        acc_i[i][j][c] += ri[c] + ir[c];
                    }
                }
            }
        }
    }
    cp_wait<0>();

    float* __restrict__ yr = p.yr + w * p.y_ws;
    float* __restrict__ yi = p.yi + w * p.y_ws;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * NT * 8 + j * 8 + 2 * t;
        if (n >= p.N)
            continue;
        const long long c0 = ycol<GATHER>(p, n);
        const bool two = n + 1 < p.N;
        const long long c1 = two ? ycol<GATHER>(p, n + 1) : 0;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = m0 + wm * MT * 16 + i * 16 + g + 8 * h;
                if (m >= p.M)
                    continue;
                const long long a = m * p.ldy;
                const float* vr = &acc_r[i][j][2 * h];
                const float* vi = &acc_i[i][j][2 * h];
                if (vec) {
                    *reinterpret_cast<float2*>(yr + a + c0) =
                        make_float2(vr[0], vr[1]);
                    *reinterpret_cast<float2*>(yi + a + c0) =
                        make_float2(vi[0], vi[1]);
                } else {
                    yr[a + c0] = vr[0];
                    yi[a + c0] = vi[0];
                    if (two) {
                        yr[a + c1] = vr[1];
                        yi[a + c1] = vi[1];
                    }
                }
            }
    }
}

// Launch ``kern``, a kernel that runs cgemm<T, A_MK, ...>, over an M x N
// product at slice width W.
template <class T, bool A_MK>
int launch(void (*kern)(Operands, int), const Operands& p, int W,
           cudaStream_t stream)
{
    constexpr int SMEM = Shape<T, A_MK>::SMEM;
    const long long n_mtiles = (p.M + T::BM - 1) / T::BM;
    const long long n_ntiles = (p.N + T::BN - 1) / T::BN;
    const long long nblk = n_mtiles * n_ntiles;
    if (p.K < 1 || nblk <= 0 || nblk > 0x7fffffffLL || W <= 0 || W > 65535)
        return (int)cudaErrorInvalidConfiguration;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess)
        return (int)e;
    dim3 grid((unsigned)nblk, (unsigned)W);
    kern<<<grid, T::THREADS, SMEM, stream>>>(p, (int)n_mtiles);
    return (int)cudaGetLastError();
}

// a pass count the C entry points take (their kernels are instantiated
// for these)
inline bool passes_ok(int passes)
{
    return passes == 1 || passes == 3;
}

inline bool aligned16(const void* a)
{
    return ((uintptr_t)a & 15) == 0;
}

}  // namespace tc
