// Pair kernel: both-big split-complex product (K, M)^T . (K, N) -> (M, N),
// for the port's sparse executor; and the same product with A stored
// (M, K), the fused complex batched matmul of ops/pallas_mm.py.
//
// pair_launch replaces the Pallas kernels
// artensor_tpu/runtime/lanes.py::_pair_kernel and _pair_kernel_b
// (apply_pair_step, pallas_call :931 and :953).  The wrapper has already
// applied the plan's re_i / re_j reorders and the v_perm row gather, so
// both operands are dense row-major (K, M) and (K, N).  A width stride of
// 0 reads a slice-invariant operand once for every instance.
//
// cmm_launch replaces artensor_tpu/ops/pallas_mm.py::_kernel
// (complex_batched_matmul, pallas_call :61): (B, M, K) . (B, K, N) ->
// (B, M, N), the batch a grid axis.  The TPU kernel raised unless its
// 256-tiles divided M and N; this one masks the ragged tiles.  It is on no
// path of the port (nor of the JAX package).
//
// Bound: FP32 FMA throughput.  With K = 64..1024 and M, N in the thousands a
// step does 8*M*N*K flop on 8*(M*K + K*N + M*N) bytes — hundreds of flop
// per byte, far above the card's balance, and the JAX kernels' HIGHEST
// precision rules out TF32 tensor cores.  Design: a register-tiled product
// whose inner loop is almost only FMAs.  A block of 256 threads owns a
// BM x BN output tile (BM = 16*TM, BN = 16*TN) and walks K in chunks of
// BK through two shared-memory buffers: the next chunk is read from
// device memory into registers (coalesced along m / n, any shape, ragged
// edges zero-filled) while the current one is multiplied, then stored into
// the other buffer, so there is one barrier per chunk.  Each thread keeps
// TM x TN complex accumulators and reads its operands from shared memory
// as float4 runs (4 consecutive m or n), which costs (TM + TN) / 2 loads
// per 4*TM*TN FMAs; all four real products are fused in those registers.
// No wgmma/TMA: tensor cores would need TF32 or a 3xTF32 split.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // 16 x 16 threads
constexpr int RUN = 64;           // m (n) values per float4 group of 16 threads
// 8 x 8 complex accumulators per thread (128 x 128 tiles), K chunks of 4:
// the fastest of the (TM, TN, BK) choices compared at the main path's
// K 1024, M = N = 4096 step (243 registers, one block of 8 warps per SM)
constexpr int TM_ = 8, TN_ = 8, BK_ = 4;

// A_MK: A is stored (M, K) (cmm_launch) instead of (K, M) (pair_launch)
template <int TM, int TN, int BK, bool A_MK>
__global__ void __launch_bounds__(NT, 1)
pair_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
            const float* __restrict__ vr, const float* __restrict__ vi,
            float* __restrict__ yr, float* __restrict__ yi,
            int K, int M, int N, long long x_ws, long long v_ws,
            long long y_ws, int n_ntiles)
{
    constexpr int BM = 16 * TM, BN = 16 * TN;
    constexpr int LA = BK * BM / NT;      // staged loads per thread per part
    constexpr int LB = BK * BN / NT;
    __shared__ __align__(16) float a_s[2][2][BK][BM];   // [buf][re/im][k][m]
    __shared__ __align__(16) float b_s[2][2][BK][BN];

    const int nt = blockIdx.x % n_ntiles;
    const int mt = blockIdx.x / n_ntiles;
    const long long w = blockIdx.y;
    const int m0 = mt * BM, n0 = nt * BN;
    const int tid = threadIdx.x;
    const int tn = tid % 16, tm = tid / 16;
    const float* __restrict__ xrw = xr + w * x_ws;
    const float* __restrict__ xiw = xi + w * x_ws;
    const float* __restrict__ vrw = vr + w * v_ws;
    const float* __restrict__ viw = vi + w * v_ws;

    float sa_r[LA], sa_i[LA], sb_r[LB], sb_i[LB];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int l = 0; l < LA; ++l) {
            const int e = tid + l * NT;
            const int k = k0 + (A_MK ? e % BK : e / BM);
            const int m = m0 + (A_MK ? e / BK : e % BM);
            const bool ok = k < K && m < M;
            const long long a = A_MK ? (long long)m * K + k
                                     : (long long)k * M + m;
            sa_r[l] = ok ? xrw[a] : 0.f;
            sa_i[l] = ok ? xiw[a] : 0.f;
        }
#pragma unroll
        for (int l = 0; l < LB; ++l) {
            const int e = tid + l * NT;
            const int k = k0 + e / BN, n = n0 + e % BN;
            const bool ok = k < K && n < N;
            const long long a = (long long)k * N + n;
            sb_r[l] = ok ? vrw[a] : 0.f;
            sb_i[l] = ok ? viw[a] : 0.f;
        }
    };
    auto stash = [&](int buf) {
#pragma unroll
        for (int l = 0; l < LA; ++l) {
            const int e = tid + l * NT;
            const int kk = A_MK ? e % BK : e / BM;
            const int mm = A_MK ? e / BK : e % BM;
            a_s[buf][0][kk][mm] = sa_r[l];
            a_s[buf][1][kk][mm] = sa_i[l];
        }
#pragma unroll
        for (int l = 0; l < LB; ++l) {
            const int e = tid + l * NT;
            b_s[buf][0][e / BN][e % BN] = sb_r[l];
            b_s[buf][1][e / BN][e % BN] = sb_i[l];
        }
    };

    float acc_r[TM][TN], acc_i[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            acc_r[i][j] = 0.f;
            acc_i[i][j] = 0.f;
        }

    fetch(0);
    stash(0);
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < K; k0 += BK) {
        const bool more = k0 + BK < K;
        if (more)
            fetch(k0 + BK);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float ar[TM], ai[TM], br[TN], bi[TN];
#pragma unroll
            for (int q = 0; q < TM / 4; ++q) {
                const float4 u = *reinterpret_cast<const float4*>(
                    &a_s[buf][0][kk][q * RUN + tm * 4]);
                const float4 v = *reinterpret_cast<const float4*>(
                    &a_s[buf][1][kk][q * RUN + tm * 4]);
                ar[4 * q] = u.x; ar[4 * q + 1] = u.y;
                ar[4 * q + 2] = u.z; ar[4 * q + 3] = u.w;
                ai[4 * q] = v.x; ai[4 * q + 1] = v.y;
                ai[4 * q + 2] = v.z; ai[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int q = 0; q < TN / 4; ++q) {
                const float4 u = *reinterpret_cast<const float4*>(
                    &b_s[buf][0][kk][q * RUN + tn * 4]);
                const float4 v = *reinterpret_cast<const float4*>(
                    &b_s[buf][1][kk][q * RUN + tn * 4]);
                br[4 * q] = u.x; br[4 * q + 1] = u.y;
                br[4 * q + 2] = u.z; br[4 * q + 3] = u.w;
                bi[4 * q] = v.x; bi[4 * q + 1] = v.y;
                bi[4 * q + 2] = v.z; bi[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    acc_r[i][j] = fmaf(ar[i], br[j], acc_r[i][j]);
                    acc_r[i][j] = fmaf(-ai[i], bi[j], acc_r[i][j]);
                    acc_i[i][j] = fmaf(ar[i], bi[j], acc_i[i][j]);
                    acc_i[i][j] = fmaf(ai[i], br[j], acc_i[i][j]);
                }
        }
        if (more)
            stash(buf ^ 1);
        __syncthreads();
        buf ^= 1;
    }

    float* __restrict__ yrw = yr + w * y_ws;
    float* __restrict__ yiw = yi + w * y_ws;
    const bool vec = (N & 3) == 0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = m0 + (i / 4) * RUN + tm * 4 + i % 4;
        if (m >= M) continue;
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
            const int n = n0 + q * RUN + tn * 4;
            const long long a = (long long)m * N + n;
            if (vec && n < N) {
                *reinterpret_cast<float4*>(yrw + a) = make_float4(
                    acc_r[i][4 * q], acc_r[i][4 * q + 1],
                    acc_r[i][4 * q + 2], acc_r[i][4 * q + 3]);
                *reinterpret_cast<float4*>(yiw + a) = make_float4(
                    acc_i[i][4 * q], acc_i[i][4 * q + 1],
                    acc_i[i][4 * q + 2], acc_i[i][4 * q + 3]);
            } else if (!vec) {
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    if (n + r < N) {
                        yrw[a + r] = acc_r[i][4 * q + r];
                        yiw[a + r] = acc_i[i][4 * q + r];
                    }
            }
        }
    }
}

template <bool A_MK>
int launch(const float* xr, const float* xi, const float* vr,
           const float* vi, float* yr, float* yi, int K, int M, int N,
           long long x_ws, long long v_ws, long long y_ws, int W,
           void* stream)
{
    constexpr int BM = 16 * TM_, BN = 16 * TN_;
    const long long n_mtiles = (M + BM - 1) / BM;
    const long long n_ntiles = (N + BN - 1) / BN;
    const long long nblk = n_mtiles * n_ntiles;
    if (K < 1 || nblk <= 0 || nblk > 0x7fffffffLL || W <= 0 || W > 65535)
        return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)nblk, (unsigned)W);
    pair_kernel<TM_, TN_, BK_, A_MK>
        <<<grid, NT, 0, (cudaStream_t)stream>>>(
        xr, xi, vr, vi, yr, yi, K, M, N, x_ws, v_ws, y_ws, (int)n_ntiles);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pair_launch(const float* xr, const float* xi, const float* vr,
                           const float* vi, float* yr, float* yi, int K,
                           int M, int N, long long x_ws, long long v_ws,
                           long long y_ws, int W, void* stream)
{
    return launch<false>(xr, xi, vr, vi, yr, yi, K, M, N, x_ws, v_ws, y_ws,
                         W, stream);
}

// (B, M, K) . (B, K, N) -> (B, M, N); A = (ar, ai), B = (br, bi)
extern "C" int cmm_launch(const float* ar, const float* ai, const float* br,
                          const float* bi, float* yr, float* yi, int B,
                          int M, int K, int N, void* stream)
{
    return launch<true>(ar, ai, br, bi, yr, yi, K, M, N, (long long)M * K,
                        (long long)K * N, (long long)M * N, B, stream);
}
