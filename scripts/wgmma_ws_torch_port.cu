// The wgmma core's warp-specialised shape (csrc/wgmma_core.cuh: a
// producer warpgroup that copies and splits beside two consumer warpgroups
// that only multiply, setmaxnreg 40 / 232) set against the shape it
// replaced, two warpgroups that share the copies and V's split between
// their products (256 threads at up to 255 registers, a cp.async ring of 3
// stages, two barriers a chunk), at the Pair steps of the 1k and 10k paths
// on the card.  The earlier shape is kept here, for Pair's operands on the
// 16-byte grid only (namespace two).
//
//   out="${TMPDIR:-/tmp}/wgmma_ws_$$" && \
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v \
//       -o "$out" scripts/wgmma_ws_torch_port.cu && "$out"
//
// (from the repository root; -Xptxas -v prints each kernel's registers and
// spills: the warp-specialised kernel reports the 168 of
// __launch_bounds__(384, 1), which setmaxnreg then moves).  Both shapes
// run the same products in the same order, so their outputs agree
// exactly.  Prints per shape and turn (two, ws, ws, two) the median ms of
// 10 calls and the TFLOP/s of the 3xTF32 (or one-pass) work, the max|d|
// between the two outputs, and one line of JSON a shape.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include <cuda_runtime.h>

#include "../artensor_tpu_torch/csrc/wgmma_core.cuh"

namespace two {

using wg::Operands;
using wg::TileAt;

// tile slot q of the block: tile blockIdx.x + q gridDim.x, the M tiles of
// one N tile next to each other (the core's order then)
__device__ __forceinline__ TileAt my_tile(const Operands& p, long long q,
                                          int BM, int BN)
{
    const long long t = blockIdx.x + q * gridDim.x;
    const long long per_w = (long long)p.n_mtiles * p.n_ntiles;
    const long long r = t % per_w;
    return TileAt{t / per_w, (int)(r % p.n_mtiles) * BM,
                  (int)(r / p.n_mtiles) * BN};
}

template <int PASSES>
struct Cfg {
    static constexpr int BM = 128, BN = 64, BK = 32, THREADS = 256;
    static constexpr int LDA = BM + 8, LDB = BN + 8;
    static constexpr int A_PART = BK * LDA, B_PART = BK * LDB;
    static constexpr int STAGE = 2 * A_PART + 2 * B_PART;
    static constexpr int PLANE = BK * BN;
    static constexpr int PLANES = (PASSES == 3 ? 4 : 2) * PLANE;
    static constexpr int STAGES = 3;
    static constexpr int SMEM = 2 * PLANES * 4 + STAGES * STAGE * 4;
};

// chunk kc of tile at: X rows [k][m], V rows [k][n], 16 bytes a cp.async
template <int PASSES>
__device__ __forceinline__ void load(const Operands& p, const TileAt& at,
                                     int kc, float* stage, int tid)
{
    using C = Cfg<PASSES>;
    const float* xr = p.xr + at.w * p.x_ws;
    const float* xi = p.xi + at.w * p.x_ws;
    const int k0 = kc * C::BK;
    const int ac = tid % (C::BM / 4), ar0 = tid / (C::BM / 4);
    const int m = at.m0 + 4 * ac;
#pragma unroll
    for (int q = 0; q < C::BK / 8; ++q) {
        const int r = ar0 + 8 * q, k = k0 + r;
        const bool ok = m < p.M && k < p.K;
        const long long off = ok ? (long long)k * p.M + m : 0;
        float* d = stage + r * C::LDA + 4 * ac;
        tc::cp16(d, xr + off, ok ? 16 : 0);
        tc::cp16(d + C::A_PART, xi + off, ok ? 16 : 0);
    }
    const int bc = tid % (C::BN / 4), br0 = tid / (C::BN / 4);
    const int n = at.n0 + 4 * bc;
    float* sb = stage + 2 * C::A_PART;
#pragma unroll
    for (int q = 0; q < C::BK / 16; ++q) {
        const int r = br0 + 16 * q, k = k0 + r;
        const bool ok = n < p.N && k < p.K;
        const long long off = ok ? (long long)k * p.N + n : 0;
        float* d = sb + r * C::LDB + 4 * bc;
        tc::cp16(d, p.vr + off, ok ? 16 : 0);
        tc::cp16(d + C::B_PART, p.vi + off, ok ? 16 : 0);
    }
}

// raw V [k][n] -> hi (lo) planes in wgmma_core.cuh's layout, 256 threads
template <int PASSES>
__device__ __forceinline__ void split_v(const float* sb, float* pl, int ct)
{
    using C = Cfg<PASSES>;
#pragma unroll
    for (int q = 0; q < C::BN * C::BK / 4 / 256; ++q) {
        const int id = ct + 256 * q;
        const int n = id % C::BN, k = 4 * (id / C::BN);
        uint32_t rh[4], rl[4], ih[4], il[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            tc::split<PASSES>(sb[(k + e) * C::LDB + n], rh[e], rl[e]);
            tc::split<PASSES>(sb[C::B_PART + (k + e) * C::LDB + n], ih[e],
                              il[e]);
        }
        const int off = (k / 8) * C::BN * 8 + (n / 8) * 64
                        + ((k % 8) / 4) * 32 + (n % 8) * 4;
        *reinterpret_cast<uint4*>(pl + off) =
            make_uint4(rh[0], rh[1], rh[2], rh[3]);
        *reinterpret_cast<uint4*>(pl + C::PLANE + off) =
            make_uint4(ih[0], ih[1], ih[2], ih[3]);
        if (PASSES == 3) {
            *reinterpret_cast<uint4*>(pl + 2 * C::PLANE + off) =
                make_uint4(rl[0], rl[1], rl[2], rl[3]);
            *reinterpret_cast<uint4*>(pl + 3 * C::PLANE + off) =
                make_uint4(il[0], il[1], il[2], il[3]);
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the earlier block: every thread copies its share STAGES - 1 chunks
// ahead, once a chunk's first wgmma are queued, and splits the next
// chunk's V into the other plane buffer while the chunk's last wgmma run
template <int PASSES>
__global__ void __launch_bounds__(256, 1) pair_two_kernel(Operands p)
{
    using C = Cfg<PASSES>;
    constexpr int BK = C::BK, LDA = C::LDA, STAGES = C::STAGES;
    constexpr int PLANE = C::PLANE, NR = C::BN / 2, BN = C::BN;
    constexpr int P = wg::PROMOTE<PASSES>;
    extern __shared__ __align__(128) float smem[];
    float* planes = smem;
    float* stages = smem + 2 * C::PLANES;
    const int tid = threadIdx.x;
    const int wgc = tid / 128, lt = tid % 128;
    const int warp = lt / 32, lane = lt % 32, g = lane / 4, t = lane % 4;
    const int row0 = 64 * wgc + 16 * warp;
    const int nks = p.n_kchunks;
    const int total = (int)((p.n_tiles - blockIdx.x + gridDim.x - 1)
                            / gridDim.x) * nks;
    const int nk8_all = (p.K + 7) / 8;
    int ld_kc = 0;
    long long ld_q = 0;
    TileAt ld_at = my_tile(p, 0, C::BM, BN);
    auto load_next = [&](int i) {
        if (i < total) {
            load<PASSES>(p, ld_at, ld_kc, stages + (i % STAGES) * C::STAGE,
                         tid);
            if (++ld_kc == nks) {
                ld_kc = 0;
                ld_at = my_tile(p, ++ld_q, C::BM, BN);
            }
        }
        tc::cp_commit();
    };
    float acc_r[NR], acc_i[NR], d_r[NR], d_i[NR];
#pragma unroll
    for (int e = 0; e < NR; ++e) {
        acc_r[e] = 0.f; acc_i[e] = 0.f; d_r[e] = 0.f; d_i[e] = 0.f;
    }
    constexpr int FRAGS = P == 1 ? 1 : BK / 8;
    uint32_t ar_h[FRAGS][4], ar_l[FRAGS][4], ai_h[FRAGS][4], ai_l[FRAGS][4];
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
        load_next(s);
    tc::cp_wait<STAGES - 2>();
    __syncthreads();
    split_v<PASSES>(stages + 2 * C::A_PART, planes, tid);
    int kc = -1;
    long long tile_q = 0;
    for (int it = 0; it < total; ++it) {
        if (++kc == nks) {
            kc = 0;
            ++tile_q;
        }
        __syncthreads();
        const float* sa = stages + (it % STAGES) * C::STAGE;
        const float* pl = planes + (it & 1) * C::PLANES;
        const int nk8 = min(BK / 8, nk8_all - kc * (BK / 8));
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
            if (j >= nk8)
                break;
            const int kk = kc * (BK / 8) + j;
            const int f = P == 1 ? 0 : j;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int a = (8 * j + t + 4 * (c >> 1)) * LDA + row0 + g
                              + 8 * (c & 1);
                tc::split<PASSES>(sa[a], ar_h[f][c], ar_l[f][c]);
                tc::split<PASSES>(sa[C::A_PART + a], ai_h[f][c], ai_l[f][c]);
            }
            const int go = kk % P ? 1 : 0;
            const float* b = pl + j * BN * 8;
            const uint64_t brh = wg::desc(b), bih = wg::desc(b + PLANE);
            wg::wg_fence();
            wg::pin<NR>(d_r);
            wg::pin<NR>(d_i);
            if (PASSES == 3) {
                const uint64_t brl = wg::desc(b + 2 * PLANE);
                const uint64_t bil = wg::desc(b + 3 * PLANE);
                wg::mma<BN, 1>(d_r, ar_l[f], brh, go);
                wg::mma<BN, 1>(d_i, ar_l[f], bih, go);
                wg::mma<BN, -1>(d_r, ai_l[f], bih, 1);
                wg::mma<BN, 1>(d_i, ai_l[f], brh, 1);
                wg::mma<BN, 1>(d_r, ar_h[f], brl, 1);
                wg::mma<BN, 1>(d_i, ar_h[f], bil, 1);
                wg::mma<BN, -1>(d_r, ai_h[f], bil, 1);
                wg::mma<BN, 1>(d_i, ai_h[f], brl, 1);
                wg::mma<BN, 1>(d_r, ar_h[f], brh, 1);
                wg::mma<BN, 1>(d_i, ar_h[f], bih, 1);
                wg::mma<BN, -1>(d_r, ai_h[f], bih, 1);
                wg::mma<BN, 1>(d_i, ai_h[f], brh, 1);
            } else {
                wg::mma<BN, 1>(d_r, ar_h[f], brh, go);
                wg::mma<BN, 1>(d_i, ar_h[f], bih, go);
                wg::mma<BN, -1>(d_r, ai_h[f], bih, 1);
                wg::mma<BN, 1>(d_i, ai_h[f], brh, 1);
            }
            wg::wg_commit();
            if (j == 0)
                load_next(it + STAGES - 1);
            if (j == nk8 - 1 && it + 1 < total) {
                tc::cp_wait<STAGES - 2>();
                asm volatile("bar.sync 1, 256;\n" ::: "memory");
                split_v<PASSES>(stages + ((it + 1) % STAGES) * C::STAGE
                                + 2 * C::A_PART,
                                planes + ((it + 1) & 1) * C::PLANES, tid);
            }
            if (kk % P == P - 1 || kk == nk8_all - 1) {
                wg::wg_wait<0>();
                wg::pin<NR>(d_r);
                wg::pin<NR>(d_i);
#pragma unroll
                for (int e = 0; e < NR; ++e) {
                    acc_r[e] += d_r[e];
                    acc_i[e] += d_i[e];
                }
            }
        }
        wg::wg_wait<0>();
        wg::pin<NR>(d_r);
        wg::pin<NR>(d_i);
        if (kc == nks - 1) {
            wg::store<wg::Cfg<false, BN, PASSES, true>>(
                p, my_tile(p, tile_q, C::BM, BN), wgc, nullptr, acc_r, acc_i);
#pragma unroll
            for (int e = 0; e < NR; ++e) {
                acc_r[e] = 0.f;
                acc_i[e] = 0.f;
            }
        }
    }
    tc::cp_wait<0>();
}

}  // namespace two

// the core's kernel, as pair.cu's pair_wgmma_kernel runs it
template <int PASSES>
__global__ void __launch_bounds__(384, 1) pair_ws_kernel(wg::Operands p)
{
    wg::gemm<wg::Cfg<false, 64, PASSES, true>>(p);
}

#define CK(x) do { cudaError_t e_ = (x); if (e_ != cudaSuccess) { \
    printf("CUDA error %s at %s:%d\n", cudaGetErrorString(e_), __FILE__, \
           __LINE__); exit(1); } } while (0)

static float median_ms(void (*run)(const wg::Operands&, int),
                       const wg::Operands& p, int W, int reps)
{
    cudaEvent_t a, b;
    CK(cudaEventCreate(&a));
    CK(cudaEventCreate(&b));
    std::vector<float> t;
    for (int r = 0; r < reps; ++r) {
        CK(cudaEventRecord(a));
        run(p, W);
        CK(cudaEventRecord(b));
        CK(cudaEventSynchronize(b));
        float ms;
        CK(cudaEventElapsedTime(&ms, a, b));
        t.push_back(ms);
    }
    std::sort(t.begin(), t.end());
    return t[t.size() / 2];
}

// the earlier shape, launched as the core launched it then: one block an
// SM, persistent
template <int PASSES>
static void run_two(const wg::Operands& q, int W)
{
    using C = two::Cfg<PASSES>;
    static bool attr = false;
    if (!attr) {
        auto kern = two::pair_two_kernel<PASSES>;
        CK(cudaFuncSetAttribute(kern,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                C::SMEM));
        attr = true;
    }
    wg::Operands p = q;
    p.n_mtiles = (p.M + C::BM - 1) / C::BM;
    p.n_ntiles = (p.N + C::BN - 1) / C::BN;
    p.n_kchunks = (p.K + C::BK - 1) / C::BK;
    p.n_tiles = (long long)W * p.n_mtiles * p.n_ntiles;
    int sms;
    CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
    const long long grid = std::min<long long>(p.n_tiles, sms);
    two::pair_two_kernel<PASSES><<<(unsigned)grid, C::THREADS, C::SMEM>>>(p);
    CK(cudaGetLastError());
}

template <int PASSES>
static void run_ws(const wg::Operands& p, int W)
{
    static unsigned attr = 0;
    const int e = wg::launch<wg::Cfg<false, 64, PASSES, true>>(
        pair_ws_kernel<PASSES>, attr, p, W, 0);
    CK((cudaError_t)e);
}

template <int PASSES>
static void compare(int K, int M, int N, int W)
{
    const size_t nx = (size_t)W * K * M, nv = (size_t)K * N,
                 ny = (size_t)W * M * N;
    std::vector<float> h(std::max(nx, nv));
    float *xr, *xi, *vr, *vi, *y0r, *y0i, *y1r, *y1i;
    CK(cudaMalloc(&xr, nx * 4)); CK(cudaMalloc(&xi, nx * 4));
    CK(cudaMalloc(&vr, nv * 4)); CK(cudaMalloc(&vi, nv * 4));
    CK(cudaMalloc(&y0r, ny * 4)); CK(cudaMalloc(&y0i, ny * 4));
    CK(cudaMalloc(&y1r, ny * 4)); CK(cudaMalloc(&y1i, ny * 4));
    unsigned s = 12345;
    auto fill = [&](float* d, size_t n) {
        for (size_t i = 0; i < n; ++i) {
            s = s * 1664525u + 1013904223u;
            h[i] = (float)((s >> 8) & 0xffff) / 32768.f - 1.f;
        }
        CK(cudaMemcpy(d, h.data(), n * 4, cudaMemcpyHostToDevice));
    };
    fill(xr, nx); fill(xi, nx); fill(vr, nv); fill(vi, nv);
    wg::Operands p{};
    p.xr = xr; p.xi = xi; p.vr = vr; p.vi = vi;
    p.M = M; p.N = N; p.K = K;
    p.x_ws = W > 1 ? (long long)K * M : 0; p.v_ws = 0;
    p.y_ws = W > 1 ? (long long)M * N : 0;
    p.ldy = N; p.F = 1; p.vec_v = true;
    wg::Operands p0 = p, p1 = p;
    p0.yr = y0r; p0.yi = y0i; p1.yr = y1r; p1.yi = y1i;
    run_two<PASSES>(p0, W);
    run_ws<PASSES>(p1, W);
    CK(cudaDeviceSynchronize());
    std::vector<float> a(ny), b(ny);
    double dmax = 0, ymax = 0;
    for (int c = 0; c < 2; ++c) {
        CK(cudaMemcpy(a.data(), c ? y0i : y0r, ny * 4,
                      cudaMemcpyDeviceToHost));
        CK(cudaMemcpy(b.data(), c ? y1i : y1r, ny * 4,
                      cudaMemcpyDeviceToHost));
        for (size_t i = 0; i < ny; ++i) {
            dmax = std::max(dmax, (double)std::abs(a[i] - b[i]));
            ymax = std::max(ymax, (double)std::abs(a[i]));
        }
    }
    float t[4];
    t[0] = median_ms(run_two<PASSES>, p0, W, 10);
    t[1] = median_ms(run_ws<PASSES>, p1, W, 10);
    t[2] = median_ms(run_ws<PASSES>, p1, W, 10);
    t[3] = median_ms(run_two<PASSES>, p0, W, 10);
    const double work = (PASSES == 3 ? 3.0 : 1.0) * 8.0 * M * N * K * W;
    auto tf = [&](float ms) { return work / (ms * 1e-3) / 1e12; };
    printf("Pair K %d M %d N %d width %d passes %d: two %.4f / %.4f ms "
           "(%.1f TFLOP/s), ws %.4f / %.4f ms (%.1f TFLOP/s); max|d| %.3e "
           "of max|y| %.3e\n", K, M, N, W, PASSES, t[0], t[3],
           tf(std::min(t[0], t[3])), t[1], t[2], tf(std::min(t[1], t[2])),
           dmax, ymax);
    printf("{\"K\": %d, \"M\": %d, \"N\": %d, \"width\": %d, \"passes\": "
           "%d, \"two_ms\": [%.4f, %.4f], \"ws_ms\": [%.4f, %.4f], "
           "\"max_abs_d\": %.3e}\n", K, M, N, W, PASSES, t[0], t[3], t[1],
           t[2], dmax);
    cudaFree(xr); cudaFree(xi); cudaFree(vr); cudaFree(vi);
    cudaFree(y0r); cudaFree(y0i); cudaFree(y1r); cudaFree(y1i);
}

int main()
{
    compare<3>(1024, 4096, 4096, 1);
    compare<3>(1024, 4096, 4096, 8);
    compare<3>(512, 32768, 256, 2);
    compare<1>(1024, 4096, 4096, 8);
    return 0;
}
