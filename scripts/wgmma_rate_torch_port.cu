// The tensor cores' rate for the wgmma form the port's core issues
// (csrc/wgmma_core.cuh): m64nNk8 TF32, A from registers, B from shared
// memory, 12 wgmma a group, with one, two or three warpgroups a block and
// one block an SM, waiting for every group or never.  Nothing but wgmma
// runs: the ceiling the core's loop can reach on the card.
//
//   out="${TMPDIR:-/tmp}/wgmma_rate_$$" && \
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o "$out" scripts/wgmma_rate_torch_port.cu && "$out"
//
// (from the repository root).  Prints one line a configuration: FMA a
// clock an SM (clock64 of the block) and TFLOP/s over the card.
#include <cstdio>
#include <cuda_runtime.h>
#include "../artensor_tpu_torch/csrc/wgmma_core.cuh"

template <int BN, int NWG>
__global__ void __launch_bounds__(384, 1) bench(int iters, int wait_every, unsigned long long* cyc, float* sink)
{
    extern __shared__ __align__(128) float smem[];
    for (int i = threadIdx.x; i < 4 * 32 * BN; i += blockDim.x) smem[i] = 0.001f * (i % 7);
    __syncthreads();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int wgc = threadIdx.x / 128;
    float d[BN / 2];
    for (int e = 0; e < BN / 2; ++e) d[e] = 0.f;
    uint32_t a[4] = {0x3f800000u, 0x3f800000u, 0x3f800000u, 0x3f800000u};
    unsigned long long t0 = clock64();
    if (wgc < NWG) {
        for (int i = 0; i < iters; ++i) {
            wg::wg_fence();
            wg::pin<BN / 2>(d);
#pragma unroll
            for (int q = 0; q < 12; ++q)
                wg::mma<BN, 1>(d, a, wg::desc(smem + (q % 4) * 8 * BN), 1);
            wg::wg_commit();
            if (i % wait_every == wait_every - 1) {
                wg::wg_wait<0>();
                wg::pin<BN / 2>(d);
            }
        }
        wg::wg_wait<0>();
        wg::pin<BN / 2>(d);
    }
    __syncthreads();
    unsigned long long t1 = clock64();
    if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
    float s = 0; for (int e = 0; e < BN / 2; ++e) s += d[e];
    if (s == 12345.f) sink[threadIdx.x] = s;
}

template <int BN, int NWG>
void run(int iters, int we, int blocks) {
    unsigned long long* cyc; float* sink;
    cudaMalloc(&cyc, 8 * 1024); cudaMalloc(&sink, 4 * 1024);
    size_t sm = 4 * 32 * BN * 4;
    bench<BN, NWG><<<blocks, 128 * (NWG > 2 ? NWG : 2), sm>>>(iters, we, cyc, sink);
    cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
    cudaEventRecord(a);
    bench<BN, NWG><<<blocks, 128 * (NWG > 2 ? NWG : 2), sm>>>(iters, we, cyc, sink);
    cudaEventRecord(b); cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b);
    unsigned long long c; cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
    double fma = (double)NWG * iters * 12 * 64.0 * BN * 8;   // per block
    printf("BN %d WGs %d wait_every %d: %.1f FMA/clk/SM (cycles %llu), %.1f TFLOP/s over %d blocks, err %s\n",
           BN, NWG, we, fma / c, 2 * fma * blocks / (ms * 1e-3) / 1e12, c, blocks,
           cudaGetErrorString(cudaGetLastError()));
}

int main() {
    int sms;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    for (int we : {1, 1000000}) {
        run<64, 1>(4096, we, sms);
        run<64, 2>(4096, we, sms);
        run<64, 3>(4096, we, sms);
        run<32, 2>(4096, we, sms);
        run<32, 3>(4096, we, sms);
    }
    return 0;
}
