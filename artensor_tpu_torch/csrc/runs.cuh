// Launches that ran on the card, counted by the kernels themselves.
//
// Each kernel's first thread (thread 0 of block (0, 0, 0)) adds one to its
// slot of its source's __device__ counter array, so a replay of a captured
// CUDA graph counts as an eager launch does, and a capture counts nothing.
// Each source's C entry point <source>_runs copies its slots to the host
// (kernels.device_runs); chip_smoke.py and the card tests hold them to a
// scheme's census.  One atomic add a launch.

#pragma once

#include <cuda_runtime.h>

namespace runs {

__device__ __forceinline__ void count(unsigned long long* slot)
{
    if (threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0 &&
        blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
        atomicAdd(slot, 1ULL);
}

}  // namespace runs
