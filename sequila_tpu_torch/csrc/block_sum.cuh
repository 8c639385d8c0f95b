// Block-wide sum of one 64-bit value a thread into a global total: warp
// shuffles, one shared-memory pass and one atomicAdd per block.  Shared by
// the rank kernels' reduce mode, so that count(*) reads back one scalar.
// Every thread of the block must call it (it synchronises the block).

#pragma once

#include <cuda_runtime.h>

template <int kThreads>
__device__ __forceinline__ void block_sum_to(unsigned long long r,
                                             unsigned long long* total) {
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps, one pass");
  __shared__ unsigned long long warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) r += __shfl_down_sync(0xffffffffu, r, off);
  if (lane == 0) warp_sums[warp] = r;
  __syncthreads();
  if (warp == 0) {
    r = lane < kThreads / 32 ? warp_sums[lane] : 0ull;
    for (int off = 16; off > 0; off >>= 1) r += __shfl_down_sync(0xffffffffu, r, off);
    if (lane == 0 && r != 0) atomicAdd(total, r);
  }
}
