// Device helpers of the port's CUDA-core kernels (the node stages of
// mega_forward.cu, through node_fused.cuh): one thread per
// output channel of a 128-wide layer, fp32 arithmetic, fixed summation
// order.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int W = 128;   // every feature width; one thread per channel
constexpr int NWARP = W / 32;

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

// v[m] <- sum over the block's W channels of v[m], for every m. red holds
// NWARP * M floats. Fixed reduction order: the result does not vary.
template <int M>
__device__ __forceinline__ void block_sum(float (&v)[M], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float s = v[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp * M + m] = s;
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float s = red[m];
#pragma unroll
    for (int q = 1; q < NWARP; ++q) s += red[q * M + m];
    v[m] = s;
  }
  __syncthreads();
}

}  // namespace
