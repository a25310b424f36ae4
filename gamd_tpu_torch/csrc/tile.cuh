// Device helpers shared by the port's CUDA-core kernels (conv_msg_gather.cu,
// conv_msg_gather_bwd.cu, the edge message, the encoder, the node stages
// of mega_forward.cu): one thread per output
// channel of a 128-wide layer, activations of a tile of M rows held in
// shared memory feature-major ([W][M]), fp32 FMAs, fixed summation order.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int W = 128;   // every feature width; one thread per channel
constexpr int KC = 16;   // edges per block in the edge stages
constexpr int NWARP = W / 32;

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

// acc[m] = bias + sum_j in_s[j][m] * w[j][c] for the calling thread's
// channel c. in_s is a shared tile [W][M] (feature-major), w is [W][W]
// row-major (in x out).
template <int M>
__device__ __forceinline__ void matmul_tile(const float* __restrict__ in_s,
                                            const float* __restrict__ w,
                                            float bias, float (&acc)[M]) {
  const int c = threadIdx.x;
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = bias;
#pragma unroll 4
  for (int j = 0; j < W; ++j) {
    const float wj = __ldg(w + j * W + c);
    const float4* row = reinterpret_cast<const float4*>(in_s + j * M);
#pragma unroll
    for (int q = 0; q < M / 4; ++q) {
      const float4 v = row[q];
      acc[4 * q + 0] = fmaf(v.x, wj, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(v.y, wj, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, wj, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, wj, acc[4 * q + 3]);
    }
  }
}

// out_s[c][m] = v[m] for the calling thread's channel c.
template <int M>
__device__ __forceinline__ void store_tile(float* __restrict__ out_s,
                                           const float (&v)[M]) {
  float4* row = reinterpret_cast<float4*>(out_s + threadIdx.x * M);
#pragma unroll
  for (int q = 0; q < M / 4; ++q)
    row[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
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

// out[i][c] = sum over q < n_chunk of part[i][q][c], q in increasing order:
// the fixed-order second pass of a per-chunk partial sum. grid n, block W.
__global__ void __launch_bounds__(W)
chunk_sum_kernel(const float* __restrict__ part, int n_chunk,
                 float* __restrict__ out) {
  const int i = blockIdx.x, c = threadIdx.x;
  const float* p = part + (size_t)i * n_chunk * W + c;
  float s = 0.f;
  for (int q = 0; q < n_chunk; ++q) s += p[q * W];
  out[(size_t)i * W + c] = s;
}

}  // namespace
