// The gated edge message of an edge MLP on pre-activations, on the CUDA
// cores: edge_mlp_agg.cu's edge stage (row 9 of the port's kernel table).
// Per row i and slot k, with z[i,k] the summed pre-activation:
//   m  = silu(silu(z[i,k]) @ W1 + b1) @ W2 + b2
//   aggp[i][chunk] = sum over the chunk's slots with mask[i,k] of
//                    h_src[i,k] * m
// A masked slot contributes exactly 0, whatever its message.
//
// A block of W threads (one per channel) runs a chunk of KC slots of one
// row through the two products as fp32 FMAs against shared-memory tiles
// (tile.cuh); h_src's rows are read at slot i*K + k with plain loads. A
// chunk with no live slot (lists are nearest first, so the tail chunks of
// a row) writes a zero partial and stops. chunk_sum_kernel (tile.cuh) then
// adds a row's chunks in a fixed order: no atomics, the same result from
// run to run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

// theta_edge's weights, W1 [H,H], W2 [H,D] and their biases, row-major
// (in x out).
struct ThetaWeights {
  const float *w1, *b1, *w2, *b2;
};

// grid (ceil(K/KC), M), block W: one chunk of KC slots of row i; z and
// h_src are [M*K, W].
__global__ void __launch_bounds__(W)
edge_msg_kernel(const float* __restrict__ z, const uint8_t* __restrict__ mask,
                ThetaWeights p, int k, const float* __restrict__ h_src,
                float* __restrict__ aggp) {
  __shared__ __align__(16) float buf_a[W * KC];
  __shared__ __align__(16) float buf_b[W * KC];
  __shared__ int live_s[KC];
  const int i = blockIdx.y, k0 = blockIdx.x * KC, c = threadIdx.x;
  const size_t row0 = (size_t)i * k + k0;

  int live = 0;
  if (c < KC) {
    live = k0 + c < k && mask[row0 + c];
    live_s[c] = live;
  }
  float* out = aggp + ((size_t)i * gridDim.x + blockIdx.x) * W + c;
  if (!__syncthreads_or(live)) {
    *out = 0.f;
    return;
  }
  float acc[KC];
#pragma unroll
  for (int m = 0; m < KC; ++m)
    acc[m] = silu((k0 + m < k) ? z[(row0 + m) * W + c] : 0.f);
  store_tile<KC>(buf_a, acc);
  __syncthreads();
  matmul_tile<KC>(buf_a, p.w1, p.b1[c], acc);
#pragma unroll
  for (int m = 0; m < KC; ++m) acc[m] = silu(acc[m]);
  store_tile<KC>(buf_b, acc);
  __syncthreads();
  matmul_tile<KC>(buf_b, p.w2, p.b2[c], acc);

  float s = 0.f;
#pragma unroll
  for (int m = 0; m < KC; ++m)
    if (live_s[m]) s += h_src[(row0 + m) * W + c] * acc[m];
  *out = s;
}

}  // namespace
