// The node update of one conv layer, conv_layer.cu's (one layer, into a new
// array): with agg[i] the sum of row i's per-chunk partials aggp,
//   h_out = h_in + silu(hn @ Wpd + bpd + agg @ Wpe + bpe) @ Wp + bp
// One thread per channel, NB rows a block; the chunks are added in a fixed
// order, so the result does not vary from run to run.

#pragma once

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int NB = 8;    // atoms per block in the node stages

// Weights of the update: Wpd, Wpe [W,W] and Wp [W,W], row-major (in x out),
// and their biases [W].
struct UpdateWeights {
  const float *w_pd, *b_pd, *w_pe, *b_pe, *w_p, *b_p;
};

// grid ceil(n/NB), block W. h_out may be h_in (an update in place); no other
// argument may alias an output.
__global__ void __launch_bounds__(W)
update_kernel(const float* h_in, const float* __restrict__ hn,
              const float* __restrict__ aggp, int n_chunk, UpdateWeights p,
              int n, float* h_out) {
  __shared__ __align__(16) float buf_h[W * NB];
  __shared__ __align__(16) float buf_g[W * NB];
  const int a0 = blockIdx.x * NB, c = threadIdx.x;

  {
    float x[NB], g[NB];
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      x[m] = 0.f;
      g[m] = 0.f;
      if (a0 + m < n) {
        x[m] = hn[(a0 + m) * W + c];
        const float* ap = aggp + (size_t)(a0 + m) * n_chunk * W + c;
        for (int q = 0; q < n_chunk; ++q) g[m] += ap[q * W];
      }
    }
    store_tile<NB>(buf_h, x);
    store_tile<NB>(buf_g, g);
  }
  __syncthreads();

  float acc[NB], acc2[NB];
  matmul_tile<NB>(buf_h, p.w_pd, p.b_pd[c], acc);
  matmul_tile<NB>(buf_g, p.w_pe, p.b_pe[c], acc2);
#pragma unroll
  for (int m = 0; m < NB; ++m) acc[m] = silu(acc[m] + acc2[m]);
  __syncthreads();
  store_tile<NB>(buf_h, acc);
  __syncthreads();
  matmul_tile<NB>(buf_h, p.w_p, p.b_p[c], acc);
#pragma unroll
  for (int m = 0; m < NB; ++m)
    if (a0 + m < n) h_out[(a0 + m) * W + c] = h_in[(a0 + m) * W + c] + acc[m];
}

}  // namespace
