// The gated edge message of one conv layer on the CUDA cores, shared by the
// op library's kernels: conv_layer.cu (source rows gathered by node id,
// clamped), conv_msg.cu (rows gathered beforehand) and edge_mlp_agg.cu (no
// edge affine). Per row i and slot k, with r = rows.row(i, i*K + k) the
// source row:
//   z  = silu(e[i,k] @ W1 + b1) @ W2 + b2 + src[r] + dst[i]
//        (with kEdgeAffine false: z = e[i,k], the summed pre-activation)
//   m  = silu(silu(z) @ W3 + b3) @ W4 + b4
//   aggp[i][chunk] = sum over the chunk's slots with mask[i,k] of hn[r] * m
// A masked slot contributes exactly 0, whatever its message.
//
// A block of W threads (one per channel) runs a chunk of KC slots of one
// row through the four products as fp32 FMAs against shared-memory tiles
// (tile.cuh); source rows are read with plain loads. A chunk with no live
// slot (lists are nearest first, so the tail chunks of a row) writes a
// zero partial and stops. chunk_sum_kernel (tile.cuh) then adds a row's
// chunks in a fixed order: no atomics, the same result from run to run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

// Weights of the edge pipeline: W1 [E,H], W2 [H,H], W3 [H,H], W4 [H,D] and
// their biases, row-major (in x out).
struct ConvWeights {
  const float *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4;
};

// Source rows by global node id (hn and src [M, W], idx [M*K]) under
// JAX's rule for an id out of range (jnp indexing): a negative id counts
// from the end, then ids clamp into [0, n). Any id is then safe to read,
// which a masked slot's need not be.
struct ClampedRows {
  const int* idx;
  const float* hn;
  const float* src;
  int n;
  static constexpr int stride = W;
  __device__ __forceinline__ int row(int, size_t slot) const {
    int j = idx[slot];
    if (j < 0) j += n;
    return min(max(j, 0), n - 1);
  }
};

// Rows gathered beforehand: hn and src are [M*K, W] (h_src and src_code),
// and slot (i, k) reads row i*K + k.
struct PreRows {
  const float* hn;
  const float* src;
  static constexpr int stride = W;
  __device__ __forceinline__ int row(int, size_t slot) const {
    return static_cast<int>(slot);
  }
};

// grid (ceil(K/KC), M), block W: one chunk of KC slots of row i. With
// kEdgeAffine false, e holds z itself and W1, b1, W2, b2, dst and rows.src
// are not read.
template <class Rows, bool kEdgeAffine = true>
__global__ void __launch_bounds__(W)
edge_msg_kernel(const float* __restrict__ e, const uint8_t* __restrict__ mask,
                const float* __restrict__ dst, ConvWeights p, int k,
                Rows rows, float* __restrict__ aggp) {
  __shared__ __align__(16) float buf_a[W * KC];
  __shared__ __align__(16) float buf_b[W * KC];
  __shared__ int idx_s[KC];
  __shared__ int live_s[KC];
  const int i = blockIdx.y, k0 = blockIdx.x * KC, c = threadIdx.x;
  const size_t row0 = (size_t)i * k + k0;

  int live = 0;
  if (c < KC) {
    const int kk = k0 + c;
    live = kk < k && mask[row0 + c];
    // A slot past K (masked) reads the chunk's first source row.
    idx_s[c] = rows.row(i, kk < k ? row0 + c : row0);
    live_s[c] = live;
  }
  float* out = aggp + ((size_t)i * gridDim.x + blockIdx.x) * W + c;
  if (!__syncthreads_or(live)) {
    *out = 0.f;
    return;
  }
  float acc[KC];
  if constexpr (kEdgeAffine) {
    {
      float x[KC];
#pragma unroll
      for (int m = 0; m < KC; ++m)
        x[m] = (k0 + m < k) ? e[(row0 + m) * W + c] : 0.f;
      store_tile<KC>(buf_a, x);
    }
    __syncthreads();

    matmul_tile<KC>(buf_a, p.w1, p.b1[c], acc);
#pragma unroll
    for (int m = 0; m < KC; ++m) acc[m] = silu(acc[m]);
    store_tile<KC>(buf_b, acc);
    __syncthreads();
    matmul_tile<KC>(buf_b, p.w2, p.b2[c], acc);
    {
      const float dc = dst[(size_t)i * W + c];
#pragma unroll
      for (int m = 0; m < KC; ++m)
        acc[m] = silu(acc[m] + rows.src[(size_t)idx_s[m] * Rows::stride + c]
                      + dc);
    }
  } else {
#pragma unroll
    for (int m = 0; m < KC; ++m)
      acc[m] = silu((k0 + m < k) ? e[(row0 + m) * W + c] : 0.f);
  }
  // buf_a was last read before a barrier above (or never): free to
  // overwrite.
  store_tile<KC>(buf_a, acc);
  __syncthreads();
  matmul_tile<KC>(buf_a, p.w3, p.b3[c], acc);
#pragma unroll
  for (int m = 0; m < KC; ++m) acc[m] = silu(acc[m]);
  store_tile<KC>(buf_b, acc);
  __syncthreads();
  matmul_tile<KC>(buf_b, p.w4, p.b4[c], acc);

  float s = 0.f;
#pragma unroll
  for (int m = 0; m < KC; ++m)
    if (live_s[m])
      s += rows.hn[(size_t)idx_s[m] * Rows::stride + c] * acc[m];
  *out = s;
}

}  // namespace
