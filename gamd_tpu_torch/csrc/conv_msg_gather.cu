// One conv layer's edge pipeline with the neighbour gathers inside, for
// Hopper (sm_90a): the forward of gamd_tpu_torch.ops.conv_gather's
// fused_conv_gather_message.
//
// Replaces gamd_tpu/ops/pallas_mp.py::_conv_msg_gather_kernel (line 370,
// pallas_call at line 437). Per row i of M nodes (a batch of B graphs of N
// nodes is one graph of B*N nodes with idx offset by b*N) and slot k:
//   z  = silu(e[i,k] @ W1 + b1) @ W2 + b2 + src[idx[i,k]] + dst[i]
//   m  = silu(silu(z) @ W3 + b3) @ W4 + b4
//   agg[i] = sum over k with mask[i,k] of hn[idx[i,k]] * m
// A masked slot contributes exactly 0, whatever its message.
//
// What bounds it on this card: at the training slice (LJ-258, K=96, every
// width 128) a frame has about 5,500 live edges of 24,768 slots; the four
// 128x128 edge products need about 0.72 GFLOP, about 11 us at the 67
// TFLOP/s fp32 peak, against reading e (12.7 MB, about 4 us at 3.35 TB/s):
// operations-bound.
//
// What the design does about it, for now: it is mega_forward.cu's
// edge_kernel with the mask given instead of computed. A block of 128
// threads (one per channel) runs a chunk of KC=16 slots of one row through
// the four products as fp32 FMAs against shared-memory tiles (tile.cuh);
// rows are gathered with plain loads (Hopper reads rows natively, so the
// TPU kernel's one-hot MXU gathers, hi/lo bf16 split and VMEM-resident node
// table have no counterpart). A chunk with no live slot (the list is
// nearest first, so the tail chunks of a row) writes a zero partial and
// stops. Each block writes one partial sum per chunk; a second kernel adds
// a row's chunks in a fixed order: no atomics, the same result from run to
// run. wgmma, TMA and bf16 operands are later work. Two launches a call.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; gamd_conv_msg_gather returns the first
// non-zero cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

// Weights of the edge pipeline: W1 [E,H], W2 [H,H], W3 [H,H], W4 [H,D] and
// their biases, row-major (in x out).
struct ConvWeights {
  const float *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4;
};

// grid (ceil(K/KC), M), block W: one chunk of KC slots of row i.
__global__ void __launch_bounds__(W)
conv_edge_kernel(const float* __restrict__ e, const int* __restrict__ idx,
                 const uint8_t* __restrict__ mask,
                 const float* __restrict__ hn, const float* __restrict__ src,
                 const float* __restrict__ dst, ConvWeights p, int k,
                 float* __restrict__ aggp) {
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
    idx_s[c] = kk < k ? idx[row0 + c] : i;
    live_s[c] = live;
  }
  float* out = aggp + ((size_t)i * gridDim.x + blockIdx.x) * W + c;
  if (!__syncthreads_or(live)) {
    *out = 0.f;
    return;
  }
  {
    float x[KC];
#pragma unroll
    for (int m = 0; m < KC; ++m)
      x[m] = (k0 + m < k) ? e[(row0 + m) * W + c] : 0.f;
    store_tile<KC>(buf_a, x);
  }
  __syncthreads();

  float acc[KC];
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
      acc[m] = silu(acc[m] + src[(size_t)idx_s[m] * W + c] + dc);
  }
  // buf_a was last read before the barrier above: free to overwrite.
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
    if (live_s[m]) s += hn[(size_t)idx_s[m] * W + c] * acc[m];
  *out = s;
}

}  // namespace

// agg [M, W] from e [M*K, W], idx [M*K] (global node ids), mask [M*K],
// hn/src/dst [M, W]; aggp [M, ceil(K/KC), W] is scratch. Returns 0, or the
// first non-zero cudaError_t seen after a launch.
extern "C" int gamd_conv_msg_gather(
    const float* e, const int* idx, const uint8_t* mask, const float* hn,
    const float* src, const float* dst, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* w4, const float* b4, int m, int k, float* aggp, float* agg,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvWeights p{w1, b1, w2, b2, w3, b3, w4, b4};
  const int n_chunk = (k + KC - 1) / KC;
  cudaError_t err;
  conv_edge_kernel<<<dim3(n_chunk, m), W, 0, s>>>(e, idx, mask, hn, src, dst,
                                                  p, k, aggp);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chunk_sum_kernel<<<m, W, 0, s>>>(aggp, n_chunk, agg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return 0;
}
