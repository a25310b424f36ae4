// One conv layer's edge pipeline on rows gathered beforehand, for Hopper
// (sm_90a): the kernel behind gamd_tpu_torch.ops.message's
// fused_conv_message.
//
// Replaces gamd_tpu/ops/pallas_mp.py::_conv_msg_kernel (line 212,
// pallas_call at line 264). Per row i of N nodes and slot k:
//   z  = silu(e[i,k] @ W1 + b1) @ W2 + b2 + src_code[i,k] + dst[i]
//   m  = silu(silu(z) @ W3 + b3) @ W4 + b4
//   agg[i] = sum over k with mask[i,k] of h_src[i,k] * m
// A masked slot contributes exactly 0, whatever it holds.
//
// What bounds it on this card: the four 128x128 edge products, 131,328
// FLOP a live edge; at the training slice (LJ-258, K=96, about 5,500 live
// edges of 24,768 slots) about 0.72 GFLOP, 11 us at the 67 TFLOP/s fp32
// peak, against e, h_src and src_code at the live slots (8.4 MB, 2.5 us
// at 3.35 TB/s): operations-bound.
//
// What the design does about it, for now: the edge stage is
// edge_msg.cuh's edge_msg_kernel, conv_msg_gather.cu's own, with the rows
// of slot (i, k) read at i*K + k (PreRows) instead of gathered by node id,
// so on the same rows the two kernels give the same bits. The TPU
// kernel's bf16 products and tile padding have no counterpart: products
// are fp32 FMAs, and the grid runs over rows. chunk_sum_kernel adds a
// row's chunk partials in a fixed order. Two launches a call.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; gamd_conv_msg returns the first non-zero
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_msg.cuh"
#include "tile.cuh"

// agg [N, W] from e, h_src, src_code [N*K, W], dst [N, W], mask [N*K];
// aggp [N, ceil(K/KC), W] is scratch. Returns 0, or the first non-zero
// cudaError_t seen after a launch.
extern "C" int gamd_conv_msg(
    const float* e, const float* h_src, const float* src_code,
    const float* dst, const uint8_t* mask, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* w4, const float* b4, int n, int k, float* aggp, float* agg,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvWeights p{w1, b1, w2, b2, w3, b3, w4, b4};
  const int n_chunk = (k + KC - 1) / KC;
  cudaError_t err;
  edge_msg_kernel<<<dim3(n_chunk, n), W, 0, s>>>(
      e, mask, dst, p, k, PreRows{h_src, src_code}, aggp);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chunk_sum_kernel<<<n, W, 0, s>>>(aggp, n_chunk, agg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return 0;
}
