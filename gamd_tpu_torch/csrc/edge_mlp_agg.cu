// The gated, masked neighbour sum of an edge MLP on pre-activations, for
// Hopper (sm_90a): the kernel behind gamd_tpu_torch.ops.message's
// fused_edge_mlp_aggregate.
//
// Replaces gamd_tpu/ops/pallas_mp.py::_fused_mlp_agg_kernel (line 104,
// pallas_call at line 125). Per row i of N nodes and slot k:
//   m  = silu(silu(edge_pre[i,k]) @ W1 + b1) @ W2 + b2   (theta_edge)
//   agg[i] = sum over k with mask[i,k] of h_src[i,k] * m
// A masked slot contributes exactly 0, whatever it holds.
//
// What bounds it on this card: the two 128x128 products, 65,792 FLOP a
// live edge; at the training slice (about 5,500 live edges) about 0.36
// GFLOP, 5.4 us at the 67 TFLOP/s fp32 peak, against edge_pre and h_src at
// the live slots (5.6 MB, 1.7 us at 3.35 TB/s): operations-bound.
//
// What the design does about it, for now: it is edge_msg.cuh's
// edge_msg_kernel, the rows of slot (i, k) read at i*K + k: one thread per
// channel, 16 slots a block, fp32 FMAs against shared-memory tiles, chunks
// without a live slot exiting at once. chunk_sum_kernel adds a row's chunk
// partials in a fixed order. Two launches a call.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; gamd_edge_mlp_agg returns the first non-zero
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_msg.cuh"
#include "tile.cuh"

// agg [N, W] from edge_pre, h_src [N*K, W] and mask [N*K]; aggp
// [N, ceil(K/KC), W] is scratch. Returns 0, or the first non-zero
// cudaError_t seen after a launch.
extern "C" int gamd_edge_mlp_agg(
    const float* edge_pre, const float* h_src, const uint8_t* mask,
    const float* w1, const float* b1, const float* w2, const float* b2, int n,
    int k, float* aggp, float* agg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ThetaWeights p{w1, b1, w2, b2};
  const int n_chunk = (k + KC - 1) / KC;
  cudaError_t err;
  edge_msg_kernel<<<dim3(n_chunk, n), W, 0, s>>>(edge_pre, mask, p, k, h_src,
                                                 aggp);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chunk_sum_kernel<<<n, W, 0, s>>>(aggp, n_chunk, agg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return 0;
}
