// One whole conv layer (edge pipeline with the neighbour gathers, node
// update and residual) for Hopper (sm_90a): the kernel behind
// gamd_tpu_torch.ops.message's fused_conv_layer.
//
// Replaces gamd_tpu/ops/pallas_mp.py::_conv_layer_kernel (line 735,
// pallas_call at line 810). Per row i of N nodes, with r = idx[i,k] read
// as JAX reads it (negative from the end, then clamped into [0, N)):
//   z  = silu(e[i,k] @ W1 + b1) @ W2 + b2 + src[r] + dst[i]
//   m  = silu(silu(z) @ W3 + b3) @ W4 + b4
//   agg[i] = sum over k with mask[i,k] of hn[r] * m
//   out[i] = h[i] + silu(hn[i] @ Wpd + bpd + agg[i] @ Wpe + bpe) @ Wp + bp
// A masked slot contributes exactly 0, whatever it holds.
//
// What bounds it on this card: the edge products as in conv_msg_gather.cu
// (131,328 FLOP a live edge, about 0.72 GFLOP at the training slice's
// 5,500 live edges) plus three 128x128 node products (25 MFLOP at N=258):
// about 11 us at the 67 TFLOP/s fp32 peak, against e at the live slots
// and the node arrays (2.9 MB, 0.9 us at 3.35 TB/s): operations-bound.
//
// What the design does about it, for now: the edge stage is edge_msg.cuh's
// edge_msg_kernel with the gathered rows clamped (ClampedRows), and the
// node update is node_update.cuh's update_kernel, which adds each row's
// chunk partials in a fixed order and writes h + the update into a new
// array (the JAX function returns a new array; h is not touched). The TPU
// kernel's one-hot MXU gathers, hi/lo bf16 split, bf16 products and
// node-table padding have no counterpart: Hopper reads rows natively and
// the products are fp32 FMAs. Two launches a call.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; gamd_conv_layer returns the first non-zero
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_msg.cuh"
#include "node_update.cuh"
#include "tile.cuh"

// out [N, W] from e [N*K, W], idx [N*K], mask [N*K], h, hn, src, dst
// [N, W] and the 14 weights; aggp [N, ceil(K/KC), W] is scratch. Returns 0,
// or the first non-zero cudaError_t seen after a launch.
extern "C" int gamd_conv_layer(
    const float* e, const int* idx, const uint8_t* mask, const float* h,
    const float* hn, const float* src, const float* dst, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* w3,
    const float* b3, const float* w4, const float* b4, const float* wpd,
    const float* bpd, const float* wpe, const float* bpe, const float* wp,
    const float* bp, int n, int k, float* aggp, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvWeights p{w1, b1, w2, b2, w3, b3, w4, b4};
  const UpdateWeights upd{wpd, bpd, wpe, bpe, wp, bp};
  const int n_chunk = (k + KC - 1) / KC;
  cudaError_t err;
  edge_msg_kernel<<<dim3(n_chunk, n), W, 0, s>>>(
      e, mask, dst, p, k, ClampedRows{idx, hn, src, n}, aggp);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  update_kernel<<<(n + NB - 1) / NB, W, 0, s>>>(h, hn, aggp, n_chunk, upd, n,
                                                out);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return 0;
}
