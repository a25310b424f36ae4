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
// What the design does about it, for now: the edge stage is
// edge_msg.cuh's edge_msg_kernel (the fp32 edge stage the whole-model
// forward used before its tensor-core redesign, with the mask given), with
// the source rows gathered by node id. Hopper reads rows natively, so the
// TPU kernel's one-hot MXU gathers, hi/lo bf16 split and VMEM-resident
// node table have no counterpart. Each
// block writes one partial sum per chunk of 16 slots; chunk_sum_kernel
// adds a row's chunks in a fixed order: no atomics, the same result from
// run to run. wgmma, TMA and bf16 operands are later work. Two launches a
// call.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; gamd_conv_msg_gather returns the first
// non-zero cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_msg.cuh"
#include "tile.cuh"

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
  edge_msg_kernel<<<dim3(n_chunk, m), W, 0, s>>>(
      e, mask, dst, p, k, GatherRows{idx, hn, src}, aggp);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chunk_sum_kernel<<<m, W, 0, s>>>(aggp, n_chunk, agg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return 0;
}
