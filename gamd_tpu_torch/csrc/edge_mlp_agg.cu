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
// What bounds it on this card: at the op library's shape (LJ-258, K=96,
// every width 128) a frame has about 5,500 live edges of 24,768 slots; the
// two 128x128 products, as three bf16 passes on the tensor cores, need
// about 1.1 GFLOP, about 1.1 us at 989 TFLOP/s, and the epilogues about
// 0.1 us more on the fp32 cores, against reading edge_pre and h_src at the
// live slots, the mask and the weights and writing agg (5.9 MB, 1.8 us at
// 3.35 TB/s): bytes-bound.
//
// What the design does about it: conv_msg.cu's (row 8) with the stage
// policy ThetaStages: the live slots laid out from the mask, so that
// masked slots cost nothing past the layout; the two weights split once a
// call and, with two weight buffers, resident in a block for all its
// tiles; tiles of 64 live edges, silu(edge_pre) staged as bf16 hi and lo,
// through the two products on wgmma (bf16 x 3, fp32-faithful to about
// 2^-16; the TPU kernel runs them in single-pass bf16 over every slot);
// slot (i, k) reads h_src at row i*K + k (PreSrc); each atom's rows summed
// in a fixed order, no atomics. Five launches a call: the layout's two,
// the split, the tiles and the fix-up (csrc/conv_tc.cuh).
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; gamd_edge_mlp_agg returns the first non-zero
// error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tc.cuh"

// agg [N, W] from edge_pre, h_src [N*K, W], mask [N*K] and theta_edge's
// weights; lay, wsplit (two split weights) and part are scratch
// (ops/edge_tiles.py), the plan ops/edge_tiles.py::launch_plan's. Returns
// 0, a cudaError_t (cudaErrorInvalidValue for a shape or plan it does not
// take), or 100000 + the CUresult of the TMA map's encoding.
extern "C" int gamd_edge_mlp_agg(
    const float* edge_pre, const float* h_src, const uint8_t* mask,
    const float* w1, const float* b1, const float* w2, const float* b2,
    int n, int k, const SlotLayout* lay, void* wsplit, float* part, int grid,
    int threads, int smem, int nbuf, float* agg, void* stream) {
  if (n <= 0 || k <= 0 || (long long)n * k >= (1LL << 31))
    return cudaErrorInvalidValue;
  const TilePlan plan{grid, threads, smem, nbuf};
  if (!plan_ok(plan, n, k)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_mask_layout(mask, n, k, *lay, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EdgeWeights w{{w1, w2, nullptr, nullptr}, {b1, b2, nullptr, nullptr}};
  return run_conv_tiles<PreSrc, ThetaStages>(
      edge_pre, nullptr, w, PreSrc{h_src, nullptr}, *lay, wsplit, part, n, k,
      plan, agg, s);
}
