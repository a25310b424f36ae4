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
// What bounds it on this card: at the deployment's shape (LJ-258, K=96,
// every width 128) a frame has about 5,500 live edges of 24,768 slots; the
// four 128x128 edge products, as three bf16 passes on the tensor cores,
// need about 2.2 GFLOP, about 2.2 us at 989 TFLOP/s, and the epilogues
// about 0.2 us more on the fp32 cores, against reading e's live rows (2.8
// MB, under 1 us at 3.35 TB/s): operations-bound.
//
// What the design does about it: conv_tc.cuh's live-edge tiles. The call
// lays out the live slots from the mask (training draws a new mask every
// layer), so that masked slots cost nothing past the layout; splits the
// four weights once; runs each tile of 64 live edges through the four
// products with wgmma (bf16 x 3, fp32-faithful to about 2^-16, the
// arithmetic of the whole-model forward's edge stage; the TPU kernel runs
// them in single-pass bf16 and gathers rows by one-hot MXU products, which
// Hopper's native row loads replace); and sums each atom's rows in a
// fixed order, no atomics. Five launches a call.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; gamd_conv_msg_gather returns the first
// non-zero error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tc.cuh"

// agg [M, W] from e [M*K, W], idx [M*K] (global node ids), mask [M*K],
// hn/src/dst [M, W] and the eight edge weights; lay, wsplit and part are
// scratch (ops/edge_tiles.py), the plan ops/edge_tiles.py::
// launch_plan's. Returns 0, a cudaError_t (cudaErrorInvalidValue for a
// shape or plan it does not take), or 100000 + the CUresult of the TMA
// map's encoding.
extern "C" int gamd_conv_msg_gather(
    const float* e, const int* idx, const uint8_t* mask, const float* hn,
    const float* src, const float* dst, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* w4, const float* b4, int m, int k, const SlotLayout* lay,
    void* wsplit, float* part, int grid, int threads, int smem, int nbuf,
    float* agg, void* stream) {
  if (m <= 0 || k <= 0 || (long long)m * k >= (1LL << 31))
    return cudaErrorInvalidValue;
  const TilePlan plan{grid, threads, smem, nbuf};
  if (!plan_ok(plan, m, k)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_mask_layout(mask, m, k, *lay, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EdgeWeights w{{w1, w2, w3, w4}, {b1, b2, b3, b4}};
  return run_conv_tiles(e, dst, w, GatherSrc{idx, hn, src}, *lay, wsplit,
                        part, m, k, plan, agg, s);
}
