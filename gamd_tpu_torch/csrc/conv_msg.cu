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
// What bounds it on this card: at the op library's shape (LJ-258, K=96,
// every width 128) a frame has about 5,500 live edges of 24,768 slots; the
// four 128x128 edge products, as three bf16 passes on the tensor cores,
// need about 2.2 GFLOP, about 2.2 us at 989 TFLOP/s, and the epilogues
// about 0.2 us more on the fp32 cores, against reading e, h_src and
// src_code at the live slots (8.4 MB, 2.5 us at 3.35 TB/s): bytes-bound,
// by a little.
//
// What the design does about it: conv_msg_gather.cu's (row 3), with the
// source policy PreSrc (slot (i, k) reads its rows at i*K + k): the live
// slots laid out from the mask, so that masked slots cost nothing past the
// layout; the four weights split once a call; tiles of 64 live edges
// through the four products on wgmma (bf16 x 3, fp32-faithful to about
// 2^-16; the TPU kernel runs them in single-pass bf16 over every slot);
// each atom's rows summed in a fixed order, no atomics. On equal rows
// (h_src = hn[idx], src_code = src[idx]) it gives row 3's bits. Five
// launches a call.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; gamd_conv_msg returns the first non-zero
// error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tc.cuh"

// agg [N, W] from e, h_src, src_code [N*K, W], dst [N, W], mask [N*K] and
// the eight edge weights; lay, wsplit and part are scratch
// (ops/edge_tiles.py), the plan ops/edge_tiles.py::launch_plan's. Returns
// 0, a cudaError_t (cudaErrorInvalidValue for a shape or plan it does not
// take), or 100000 + the CUresult of the TMA map's encoding.
extern "C" int gamd_conv_msg(
    const float* e, const float* h_src, const float* src_code,
    const float* dst, const uint8_t* mask, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* w4, const float* b4, int n, int k, const SlotLayout* lay,
    void* wsplit, float* part, int grid, int threads, int smem, int nbuf,
    float* agg, void* stream) {
  if (n <= 0 || k <= 0 || (long long)n * k >= (1LL << 31))
    return cudaErrorInvalidValue;
  const TilePlan plan{grid, threads, smem, nbuf};
  if (!plan_ok(plan, n, k)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_mask_layout(mask, n, k, *lay, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EdgeWeights w{{w1, w2, w3, w4}, {b1, b2, b3, b4}};
  return run_conv_tiles(e, dst, w, PreSrc{h_src, src_code}, *lay, wsplit,
                        part, n, k, plan, agg, s);
}
