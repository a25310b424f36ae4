// One conv layer's edge pipeline with the neighbour gathers inside, for
// Hopper (sm_90a): the forward of gamd_tpu_torch.ops.conv_gather's
// fused_conv_gather_message.
//
// Replaces gamd_tpu/ops/pallas_mp.py::_conv_msg_gather_kernel (line 370,
// pallas_call at line 437), which reads every width from its refs: here E
// (e's) and D (hn's and the message's) are equal, 128 or 256, and H
// (src's, dst's, the hidden) 128. Per row i of M nodes (a batch of B graphs of N
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
// MB, under 1 us at 3.35 TB/s): operations-bound. At the DFT model's
// widths (192 atoms, K=192 at 9.5 bohr: about 10,000 live edges) the six
// 128 x 128 blocks a live edge are about 6 GFLOP as three bf16 passes:
// operations-bound too.
//
// What the design does about it: conv_tc.cuh's live-edge tiles. The call
// lays out the live slots from the mask (training draws a new mask every
// layer), so that masked slots cost nothing past the layout; splits the
// weights once (six 128 x 128 blocks at the DFT model's 256 / 128 / 256:
// W1's two row blocks, W2, W3, W4's two column blocks); runs each tile of
// 64 live edges through the four products (six blocks) with wgmma (bf16 x
// 3, fp32-faithful to about 2^-16, the arithmetic of the whole-model
// forward's edge stage; the TPU kernel runs
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

namespace {

// The call at e width 128 EB and message width 128 DB (EB = DB: 1, or 2
// for the DFT model).
template <int EB, int DB>
int conv_msg_gather_at(const float* e, const int* idx, const float* hn,
                       const float* src, const float* dst,
                       const EdgeWeights& w, int m, int k,
                       const SlotLayout& lay, void* wsplit, float* part,
                       const TilePlan& plan, float* agg, cudaStream_t s) {
  return run_conv_tiles<GatherSrc<DB * CW>, ConvStages, EB, DB>(
      e, dst, w, GatherSrc<DB * CW>{idx, hn, src}, lay, wsplit, part, m, k,
      plan, agg, s);
}

}  // namespace

// agg [M, D] from e [M*K, E], idx [M*K] (global node ids), mask [M*K],
// hn [M, D], src/dst [M, 128] and the eight edge weights (W1 [E, 128], W2
// and W3 [128, 128], W4 [128, D]), E = D, 128 or 256; lay, wsplit
// (E/128 + 2 + D/128 split blocks) and part ([tiles, 2, D]) are scratch
// (ops/edge_tiles.py), the plan ops/edge_tiles.py::launch_plan's. Returns
// 0, a cudaError_t (cudaErrorInvalidValue for a shape, width or plan it
// does not take), or 100000 + the CUresult of the TMA map's encoding.
extern "C" int gamd_conv_msg_gather(
    const float* e, const int* idx, const uint8_t* mask, const float* hn,
    const float* src, const float* dst, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* w4, const float* b4, int m, int k, int e_width,
    int d_width, const SlotLayout* lay, void* wsplit, float* part, int grid,
    int threads, int smem, int nbuf, float* agg, void* stream) {
  if (m <= 0 || k <= 0 || (long long)m * k >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (e_width != d_width || (d_width != CW && d_width != 2 * CW))
    return cudaErrorInvalidValue;
  const TilePlan plan{grid, threads, smem, nbuf};
  if (!plan_ok(plan, m, k)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_mask_layout(mask, m, k, *lay, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EdgeWeights w{{w1, w2, w3, w4}, {b1, b2, b3, b4}};
  if (d_width == CW)
    return conv_msg_gather_at<1, 1>(e, idx, hn, src, dst, w, m, k, *lay,
                                    wsplit, part, plan, agg, s);
  return conv_msg_gather_at<2, 2>(e, idx, hn, src, dst, w, m, k, *lay,
                                  wsplit, part, plan, agg, s);
}
