// One conv layer's edge pipeline on an x-sorted frame with the source rows
// read from a per-tile band, for Hopper (sm_90a): the kernel behind
// gamd_tpu_torch.ops.banded's banded_conv_message, the large-N force path.
//
// Replaces gamd_tpu/ops/banded.py::_banded_msg_kernel (line 58,
// pallas_call at line 206). Per row i of the sorted frame and slot k, with
// r = lo[i / tile_n] + idx_loc[i,k] a row of the extended node array nodes
// [np_rows + band, 2W] = [hn | src_affine(hn)]:
//   z  = silu(e[i,k] @ W1 + b1) @ W2 + b2 + nodes[r, W:] + dst[i]
//   m  = silu(silu(z) @ W3 + b3) @ W4 + b4
//   agg[i] = sum over k with mask[i,k] of nodes[r, :W] * m
// A masked slot contributes exactly 0, whatever its message.
//
// What bounds it on this card: at N=10,000 (LJ, reduced density 0.5,
// cutoff 7.5 A, K=96) about 164,000 of the 960,000 slots are live; the
// four 128x128 edge products as three bf16 passes need about 64.5 GFLOP,
// about 65 us at 989 TFLOP/s, and the epilogues about 5 us more on the
// fp32 cores, against reading e's live rows (84 MB, 25 us at 3.35 TB/s):
// operations-bound.
//
// What the design does about it: conv_tc.cuh's live-edge tiles, with the
// band as one more indirection. The TPU kernel DMAs each tile's band of
// node rows into VMEM and gathers from it with one-hot MXU products; a
// band at N=10,000 is 2,304 rows of 256 floats (2.36 MB), ten times a
// block's shared memory, and Hopper gathers rows natively, so each live
// edge reads its source row with plain loads from the extended array at r
// (a tile's sources lie in one contiguous window that L2 holds). The
// layout of the live slots comes from the mask once per force call
// (gamd_mask_layout; every layer shares the mask); each layer's call
// splits its four weights, runs the tiles of 64 live edges through the
// four products with wgmma (bf16 x 3, fp32-faithful to about 2^-16; the
// TPU kernel runs them in single-pass bf16) and sums each atom's rows in a
// fixed order, no atomics. Three launches a layer.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; the entries return the first non-zero error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tc.cuh"

// The live-edge layout of M rows of K slots from mask [M*K] into lay (its
// slot array holds ceil(M*K / 64) * 64 ids). Returns 0 or a cudaError_t.
extern "C" int gamd_mask_layout(const uint8_t* mask, int m, int k,
                                const SlotLayout* lay, void* stream) {
  if (m <= 0 || k <= 0 || (long long)m * k >= (1LL << 31))
    return cudaErrorInvalidValue;
  return static_cast<int>(launch_mask_layout(
      mask, m, k, *lay, static_cast<cudaStream_t>(stream)));
}

// agg [M, W] from e [M*K, W], idx_loc [M*K] (band-local, in [0, band)),
// lo [ceil(M / tile_n)] (band start rows), nodes [np_rows + band, 2W], dst
// [M, W] and the eight edge weights, over the layout lay of the mask
// (gamd_mask_layout); wsplit and part are scratch (ops/edge_tiles.py),
// the plan ops/edge_tiles.py::launch_plan's. Returns 0, a cudaError_t
// (cudaErrorInvalidValue for a shape or plan it does not take), or 100000
// + the CUresult of the TMA map's encoding.
extern "C" int gamd_banded_msg(
    const float* e, const int* idx_loc, const int* lo, const float* nodes,
    const float* dst, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, const float* w4,
    const float* b4, int m, int k, int tile_n, const SlotLayout* lay,
    void* wsplit, float* part, int grid, int threads, int smem, int nbuf,
    float* agg, void* stream) {
  if (m <= 0 || k <= 0 || tile_n <= 0 || (long long)m * k >= (1LL << 31))
    return cudaErrorInvalidValue;
  const EdgeWeights w{{w1, w2, w3, w4}, {b1, b2, b3, b4}};
  return run_conv_tiles(e, dst, w, BandSrc{idx_loc, lo, nodes, tile_n},
                        *lay, wsplit, part, m, k,
                        TilePlan{grid, threads, smem, nbuf}, agg,
                        static_cast<cudaStream_t>(stream));
}
