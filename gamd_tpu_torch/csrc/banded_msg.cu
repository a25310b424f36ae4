// One conv layer's edge pipeline on an x-sorted frame with the source rows
// read from a per-tile band, for Hopper (sm_90a): the kernel behind
// gamd_tpu_torch.ops.banded's banded_conv_message, the large-N force path.
//
// Replaces gamd_tpu/ops/banded.py::_banded_msg_kernel (line 58,
// pallas_call at line 206). Per row i of the padded sorted frame and slot
// k, with r = lo[i / tile_n] + idx_loc[i,k] a row of the extended node
// array nodes [np_rows + band, 2W] = [hn | src_affine(hn)]:
//   z  = silu(e[i,k] @ W1 + b1) @ W2 + b2 + nodes[r, W:] + dst[i]
//   m  = silu(silu(z) @ W3 + b3) @ W4 + b4
//   agg[i] = sum over k with mask[i,k] of nodes[r, :W] * m
// A masked slot contributes exactly 0, whatever its message.
//
// What bounds it on this card: at N=10,000 (LJ, reduced density 0.5,
// cutoff 7.5 A) an atom has about 22 live edges, about 2.2e5 a layer; the
// four 128x128 edge products need about 29 GFLOP, about 0.43 ms at the 67
// TFLOP/s fp32 peak, against reading e (N*K*128*4 B = 492 MB at K=96,
// about 0.15 ms at 3.35 TB/s): operations-bound.
//
// What the design does about it, for now: the TPU kernel DMAs each tile's
// band of node rows into VMEM and gathers from it with one-hot MXU
// products over a bf16 hi/lo split. A band at N=10,000 is 2,304 rows of
// 256 floats (2.36 MB), ten times a block's shared memory, and Hopper
// gathers rows natively: so the band is not staged, and each slot reads
// its source row with plain loads from the extended array at r. What the
// band buys here is locality: a tile's sources lie in one contiguous
// window that L2 (50 MB) holds. The edge stage is edge_msg.cuh's
// edge_msg_kernel, the one conv_msg_gather.cu runs, with that one more
// indirection: a block of 128 threads runs a chunk of 16 slots of one row
// through the four products as fp32 FMAs (the TPU kernel runs them in
// bf16), a chunk with no live slot exits at once (lists are nearest
// first), and chunk_sum_kernel adds a row's chunk partials in a fixed
// order: no atomics, the same result from run to run. TMA staging of band
// slices, wgmma and bf16 operands are later work. Two launches a call.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; gamd_banded_msg returns the first non-zero
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_msg.cuh"
#include "tile.cuh"

// agg [M, W] from e [M*K, W], idx_loc [M*K] (band-local, in [0, band)),
// mask [M*K], lo [M / tile_n] (band start rows), nodes [np_rows + band,
// 2W] and dst [M, W], with M a multiple of tile_n; aggp [M, ceil(K/KC), W]
// is scratch. Returns 0, or the first non-zero cudaError_t seen after a
// launch.
extern "C" int gamd_banded_msg(
    const float* e, const int* idx_loc, const uint8_t* mask, const int* lo,
    const float* nodes, const float* dst, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* w4, const float* b4, int m, int k, int tile_n, float* aggp,
    float* agg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvWeights p{w1, b1, w2, b2, w3, b3, w4, b4};
  const int n_chunk = (k + KC - 1) / KC;
  cudaError_t err;
  edge_msg_kernel<<<dim3(n_chunk, m), W, 0, s>>>(
      e, mask, dst, p, k, BandRows{idx_loc, lo, nodes, nodes + W, tile_n},
      aggp);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chunk_sum_kernel<<<m, W, 0, s>>>(aggp, n_chunk, agg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return 0;
}
