// Edge featurisation and encoder for Hopper (sm_90a): positions, neighbour
// lists and the model's encoder weights in, the edge embedding e (fp32,
// W = 128 wide) out. The kernels behind gamd_tpu_torch.ops.encoder:
// * fused_edge_encoder (GAMDNet's use_pallas_encoder path, the counterpart
//   of JAX's entry): B frames, e [B, N, K, W] for every slot, dead ones
//   included, and the live mask [B, N, K];
// * live_edge_encoder (the large-N banded force path; its entry in
//   live_edge_encoder.cu, beside this file's so that the two build in
//   parallel): one frame and a
//   live-slot layout (ops/edge_tiles.py::mask_layout), e's rows of the
//   listed slots written at their slot positions of an [N, K, W] buffer;
//   the rows of dead slots are never written (conv_tc.cuh reads e by slot
//   id, and only for live rows). With water's bond channel ([N, K], read
//   at each live row's slot; a BOND form of the tile kernel, as
//   mega_forward.cu's encoder stage) or without, and the MLP activation
//   tanh-gelu or silu (a form of the tile kernel each; encode.cuh).
//
// Replaces gamd_tpu/ops/pallas_encoder.py::_encoder_kernel (line 46,
// pallas_call at line 199), which the JAX model runs per frame under vmap;
// what a row computes, and its precision (bf16 x 3 products on the tensor
// cores, fp32 epilogues), is written in encode.cuh.
//
// Design: the tile body of the whole-model forward's encoder stage
// (encode.cuh, shared with mega_forward.cu) in a persistent kernel over a
// list of rows. Block b takes tiles b, b + grid, ... of 64 rows: every
// slot of the B frames in order (the first entry; no layout is needed),
// or the layout's live slots (the second). Per tile the geometry and the
// RBF in fp32, the RBF, w1 and w2 products as bf16 x 3 wgmma (edge_tc.cuh,
// the two warpgroups splitting the 128 output columns), gelu and the
// LayerNorm in fp32 epilogues. The three weights are split into bf16 hi
// and lo once a call (split_encoder_weights_kernel) and staged by TMA into
// a ring of one or two 64 KB buffers that runs on across the block's tiles
// (ops/edge_tiles.py::launch_plan picks them and the grid, as for the conv
// tiles). Two launches a call. Unlike the forward's stage, the RBF product
// runs over a constant 3 k-steps where n_rbf <= 48, whose wgmma issue back
// to back where a run-time count makes the compiler wait after each (more
// centres take the run-time count, as the forward does), and gelu and the
// RBF take the fast exponential and division (gelu_fast: about 2^-20
// relative, below the products' 2^-16). Measured on the H100
// against this design and dropped (PERF.md): the forward's arithmetic
// as it is (6-16% slower), and the three weights resident in one block an
// SM (192 KB; 39-49% slower at B=16 and on the live slots: nothing
// overlaps a tile's epilogues with another's products).
//
// What bounds it on this card: the three products are 2 ((4 + n_rbf) W +
// 2 W W) FLOP per edge (76,800 at n_rbf = 40), as three bf16 passes
// against the 989 TFLOP/s tensor peak, the epilogues on the fp32 cores.
// At the LJ deployment (LJ-258, K=96, 5,500 live of 24,768 slots) the
// live edges' products take about 1.3 us against writing e for every slot
// (12.7 MB, 3.8 us at 3.35 TB/s): bytes-bound. At N=10,000 on the banded
// path (164,100 live edges) the products take about 38 us against e's
// live rows (84 MB, 25 us): operations-bound. What bounds the design is
// latency: a tile's three products and epilogues run in sequence on one
// SM.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; each entry returns 0, a cudaError_t
// (cudaErrorInvalidValue for a shape or plan it does not take), or 100000
// + the CUresult of the TMA map's encoding.

#include "edge_encoder.cuh"

// Every slot of b frames: pos [b, n, 3], idx and bmask [b, n, k] (per-
// frame ids) in; e [b*n*k, W] and live [b*n*k] out. wsplit is the split
// table's scratch (2 * 3 * 128 * 128 bf16); the plan is ops/edge_tiles.py::
// launch_plan(b * n, k).
extern "C" int gamd_edge_encoder(
    const float* pos, const int* idx, const uint8_t* bmask,
    const EncoderWeights* weights, int n_rbf, int b, int n, int k,
    int flip_dir, float box, float cutoff2, float length_mean,
    float length_std, float gamma, void* wsplit, int grid, int threads,
    int smem, int nbuf, float* e, uint8_t* live, void* stream) {
  if (b <= 0 || n <= 0 || k <= 0 ||
      (long long)b * n * k > (1LL << 31) - 64)
    return cudaErrorInvalidValue;
  const AllSlots rows{pos, idx, bmask, live, n, k, b * n * k, cutoff2};
  return run_encoder<AllSlots, false, true>(
      *weights,
      tile_args(*weights, n_rbf, flip_dir, box, length_mean, length_std,
                gamma, ACT_GELU),
      rows, wsplit, b * n, k, TilePlan{grid, threads, smem, nbuf}, e,
      static_cast<cudaStream_t>(stream));
}
