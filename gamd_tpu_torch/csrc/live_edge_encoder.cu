// The live-slot entry of the edge encoder for Hopper (sm_90a), the kernel
// behind gamd_tpu_torch.ops.encoder.live_edge_encoder: one frame's live
// slots of a layout (ops/edge_tiles.py::mask_layout), e's rows of those
// slots written at their slot positions, with water's bond channel ([N,
// K], read at each live row's slot: the BOND form of the tile kernel) or
// without. The kernel, what it replaces (gamd_tpu/ops/pallas_encoder.py::
// _encoder_kernel), its design and its bound are edge_encoder.cu's
// (edge_encoder.cuh). This file holds the entry and its forms without a
// bond, live_edge_encoder_bond.cu those with one, so that they build in
// parallel with each other and with the every-slot entry's.

#include <cuda_runtime.h>

#include "edge_encoder.cuh"
// The live slots of one frame: pos [n, 3], idx [n, k], the layout's slot
// ids [ceil(n*k / 64) * 64] (its first *total rows read), and the bond
// channel [n, k] or null in; e's rows of those slots out, into e [n*k, W].
// mlp_act is the MLP activation's code (Act). wsplit and the plan as
// above, the plan of launch_plan(n, k).
extern "C" int gamd_live_edge_encoder(
    const float* pos, const int* idx, const int* slot, const int* total,
    const float* bond, const EncoderWeights* weights, int n_rbf, int n,
    int k, int flip_dir, int mlp_act, float box, float length_mean,
    float length_std, float gamma, void* wsplit, int grid, int threads,
    int smem, int nbuf, float* e, void* stream) {
  if (n <= 0 || k <= 0 || (long long)n * k > (1LL << 31) - 64)
    return cudaErrorInvalidValue;
  const LiveSlots rows{pos, idx, slot, total, bond, k};
  const EncTileArgs a = tile_args(*weights, n_rbf, flip_dir, box,
                                  length_mean, length_std, gamma, mlp_act);
  const TilePlan plan{grid, threads, smem, nbuf};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bond != nullptr
             ? run_live_bond(*weights, a, pos, idx, slot, total, bond, n, k,
                             wsplit, plan, e, s)
             : run_encoder(*weights, a, rows, wsplit, n, k, plan, e, s);
}
