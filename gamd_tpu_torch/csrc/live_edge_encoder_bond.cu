// The bond channel's forms of the edge encoder's live-slot entry for Hopper
// (sm_90a): edge_encoder.cuh's tile kernel in its BOND form (water's [N, K]
// bond channel read at each live row's slot), under each weight-buffer
// count, RBF depth and MLP activation. The entry, what the kernel replaces
// (gamd_tpu/ops/pallas_encoder.py::_encoder_kernel), its design and its
// bound are live_edge_encoder.cu's and edge_encoder.cu's; these forms
// build in their own file, beside the entry's, so that nvcc compiles the
// two in parallel.

#include <cuda_runtime.h>

#include "edge_encoder.cuh"

int run_live_bond(const EncoderWeights& w, const EncTileArgs& a,
                  const float* pos, const int* idx, const int* slot,
                  const int* total, const float* bond, int n, int k,
                  void* wsplit, const tc::TilePlan& plan, float* e,
                  cudaStream_t s) {
  const LiveSlots rows{pos, idx, slot, total, bond, k};
  return run_encoder<LiveSlots, true>(w, a, rows, wsplit, n, k, plan, e, s);
}
