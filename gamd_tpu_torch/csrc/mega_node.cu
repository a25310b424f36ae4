// The node stages of the whole-model forward for Hopper (sm_90a), their
// production forms: node_fused.cuh's node_fused_kernel at 4, 8 and 16
// atoms a block under each pair of conv and MLP activations (silu or
// tanh-gelu), launched by mega_forward.cu's forward. They replace the node
// part of gamd_tpu/ops/pallas_model.py::_forward_body (lines 480-600, row
// 1 of PERF.md's table); what the stages compute, their design and their
// bound are written in node_fused.cuh and mega_forward.cu. The forms build
// in this file, beside mega_forward.cu's, so that nvcc compiles the two in
// parallel.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mega.cuh"
#include "mega_stages.cuh"

namespace {

// The production node kernel of B atoms a block and activations CACT,
// MACT, its shared memory set once per process.
template <int B, int CACT, int MACT>
cudaError_t launch_form(const NodeArgs& na, int layer, cudaStream_t s) {
  const auto kernel = node_fused_kernel<B, ABL_NONE, CACT, MACT>;
  static bool done = false;
  if (!done) {
    const cudaError_t err = allow_smem(kernel, node_smem_bytes(B));
    if (err != cudaSuccess) return err;
    done = true;
  }
  return launch_pdl(kernel, dim3((na.atoms + B - 1) / B), dim3(W),
                    node_smem_bytes(B), s, na, layer);
}

template <int B>
cudaError_t launch_width(const NodeArgs& na, int layer, cudaStream_t s) {
  if (na.cact == ACT_SILU)
    return na.mact == ACT_GELU
               ? launch_form<B, ACT_SILU, ACT_GELU>(na, layer, s)
               : launch_form<B, ACT_SILU, ACT_SILU>(na, layer, s);
  return na.mact == ACT_GELU
             ? launch_form<B, ACT_GELU, ACT_GELU>(na, layer, s)
             : launch_form<B, ACT_GELU, ACT_SILU>(na, layer, s);
}

}  // namespace

cudaError_t launch_node_production(const NodeArgs& na, int layer, int b,
                                   cudaStream_t s) {
  switch (b) {
    case 4: return launch_width<4>(na, layer, s);
    case 8: return launch_width<8>(na, layer, s);
    default: return launch_width<16>(na, layer, s);
  }
}
