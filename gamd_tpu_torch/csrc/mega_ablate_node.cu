// The benchmark forms of the whole-model forward's node stages, for Hopper
// (sm_90a): node_fused.cuh's node_fused_kernel with one stage of the node
// update, norm or decoder switched off, which tools/bench_ablate.py runs
// through the MD window (mega_md_steps.cu).
//
// Replaces no TPU kernel of its own: the `ablate` forms of
// gamd_tpu/ops/pallas_model.py::_forward_body, as mega_ablate_encode.cu
// sets out. The node stages' forms here: acts (every activation 0.5 x),
// ln (the node LayerNorm out, its affine kept), nodeops (dst = hn and h +
// act(hn + agg): no node products), srcaff (the source product out), agg
// (an atom's first message row for the sum) and decoder (forces h[:3]),
// each at 4 atoms a block (the production width at LJ-258; mega_forward.cu
// refuses a switch where the production width differs) under each pair of
// activations.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mega.cuh"
#include "mega_stages.cuh"

namespace {

// The node stages' form F under activations CACT and MACT, its shared
// memory set once per process.
template <int F, int CACT, int MACT>
cudaError_t launch_form(const NodeArgs& na, int layer, cudaStream_t s) {
  const auto kernel = node_fused_kernel<NODE_MIN_B, F, CACT, MACT>;
  static bool done = false;
  if (!done) {
    const cudaError_t err = allow_smem(kernel, node_smem_bytes(NODE_MIN_B));
    if (err != cudaSuccess) return err;
    done = true;
  }
  return tc::launch_pdl(kernel,
                        dim3((na.atoms + NODE_MIN_B - 1) / NODE_MIN_B),
                        dim3(W), node_smem_bytes(NODE_MIN_B), s, na, layer);
}

// Form F under na's activation pair.
template <int F>
cudaError_t launch_acts(const NodeArgs& na, int layer, cudaStream_t s) {
  if (na.cact == ACT_SILU)
    return na.mact == ACT_GELU
               ? launch_form<F, ACT_SILU, ACT_GELU>(na, layer, s)
               : launch_form<F, ACT_SILU, ACT_SILU>(na, layer, s);
  return na.mact == ACT_GELU
             ? launch_form<F, ACT_GELU, ACT_GELU>(na, layer, s)
             : launch_form<F, ACT_GELU, ACT_SILU>(na, layer, s);
}

}  // namespace

cudaError_t launch_node_ablated(int ablate, const NodeArgs& na, int layer,
                                cudaStream_t s) {
  switch (ablate) {
    // every activation 0.5 x, whatever the pair
    case ABL_ACTS: return launch_form<ABL_ACTS, ACT_SILU, ACT_GELU>(na, layer,
                                                                    s);
    case ABL_LN: return launch_acts<ABL_LN>(na, layer, s);
    case ABL_NODEOPS: return launch_acts<ABL_NODEOPS>(na, layer, s);
    case ABL_SRCAFF: return launch_acts<ABL_SRCAFF>(na, layer, s);
    case ABL_AGG: return launch_acts<ABL_AGG>(na, layer, s);
    case ABL_DECODER: return launch_acts<ABL_DECODER>(na, layer, s);
    default: return cudaErrorInvalidValue;
  }
}
