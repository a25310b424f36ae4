// The benchmark forms of the whole-model forward's edge stage, for Hopper
// (sm_90a): mega_forward.cu's edge_tile_kernel with one stage of the conv
// layers' edge pipeline switched off, which tools/bench_ablate.py runs
// through the MD window (mega_md_steps.cu).
//
// Replaces no TPU kernel of its own: the `ablate` forms of
// gamd_tpu/ops/pallas_model.py::_forward_body, as mega_ablate_encode.cu
// sets out. The edge stage's forms here: acts (every activation 0.5 x),
// gather_conv (src and hn of atom 0 for every edge), srcaff (b_src for
// the source code), emlp (z = e, no W_e1, W_e2), repeat (atom 0's dst for
// every edge) and theta (no W_t1, W_t2), each with two weight buffers a
// tile block.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mega.cuh"
#include "mega_stages.cuh"

namespace {

// The edge stage's form F under conv activation CACT, its shared memory
// set once per process.
template <int F, int CACT>
cudaError_t launch_form(const CUtensorMap& map, const EdgeArgs& ga, int m0,
                        dim3 tiles, cudaStream_t s) {
  const auto kernel = edge_tile_kernel<2, F, CACT>;
  static bool done = false;
  if (!done) {
    const cudaError_t err = allow_smem(kernel, tc::smem_bytes(2));
    if (err != cudaSuccess) return err;
    done = true;
  }
  return tc::launch_pdl(kernel, tiles, dim3(tc::THREADS), tc::smem_bytes(2),
                        s, map, ga, m0);
}

template <int F>
cudaError_t launch_form(const CUtensorMap& map, const EdgeArgs& ga, int m0,
                        dim3 tiles, cudaStream_t s) {
  return ga.cact == ACT_SILU
             ? launch_form<F, ACT_SILU>(map, ga, m0, tiles, s)
             : launch_form<F, ACT_GELU>(map, ga, m0, tiles, s);
}

}  // namespace

cudaError_t launch_edge_ablated(int ablate, const CUtensorMap& map,
                                const EdgeArgs& ga, int m0, dim3 tiles,
                                cudaStream_t s) {
  switch (ablate) {   // acts has one form: every activation 0.5 x
    case ABL_ACTS:
      return launch_form<ABL_ACTS, ACT_SILU>(map, ga, m0, tiles, s);
    case ABL_GATHER_CONV:
      return launch_form<ABL_GATHER_CONV>(map, ga, m0, tiles, s);
    case ABL_SRCAFF: return launch_form<ABL_SRCAFF>(map, ga, m0, tiles, s);
    case ABL_EMLP: return launch_form<ABL_EMLP>(map, ga, m0, tiles, s);
    case ABL_REPEAT: return launch_form<ABL_REPEAT>(map, ga, m0, tiles, s);
    case ABL_THETA: return launch_form<ABL_THETA>(map, ga, m0, tiles, s);
    default: return cudaErrorInvalidValue;
  }
}
