// The benchmark forms of the whole-model forward's encoder stage, for
// Hopper (sm_90a): mega_forward.cu's encode_tile_kernel with one stage of
// the encoder switched off, which tools/bench_ablate.py runs through the
// MD window (mega_md_steps.cu).
//
// Replaces no TPU kernel of its own: the benchmark forms are the `ablate`
// argument of gamd_tpu/ops/pallas_model.py::_forward_body (lines 307-317,
// the switches at :356-590), which the JAX package compiles into
// _mega_md_kernel (row 2 of PERF.md's table) for scripts/bench_ablate.py.
// Each switch replaces one stage by a cheap stand-in of the same shape, as
// the plain version does (gamd_tpu_torch/ops/mega.py::reference_forward,
// ABLATE_STAGES), so that the step time it saves prices the stage end to
// end; the numerics are then meant to be wrong. A form is a template
// argument of the stage kernel (Ablate, mega.cuh; the code in
// mega_stages.cuh, encode.cuh, node_fused.cuh); mega_forward_run launches
// the form of each stage a switch changes and the production form of the
// others. The encoder's forms here: acts (every activation 0.5 x),
// gather_pos (atom 0's position for every neighbour, the layout still the
// true list's), rbf (std in every column of the RBF product), encmlp (no
// w1, w2 or their activations) and ln (the affine alone);
// mega_ablate_edge.cu and mega_ablate_node.cu hold the other stages'.
//
// Design: only the forms the benchmark runs are built: one switch at a
// time, two weight buffers a tile block and 4 atoms a node block (the
// production choices at LJ-258, the benchmark's system; mega_forward.cu
// refuses a switch where the production choices differ, so that a form
// changes its stage and nothing else), no bond channel. Each stage's
// forms build in their own file, so that nvcc compiles them in parallel
// with the production forms. What bounds a form is what bounds the forward
// (latency: a tile's products and epilogues in sequence, dependent
// launches), less the stage it takes out.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mega.cuh"
#include "mega_stages.cuh"

namespace {

// The encoder's form F under MLP activation MACT, its shared memory set
// once per process.
template <int F, int MACT>
cudaError_t launch_form(const CUtensorMap& map, const EncArgs& ea,
                        dim3 tiles, cudaStream_t s) {
  const auto kernel = encode_tile_kernel<2, false, F, MACT>;
  static bool done = false;
  if (!done) {
    const cudaError_t err = allow_smem(kernel, tc::smem_bytes(2));
    if (err != cudaSuccess) return err;
    done = true;
  }
  return tc::launch_pdl(kernel, tiles, dim3(tc::THREADS), tc::smem_bytes(2),
                        s, map, ea);
}

template <int F>
cudaError_t launch_form(const CUtensorMap& map, const EncArgs& ea,
                        dim3 tiles, cudaStream_t s) {
  return ea.t.mact == ACT_SILU ? launch_form<F, ACT_SILU>(map, ea, tiles, s)
                               : launch_form<F, ACT_GELU>(map, ea, tiles, s);
}

}  // namespace

cudaError_t launch_encode_ablated(int ablate, const CUtensorMap& map,
                                  const EncArgs& ea, dim3 tiles,
                                  cudaStream_t s) {
  switch (ablate) {   // acts has one form: every activation 0.5 x
    case ABL_ACTS: return launch_form<ABL_ACTS, ACT_SILU>(map, ea, tiles, s);
    case ABL_GATHER_POS: return launch_form<ABL_GATHER_POS>(map, ea, tiles, s);
    case ABL_RBF: return launch_form<ABL_RBF>(map, ea, tiles, s);
    case ABL_ENCMLP: return launch_form<ABL_ENCMLP>(map, ea, tiles, s);
    case ABL_LN: return launch_form<ABL_LN>(map, ea, tiles, s);
    default: return cudaErrorInvalidValue;
  }
}
