// The encoder stage of the whole-model forward for Hopper (sm_90a), its
// production forms: mega_stages.cuh's encode_tile_kernel under each
// weight-buffer count, bond form and MLP activation (silu or tanh-gelu),
// launched by mega_forward.cu's forward. It replaces the encoder part of
// gamd_tpu/ops/pallas_model.py::_forward_body (lines 394-463, row 1 of
// PERF.md's table); what the stage computes, its design and its bound are
// written in mega_forward.cu and encode.cuh. The forms build in this file,
// beside mega_forward.cu's, so that nvcc compiles the two in parallel.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mega.cuh"
#include "mega_stages.cuh"

namespace {

// The production encoder kernel of NBUF buffers, BOND and MLP activation
// MACT, its shared memory set once per process.
template <int NBUF, bool BOND, int MACT>
cudaError_t launch_form(const CUtensorMap& map, const EncArgs& ea,
                        dim3 tiles, cudaStream_t s) {
  const auto kernel = encode_tile_kernel<NBUF, BOND, ABL_NONE, MACT>;
  static bool done = false;
  if (!done) {
    const cudaError_t err = allow_smem(kernel, tc::smem_bytes(NBUF));
    if (err != cudaSuccess) return err;
    done = true;
  }
  return tc::launch_pdl(kernel, tiles, dim3(tc::THREADS),
                        tc::smem_bytes(NBUF), s, map, ea);
}

template <int MACT>
cudaError_t launch_act(const CUtensorMap& map, const EncArgs& ea, dim3 tiles,
                       bool one, cudaStream_t s) {
  if (ea.bond != nullptr)
    return one ? launch_form<1, true, MACT>(map, ea, tiles, s)
               : launch_form<2, true, MACT>(map, ea, tiles, s);
  return one ? launch_form<1, false, MACT>(map, ea, tiles, s)
             : launch_form<2, false, MACT>(map, ea, tiles, s);
}

}  // namespace

cudaError_t launch_encode_production(const CUtensorMap& map,
                                     const EncArgs& ea, dim3 tiles, bool one,
                                     cudaStream_t s) {
  return ea.t.mact == ACT_SILU ? launch_act<ACT_SILU>(map, ea, tiles, one, s)
                               : launch_act<ACT_GELU>(map, ea, tiles, one, s);
}
