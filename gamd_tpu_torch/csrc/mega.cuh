// Shared by the port's CUDA sources: the packed-weights struct and the
// whole-model forward's host entry (defined in mega_forward.cu), which the
// fused MD window (mega_md_steps.cu) calls once per step.

#pragma once

#include <stdint.h>

// One device pointer per field of gamd_tpu_torch.ops.mega.MegaParams, in
// the same order (the ctypes Structure _MegaWeights mirrors it).
struct MegaWeights {
  const float *centers, *w_geo, *w_rbf, *b0, *w1, *b1, *w2, *b2, *eln_s,
      *eln_b;
  const float *nln_s, *nln_b, *w_src, *b_src, *w_dst, *b_dst, *w_e1, *b_e1,
      *w_e2, *b_e2, *w_t1, *b_t1, *w_t2, *b_t2, *w_pd, *b_pd, *w_pe, *b_pe,
      *w_p, *b_p;
  const float *wd0, *bd0, *wd1, *bd1;
};

// All launches of one forward of r replicas of n atoms on `stream`
// (positions to forces `out`, every array replica-major). Returns 0, or the
// first non-zero cudaError_t seen.
extern "C" int gamd_mega_forward(
    const float* pos, const int* idx, const uint8_t* bmask, const float* h0,
    const MegaWeights* weights, int r, int n, int k, int n_layers, int use_ln,
    int flip_dir, float box, float cutoff2, float length_mean,
    float length_std, float gamma, float* e, float* live, float* h, float* hn,
    float* src, float* dst, float* aggp, float* out, void* stream);
