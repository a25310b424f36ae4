// One Nose-Hoover chain half-step of the chain alone: the device code that
// csrc/nhc_chain.cu's three kernels share.
//
// The math and its order are gamd_tpu/md/integrators.py::_nhc_propagate's
// (lines 206-229): g[0] is reset from ke2 = sum m v^2, then for each
// weighted substep wdt of the n_c * n_ys schedule
//   vxi[M-1] += wdt/4 g[M-1]
//   for j = M-2 .. 0:  a = exp(-wdt/8 vxi[j+1]);  vxi[j] = a (a vxi[j] + wdt/4 g[j])
//   scale *= exp(-wdt/2 vxi[0]);  xi += wdt/2 vxi
//   g[0] = (scale^2 ke2 - ndf kT) / q[0]
//   for j = 0 .. M-2:  a = exp(-wdt/8 vxi[j+1]);  vxi[j] = a (a vxi[j] + wdt/4 g[j])
//                      g[j+1] = (q[j] vxi[j]^2 - kT) / q[j+1]
//   vxi[M-1] += wdt/4 g[M-1]
// and the half-step returns the product of the scales; the particles'
// velocities are scaled by it once, after the last substep.
//
// Precision: fp32, expf and IEEE division (no fast math). Every product and
// sum is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn:
// nothing is contracted into an FMA), so each update rounds as the plain
// PyTorch version's element-wise operations do, one by one.
//
// The chain length M is a template argument (the entries dispatch a
// run-time M in [1, NHC_MAX_M]), so every loop over the chain unrolls with
// constant indices and the chain lives in registers.

#pragma once

#include <cuda_runtime.h>

constexpr int NHC_MAX_M = 16;

__device__ __forceinline__ float nhc_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float nhc_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float nhc_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float nhc_div(float a, float b) {
  return __fdiv_rn(a, b);
}

// a (a v + quarter g): the kick of one chain velocity by its force, damped
// by the next element's exponential a.
__device__ __forceinline__ float nhc_kick(float a, float v, float quarter,
                                          float g) {
  return nhc_mul(a, nhc_add(nhc_mul(a, v), nhc_mul(quarter, g)));
}

// The chain of one system in registers; q holds the chain masses.
template <int M>
struct NhcChain {
  float xi[M];
  float vxi[M];
  float g[M];
  float q[M];
};

template <int M>
__device__ __forceinline__ void nhc_load(NhcChain<M>& c, const float* xi,
                                         const float* vxi, const float* g,
                                         const float* q) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    c.xi[j] = xi[j];
    c.vxi[j] = vxi[j];
    c.g[j] = g[j];
    c.q[j] = q[j];
  }
}

template <int M>
__device__ __forceinline__ void nhc_store(const NhcChain<M>& c, float* xi,
                                          float* vxi, float* g) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    xi[j] = c.xi[j];
    vxi[j] = c.vxi[j];
    g[j] = c.g[j];
  }
}

// One half-step of the chain over the n_sub weighted substeps wdts; returns
// the product of the substeps' scales.
template <int M>
__device__ __forceinline__ float nhc_chain_half_step(
    NhcChain<M>& c, const float* __restrict__ wdts, int n_sub, float ke2,
    float kt, float ndf_kt) {
  float scale = 1.0f;
  c.g[0] = nhc_div(nhc_sub(ke2, ndf_kt), c.q[0]);
  for (int s = 0; s < n_sub; ++s) {
    const float wdt = wdts[s];
    const float quarter = nhc_mul(0.25f, wdt);
    const float eighth = nhc_mul(-0.125f, wdt);
    const float half = nhc_mul(0.5f, wdt);
    c.vxi[M - 1] = nhc_add(c.vxi[M - 1], nhc_mul(quarter, c.g[M - 1]));
#pragma unroll
    for (int j = M - 2; j >= 0; --j) {
      const float aa = expf(nhc_mul(eighth, c.vxi[j + 1]));
      c.vxi[j] = nhc_kick(aa, c.vxi[j], quarter, c.g[j]);
    }
    scale = nhc_mul(scale, expf(nhc_mul(-half, c.vxi[0])));
#pragma unroll
    for (int j = 0; j < M; ++j) {
      c.xi[j] = nhc_add(c.xi[j], nhc_mul(half, c.vxi[j]));
    }
    c.g[0] = nhc_div(nhc_sub(nhc_mul(nhc_mul(scale, scale), ke2), ndf_kt),
                     c.q[0]);
#pragma unroll
    for (int j = 0; j < M - 1; ++j) {
      const float aa = expf(nhc_mul(eighth, c.vxi[j + 1]));
      c.vxi[j] = nhc_kick(aa, c.vxi[j], quarter, c.g[j]);
      c.g[j + 1] = nhc_div(
          nhc_sub(nhc_mul(nhc_mul(c.q[j], c.vxi[j]), c.vxi[j]), kt),
          c.q[j + 1]);
    }
    c.vxi[M - 1] = nhc_add(c.vxi[M - 1], nhc_mul(quarter, c.g[M - 1]));
  }
  return scale;
}
