// The edge featurisation and encoder, positions to the edge embedding:
// device code shared by mega_forward.cu (the whole-model forward's first
// stage) and edge_encoder.cu (the standalone, batched entry of
// gamd_tpu_torch.ops.encoder.fused_edge_encoder).
//
// It computes the function of gamd_tpu/ops/pallas_encoder.py::
// _encoder_kernel (line 46) for every slot, dead ones included: gather
// pos[idx], min-image displacement in round form (rintf, half to even),
// distance, unit vector 1/(dist + 1e-8) (negated under flip_dir),
// standardised distance (dist - mean) / std, the live mask (build mask AND
// d^2 < cutoff^2; cutoff^2 = inf passes the build mask through), the RBF
// exp(-gamma (std - centre_j)^2) over the centres, Linear(4 + n_rbf -> W)
// as rank-1 geometric terms plus the RBF product, tanh-gelu, Linear, tanh-
// gelu, Linear, and LayerNorm (eps 1e-6) with its affine.
//
// Precision: fp32 CUDA-core FMAs throughout, no TF32, e written in fp32.
// The TPU kernel's bf16 operands and bf16 output, its one-hot hi/lo
// gathers and its zero-padding of the RBF rows to 128 are TPU choices, not
// part of the function. The RBF product runs over `n_rbf` weight rows:
// mega_forward passes its packed weights, whose w_rbf is zero-padded to
// 128 rows (ops/mega.py::pack_params), and so still multiplies by the
// padding; edge_encoder.cu passes the model's own w0 rows and n_rbf = 40.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

// One device pointer per field of gamd_tpu_torch.ops.encoder.EncoderParams,
// in the same order (the first ten fields of MegaWeights, mega.cuh).
// w_geo rows 0-3 weight the unit vector and the standardised distance;
// w_rbf holds n_rbf rows, one per centre; b0..b2 [W], w1/w2 [W][W],
// eln_s/eln_b the LayerNorm affine [W]; centers [n_rbf].
struct EncoderWeights {
  const float *centers, *w_geo, *w_rbf, *b0, *w1, *b1, *w2, *b2, *eln_s,
      *eln_b;
};

namespace {

constexpr float LN_EPS = 1e-6f;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;   // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// Per-row LayerNorm over the W channels (no affine): two-pass mean and
// variance, x * rsqrt(var + 1e-6).
template <int M>
__device__ __forceinline__ void layer_norm(float (&x)[M], float* red) {
  float s[M];
#pragma unroll
  for (int m = 0; m < M; ++m) s[m] = x[m];
  block_sum<M>(s, red);
#pragma unroll
  for (int m = 0; m < M; ++m) x[m] -= s[m] * (1.0f / W);
#pragma unroll
  for (int m = 0; m < M; ++m) s[m] = x[m] * x[m];
  block_sum<M>(s, red);
#pragma unroll
  for (int m = 0; m < M; ++m) x[m] *= rsqrtf(s[m] * (1.0f / W) + LN_EPS);
}

// Encoder. grid (ceil(K/KC), N, B), block W: one chunk of KC slots of atom
// i of frame blockIdx.z. idx holds per-frame indices in [0, N). Writes e
// [B*N*K, W] and live [B*N*K] (1 / 0 as LiveT: float for mega_forward's
// edge stages, uint8_t for a torch.bool tensor).
template <typename LiveT>
__global__ void __launch_bounds__(W)
encode_kernel(const float* __restrict__ pos, const int* __restrict__ idx,
              const uint8_t* __restrict__ bmask, EncoderWeights p, int n_rbf,
              int n, int k, int flip_dir, float box, float cutoff2,
              float length_mean, float length_std, float gamma,
              float* __restrict__ e_out, LiveT* __restrict__ live_out) {
  __shared__ __align__(16) float buf[W * KC];
  __shared__ float geo[4][KC];            // ux, uy, uz, standardised dist
  __shared__ float red[NWARP * KC];
  const int i = blockIdx.y, k0 = blockIdx.x * KC, c = threadIdx.x;
  const size_t frame = blockIdx.z;
  pos += frame * n * 3;
  idx += frame * n * k;
  bmask += frame * n * k;
  e_out += frame * n * k * W;
  live_out += frame * n * k;

  if (c < KC) {
    const int kk = k0 + c;
    float ux = 0.f, uy = 0.f, uz = 0.f, sd = 0.f;
    if (kk < k) {
      const int j = idx[i * k + kk];
      float rx = pos[3 * j + 0] - pos[3 * i + 0];
      float ry = pos[3 * j + 1] - pos[3 * i + 1];
      float rz = pos[3 * j + 2] - pos[3 * i + 2];
      rx -= box * rintf(rx / box);
      ry -= box * rintf(ry / box);
      rz -= box * rintf(rz / box);
      const float d2 = rx * rx + ry * ry + rz * rz;
      const float dist = sqrtf(d2);
      const float inv = (flip_dir ? -1.0f : 1.0f) / (dist + 1e-8f);
      ux = rx * inv;
      uy = ry * inv;
      uz = rz * inv;
      sd = (dist - length_mean) / length_std;
      live_out[i * k + kk] =
          static_cast<LiveT>((bmask[i * k + kk] && d2 < cutoff2) ? 1 : 0);
    }
    geo[0][c] = ux;
    geo[1][c] = uy;
    geo[2][c] = uz;
    geo[3][c] = sd;
  }
  __syncthreads();

  // RBF tile: row c < n_rbf holds exp(-gamma (std_m - centre_c)^2) for
  // every edge m.
  if (c < n_rbf) {
    const float cc = p.centers[c];
    float r[KC];
#pragma unroll
    for (int m = 0; m < KC; ++m) {
      const float d = geo[3][m] - cc;
      r[m] = expf(-gamma * d * d);
    }
    store_tile<KC>(buf, r);
  }
  __syncthreads();

  // acc[m] = sum over the n_rbf rows j of rbf[j][m] * w_rbf[j][c], j in
  // increasing order.
  float acc[KC];
#pragma unroll
  for (int m = 0; m < KC; ++m) acc[m] = 0.f;
#pragma unroll 4
  for (int j = 0; j < n_rbf; ++j) {
    const float wj = __ldg(p.w_rbf + j * W + c);
    const float4* row = reinterpret_cast<const float4*>(buf + j * KC);
#pragma unroll
    for (int q = 0; q < KC / 4; ++q) {
      const float4 v = row[q];
      acc[4 * q + 0] = fmaf(v.x, wj, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(v.y, wj, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, wj, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, wj, acc[4 * q + 3]);
    }
  }
  {
    const float g0 = p.w_geo[c], g1 = p.w_geo[W + c], g2 = p.w_geo[2 * W + c];
    const float g3 = p.w_geo[3 * W + c], bb = p.b0[c];
#pragma unroll
    for (int m = 0; m < KC; ++m)
      acc[m] = gelu_tanh(acc[m] + geo[0][m] * g0 + geo[1][m] * g1 +
                         geo[2][m] * g2 + geo[3][m] * g3 + bb);
  }
  __syncthreads();
  store_tile<KC>(buf, acc);
  __syncthreads();
  matmul_tile<KC>(buf, p.w1, p.b1[c], acc);
#pragma unroll
  for (int m = 0; m < KC; ++m) acc[m] = gelu_tanh(acc[m]);
  __syncthreads();
  store_tile<KC>(buf, acc);
  __syncthreads();
  matmul_tile<KC>(buf, p.w2, p.b2[c], acc);
  layer_norm<KC>(acc, red);

  const float s = p.eln_s[c], b = p.eln_b[c];
#pragma unroll
  for (int m = 0; m < KC; ++m)
    if (k0 + m < k) e_out[(size_t)(i * k + k0 + m) * W + c] = acc[m] * s + b;
}

}  // namespace
