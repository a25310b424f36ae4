// The edge featurisation and encoder, positions to the edge embedding: the
// tile body on the tensor cores that edge_encoder.cu's kernel (the entries
// of gamd_tpu_torch.ops.encoder) and mega_forward.cu's encoder stage share,
// and the activation and LayerNorm helpers of the node stages.
//
// It computes the function of gamd_tpu/ops/pallas_encoder.py::
// _encoder_kernel (line 46) for each row of a tile: gather pos[i] and
// pos[j], min-image displacement in round form (rintf, half to even),
// distance, unit vector 1/(dist + 1e-8) (negated under flip_dir),
// standardised distance (dist - mean) / std, the RBF exp(-gamma (std -
// centre_c)^2) over the model's n_rbf centres, Linear(4 + n_rbf -> W) as
// rank-1 geometric terms plus the RBF product, the MLP activation (tanh-
// gelu or silu, JAX's mlp_act, pallas_model.py:63; a template form each),
// Linear, the activation, Linear, and LayerNorm (eps 1e-6) with its
// affine. With BOND (the water model) each row adds one more rank-1 term
// before the first activation, bond * w_geo[4], as
// gamd_tpu/ops/pallas_model.py::encode_edges (lines 212-223) does; BOND is
// a template switch, so the LJ encoder compiles to the code it had. ABL
// (mega.cuh, Ablate; the whole-model forward's benchmark forms only) takes
// out the RBF (std in every column of its product), the MLP (its two
// products and activations), the LayerNorm (the affine stays), or the
// activations (0.5 x).
//
// Precision: the three products (RBF, w1, w2) on the tensor cores as bf16
// x 3 with fp32 accumulation (edge_tc.cuh: JAX's edge_hilo arithmetic,
// about 2^-16 relative), the geometry, activations and the LayerNorm in
// fp32 epilogues, e written in fp32. The forward's stage takes tanhf and
// expf; edge_encoder.cu the fast exponential and division (FAST). The TPU
// kernel's single-pass bf16 operands and bf16 output, its one-hot hi/lo
// gathers and its zero-padding of the RBF rows to 128 are TPU choices, not
// part of the function: the RBF product runs over ceil(n_rbf / 16)
// k-steps of 16.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tc.cuh"
#include "mega.cuh"
#include "tile.cuh"

// One device pointer per field of gamd_tpu_torch.ops.encoder.EncoderParams,
// in the same order (the first ten fields of MegaWeights, mega.cuh).
// w_geo rows 0-3 weight the unit vector and the standardised distance,
// row 4 the bond channel;
// w_rbf holds at least n_rbf rows, one per centre; b0..b2 [W], w1/w2
// [W][W], eln_s/eln_b the LayerNorm affine [W]; centers [>= n_rbf].
struct EncoderWeights {
  const float *centers, *w_geo, *w_rbf, *b0, *w1, *b1, *w2, *b2, *eln_s,
      *eln_b;
};

// What an encoder tile reads besides its rows and the split weights (w_rbf,
// w1, w2 go through the TMA map): the centres, the geometric rows of w0,
// the biases and the LayerNorm affine, the scalars and the MLP's
// activation code (Act), which the host reads to launch that activation's
// form of the kernel.
struct EncTileArgs {
  const float *centers, *w_geo, *b0, *b1, *b2, *eln_s, *eln_b;
  int n_rbf, flip_dir;
  float box, length_mean, length_std, gamma;
  int mact;
};

namespace {

constexpr float LN_EPS = 1e-6f;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;   // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// The same tanh-gelu as x sigmoid(2u), u = sqrt(2/pi) (x + 0.044715 x^3),
// with the fast exponential and division: 0.5 x (1 + tanh u) = x / (1 +
// exp(-2u)), within about 2^-20 of it (the products' bf16 x 3 error is
// 2^-16).
__device__ __forceinline__ float gelu_fast(float x) {
  const float c2 = 1.5957691216057308f;   // 2 sqrt(2/pi)
  return __fdividef(x, 1.0f + __expf(-c2 * (x + 0.044715f * x * x * x)));
}

// The activations the kernels take (gamd_tpu_torch.ops.mega.ACT_CODES):
// silu and tanh-gelu.
enum Act { ACT_SILU = 0, ACT_GELU = 1 };

struct SiluAct {
  __device__ __forceinline__ float operator()(float x) const {
    return silu(x);
  }
};
struct GeluAct {
  __device__ __forceinline__ float operator()(float x) const {
    return gelu_tanh(x);
  }
};
struct SiluFastAct {
  __device__ __forceinline__ float operator()(float x) const {
    return tc::silu_fast(x);
  }
};
struct GeluFastAct {
  __device__ __forceinline__ float operator()(float x) const {
    return gelu_fast(x);
  }
};
// The benchmark's `acts` form (ABL_ACTS): every activation 0.5 x.
struct HalfAct {
  __device__ __forceinline__ float operator()(float x) const {
    return 0.5f * x;
  }
};

// The activation of code ACT (FAST: the fast forms), 0.5 x in ABL_ACTS's
// form. Every kernel fixes its activations at compile time, a form a
// code, which the host picks at launch: a run-time branch in the edge
// tiles' epilogues measured 16% slower on the H100.
template <bool FAST, int ABL, int ACT>
__device__ __forceinline__ auto act_of() {
  if constexpr (ABL == ABL_ACTS) {
    return HalfAct{};
  } else if constexpr (ACT == ACT_SILU) {
    if constexpr (FAST) return SiluFastAct{}; else return SiluAct{};
  } else {
    if constexpr (FAST) return GeluFastAct{}; else return GeluAct{};
  }
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

// The geometry of the edge from atom i (position pi) to atom j (pj): g =
// unit vector and standardised distance. Returns d^2.
__device__ __forceinline__ float edge_geometry(const float* __restrict__ pi,
                                               const float* __restrict__ pj,
                                               const EncTileArgs& a,
                                               float (&g)[4]) {
  float rx = pj[0] - pi[0], ry = pj[1] - pi[1], rz = pj[2] - pi[2];
  rx -= a.box * rintf(rx / a.box);
  ry -= a.box * rintf(ry / a.box);
  rz -= a.box * rintf(rz / a.box);
  const float d2 = rx * rx + ry * ry + rz * rz;
  const float dist = sqrtf(d2);
  const float inv = (a.flip_dir ? -1.0f : 1.0f) / (dist + 1e-8f);
  g[0] = rx * inv;
  g[1] = ry * inv;
  g[2] = rz * inv;
  g[3] = (dist - a.length_mean) / a.length_std;
  return d2;
}

// The first pre-activation of a row's column c: the RBF product's acc,
// the rank-1 geometric terms and b0, and with BOND the bond's (one fma
// after the LJ sum, so that a bond of 0 gives the LJ bits).
template <bool BOND>
__device__ __forceinline__ float first_pre(float acc, const float (&g)[4],
                                           const EncTileArgs& a, int c,
                                           float bond) {
  float z = acc + g[0] * a.w_geo[c] + g[1] * a.w_geo[W + c] +
            g[2] * a.w_geo[2 * W + c] + g[3] * a.w_geo[3 * W + c] + a.b0[c];
  if constexpr (BOND) z = __fmaf_rn(bond, a.w_geo[4 * W + c], z);
  return z;
}

// The encoder of one tile of 64 rows, by the block's two warpgroups: the
// calling thread holds rows f.r0 and f.r0 + 8 (geometry geo[s], written to
// e at row[s] * W where live[s]). Products p, p + 1, p + 2 of the ring are
// the split w_rbf, w1, w2 (under ABL_RBF w1, w2 at p, p + 1; under
// ABL_ENCMLP w_rbf alone); each is released after it (the last one's
// release lets a persistent block's next tile write the activations and
// load its weights). red is the LayerNorm's exchange between the
// warpgroups. FAST takes the fast activations and the fast exponential
// for the RBF; RBF_STEPS > 0 runs the RBF product over that many k-steps
// of 16 (its zero columns past n_rbf add nothing), 0 over ceil(n_rbf /
// 16) known at run time. BOND adds bond[s] * w_geo[4] to row s's first
// pre-activation; without it `bond` is not read. MACT is the MLP's
// activation (Act) and ABL the form (Ablate).
template <int NBUF, bool FAST, int RBF_STEPS, bool BOND, int ABL, int MACT>
__device__ __forceinline__ void encode_tile(
    const tc::WeightRing<NBUF>& sm, const CUtensorMap* wmap, int p,
    const tc::Frag& f, const EncTileArgs& a, const float (&geo)[2][4],
    const bool (&live)[2], const size_t (&row)[2],
    float (&red)[2][2][tc::TILE], float* __restrict__ e,
    const float* bond = nullptr) {
  constexpr bool RBF = ABL != ABL_RBF, MLP = ABL != ABL_ENCMLP;
  constexpr bool LN = ABL != ABL_LN;
  float acc[2 * tc::PAIRS];
  if constexpr (RBF) {
    // RBF operand: column c < n_rbf holds exp(-gamma (std - centre_c)^2).
#pragma unroll
    for (int q = 0; q < tc::PAIRS; ++q) {
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = f.col(q) + u;
        const float d = geo[q & 1][3] - (c < a.n_rbf ? a.centers[c] : 0.f);
        v[u] = c < a.n_rbf ? (FAST ? __expf(-a.gamma * d * d)
                                   : expf(-a.gamma * d * d))
                           : 0.f;
      }
      tc::store_pair(sm.a, f, q, v[0], v[1]);
    }
    tc::activations_ready();
    sm.product(acc, p, f.wg,
               RBF_STEPS > 0 ? RBF_STEPS : (a.n_rbf + 15) / 16);
    sm.release(wmap, p);
  } else {   // std in every column of the RBF product
#pragma unroll
    for (int q = 0; q < tc::PAIRS; ++q)
      acc[2 * q] = acc[2 * q + 1] = geo[q & 1][3];
  }
  const float bonds[2] = {BOND ? bond[0] : 0.f, BOND ? bond[1] : 0.f};
  if constexpr (MLP) {
    const int p1 = RBF ? p + 1 : p;   // w1's product
    const auto act = act_of<FAST, ABL, MACT>();
#pragma unroll
    for (int q = 0; q < tc::PAIRS; ++q) {
      const int c = f.col(q), s = q & 1;
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        v[u] = act(first_pre<BOND>(acc[2 * q + u], geo[s], a, c + u,
                                   bonds[s]));
      tc::store_pair(sm.a, f, q, v[0], v[1]);
    }
    tc::activations_ready();
    sm.product(acc, p1, f.wg);
    sm.release(wmap, p1);
#pragma unroll
    for (int q = 0; q < tc::PAIRS; ++q) {
      const float2 b = tc::ld2(a.b1 + f.col(q));
      tc::store_pair(sm.a, f, q, act(acc[2 * q] + b.x),
                     act(acc[2 * q + 1] + b.y));
    }
    tc::activations_ready();
    sm.product(acc, p1 + 1, f.wg);
    sm.release(wmap, p1 + 1);
  } else {   // the first pre-activation is the row's embedding
#pragma unroll
    for (int q = 0; q < tc::PAIRS; ++q)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        acc[2 * q + u] = first_pre<BOND>(acc[2 * q + u], geo[q & 1], a,
                                         f.col(q) + u, bonds[q & 1]);
  }

  if constexpr (!LN) {   // + b2 and the affine alone
#pragma unroll
    for (int q = 0; q < tc::PAIRS; ++q) {
      const int s = q & 1, c = f.col(q);
      if (!live[s]) continue;
      float2 z = make_float2(acc[2 * q], acc[2 * q + 1]);
      if constexpr (MLP) {
        const float2 b = tc::ld2(a.b2 + c);
        z.x += b.x;
        z.y += b.y;
      }
      const float2 sc = tc::ld2(a.eln_s + c), sh = tc::ld2(a.eln_b + c);
      *reinterpret_cast<float2*>(e + row[s] * W + c) =
          make_float2(z.x * sc.x + sh.x, z.y * sc.y + sh.y);
    }
    return;
  }

  // + b2, then LayerNorm of each row over its 128 values: the quad's four
  // threads of each warpgroup, then the two warpgroups, in a fixed order.
  float stat[2] = {0.f, 0.f};
#pragma unroll
  for (int q = 0; q < tc::PAIRS; ++q) {
    if constexpr (MLP) {
      const float2 b = tc::ld2(a.b2 + f.col(q));
      acc[2 * q] += b.x;
      acc[2 * q + 1] += b.y;
    }
    stat[q & 1] += acc[2 * q] + acc[2 * q + 1];
  }
  float mean[2], rstd[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    stat[s] += __shfl_xor_sync(0xffffffffu, stat[s], 1);
    stat[s] += __shfl_xor_sync(0xffffffffu, stat[s], 2);
    if (f.q == 0) red[0][f.wg][f.r0 + 8 * s] = stat[s];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r = f.r0 + 8 * s;
    mean[s] = (red[0][0][r] + red[0][1][r]) * (1.0f / W);
    stat[s] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < tc::PAIRS; ++q) {
    acc[2 * q] -= mean[q & 1];
    acc[2 * q + 1] -= mean[q & 1];
    stat[q & 1] += acc[2 * q] * acc[2 * q] + acc[2 * q + 1] * acc[2 * q + 1];
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    stat[s] += __shfl_xor_sync(0xffffffffu, stat[s], 1);
    stat[s] += __shfl_xor_sync(0xffffffffu, stat[s], 2);
    if (f.q == 0) red[1][f.wg][f.r0 + 8 * s] = stat[s];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r = f.r0 + 8 * s;
    rstd[s] = rsqrtf((red[1][0][r] + red[1][1][r]) * (1.0f / W) + LN_EPS);
  }
#pragma unroll
  for (int q = 0; q < tc::PAIRS; ++q) {
    const int s = q & 1, c = f.col(q);
    if (!live[s]) continue;
    const float2 sc = tc::ld2(a.eln_s + c), sh = tc::ld2(a.eln_b + c);
    *reinterpret_cast<float2*>(e + row[s] * W + c) =
        make_float2(acc[2 * q] * rstd[s] * sc.x + sh.x,
                    acc[2 * q + 1] * rstd[s] * sc.y + sh.y);
  }
}

}  // namespace
