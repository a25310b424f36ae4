// Backward of one conv layer's edge pipeline (conv_msg_gather.cu) for
// Hopper (sm_90a): given the cotangent g [M, D] of agg, the gradients of
// e, hn, src, dst and of the eight weights and biases.
//
// Replaces gamd_tpu/ops/pallas_mp.py::_conv_msg_gather_bwd_kernel (line 530,
// pallas_call at line 658; wrapper _conv_msg_gather_backward, line 624). It
// recomputes the edge pipeline of a tile (s1 = e W1 + b1, z1 = silu(s1),
// z2 = z1 W2 + b2 + src[idx] + dst, a2 = silu(z2), s3 = a2 W3 + b3,
// z3 = silu(s3), m = z3 W4 + b4) and runs the reverse sweep of
// pallas_mp.py:588-621:
//   g_rows = mask g[i];  g_m = g_rows h_src;  g_hsrc = g_rows m
//   g_s3 = (g_m W4^T) silu'(s3);  g_z2 = (g_s3 W3^T) silu'(z2)
//   g_s1 = (g_z2 W2^T) silu'(s1); ge = g_s1 W1^T (exact 0 on masked slots)
// and three reductions leave the edge:
//   gdst[i]  = sum_k g_z2[i,k]          per-chunk partials, fixed-order sum;
//   ghn[j], gsrc[j] = sum of g_hsrc, g_z2 over the live edges with
//                     idx = j           a segmented sum per target node over
//                     the edges ordered by (i, k): the host sorts the edge
//                     ids by target (index bookkeeping, torch.sort) and this
//                     file adds the gradient rows;
//   dW = sum_rows act^T grad for (e, g_s1), (z1, g_z2), (a2, g_s3), (z3,
//        g_m), and the bias sums of the grads: each of 32 fixed ranges of
//        the live edges writes a partial [W, W] per weight, a second kernel
//        adds the 32 partials in order.
// No atomics anywhere, so the result is the same from run to run.
//
// What bounds it on this card: per call at the training slice (LJ-258,
// K=96, widths 128, about 5,500 live edges of 24,768 slots) the recompute,
// the input-gradient products and the weight-gradient products need about
// 3 x 0.72 = 2.2 GFLOP, about 32 us at the 67 TFLOP/s fp32 peak, against
// reading e and writing ge (25.4 MB, about 8 us at 3.35 TB/s):
// operations-bound.
//
// What the design does about it, for now: the simple exact fp32 version.
// The edge kernel is the forward's block (one thread per channel, a chunk
// of KC=16 slots, FMAs against shared-memory tiles) run forward and back;
// the transposed weights come from the host. Chunks with no live slot
// write zeros and stop. The weight gradients read per-edge activations and
// gradients that the edge kernel writes for live slots only, to one
// scratch block of 8 x [M*K, W] fp32 (z1, a2, z3, g_m, g_s3, g_z2, g_s1,
// g_hsrc; 101 MB at M*K = 24,768, of which the live rows, about 23 MB, are
// written and read): recomputing them inside the weight-gradient kernel
// would trade those bytes for a second copy of the recompute. Five
// launches a call. wgmma, TMA and bf16 are later work.
//
// The host allocates every buffer (scratch included) with torch.empty and
// launches on PyTorch's current stream; gamd_conv_msg_gather_bwd returns the
// first non-zero cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

// N_ROWS and N_RANGE size the host's scratch: gamd_tpu_torch/ops/
// conv_gather.py mirrors them (SCRATCH_PLANES, WGRAD_RANGES).
constexpr int N_ROWS = 8;      // per-edge planes of the scratch block
constexpr int Z1 = 0, A2 = 1, Z3 = 2, GM = 3, GS3 = 4, GZ2 = 5, GS1 = 6,
              GHS = 7;
constexpr int AT = 32;         // rows of a weight gradient per block
constexpr int RB = 16;         // edges staged in shared memory per pass
constexpr int N_RANGE = 32;    // edge ranges of the weight-gradient partials

// The weights, biases and transposed weights of the edge pipeline.
struct ConvGradWeights {
  const float *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4;
  const float *w1t, *w2t, *w3t, *w4t;
};

// Activation and gradient planes of the four weight-gradient products.
struct WgradPlanes {
  const float* act[4];
  const float* grad[4];
};

__device__ __forceinline__ float dsilu(float x) {
  const float s = 1.0f / (1.0f + expf(-x));
  return s * (1.0f + x * (1.0f - s));
}

// grid (ceil(K/KC), M), block W: one chunk of KC slots of row i, recomputed
// and swept back. Writes ge for every slot, the chunk's gdst partial, and
// the per-edge planes of its live slots.
__global__ void __launch_bounds__(W)
bwd_edge_kernel(const float* __restrict__ g, const float* __restrict__ e,
                const int* __restrict__ idx, const uint8_t* __restrict__ mask,
                const float* __restrict__ hn, const float* __restrict__ src,
                const float* __restrict__ dst, ConvGradWeights p, int k,
                size_t plane, float* __restrict__ rows,
                float* __restrict__ gdstp, float* __restrict__ ge) {
  __shared__ __align__(16) float buf_a[W * KC];
  __shared__ __align__(16) float buf_b[W * KC];
  __shared__ int idx_s[KC];
  __shared__ int live_s[KC];
  const int i = blockIdx.y, k0 = blockIdx.x * KC, c = threadIdx.x;
  const size_t row0 = (size_t)i * k + k0;

  int live = 0;
  if (c < KC) {
    const int kk = k0 + c;
    live = kk < k && mask[row0 + c];
    idx_s[c] = kk < k ? idx[row0 + c] : i;
    live_s[c] = live;
  }
  float* gdst_out = gdstp + ((size_t)i * gridDim.x + blockIdx.x) * W + c;
  if (!__syncthreads_or(live)) {
#pragma unroll
    for (int m = 0; m < KC; ++m)
      if (k0 + m < k) ge[(row0 + m) * W + c] = 0.f;
    *gdst_out = 0.f;
    return;
  }
  // Plane t of slot m: rows[t * plane + (row0 + m) * W + c], live slots only.
  auto put = [&](int t, int m, float v) {
    if (live_s[m]) rows[t * plane + (row0 + m) * W + c] = v;
  };

  {
    float x[KC];
#pragma unroll
    for (int m = 0; m < KC; ++m)
      x[m] = (k0 + m < k) ? e[(row0 + m) * W + c] : 0.f;
    store_tile<KC>(buf_a, x);
  }
  __syncthreads();

  // ---- recompute ----------------------------------------------------------
  float s1[KC], z2[KC], s3[KC], acc[KC];
  matmul_tile<KC>(buf_a, p.w1, p.b1[c], acc);
#pragma unroll
  for (int m = 0; m < KC; ++m) {
    s1[m] = acc[m];
    acc[m] = silu(acc[m]);
    put(Z1, m, acc[m]);
  }
  store_tile<KC>(buf_b, acc);
  __syncthreads();
  matmul_tile<KC>(buf_b, p.w2, p.b2[c], acc);
  {
    const float dc = dst[(size_t)i * W + c];
#pragma unroll
    for (int m = 0; m < KC; ++m) {
      z2[m] = acc[m] + src[(size_t)idx_s[m] * W + c] + dc;
      acc[m] = silu(z2[m]);
      put(A2, m, acc[m]);
    }
  }
  // Each tile below overwrites a buffer whose last reader ran before the
  // barrier that precedes the store.
  store_tile<KC>(buf_a, acc);
  __syncthreads();
  matmul_tile<KC>(buf_a, p.w3, p.b3[c], acc);
#pragma unroll
  for (int m = 0; m < KC; ++m) {
    s3[m] = acc[m];
    acc[m] = silu(acc[m]);
    put(Z3, m, acc[m]);
  }
  store_tile<KC>(buf_b, acc);
  __syncthreads();
  matmul_tile<KC>(buf_b, p.w4, p.b4[c], acc);            // m

  // ---- reverse sweep -------------------------------------------------------
  {
    const float gi = g[(size_t)i * W + c];
#pragma unroll
    for (int m = 0; m < KC; ++m) {
      const float gr = live_s[m] ? gi : 0.f;
      put(GHS, m, gr * acc[m]);
      acc[m] = gr * hn[(size_t)idx_s[m] * W + c];        // g_m
      put(GM, m, acc[m]);
    }
  }
  store_tile<KC>(buf_a, acc);
  __syncthreads();
  matmul_tile<KC>(buf_a, p.w4t, 0.f, acc);               // g_z3
#pragma unroll
  for (int m = 0; m < KC; ++m) {
    acc[m] *= dsilu(s3[m]);                                // g_s3
    put(GS3, m, acc[m]);
  }
  store_tile<KC>(buf_b, acc);
  __syncthreads();
  matmul_tile<KC>(buf_b, p.w3t, 0.f, acc);               // g_a2
  {
    float gsum = 0.f;
#pragma unroll
    for (int m = 0; m < KC; ++m) {
      acc[m] *= dsilu(z2[m]);                              // g_z2
      put(GZ2, m, acc[m]);
      if (live_s[m]) gsum += acc[m];
    }
    *gdst_out = gsum;
  }
  store_tile<KC>(buf_a, acc);
  __syncthreads();
  matmul_tile<KC>(buf_a, p.w2t, 0.f, acc);               // g_z1
#pragma unroll
  for (int m = 0; m < KC; ++m) {
    acc[m] *= dsilu(s1[m]);                                // g_s1
    put(GS1, m, acc[m]);
  }
  store_tile<KC>(buf_b, acc);
  __syncthreads();
  matmul_tile<KC>(buf_b, p.w1t, 0.f, acc);               // ge
#pragma unroll
  for (int m = 0; m < KC; ++m)
    if (k0 + m < k) ge[(row0 + m) * W + c] = live_s[m] ? acc[m] : 0.f;
}

// grid M, block W: ghn[j] and gsrc[j], the sums of the g_hsrc and g_z2 rows
// of the live edges whose source is node j, in the order of `order`
// between offsets[j] and offsets[j + 1].
__global__ void __launch_bounds__(W)
bwd_node_kernel(const int* __restrict__ order, const int* __restrict__ offsets,
                const float* __restrict__ ghs, const float* __restrict__ gz2,
                float* __restrict__ ghn, float* __restrict__ gsrc) {
  const int j = blockIdx.x, c = threadIdx.x;
  float sh = 0.f, ss = 0.f;
  for (int q = offsets[j]; q < offsets[j + 1]; ++q) {
    const size_t r = (size_t)order[q] * W + c;
    sh += ghs[r];
    ss += gz2[r];
  }
  ghn[(size_t)j * W + c] = sh;
  gsrc[(size_t)j * W + c] = ss;
}

// grid (N_RANGE, 4, W / AT), block W. Block (q, t, z) adds, over the live
// edges of range q (positions of `order`), act_t[r][a] * grad_t[r][c] for
// its AT rows a of weight t and the thread's column c, and (z == 0) the
// bias sum grad_t[r][c]; partials go to wpart [4, N_RANGE, W, W] and
// bpart [4, N_RANGE, W].
__global__ void __launch_bounds__(W)
wgrad_kernel(const int* __restrict__ order, const int* __restrict__ offsets,
             int m_nodes, WgradPlanes planes, float* __restrict__ wpart,
             float* __restrict__ bpart) {
  __shared__ __align__(16) float act_s[RB][AT];
  __shared__ int row_s[RB];
  const int q = blockIdx.x, t = blockIdx.y, a0 = blockIdx.z * AT;
  const int c = threadIdx.x;
  const int n_live = offsets[m_nodes];
  const int per = (n_live + N_RANGE - 1) / N_RANGE;
  const int p0 = min(q * per, n_live), p1 = min(p0 + per, n_live);
  const float* act = planes.act[t];
  const float* grad = planes.grad[t];

  float acc[AT], bacc = 0.f;
#pragma unroll
  for (int m = 0; m < AT; ++m) acc[m] = 0.f;
  for (int base = p0; base < p1; base += RB) {
    const int cnt = min(RB, p1 - base);
    if (c < cnt) row_s[c] = order[base + c];
    __syncthreads();
    for (int x = c; x < cnt * AT; x += W)
      act_s[x / AT][x % AT] = act[(size_t)row_s[x / AT] * W + a0 + x % AT];
    __syncthreads();
    for (int r = 0; r < cnt; ++r) {
      const float gv = grad[(size_t)row_s[r] * W + c];
      bacc += gv;
      const float4* ar = reinterpret_cast<const float4*>(act_s[r]);
#pragma unroll
      for (int v = 0; v < AT / 4; ++v) {
        const float4 a = ar[v];
        acc[4 * v + 0] = fmaf(a.x, gv, acc[4 * v + 0]);
        acc[4 * v + 1] = fmaf(a.y, gv, acc[4 * v + 1]);
        acc[4 * v + 2] = fmaf(a.z, gv, acc[4 * v + 2]);
        acc[4 * v + 3] = fmaf(a.w, gv, acc[4 * v + 3]);
      }
    }
    __syncthreads();
  }
  float* out = wpart + ((size_t)(t * N_RANGE + q) * W + a0) * W + c;
#pragma unroll
  for (int m = 0; m < AT; ++m) out[(size_t)m * W] = acc[m];
  if (blockIdx.z == 0) bpart[(size_t)(t * N_RANGE + q) * W + c] = bacc;
}

// grid (4, W + 1), block W: gw[t][a][c] = sum over ranges q in order of
// wpart[t][q][a][c]; the last row of the grid does the biases into gb[t].
__global__ void __launch_bounds__(W)
wgrad_sum_kernel(const float* __restrict__ wpart,
                 const float* __restrict__ bpart, float* __restrict__ gw,
                 float* __restrict__ gb) {
  const int t = blockIdx.x, a = blockIdx.y, c = threadIdx.x;
  float s = 0.f;
  if (a < W) {
    for (int q = 0; q < N_RANGE; ++q)
      s += wpart[((size_t)(t * N_RANGE + q) * W + a) * W + c];
    gw[((size_t)t * W + a) * W + c] = s;
  } else {
    for (int q = 0; q < N_RANGE; ++q)
      s += bpart[(size_t)(t * N_RANGE + q) * W + c];
    gb[(size_t)t * W + c] = s;
  }
}

}  // namespace

// Gradients of agg = conv_msg_gather(...) for the cotangent g [M, W]:
// ge [M*K, W], ghn/gsrc/gdst [M, W], gw [4, W, W] (W1..W4) and gb [4, W]
// (b1..b4). order [n_live] and offsets [M + 1] list the live edges by
// source node (order[offsets[j]:offsets[j+1]] are the flat slot ids i*K+k
// with mask set and idx = j, ascending). Scratch: rows [N_ROWS, M*K, W],
// gdstp [M, ceil(K/KC), W], wpart [4, N_RANGE, W, W], bpart
// [4, N_RANGE, W]. Returns 0, or the first non-zero
// cudaError_t seen after a launch.
extern "C" int gamd_conv_msg_gather_bwd(
    const float* g, const float* e, const int* idx, const uint8_t* mask,
    const float* hn, const float* src, const float* dst, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* w3,
    const float* b3, const float* w4, const float* b4, const float* w1t,
    const float* w2t, const float* w3t, const float* w4t, const int* order,
    const int* offsets, int m, int k, float* rows, float* gdstp, float* wpart,
    float* bpart, float* ge, float* ghn, float* gsrc, float* gdst, float* gw,
    float* gb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvGradWeights p{w1, b1, w2, b2, w3, b3, w4, b4, w1t, w2t, w3t, w4t};
  const int n_chunk = (k + KC - 1) / KC;
  const size_t plane = (size_t)m * k * W;
  const WgradPlanes planes{{e, rows + Z1 * plane, rows + A2 * plane,
                            rows + Z3 * plane},
                           {rows + GS1 * plane, rows + GZ2 * plane,
                            rows + GS3 * plane, rows + GM * plane}};
  cudaError_t err;
  bwd_edge_kernel<<<dim3(n_chunk, m), W, 0, s>>>(
      g, e, idx, mask, hn, src, dst, p, k, plane, rows, gdstp, ge);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_node_kernel<<<m, W, 0, s>>>(order, offsets, rows + GHS * plane,
                                  rows + GZ2 * plane, ghn, gsrc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chunk_sum_kernel<<<m, W, 0, s>>>(gdstp, n_chunk, gdst);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  wgrad_kernel<<<dim3(N_RANGE, 4, W / AT), W, 0, s>>>(order, offsets, m,
                                                      planes, wpart, bpart);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  wgrad_sum_kernel<<<dim3(4, W + 1), W, 0, s>>>(wpart, bpart, gw, gb);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return 0;
}
