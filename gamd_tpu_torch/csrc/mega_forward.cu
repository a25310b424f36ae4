// Whole-model GAMD forward for Hopper (sm_90a): wrapped positions, a
// build-time neighbour list and packed weights in, per-atom forces out.
//
// Replaces gamd_tpu/ops/pallas_model.py::_mega_kernel (line 677; its body is
// _forward_body, lines 291-600), reached through mega_forward there. It
// computes the same function: min-image geometry in round form, the live
// mask (build mask and d^2 < cutoff^2), RBF + rank-1 geometric terms into
// the tanh-gelu encoder MLP and the edge LayerNorm (encode_kernel, in
// encode.cuh, shared with edge_encoder.cu), L edge-gated conv layers
// (pre-norm LayerNorm or folded BatchNorm, silu), and the tanh-gelu decoder
// whose last affine already holds the force denormalisation.
//
// What bounds it on this card: per force call at LJ-258 (N=258, K=48,
// every width 128, L=4, 40 RBF centres) the edge MLPs take about 300k
// multiply-adds per live edge. A frame of the 100 K fluid has about 5,500
// live edges of the 12,384 slots, so with the node-level products the
// forces need about 3.5 GFLOP, against about 2.3 MB of compulsory traffic
// (weights and inputs read once). The work is compute-bound: about 52 us
// at the fp32 CUDA-core peak (67 TFLOP/s). This kernel computes every
// slot, dead ones too, over all 128 padded RBF rows (7.9 GFLOP): skipping
// dead slots is later work.
//
// What the design does about it, for now: it is the simple, exact fp32
// version. Threads own one output channel each (128 threads = one width)
// and run fp32 FMAs against a tile of activations held in shared memory
// (one edge chunk of KC=16 edges, or NB=8 atoms), reading each weight
// once per tile from L1/L2. 16 edges per weight load keep the FMA units
// busier than the loads. Row gathers (neighbour positions, src codes,
// normalised node rows) are plain coalesced global loads: Hopper gathers
// rows natively, so none of the TPU's one-hot matmul gathers, hi/lo bf16
// splits or VMEM caps are carried over. Sums over a neighbour list are
// taken in a fixed order inside a block, partial sums per edge chunk are
// added in a fixed order by the node update: no atomics, and the result is
// the same from run to run. Tensor cores (wgmma), TMA and bf16 are later
// work. 14 launches per call at L=4: encoder, then per layer node norm,
// edge stage and node update, then the decoder.
//
// The host passes every pointer, allocates all scratch with torch.empty
// and launches on PyTorch's current stream; gamd_mega_forward returns the
// first non-zero cudaGetLastError() after any launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode.cuh"
#include "mega.cuh"
#include "tile.cuh"

namespace {

constexpr int NB = 8;    // atoms per block in the node stages

// Node stage of one layer. grid ceil(N/NB), block W.
// hn = norm(h) * s + b; src = hn @ w_src + b; dst = hn @ w_dst + b.
__global__ void __launch_bounds__(W)
node_kernel(const float* __restrict__ h, MegaWeights p, int layer, int n,
            int use_ln, float* __restrict__ hn_out, float* __restrict__ src_out,
            float* __restrict__ dst_out) {
  __shared__ __align__(16) float buf[W * NB];
  __shared__ float red[NWARP * NB];
  const int a0 = blockIdx.x * NB, c = threadIdx.x;
  const int lw = layer * W * W, lb = layer * W;

  float x[NB];
#pragma unroll
  for (int m = 0; m < NB; ++m) x[m] = (a0 + m < n) ? h[(a0 + m) * W + c] : 0.f;
  if (use_ln) layer_norm<NB>(x, red);
  const float s = p.nln_s[lb + c], b = p.nln_b[lb + c];
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    x[m] = x[m] * s + b;
    if (a0 + m < n) hn_out[(a0 + m) * W + c] = x[m];
  }
  store_tile<NB>(buf, x);
  __syncthreads();

  float acc[NB];
  matmul_tile<NB>(buf, p.w_src + lw, p.b_src[lb + c], acc);
#pragma unroll
  for (int m = 0; m < NB; ++m)
    if (a0 + m < n) src_out[(a0 + m) * W + c] = acc[m];
  matmul_tile<NB>(buf, p.w_dst + lw, p.b_dst[lb + c], acc);
#pragma unroll
  for (int m = 0; m < NB; ++m)
    if (a0 + m < n) dst_out[(a0 + m) * W + c] = acc[m];
}

// Edge stage of one layer. grid (ceil(K/KC), N), block W: one chunk of KC
// edges of atom i.
//   z = silu(e @ w_e1 + b) @ w_e2 + b + src[idx] + dst[i]
//   g = silu(silu(z) @ w_t1 + b) @ w_t2 + b
//   aggp[i, chunk] = sum over live edges of hn[idx] * g
__global__ void __launch_bounds__(W)
edge_kernel(const float* __restrict__ e, const float* __restrict__ live,
            const int* __restrict__ idx, const float* __restrict__ hn,
            const float* __restrict__ src, const float* __restrict__ dst,
            MegaWeights p, int layer, int n, int k,
            float* __restrict__ aggp) {
  __shared__ __align__(16) float buf_a[W * KC];
  __shared__ __align__(16) float buf_b[W * KC];
  __shared__ int idx_s[KC];
  __shared__ float live_s[KC];
  const int i = blockIdx.y, k0 = blockIdx.x * KC, c = threadIdx.x;
  const int lw = layer * W * W, lb = layer * W;

  if (c < KC) {
    const int kk = k0 + c;
    idx_s[c] = kk < k ? idx[i * k + kk] : i;
    live_s[c] = kk < k ? live[i * k + kk] : 0.f;
  }
  {
    float x[KC];
#pragma unroll
    for (int m = 0; m < KC; ++m)
      x[m] = (k0 + m < k) ? e[(size_t)(i * k + k0 + m) * W + c] : 0.f;
    store_tile<KC>(buf_a, x);
  }
  __syncthreads();

  float acc[KC];
  matmul_tile<KC>(buf_a, p.w_e1 + lw, p.b_e1[lb + c], acc);
#pragma unroll
  for (int m = 0; m < KC; ++m) acc[m] = silu(acc[m]);
  store_tile<KC>(buf_b, acc);
  __syncthreads();
  matmul_tile<KC>(buf_b, p.w_e2 + lw, p.b_e2[lb + c], acc);
  {
    const float dc = dst[i * W + c];
#pragma unroll
    for (int m = 0; m < KC; ++m)
      acc[m] = silu(acc[m] + src[idx_s[m] * W + c] + dc);
  }
  // buf_a was last read before the barrier above: free to overwrite.
  store_tile<KC>(buf_a, acc);
  __syncthreads();
  matmul_tile<KC>(buf_a, p.w_t1 + lw, p.b_t1[lb + c], acc);
#pragma unroll
  for (int m = 0; m < KC; ++m) acc[m] = silu(acc[m]);
  store_tile<KC>(buf_b, acc);
  __syncthreads();
  matmul_tile<KC>(buf_b, p.w_t2 + lw, p.b_t2[lb + c], acc);

  float s = 0.f;
#pragma unroll
  for (int m = 0; m < KC; ++m)
    if (live_s[m] != 0.f) s += hn[idx_s[m] * W + c] * acc[m];
  aggp[((size_t)i * gridDim.x + blockIdx.x) * W + c] = s;
}

// Node update of one layer. grid ceil(N/NB), block W.
//   agg = sum over chunks of aggp; h += silu(hn @ w_pd + b + agg @ w_pe + b)
//   @ w_p + b
__global__ void __launch_bounds__(W)
update_kernel(float* __restrict__ h, const float* __restrict__ hn,
              const float* __restrict__ aggp, int n_chunk, MegaWeights p,
              int layer, int n) {
  __shared__ __align__(16) float buf_h[W * NB];
  __shared__ __align__(16) float buf_g[W * NB];
  const int a0 = blockIdx.x * NB, c = threadIdx.x;
  const int lw = layer * W * W, lb = layer * W;

  {
    float x[NB], g[NB];
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      x[m] = 0.f;
      g[m] = 0.f;
      if (a0 + m < n) {
        x[m] = hn[(a0 + m) * W + c];
        const float* ap = aggp + (size_t)(a0 + m) * n_chunk * W + c;
        for (int q = 0; q < n_chunk; ++q) g[m] += ap[q * W];
      }
    }
    store_tile<NB>(buf_h, x);
    store_tile<NB>(buf_g, g);
  }
  __syncthreads();

  float acc[NB], acc2[NB];
  matmul_tile<NB>(buf_h, p.w_pd + lw, p.b_pd[lb + c], acc);
  matmul_tile<NB>(buf_g, p.w_pe + lw, p.b_pe[lb + c], acc2);
#pragma unroll
  for (int m = 0; m < NB; ++m) acc[m] = silu(acc[m] + acc2[m]);
  __syncthreads();
  store_tile<NB>(buf_h, acc);
  __syncthreads();
  matmul_tile<NB>(buf_h, p.w_p + lw, p.b_p[lb + c], acc);
#pragma unroll
  for (int m = 0; m < NB; ++m)
    if (a0 + m < n) h[(a0 + m) * W + c] += acc[m];
}

// Decoder. grid ceil(N/NB), block W.
//   f = gelu(h @ wd0 + bd0) @ wd1[:, :3] + bd1[:3]
__global__ void __launch_bounds__(W)
decode_kernel(const float* __restrict__ h, MegaWeights p, int n,
              float* __restrict__ out) {
  __shared__ __align__(16) float buf[W * NB];
  const int a0 = blockIdx.x * NB, c = threadIdx.x;

  float x[NB];
#pragma unroll
  for (int m = 0; m < NB; ++m) x[m] = (a0 + m < n) ? h[(a0 + m) * W + c] : 0.f;
  store_tile<NB>(buf, x);
  __syncthreads();
  float acc[NB];
  matmul_tile<NB>(buf, p.wd0, p.bd0[c], acc);
#pragma unroll
  for (int m = 0; m < NB; ++m) acc[m] = gelu_tanh(acc[m]);
  __syncthreads();
  store_tile<NB>(buf, acc);
  __syncthreads();

  if (c < NB * 3) {
    const int m = c / 3, o = c % 3;
    float s = p.bd1[o];
    for (int j = 0; j < W; ++j) s = fmaf(buf[j * NB + m], p.wd1[j * W + o], s);
    if (a0 + m < n) out[(a0 + m) * 3 + o] = s;
  }
}

}  // namespace

// All launches of one forward on `stream`. Returns 0, or the first
// non-zero cudaError_t seen after a launch or the h0 copy.
extern "C" int gamd_mega_forward(
    const float* pos, const int* idx, const uint8_t* bmask, const float* h0,
    const MegaWeights* weights, int n, int k, int n_layers, int use_ln,
    int flip_dir, float box, float cutoff2, float length_mean,
    float length_std, float gamma, float* e, float* live, float* h, float* hn,
    float* src, float* dst, float* aggp, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MegaWeights p = *weights;
  const int n_chunk = (k + KC - 1) / KC;
  const int n_blk = (n + NB - 1) / NB;
  const dim3 edge_grid(n_chunk, n);
  cudaError_t err;

  const EncoderWeights enc{p.centers, p.w_geo, p.w_rbf, p.b0, p.w1,
                           p.b1, p.w2, p.b2, p.eln_s, p.eln_b};
  encode_kernel<float><<<edge_grid, W, 0, s>>>(
      pos, idx, bmask, enc, W, n, k, flip_dir, box, cutoff2, length_mean,
      length_std, gamma, e, live);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyAsync(h, h0, sizeof(float) * n * W,
                        cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int layer = 0; layer < n_layers; ++layer) {
    node_kernel<<<n_blk, W, 0, s>>>(h, p, layer, n, use_ln, hn, src, dst);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    edge_kernel<<<edge_grid, W, 0, s>>>(e, live, idx, hn, src, dst, p, layer,
                                        n, k, aggp);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    update_kernel<<<n_blk, W, 0, s>>>(h, hn, aggp, n_chunk, p, layer, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  decode_kernel<<<n_blk, W, 0, s>>>(h, p, n, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return 0;
}
