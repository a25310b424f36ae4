// The node stages of the whole-model forward (mega_forward.cu), fused: one
// launch a layer takes each atom from the summed messages of its live
// edges to the next layer's codes, or to its force.
//
//   layer -1 (prologue): h = h0
//   layer l >= 0 (update): agg = sum of the atom's message rows, in their
//     compacted order (the live-edge layout, mega_forward.cu)
//     h = h + cact(hn @ Wpd + bpd + agg @ Wpe + bpe) @ Wp + bp
//   then, for l + 1 < L: hn = norm(h) * s + b (LayerNorm, eps 1e-6, or the
//     folded BatchNorm affine alone), src = hn @ Wsrc + b, dst = hn @ Wdst
//     + b of layer l + 1; for l = L - 1 the decoder,
//     f = mact(h @ Wd0 + bd0) @ Wd1[:, :3] + bd1[:3].
// cact and mact are JAX's conv_act and mlp_act (silu or tanh-gelu), the
// kernel's forms CACT and MACT (encode.cuh, Act), fixed at compile time.
// ABL (mega.cuh, Ablate; the benchmark's forms) takes out the LayerNorm (the affine stays), the node products
// (dst = hn, h = h + cact(hn + agg)), the source affine (src unwritten:
// the edge stage reads b_src), the sum (an atom takes its first message
// row), the decoder (f = h[:3]) or the activations (0.5 x); the weights
// the form skips are not staged.
//
// The node products are fp32 FMAs on the CUDA cores, as JAX keeps them
// fp32 (pallas_model.py:383-389, mmf): they are about 3% of a forward's
// operations, the residual stream compounds their error over the layers,
// and a block of B atoms (4 to 16) fills no 64-row tensor-core tile. One
// thread per channel, each weight matrix (64 KB fp32) staged whole into
// shared memory by a bulk copy (cp.async.bulk with an mbarrier), the next
// one in flight while the current one computes (two buffers). Every block
// reads all its weights from L2 (320 KB a layer), so B trades that traffic
// against the block's FMAs: the host picks the smallest B whose grid fits
// in one wave of the card's SMs (B = 4 at LJ-258, 65 blocks; 16 at 8
// replicas, 129 blocks). An atom's
// arithmetic is the same for any B and in any block: per channel, the
// weights' rows in order, one fmaf each; sums over channels in a fixed
// order (block_sum, tile.cuh); messages in compacted order. No atomics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tc.cuh"
#include "encode.cuh"
#include "mega.cuh"
#include "tile.cuh"

struct NodeArgs {
  MegaWeights p;
  const float* h0;      // [A, W], A = R * N atoms
  const int* off;       // [A] first message row of the atom, in its replica
  const int* cnt;       // [A] its live edges
  const float* msg;     // [R * cap, W]
  float *h, *hn, *src, *dst;   // [A, W]
  float* out;           // [A, 3]
  int atoms, n, cap, n_layers, use_ln;
  int cact, mact;       // activation codes (Act): the host launches their
                        // form
};

namespace {

constexpr int NODE_MAT_BYTES = W * W * 4;   // one fp32 weight matrix
constexpr int NODE_MIN_B = 4, NODE_MAX_B = 16;

// Bytes of dynamic shared memory of node_fused_kernel<B, ..>: two weight
// buffers and two activation tiles [W][B].
constexpr int node_smem_bytes(int b) {
  return 2 * NODE_MAT_BYTES + 2 * W * b * 4;
}

// acc[m] = bias + sum over j of x_s[j][m] * w_s[j][c], j in order, for the
// calling thread's channel c (w_s [W][W] fp32 in shared memory, x_s
// [W][B]).
template <int B>
__device__ __forceinline__ void node_product(const float* __restrict__ x_s,
                                             const float* __restrict__ w_s,
                                             float bias, float (&acc)[B]) {
  const int c = threadIdx.x;
#pragma unroll
  for (int m = 0; m < B; ++m) acc[m] = bias;
#pragma unroll 8
  for (int j = 0; j < W; ++j) {
    const float w = w_s[j * W + c];
#pragma unroll
    for (int m = 0; m < B; ++m) acc[m] = fmaf(x_s[j * B + m], w, acc[m]);
  }
}

template <int B>
__device__ __forceinline__ void node_store(float* __restrict__ x_s,
                                           const float (&v)[B]) {
#pragma unroll
  for (int m = 0; m < B; ++m) x_s[threadIdx.x * B + m] = v[m];
}

// grid ceil(A / B), block W, node_smem_bytes(B) of dynamic shared memory;
// ABL the form (Ablate), CACT and MACT the conv and MLP activations (Act).
template <int B, int ABL, int CACT, int MACT>
__global__ void __launch_bounds__(W, 1)
node_fused_kernel(NodeArgs a, int layer) {
  constexpr bool NODEOPS = ABL != ABL_NODEOPS;
  const auto cact = act_of<false, ABL, CACT>();
  extern __shared__ __align__(16) float node_smem[];
  float* wbuf = node_smem;                       // [2][W * W]
  float* x_s = node_smem + 2 * W * W;            // [W][B]
  float* y_s = x_s + W * B;                      // [W][B]
  __shared__ float red[NWARP * B];
  __shared__ __align__(8) uint64_t bars[2];
  const int c = threadIdx.x, a0 = blockIdx.x * B;
  const MegaWeights& p = a.p;
  const int last = a.n_layers - 1;

  // The weights in the order the products use them (at least one in every
  // form).
  const float* mats[5];
  int n_mats = 0;
  if (layer >= 0 && NODEOPS) {
    const size_t lw = (size_t)layer * W * W;
    mats[n_mats++] = p.w_pd + lw;
    mats[n_mats++] = p.w_pe + lw;
    mats[n_mats++] = p.w_p + lw;
  }
  if (layer < last) {
    const size_t nw = (size_t)(layer + 1) * W * W;
    if (ABL != ABL_SRCAFF) mats[n_mats++] = p.w_src + nw;
    if (NODEOPS) mats[n_mats++] = p.w_dst + nw;
  } else if (ABL != ABL_DECODER) {
    mats[n_mats++] = p.wd0;
  }
  const uint32_t buf0 = tc::smem_addr(wbuf);
  const uint32_t bar0 = tc::smem_addr(&bars[0]);
  auto stage = [&](int i) {       // one thread: matrix i into buffer i % 2
    tc::proxy_fence();
    tc::mbar_expect(bar0 + 8 * (i & 1), NODE_MAT_BYTES);
    tc::bulk_load(buf0 + (i & 1) * NODE_MAT_BYTES, mats[i], NODE_MAT_BYTES,
                  bar0 + 8 * (i & 1));
  };
  tc::let_next_start();
  if (c == 0) {   // the weights: inputs, not the previous kernel's output
    tc::mbar_init(bar0, 1);
    tc::mbar_init(bar0 + 8, 1);
    tc::mbar_init_fence();
    stage(0);
    if (n_mats > 1) stage(1);
  }
  // The prologue reads only h0 and weights, so it runs beside the encoder
  // and waits for it at its end (the next kernel then finds both done).
  if (layer >= 0) tc::grid_wait();
  __syncthreads();
  int used = 0;   // products done
  // The weights of product `used`, once they have landed.
  auto weights = [&]() -> const float* {
    tc::mbar_wait(bar0 + 8 * (used & 1), (used >> 1) & 1);
    return wbuf + (used & 1) * W * W;
  };
  // After product `used`: every thread is done with its buffer; refill it.
  auto release = [&]() {
    __syncthreads();
    if (c == 0 && used + 2 < n_mats) stage(used + 2);
    ++used;
  };

  float h[B];
  if (layer < 0) {
#pragma unroll
    for (int m = 0; m < B; ++m)
      h[m] = a0 + m < a.atoms ? a.h0[(size_t)(a0 + m) * W + c] : 0.f;
  } else {
    float hn[B], g[B];
    const float* rows[B];   // the atom's message rows, channel c
    int rows_n[B], most = 0;
#pragma unroll
    for (int m = 0; m < B; ++m) {
      const int atom = a0 + m;
      h[m] = hn[m] = g[m] = 0.f;
      rows[m] = a.msg + c;
      rows_n[m] = 0;
      if (atom < a.atoms) {
        h[m] = a.h[(size_t)atom * W + c];
        hn[m] = a.hn[(size_t)atom * W + c];
        rows[m] += ((size_t)(atom / a.n) * a.cap + a.off[atom]) * W;
        rows_n[m] = a.cnt[atom];
      }
      most = max(most, rows_n[m]);
    }
    if constexpr (ABL == ABL_AGG) {   // the first message row alone
#pragma unroll
      for (int m = 0; m < B; ++m) g[m] = rows_n[m] > 0 ? rows[m][0] : 0.f;
    } else {
      // Each atom's rows added in compacted order; the loads of U rows of
      // every atom (64 a thread) in flight at once.
      constexpr int U = 64 / B;
      for (int q = 0; q < most; q += U) {
        float v[B][U];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int m = 0; m < B; ++m)
            v[m][u] = q + u < rows_n[m] ? rows[m][(size_t)(q + u) * W] : 0.f;
#pragma unroll
        for (int m = 0; m < B; ++m)
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (q + u < rows_n[m]) g[m] += v[m][u];
      }
    }
    if constexpr (!NODEOPS) {
#pragma unroll
      for (int m = 0; m < B; ++m) h[m] = h[m] + cact(hn[m] + g[m]);
    } else {
      node_store<B>(x_s, hn);
      node_store<B>(y_s, g);
      __syncthreads();
      const size_t lb = (size_t)layer * W;
      float pre[B], pe[B], u[B];
      node_product<B>(x_s, weights(), p.b_pd[lb + c], pre);
      release();
      node_product<B>(y_s, weights(), p.b_pe[lb + c], pe);
      release();
#pragma unroll
      for (int m = 0; m < B; ++m) pre[m] = cact(pre[m] + pe[m]);
      node_store<B>(x_s, pre);    // x_s was last read before release()
      __syncthreads();
      node_product<B>(x_s, weights(), p.b_p[lb + c], u);
      release();
#pragma unroll
      for (int m = 0; m < B; ++m) h[m] = h[m] + u[m];
    }
  }

  if (layer < last) {
#pragma unroll
    for (int m = 0; m < B; ++m)
      if (a0 + m < a.atoms) a.h[(size_t)(a0 + m) * W + c] = h[m];
    const size_t nb = (size_t)(layer + 1) * W;
    float x[B];
#pragma unroll
    for (int m = 0; m < B; ++m) x[m] = h[m];
    if (ABL != ABL_LN && a.use_ln) layer_norm<B>(x, red);
    const float s = p.nln_s[nb + c], b = p.nln_b[nb + c];
#pragma unroll
    for (int m = 0; m < B; ++m) {
      x[m] = x[m] * s + b;
      if (a0 + m < a.atoms) a.hn[(size_t)(a0 + m) * W + c] = x[m];
    }
    node_store<B>(x_s, x);      // x_s was last read before release()
    __syncthreads();
    float acc[B];
    if constexpr (ABL != ABL_SRCAFF) {
      node_product<B>(x_s, weights(), p.b_src[nb + c], acc);
      release();
#pragma unroll
      for (int m = 0; m < B; ++m)
        if (a0 + m < a.atoms) a.src[(size_t)(a0 + m) * W + c] = acc[m];
    }
    if constexpr (NODEOPS) {
      node_product<B>(x_s, weights(), p.b_dst[nb + c], acc);
      release();
    } else {
#pragma unroll
      for (int m = 0; m < B; ++m) acc[m] = x[m];   // dst = hn
    }
#pragma unroll
    for (int m = 0; m < B; ++m)
      if (a0 + m < a.atoms) a.dst[(size_t)(a0 + m) * W + c] = acc[m];
  } else if constexpr (ABL == ABL_DECODER) {
    if (c < 3) {
#pragma unroll
      for (int m = 0; m < B; ++m)
        if (a0 + m < a.atoms) a.out[(size_t)(a0 + m) * 3 + c] = h[m];
    }
  } else {
    node_store<B>(x_s, h);
    __syncthreads();
    float z[B];
    node_product<B>(x_s, weights(), p.bd0[c], z);
    release();
    const auto mact = act_of<false, ABL, MACT>();
#pragma unroll
    for (int m = 0; m < B; ++m) z[m] = mact(z[m]);
    node_store<B>(y_s, z);
    __syncthreads();
    if (c < B * 3) {
      const int m = c / 3, o = c % 3;
      float f = p.bd1[o];
      for (int j = 0; j < W; ++j)
        f = fmaf(y_s[j * B + m], p.wd1[j * W + o], f);
      if (a0 + m < a.atoms) a.out[(size_t)(a0 + m) * 3 + o] = f;
    }
  }
  if (layer < 0) tc::grid_wait();
}

}  // namespace
