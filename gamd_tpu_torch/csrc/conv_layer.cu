// One whole conv layer (edge pipeline with the neighbour gathers, node
// update and residual) for Hopper (sm_90a): the kernel behind
// gamd_tpu_torch.ops.message's fused_conv_layer.
//
// Replaces gamd_tpu/ops/pallas_mp.py::_conv_layer_kernel (line 735,
// pallas_call at line 810). Per row i of N nodes, with r = idx[i,k] read
// as JAX reads it (negative from the end, then clamped into [0, N)):
//   z  = silu(e[i,k] @ W1 + b1) @ W2 + b2 + src[r] + dst[i]
//   m  = silu(silu(z) @ W3 + b3) @ W4 + b4
//   agg[i] = sum over k with mask[i,k] of hn[r] * m
//   out[i] = h[i] + silu(hn[i] @ Wpd + bpd + agg[i] @ Wpe + bpe) @ Wp + bp
// A masked slot contributes exactly 0, whatever it holds.
//
// What bounds it on this card: at the op library's shape (LJ-258, K=96,
// about 5,500 live edges of 24,768 slots) the edge products as in
// conv_msg_gather.cu (about 2.2 GFLOP as three bf16 passes, 2.2 us at 989
// TFLOP/s, and 0.2 us of epilogues on the fp32 cores) plus three 128x128
// node products in fp32 (25 MFLOP, 0.4 us at 67 TFLOP/s): about 2.8 us,
// against e and the ids at the live slots, the mask, the node arrays and
// the weights (about 4 MB, 1.2 us at 3.35 TB/s): operations-bound.
//
// What the design does about it, launch by launch:
// 1-5. conv_tc.cuh's live-edge pipeline, as conv_msg_gather.cu (row 3)
//    runs it, with the source policy ClampedSrc (ids by JAX's rule; a
//    masked slot's id is never read): the layout of the live slots from
//    the mask (2 launches), the weight split, tiles of 64 live edges
//    through the four products on wgmma (bf16 x 3) and the fix-up, into
//    agg [N, 128], each atom's sum in a fixed order.
// 6. conv_update_kernel<B>: the node update into a new array (the JAX
//    function returns one; h is not touched). B atoms a block, one thread
//    a channel, its three products fp32 FMAs on the CUDA cores, as the
//    plain version and the whole-model forward's node stages
//    (node_fused.cuh) keep them for the residual stream; each 64 KB weight
//    staged whole into shared memory by a bulk copy, the next one in
//    flight while the current one computes (two buffers). Every block
//    reads all three weights from L2 (192 KB), so the host takes the
//    smallest B of 4, 8, 16 whose grid fits in one wave of the card's SMs
//    (4 at N=258: 65 blocks). It is launched with programmatic dependent
//    launch: its blocks stage the weights and read h and hn while the
//    fix-up runs, then wait for it (griddepcontrol) before reading agg.
// Six launches a call. The TPU kernel's one-hot MXU gathers, hi/lo bf16
// split of the node table and node-table padding have no counterpart:
// Hopper reads rows natively.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; gamd_conv_layer returns the first non-zero
// error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tc.cuh"
#include "node_fused.cuh"

namespace {

// The node update's inputs and weights ([in][out] row-major fp32).
struct UpdateArgs {
  const float *h, *hn, *agg;               // [N, W]
  const float *w_pd, *b_pd, *w_pe, *b_pe, *w_p, *b_p;
  float* out;                              // [N, W]
  int n;
};

// grid ceil(N / B), block W, node_smem_bytes(B) of dynamic shared memory.
template <int B>
__global__ void __launch_bounds__(W, 1)
conv_update_kernel(UpdateArgs a) {
  extern __shared__ __align__(16) float upd_smem[];
  float* wbuf = upd_smem;                       // [2][W * W]
  float* x_s = upd_smem + 2 * W * W;            // [W][B]
  float* y_s = x_s + W * B;                     // [W][B]
  __shared__ __align__(8) uint64_t bars[2];
  const int c = threadIdx.x, a0 = blockIdx.x * B;
  const float* mats[3] = {a.w_pd, a.w_pe, a.w_p};
  const uint32_t buf0 = tc::smem_addr(wbuf);
  const uint32_t bar0 = tc::smem_addr(&bars[0]);
  auto stage = [&](int i) {       // one thread: matrix i into buffer i % 2
    tc::proxy_fence();
    tc::mbar_expect(bar0 + 8 * (i & 1), NODE_MAT_BYTES);
    tc::bulk_load(buf0 + (i & 1) * NODE_MAT_BYTES, mats[i], NODE_MAT_BYTES,
                  bar0 + 8 * (i & 1));
  };
  tc::let_next_start();
  if (c == 0) {   // the weights: inputs, not the fix-up's output
    tc::mbar_init(bar0, 1);
    tc::mbar_init(bar0 + 8, 1);
    tc::mbar_init_fence();
    stage(0);
    stage(1);
  }
  float h[B], hn[B], g[B];
#pragma unroll
  for (int m = 0; m < B; ++m) {
    const bool in = a0 + m < a.n;
    h[m] = in ? a.h[(size_t)(a0 + m) * W + c] : 0.f;
    hn[m] = in ? a.hn[(size_t)(a0 + m) * W + c] : 0.f;
  }
  tc::grid_wait();   // agg: the tile and fix-up kernels' output
#pragma unroll
  for (int m = 0; m < B; ++m)
    g[m] = a0 + m < a.n ? a.agg[(size_t)(a0 + m) * W + c] : 0.f;
  node_store<B>(x_s, hn);
  node_store<B>(y_s, g);
  __syncthreads();

  float pre[B], pe[B], u[B];
  tc::mbar_wait(bar0, 0);
  node_product<B>(x_s, wbuf, a.b_pd[c], pre);
  __syncthreads();               // buffer 0 and x_s read by every thread
  if (c == 0) stage(2);
  tc::mbar_wait(bar0 + 8, 0);
  node_product<B>(y_s, wbuf + W * W, a.b_pe[c], pe);
#pragma unroll
  for (int m = 0; m < B; ++m) pre[m] = silu(pre[m] + pe[m]);
  node_store<B>(x_s, pre);
  __syncthreads();
  tc::mbar_wait(bar0, 1);
  node_product<B>(x_s, wbuf, a.b_p[c], u);
#pragma unroll
  for (int m = 0; m < B; ++m)
    if (a0 + m < a.n) a.out[(size_t)(a0 + m) * W + c] = h[m] + u[m];
}

// Atoms an update block takes: the smallest of 4, 8, 16 whose grid fits
// in one wave (a block an SM: its 128 KB of weight buffers leave room for
// no second). ops/message.py::update_atoms is its host twin.
int update_atoms(int n) {
  for (int b = NODE_MIN_B; b < NODE_MAX_B; b *= 2)
    if ((n + b - 1) / b <= sm_count()) return b;
  return NODE_MAX_B;
}

// Dynamic shared memory above 48 KB for the update kernels, once per
// process.
cudaError_t configure_update() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaFuncAttribute max_smem =
      cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(conv_update_kernel<4>, max_smem,
                                  node_smem_bytes(4))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(conv_update_kernel<8>, max_smem,
                                  node_smem_bytes(8))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(conv_update_kernel<16>, max_smem,
                                  node_smem_bytes(16))) != cudaSuccess)
    return err;
  done = true;
  return cudaSuccess;
}

cudaError_t launch_update(const UpdateArgs& ua, int b, cudaStream_t s) {
  const dim3 blocks((ua.n + b - 1) / b);
  switch (b) {
    case 4:
      return launch_pdl(conv_update_kernel<4>, blocks, dim3(W),
                        node_smem_bytes(4), s, ua);
    case 8:
      return launch_pdl(conv_update_kernel<8>, blocks, dim3(W),
                        node_smem_bytes(8), s, ua);
    default:
      return launch_pdl(conv_update_kernel<16>, blocks, dim3(W),
                        node_smem_bytes(16), s, ua);
  }
}

}  // namespace

// out [N, W] from e [N*K, W], idx [N*K], mask [N*K], h, hn, src, dst
// [N, W] and the 14 weights; lay, wsplit, part (ops/edge_tiles.py) and agg
// [N, W] are scratch, the plan ops/edge_tiles.py::launch_plan's and b
// ops/message.py::update_atoms'. Returns 0, a cudaError_t
// (cudaErrorInvalidValue for a shape, plan or b it does not take), or
// 100000 + the CUresult of the TMA map's encoding.
extern "C" int gamd_conv_layer(
    const float* e, const int* idx, const uint8_t* mask, const float* h,
    const float* hn, const float* src, const float* dst, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* w3,
    const float* b3, const float* w4, const float* b4, const float* wpd,
    const float* bpd, const float* wpe, const float* bpe, const float* wp,
    const float* bp, int n, int k, const SlotLayout* lay, void* wsplit,
    float* part, int grid, int threads, int smem, int nbuf, float* agg,
    int b, float* out, void* stream) {
  if (n <= 0 || k <= 0 || (long long)n * k >= (1LL << 31))
    return cudaErrorInvalidValue;
  const TilePlan plan{grid, threads, smem, nbuf};
  if (!plan_ok(plan, n, k) || b != update_atoms(n))
    return cudaErrorInvalidValue;
  cudaError_t err = configure_update();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = launch_mask_layout(mask, n, k, *lay, s)) != cudaSuccess)
    return static_cast<int>(err);
  const EdgeWeights w{{w1, w2, w3, w4}, {b1, b2, b3, b4}};
  const ClampedSrc rows{idx, hn, src, n};
  const int tiles_err = run_conv_tiles(e, dst, w, rows, *lay, wsplit, part,
                                       n, k, plan, agg, s);
  if (tiles_err != 0) return tiles_err;
  const UpdateArgs ua{h, hn, agg, wpd, bpd, wpe, bpe, wp, bp, out, n};
  return static_cast<int>(launch_update(ua, b, s));
}
