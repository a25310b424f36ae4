// The edge encoder's tile kernel and host code, shared by its two entries:
// edge_encoder.cu (every slot of B frames) and live_edge_encoder.cu (a
// layout's live slots of one frame, with the bond channel or without; the
// bond's forms in live_edge_encoder_bond.cu), which build in parallel. What the kernel computes, its design and its
// bound are written in edge_encoder.cu.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tc.cuh"
#include "encode.cuh"

namespace {

using tc::launch_pdl;
using tc::TilePlan;

constexpr int N_ENC_WEIGHTS = 3;   // w_rbf, w1, w2

// grid (3, 4), block (32, 8): 32 output rows of weight m (w_rbf with its
// n_rbf rows, zero past them; w1; w2) as W^T hi and lo bf16 ([2m] and
// [2m+1] of the table, each [128 out][128 in]), x = hi + lo, lo = bf16(x
// - hi). The transpose goes through shared memory.
__global__ void __launch_bounds__(256)
split_encoder_weights_kernel(EncoderWeights p, int n_rbf,
                             __nv_bfloat16* __restrict__ out) {
  __shared__ float tile[W][33];
  const int m = blockIdx.x, o0 = 32 * blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* w = m == 0 ? p.w_rbf : (m == 1 ? p.w1 : p.w2);
  const int rows = m == 0 ? n_rbf : W;
  for (int kin = ty; kin < W; kin += 8)
    tile[kin][tx] = kin < rows ? w[kin * W + o0 + tx] : 0.f;
  __syncthreads();
  __nv_bfloat16* hi = out + (size_t)(2 * m) * W * W;
  __nv_bfloat16* lo = hi + W * W;
  for (int o = ty; o < 32; o += 8)
    for (int kin = tx; kin < W; kin += 32) {
      const float x = tile[kin][o];
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      hi[(o0 + o) * W + kin] = h;
      lo[(o0 + o) * W + kin] = __float2bfloat16_rn(x - __bfloat162float(h));
    }
}

// Rows of the first entry: every slot g of B frames of N atoms of K slots
// (g = (b N + i) K + k), e's row g; the thread of the row's first column
// also writes live[g] = bmask[g] and d^2 < cutoff^2.
struct AllSlots {
  const float* pos;
  const int* idx;
  const uint8_t* bmask;
  uint8_t* live;
  int n, k, count;
  float cutoff2;
  __device__ __forceinline__ int total() const { return count; }
  __device__ __forceinline__ void edge(int g, const float*& pi,
                                       const float*& pj, size_t& row) const {
    const int nk = n * k, frame = g / nk, i = (g - frame * nk) / k;
    pi = pos + ((size_t)frame * n + i) * 3;
    pj = pos + ((size_t)frame * n + idx[g]) * 3;
    row = g;
  }
  __device__ __forceinline__ void mark(const tc::Frag& f, bool valid, int g,
                                       float d2) const {
    if (valid && f.wg == 0 && f.q == 0)
      live[g] = (bmask[g] && d2 < cutoff2) ? 1 : 0;
  }
};

// Rows of the second entry: the layout's live slots of one frame, e's row
// the slot id i*K + k; bond, when given, the [N, K] bond channel.
struct LiveSlots {
  const float* pos;
  const int *idx, *slot, *count;
  const float* bond;
  int k;
  __device__ __forceinline__ int total() const { return *count; }
  __device__ __forceinline__ float bond_of(int g) const {
    return bond[slot[g]];
  }
  __device__ __forceinline__ void edge(int g, const float*& pi,
                                       const float*& pj, size_t& row) const {
    const int sl = slot[g];
    pi = pos + (size_t)(sl / k) * 3;
    pj = pos + (size_t)idx[sl] * 3;
    row = sl;
  }
  __device__ __forceinline__ void mark(const tc::Frag&, bool, int,
                                       float) const {}
};

// The persistent encoder. grid plan.grid, block 256 (one tile at a time,
// its columns split between the two warpgroups), tc::smem_bytes(NBUF) of
// dynamic shared memory; block b takes tiles b, b + grid, ... of the
// rows' ceil(total / 64). The RBF product runs over RBF_STEPS k-steps of
// 16 (its columns past n_rbf are zero), a constant so that the tensor
// cores' products of a tile issue back to back; 0 takes ceil(n_rbf / 16)
// at run time. BOND (LiveSlots only) reads each row's bond at its slot (a
// dead row reads the tile's first, in bounds, and is never written). MACT
// is the MLP's activation (Act, a.mact's form).
template <int NBUF, int RBF_STEPS, class Rows, bool BOND, int MACT>
__global__ void __launch_bounds__(tc::THREADS, 3 - NBUF)
encoder_tile_kernel(const __grid_constant__ CUtensorMap wmap, EncTileArgs a,
                    Rows rows, float* __restrict__ e) {
  tc::let_next_start();
  tc::grid_wait();
  const int total = rows.total();
  const int tiles = (total + tc::TILE - 1) / tc::TILE;
  if ((int)blockIdx.x >= tiles) return;
  const int mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  extern __shared__ uint8_t tile_smem[];
  __shared__ __align__(8) uint64_t bars[NBUF];
  __shared__ float red[2][2][tc::TILE];   // [stat][warpgroup][row]
  const tc::WeightRing<NBUF> ring(tile_smem, bars, &wmap, 0, N_ENC_WEIGHTS,
                                  N_ENC_WEIGHTS * mine);
  const tc::Frag f;
  int p = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, p += N_ENC_WEIGHTS) {
    const int row0 = t * tc::TILE;
    float geo[2][4];   // ux, uy, uz, standardised distance of each row
    bool live[2];
    size_t row[2];
    float bond[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int g = row0 + f.r0 + 8 * s;
      live[s] = g < total;
      const float *pi, *pj;
      rows.edge(live[s] ? g : row0, pi, pj, row[s]);
      rows.mark(f, live[s], g, edge_geometry(pi, pj, a, geo[s]));
      if constexpr (BOND) bond[s] = rows.bond_of(live[s] ? g : row0);
    }
    encode_tile<NBUF, true, RBF_STEPS, BOND, ABL_NONE, MACT>(
        ring, &wmap, p, f, a, geo, live, row, red, e, bond);
  }
}

// The tile kernel of NBUF buffers, RBF_STEPS, BOND and MACT on `s`, its
// shared memory set once per process.
template <int NBUF, int RBF_STEPS, class Rows, bool BOND, int MACT>
cudaError_t launch_tiles(const CUtensorMap& map, const EncTileArgs& a,
                         const Rows& rows, const TilePlan& plan, float* e,
                         cudaStream_t s) {
  auto kernel = encoder_tile_kernel<NBUF, RBF_STEPS, Rows, BOND, MACT>;
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc::smem_bytes(NBUF));
    if (err != cudaSuccess) return err;
    done = true;
  }
  return launch_pdl(kernel, dim3(plan.grid), dim3(tc::THREADS), plan.smem,
                    s, map, a, rows, e);
}

// The tile kernel's form of the plan's buffers and a's centres: 3 RBF
// k-steps up to 48 centres (the GAMD models' 40), else ceil(n_rbf / 16)
// known at run time.
template <class Rows, bool BOND, int MACT>
cudaError_t launch_plan_form(const CUtensorMap& map, const EncTileArgs& a,
                             const Rows& rows, const TilePlan& plan,
                             float* e, cudaStream_t s) {
  const bool few = a.n_rbf <= 48;
  if (plan.nbuf == 2)
    return few ? launch_tiles<2, 3, Rows, BOND, MACT>(map, a, rows, plan, e,
                                                      s)
               : launch_tiles<2, 0, Rows, BOND, MACT>(map, a, rows, plan, e,
                                                      s);
  return few ? launch_tiles<1, 3, Rows, BOND, MACT>(map, a, rows, plan, e, s)
             : launch_tiles<1, 0, Rows, BOND, MACT>(map, a, rows, plan, e, s);
}

// The weight split, then the tile kernel over `rows` (of at most m * k
// rows, the plan's capacity) on `s`: with BOND the bond channel's form;
// MLP activations a.mact (Act), or gelu alone where GELU_ONLY (the
// every-slot entry, JAX's encoder).
template <class Rows, bool BOND = false, bool GELU_ONLY = false>
int run_encoder(const EncoderWeights& w, const EncTileArgs& a,
                const Rows& rows, void* wsplit, int m, int k,
                const TilePlan& plan, float* e, cudaStream_t s) {
  if (!tc::plan_ok(plan, m, k) || a.n_rbf < 1 || a.n_rbf > W ||
      a.mact < ACT_SILU || a.mact > ACT_GELU)
    return cudaErrorInvalidValue;
  split_encoder_weights_kernel<<<dim3(N_ENC_WEIGHTS, W / 32), dim3(32, 8), 0,
                                 s>>>(w, a.n_rbf,
                                      static_cast<__nv_bfloat16*>(wsplit));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  const int map_err = tc::encode_split_map(wsplit, N_ENC_WEIGHTS, &map);
  if (map_err != 0) return map_err;
  if (GELU_ONLY || a.mact == ACT_GELU)
    err = launch_plan_form<Rows, BOND, ACT_GELU>(map, a, rows, plan, e, s);
  else if constexpr (!GELU_ONLY)
    err = launch_plan_form<Rows, BOND, ACT_SILU>(map, a, rows, plan, e, s);
  return static_cast<int>(err);
}

EncTileArgs tile_args(const EncoderWeights& w, int n_rbf, int flip_dir,
                      float box, float length_mean, float length_std,
                      float gamma, int mact) {
  return EncTileArgs{w.centers, w.w_geo, w.b0, w.b1, w.b2, w.eln_s,
                     w.eln_b, n_rbf, flip_dir, box, length_mean,
                     length_std, gamma, mact};
}

}  // namespace

// The live-slot entry's bond forms (live_edge_encoder_bond.cu, so that they
// build beside its other forms): run_encoder over the live slots of pos
// [n, 3] and idx [n, k] listed by slot and total, with the bond channel
// bond [n, k].
int run_live_bond(const EncoderWeights& w, const EncTileArgs& a,
                  const float* pos, const int* idx, const int* slot,
                  const int* total, const float* bond, int n, int k,
                  void* wsplit, const tc::TilePlan& plan, float* e,
                  cudaStream_t s);
