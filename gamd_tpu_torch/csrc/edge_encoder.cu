// Edge featurisation and encoder for Hopper (sm_90a): positions, neighbour
// lists and the model's encoder weights in, the edge embedding e (fp32,
// W = 128 wide) out. The kernels behind gamd_tpu_torch.ops.encoder:
// * fused_edge_encoder (GAMDNet's use_pallas_encoder path, the counterpart
//   of JAX's entry): B frames, e [B, N, K, W] for every slot, dead ones
//   included, and the live mask [B, N, K];
// * live_edge_encoder (the large-N banded force path): one frame and a
//   live-slot layout (ops/edge_tiles.py::mask_layout), e's rows of the
//   listed slots written at their slot positions of an [N, K, W] buffer;
//   the rows of dead slots are never written (conv_tc.cuh reads e by slot
//   id, and only for live rows).
//
// Replaces gamd_tpu/ops/pallas_encoder.py::_encoder_kernel (line 46,
// pallas_call at line 199), which the JAX model runs per frame under vmap;
// what a row computes, and its precision (bf16 x 3 products on the tensor
// cores, fp32 epilogues), is written in encode.cuh.
//
// Design: the tile body of the whole-model forward's encoder stage
// (encode.cuh, shared with mega_forward.cu) in a persistent kernel over a
// list of rows. Block b takes tiles b, b + grid, ... of 64 rows: every
// slot of the B frames in order (the first entry; no layout is needed),
// or the layout's live slots (the second). Per tile the geometry and the
// RBF in fp32, the RBF, w1 and w2 products as bf16 x 3 wgmma (edge_tc.cuh,
// the two warpgroups splitting the 128 output columns), gelu and the
// LayerNorm in fp32 epilogues. The three weights are split into bf16 hi
// and lo once a call (split_encoder_weights_kernel) and staged by TMA into
// a ring of one or two 64 KB buffers that runs on across the block's tiles
// (ops/edge_tiles.py::launch_plan picks them and the grid, as for the conv
// tiles). Two launches a call. Unlike the forward's stage, the RBF product
// runs over a constant 3 k-steps where n_rbf <= 48, whose wgmma issue back
// to back where a run-time count makes the compiler wait after each (more
// centres take the run-time count, as the forward does), and gelu and the
// RBF take the fast exponential and division (gelu_fast: about 2^-20
// relative, below the products' 2^-16). Measured on the H100
// against this design and dropped (PERF.md): the forward's arithmetic
// as it is (6-16% slower), and the three weights resident in one block an
// SM (192 KB; 39-49% slower at B=16 and on the live slots: nothing
// overlaps a tile's epilogues with another's products).
//
// What bounds it on this card: the three products are 2 ((4 + n_rbf) W +
// 2 W W) FLOP per edge (76,800 at n_rbf = 40), as three bf16 passes
// against the 989 TFLOP/s tensor peak, the epilogues on the fp32 cores.
// At the LJ deployment (LJ-258, K=96, 5,500 live of 24,768 slots) the
// live edges' products take about 1.3 us against writing e for every slot
// (12.7 MB, 3.8 us at 3.35 TB/s): bytes-bound. At N=10,000 on the banded
// path (164,100 live edges) the products take about 38 us against e's
// live rows (84 MB, 25 us): operations-bound. What bounds the design is
// latency: a tile's three products and epilogues run in sequence on one
// SM.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; each entry returns 0, a cudaError_t
// (cudaErrorInvalidValue for a shape or plan it does not take), or 100000
// + the CUresult of the TMA map's encoding.

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
// the slot id i*K + k.
struct LiveSlots {
  const float* pos;
  const int *idx, *slot, *count;
  int k;
  __device__ __forceinline__ int total() const { return *count; }
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
// at run time.
template <int NBUF, int RBF_STEPS, class Rows>
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
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int g = row0 + f.r0 + 8 * s;
      live[s] = g < total;
      const float *pi, *pj;
      rows.edge(live[s] ? g : row0, pi, pj, row[s]);
      rows.mark(f, live[s], g, edge_geometry(pi, pj, a, geo[s]));
    }
    encode_tile<NBUF, true, RBF_STEPS>(ring, &wmap, p, f, a, geo, live,
                                       row, red, e);
  }
}

// The tile kernel of NBUF buffers and RBF_STEPS on `s`, its shared memory
// set once per process.
template <int NBUF, int RBF_STEPS, class Rows>
cudaError_t launch_tiles(const CUtensorMap& map, const EncTileArgs& a,
                         const Rows& rows, const TilePlan& plan, float* e,
                         cudaStream_t s) {
  auto kernel = encoder_tile_kernel<NBUF, RBF_STEPS, Rows>;
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

// The weight split, then the tile kernel over `rows` (of at most m * k
// rows, the plan's capacity) on `s`: 3 RBF k-steps up to 48 centres (the
// GAMD models' 40), else ceil(n_rbf / 16) known at run time.
template <class Rows>
int run_encoder(const EncoderWeights& w, const EncTileArgs& a,
                const Rows& rows, void* wsplit, int m, int k,
                const TilePlan& plan, float* e, cudaStream_t s) {
  if (!tc::plan_ok(plan, m, k) || a.n_rbf < 1 || a.n_rbf > W)
    return cudaErrorInvalidValue;
  split_encoder_weights_kernel<<<dim3(N_ENC_WEIGHTS, W / 32), dim3(32, 8), 0,
                                 s>>>(w, a.n_rbf,
                                      static_cast<__nv_bfloat16*>(wsplit));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  const int map_err = tc::encode_split_map(wsplit, N_ENC_WEIGHTS, &map);
  if (map_err != 0) return map_err;
  const bool few = a.n_rbf <= 48;
  if (plan.nbuf == 2)
    err = few ? launch_tiles<2, 3>(map, a, rows, plan, e, s)
              : launch_tiles<2, 0>(map, a, rows, plan, e, s);
  else
    err = few ? launch_tiles<1, 3>(map, a, rows, plan, e, s)
              : launch_tiles<1, 0>(map, a, rows, plan, e, s);
  return static_cast<int>(err);
}

EncTileArgs tile_args(const EncoderWeights& w, int n_rbf, int flip_dir,
                      float box, float length_mean, float length_std,
                      float gamma) {
  return EncTileArgs{w.centers, w.w_geo, w.b0, w.b1, w.b2, w.eln_s,
                     w.eln_b, n_rbf, flip_dir, box, length_mean,
                     length_std, gamma};
}

}  // namespace

// Every slot of b frames: pos [b, n, 3], idx and bmask [b, n, k] (per-
// frame ids) in; e [b*n*k, W] and live [b*n*k] out. wsplit is the split
// table's scratch (2 * 3 * 128 * 128 bf16); the plan is ops/edge_tiles.py::
// launch_plan(b * n, k).
extern "C" int gamd_edge_encoder(
    const float* pos, const int* idx, const uint8_t* bmask,
    const EncoderWeights* weights, int n_rbf, int b, int n, int k,
    int flip_dir, float box, float cutoff2, float length_mean,
    float length_std, float gamma, void* wsplit, int grid, int threads,
    int smem, int nbuf, float* e, uint8_t* live, void* stream) {
  if (b <= 0 || n <= 0 || k <= 0 ||
      (long long)b * n * k > (1LL << 31) - 64)
    return cudaErrorInvalidValue;
  const AllSlots rows{pos, idx, bmask, live, n, k, b * n * k, cutoff2};
  return run_encoder(*weights,
                     tile_args(*weights, n_rbf, flip_dir, box, length_mean,
                               length_std, gamma),
                     rows, wsplit, b * n, k,
                     TilePlan{grid, threads, smem, nbuf}, e,
                     static_cast<cudaStream_t>(stream));
}

// The live slots of one frame: pos [n, 3], idx [n, k], the layout's slot
// ids [ceil(n*k / 64) * 64] (its first *total rows read) in; e's rows of
// those slots out, into e [n*k, W]. wsplit and the plan as above, the plan
// of launch_plan(n, k).
extern "C" int gamd_live_edge_encoder(
    const float* pos, const int* idx, const int* slot, const int* total,
    const EncoderWeights* weights, int n_rbf, int n, int k, int flip_dir,
    float box, float length_mean, float length_std, float gamma,
    void* wsplit, int grid, int threads, int smem, int nbuf, float* e,
    void* stream) {
  if (n <= 0 || k <= 0 || (long long)n * k > (1LL << 31) - 64)
    return cudaErrorInvalidValue;
  const LiveSlots rows{pos, idx, slot, total, k};
  return run_encoder(*weights,
                     tile_args(*weights, n_rbf, flip_dir, box, length_mean,
                               length_std, gamma),
                     rows, wsplit, n, k, TilePlan{grid, threads, smem, nbuf},
                     e, static_cast<cudaStream_t>(stream));
}
