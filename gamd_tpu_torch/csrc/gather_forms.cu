// The lane, sublane and transpose forms of the gather probe for Hopper
// (sm_90a): the kernels behind gamd_tpu_torch.ops.gather_probe's
// lane_gather, sublane_gather and transpose_probe and tools/probe_gather.py.
//
// Replaces the last three of scripts/probe_gather.py's Pallas kernels
// (pallas_call at lines 318-334), each run `iters` times with a full sum of
// every result folded into the carry (`_acc_update`, line 52) and the
// carry's data-dependent zero (`_dep_scalar`, line 60: 1 once the carry
// passes 1e30, else 0) in every iteration's input:
//   * kernel_lane (line 147): out[d, e] = TT[d, idx[e] + dep] over the
//     transposed table TT [256, n_pad], the whole edge stream an iteration;
//     width 384 gathers across the whole row (LANE384), width 128 gathers
//     from three 128-wide sub-tables with clip(idx - 128 s, 0, 127) and
//     selects by idx // 128 (LANE128; the compiler may fold the three loads
//     and two selects into one load, which is what the hardware would do);
//   * kernel_sublane (line 178): out[e, :] = T[idx[e] + dep, :] over the
//     table T [n_pad, 256] (SUBLANE);
//   * kernel_transpose (line 196): (TT + dep).T, `copies` times an
//     iteration (the script's 34 blocks) (TRANSPOSE).
//
// Design. The TPU's lane gather is a cross-lane shuffle inside a vreg; its
// Hopper counterpart is a gather from shared memory: TT (393 KB in fp32)
// exceeds a block's 227 KB, so a LANE block stages 32 of TT's 256 rows
// (49 KB) and gathers its 256 edges (one a thread) from that slice, grid
// (rows / 256, 8). The sublane gather is a row load: 64 threads read one
// 1 KB table row as float4s, coalesced, from L2 (the table stays resident),
// 4 rows at a time, 32 edges a block. The transpose goes through a shared
// tile [32][33] (the pad column keeps the transposed reads free of bank
// conflicts): a block holds 4 of the 96 tiles of TT in registers, and every
// iteration adds the dependent zero, stores them, syncs and reads them
// transposed, grid (24, copies).
//
// Blocks run in parallel, so there is no global carry: every thread keeps
// its own running sum and takes the dependent zero from it (the keep-alive
// term on the block's own data), so each iteration's reads depend on the
// last iteration's sum and none can be hoisted. After the loop each block
// adds its threads' sums in a fixed order into partials[block], and a
// second launch adds the partials in a fixed order (thread t the partials
// t, t + 256, ..., then a fixed tree over the threads; one thread walking
// them all in turn costs some 20 us of dependent loads) and writes the
// total to out [8, 128] (every element), so a call repeats bit for bit.
// The total equals JAX's carry up to the order of the fp32 sums.
//
// What bounds it on this card: the additions, 256 x 13,056 = 3,342,336 an
// iteration at 67 TFLOP/s fp32 (0.0499 us); the inputs (the 393 KB table,
// the 52 KB of indices) read once take 0.13 us at 3.35 TB/s, once a call.
// What limits these simple forms is the shared-memory and L2 traffic of
// the gathered values, 13.4 MB an iteration, which the bound does not
// count: every value is read from a table that the TPU holds in vregs.
//
// g_out, when given, receives the last iteration's result: [256, rows]
// (lane), [rows, 256] (sublane) or [n_pad, 256] (transpose), so that a
// check can compare values and not only the carry; timed calls pass none.
// An index outside the table is clamped into it, so no read leaves the
// table (the script's indices never are). The host allocates every buffer
// with torch.empty and launches on PyTorch's current stream; the entry
// returns cudaGetLastError(), or cudaErrorInvalidValue for a shape it does
// not take.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int LANES = 256;          // table lanes (hi|lo packed)
constexpr float DEP_LIMIT = 1e30f;  // _dep_scalar's threshold
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;

enum Form { LANE384 = 0, LANE128 = 1, SUBLANE = 2, TRANSPOSE = 3 };

// LANE: one edge a thread, LANE_ROWS rows of TT a block.
constexpr int LANE_THREADS = 256;
constexpr int LANE_ROWS = 32;
constexpr int SUB_WIDTH = 128;      // LANE128's sub-table width
// SUBLANE: 64 threads a row (float4 each), 4 rows at a time.
constexpr int SUB_THREADS = 256;
constexpr int SUB_EDGES = 32;
constexpr int ROW_THREADS = LANES / 4;
constexpr int SUB_PASSES = SUB_EDGES / (SUB_THREADS / ROW_THREADS);
// TRANSPOSE: 32 x 8 threads, TR_TILES tiles of 32 x 32 a block.
constexpr int TILE = 32;
constexpr int TR_THREADS = 256;
constexpr int TR_ROWS = TR_THREADS / TILE;   // 8
constexpr int TR_TILES = 4;
constexpr int TOTAL_THREADS = 256;  // the partials' total

// Adds the block's per-thread sums in a fixed order into *partial.
template <int THREADS>
__device__ __forceinline__ void block_total(float v, float* partial) {
  __shared__ float red[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s = __fadd_rn(s, red[w]);
    *partial = s;
  }
}

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// grid (rows / LANE_THREADS, LANES / LANE_ROWS), block LANE_THREADS,
// dynamic shared memory LANE_ROWS * n_pad floats.
template <bool SUB128>
__global__ void __launch_bounds__(LANE_THREADS)
lane_kernel(const int* __restrict__ idx, const float* __restrict__ tt,
            int rows, int n_pad, int iters, float* __restrict__ partials,
            float* __restrict__ g_out) {
  extern __shared__ __align__(16) float slice[];
  const int d0 = blockIdx.y * LANE_ROWS;
  const int e = blockIdx.x * LANE_THREADS + threadIdx.x;
  for (int v = threadIdx.x; v < LANE_ROWS * n_pad / 4; v += LANE_THREADS)
    reinterpret_cast<float4*>(slice)[v] =
        reinterpret_cast<const float4*>(tt + (size_t)d0 * n_pad)[v];
  __syncthreads();

  const int i = clamp_index(idx[e], n_pad);
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    const int j = min(i + (acc > DEP_LIMIT ? 1 : 0), n_pad - 1);
    const bool keep = g_out != nullptr && it == iters - 1;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < LANE_ROWS; ++d) {
      const float* row = slice + d * n_pad;
      float v;
      if constexpr (SUB128) {
        const float p0 = row[min(max(j, 0), SUB_WIDTH - 1)];
        const float p1 = row[SUB_WIDTH + min(max(j - SUB_WIDTH, 0),
                                             SUB_WIDTH - 1)];
        const float p2 = row[2 * SUB_WIDTH + min(max(j - 2 * SUB_WIDTH, 0),
                                                 SUB_WIDTH - 1)];
        const int blk = j / SUB_WIDTH;
        v = blk == 0 ? p0 : (blk == 1 ? p1 : p2);
      } else {
        v = row[j];
      }
      s += v;
      if (keep) g_out[(size_t)(d0 + d) * rows + e] = v;
    }
    acc += s;
  }
  block_total<LANE_THREADS>(acc, partials + blockIdx.y * gridDim.x
                                     + blockIdx.x);
}

// grid rows / SUB_EDGES, block SUB_THREADS: thread (r, q) loads lanes
// 4q..4q+3 of the rows of edges r, r + 4, ... of the block.
__global__ void __launch_bounds__(SUB_THREADS)
sublane_kernel(const int* __restrict__ idx, const float* __restrict__ tbl,
               int n_pad, int iters, float* __restrict__ partials,
               float* __restrict__ g_out) {
  const int q = threadIdx.x % ROW_THREADS, r = threadIdx.x / ROW_THREADS;
  const int e0 = blockIdx.x * SUB_EDGES + r;
  const float4* t4 = reinterpret_cast<const float4*>(tbl);
  int src[SUB_PASSES];
#pragma unroll
  for (int m = 0; m < SUB_PASSES; ++m)
    src[m] = clamp_index(idx[e0 + m * (SUB_THREADS / ROW_THREADS)], n_pad);

  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    const int dep = acc > DEP_LIMIT ? 1 : 0;
    const bool keep = g_out != nullptr && it == iters - 1;
    float s = 0.f;
#pragma unroll
    for (int m = 0; m < SUB_PASSES; ++m) {
      const int j = min(src[m] + dep, n_pad - 1);
      const float4 v = __ldg(t4 + (size_t)j * ROW_THREADS + q);
      s += (v.x + v.y) + (v.z + v.w);
      if (keep)
        reinterpret_cast<float4*>(g_out)[
            (size_t)(e0 + m * (SUB_THREADS / ROW_THREADS)) * ROW_THREADS
            + q] = v;
    }
    acc += s;
  }
  block_total<SUB_THREADS>(acc, partials + blockIdx.x);
}

// grid (tiles / TR_TILES, copies), block TR_THREADS = 32 x 8: thread
// (tx, ty) holds rows ty, ty + 8, ty + 16, ty + 24 of column tx of each of
// the block's tiles of TT [LANES, n_pad]; copy 0 writes g_out [n_pad,
// LANES].
__global__ void __launch_bounds__(TR_THREADS)
transpose_kernel(const float* __restrict__ tt, int n_pad, int iters,
                 float* __restrict__ partials, float* __restrict__ g_out) {
  __shared__ float tile[TR_TILES][TILE][TILE + 1];
  const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
  const int tile_cols = n_pad / TILE;
  int r0[TR_TILES], c0[TR_TILES];
  float x[TR_TILES][TILE / TR_ROWS];
#pragma unroll
  for (int t = 0; t < TR_TILES; ++t) {
    const int id = blockIdx.x * TR_TILES + t;
    r0[t] = (id / tile_cols) * TILE;
    c0[t] = (id % tile_cols) * TILE;
#pragma unroll
    for (int q = 0; q < TILE / TR_ROWS; ++q)
      x[t][q] = tt[(size_t)(r0[t] + ty + TR_ROWS * q) * n_pad + c0[t] + tx];
  }

  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    const float dep = acc > DEP_LIMIT ? 1.f : 0.f;
    const bool keep = g_out != nullptr && blockIdx.y == 0 && it == iters - 1;
#pragma unroll
    for (int t = 0; t < TR_TILES; ++t)
#pragma unroll
      for (int q = 0; q < TILE / TR_ROWS; ++q)
        tile[t][ty + TR_ROWS * q][tx] = x[t][q] + dep;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < TR_TILES; ++t)
#pragma unroll
      for (int q = 0; q < TILE / TR_ROWS; ++q) {
        // (TT + dep).T [c0 + ty + 8q, r0 + tx] = tile[t][tx][ty + 8q].
        const float v = tile[t][tx][ty + TR_ROWS * q];
        s += v;
        if (keep)
          g_out[(size_t)(c0[t] + ty + TR_ROWS * q) * LANES + r0[t] + tx] = v;
      }
    acc += s;
    __syncthreads();
  }
  block_total<TR_THREADS>(acc, partials + blockIdx.y * gridDim.x
                                   + blockIdx.x);
}

// out[0 .. 1024) = the sum of the n partials, in a fixed order.
__global__ void __launch_bounds__(TOTAL_THREADS)
total_kernel(const float* __restrict__ partials, int n,
             float* __restrict__ out) {
  __shared__ float total;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += TOTAL_THREADS)
    s = __fadd_rn(s, partials[i]);
  block_total<TOTAL_THREADS>(s, &total);
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * 128; i += TOTAL_THREADS) out[i] = total;
}

template <bool SUB128>
cudaError_t launch_lane(const int* idx, const float* tt, int rows, int n_pad,
                        int iters, float* partials, float* g_out,
                        cudaStream_t s, int* blocks) {
  const size_t smem = sizeof(float) * LANE_ROWS * n_pad;
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lane_kernel<SUB128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows / LANE_THREADS, LANES / LANE_ROWS);
  *blocks = grid.x * grid.y;
  lane_kernel<SUB128><<<grid, LANE_THREADS, smem, s>>>(
      idx, tt, rows, n_pad, iters, partials, g_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Partials (fp32 scratch) one call of `form` needs.
int gamd_gather_form_partials(int form, int rows, int n_pad, int copies) {
  switch (form) {
    case LANE384:
    case LANE128: return rows / LANE_THREADS * (LANES / LANE_ROWS);
    case SUBLANE: return rows / SUB_EDGES;
    case TRANSPOSE:
      return (LANES / TILE) * (n_pad / TILE) / TR_TILES * copies;
    default: return 0;
  }
}

// One call of the probe: `iters` iterations of form `form` (0 lane over
// the whole row, 1 lane from three 128-wide sub-tables, 2 sublane, 3
// transpose), the total of their sums in out [8, 128]. idx [rows] int32
// in [0, n_pad) (unused by the transpose); tbl the transposed table TT
// [256, n_pad] (lane, transpose) or the table T [n_pad, 256] (sublane),
// fp32; partials gamd_gather_form_partials(...) fp32; g_out the last
// iteration's result or null. Lane: rows a positive multiple of 256, n_pad
// a multiple of 4 (384 for form 1); sublane: rows a positive multiple of
// 32; transpose: n_pad a multiple of 32 with (n_pad / 32) * 8 a multiple
// of 4, `copies` transposes an iteration.
int gamd_gather_form(int form, const int* idx, const float* tbl, int rows,
                     int n_pad, int copies, int iters, float* partials,
                     float* out, float* g_out, void* stream) {
  if (n_pad <= 0 || iters < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  cudaError_t err;
  switch (form) {
    case LANE384:
    case LANE128:
      if (rows <= 0 || rows % LANE_THREADS != 0 || n_pad % 4 != 0
          || (form == LANE128 && n_pad != 3 * SUB_WIDTH))
        return cudaErrorInvalidValue;
      err = form == LANE128
          ? launch_lane<true>(idx, tbl, rows, n_pad, iters, partials, g_out,
                              s, &blocks)
          : launch_lane<false>(idx, tbl, rows, n_pad, iters, partials,
                               g_out, s, &blocks);
      break;
    case SUBLANE:
      if (rows <= 0 || rows % SUB_EDGES != 0) return cudaErrorInvalidValue;
      blocks = rows / SUB_EDGES;
      sublane_kernel<<<blocks, SUB_THREADS, 0, s>>>(idx, tbl, n_pad, iters,
                                                    partials, g_out);
      err = cudaGetLastError();
      break;
    case TRANSPOSE: {
      const int tiles = (LANES / TILE) * (n_pad / TILE);
      if (n_pad % TILE != 0 || tiles % TR_TILES != 0 || copies <= 0)
        return cudaErrorInvalidValue;
      const dim3 grid(tiles / TR_TILES, copies);
      blocks = grid.x * grid.y;
      transpose_kernel<<<grid, TR_THREADS, 0, s>>>(tbl, n_pad, iters,
                                                   partials, g_out);
      err = cudaGetLastError();
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  total_kernel<<<1, TOTAL_THREADS, 0, s>>>(partials, blocks, out);
  return cudaGetLastError();
}

}  // extern "C"
