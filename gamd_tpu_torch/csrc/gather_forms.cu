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
//     selects by idx // 128 (LANE128: the three indices and the two
//     selects are made on the index, and the value is one load, since on
//     Hopper the three sub-tables are one row of shared memory);
//   * kernel_sublane (line 178): out[e, :] = T[idx[e] + dep, :] over the
//     table T [n_pad, 256] (sublane_kernel, entry gamd_sublane_gather);
//   * kernel_transpose (line 196): (TT + dep).T, `copies` times an
//     iteration (the script's 34 blocks) (TRANSPOSE).
//
// Design. The TPU's lane gather is a cross-lane shuffle inside a vreg; its
// Hopper counterpart is a gather from shared memory: TT (393 KB in fp32)
// exceeds a block's 227 KB, so a LANE block stages 32 of TT's 256 rows
// (49 KB), index-major (a column's 32 values in 128 contiguous bytes), and
// each thread reads its edge's column as eight float4s in an order rotated
// by its lane, so that a quarter warp's eight 16-byte loads hit eight
// different bank groups whatever the columns: no bank conflict, where a
// row-major slice gave each warp's scalar loads random banks. The blocks
// the card holds at once (4 an SM) split the stream evenly among the 8
// slices, one wave. Measured on the H100 against this design and dropped
// (PERF.md): a block of 256 edges a slice (408 blocks, 3 or 4 an SM: 14-
// 17% slower), the row-major slice (3.7 and 5.6 times slower at widths
// 384 and 128), and the TPU's own form, a cross-lane shuffle of a table
// row held in a warp's registers, which costs twelve shuffles a value at
// a 384-wide row (13 times slower). The sublane gather is row 15's design
// in the row layout: T (393 KB) exceeds a block's shared memory too, so a
// SUBLANE block stages 64 of T's 256 lanes of every row (96 KB,
// row-major: two blocks an SM, four slices) once a call, and gathers an
// even share of the stream from it: 16 threads on a row of the slice,
// 16 edges at once, a quarter warp on 128 contiguous bytes of one row, so
// no bank conflict by layout whatever the rows; the blocks the card holds
// at once (sublane_plan in ops/gather_probe.py, 264) split the stream
// evenly among the slices, one wave of 198 edges a block. Measured on the
// H100 and dropped (PERF.md): the row load from global memory (64 threads
// a 1 KB row, 32 edges a block, 408 blocks: 0.1657 ms at iters 200, set
// by L2's latency, since the 258 rows, 264 KB, do not stay in an SM's L1
// and the dependent zero lets a thread have one round of eight loads in
// flight), and slices of 32 or 128 lanes (four or one block an SM: the
// same 16 warps an SM and the same time within 1.5%). The
// transpose goes through a shared tile [32][33] (the pad column keeps the
// transposed reads free of bank conflicts): a block holds 4 of the 96
// tiles of TT in registers, and every iteration adds the dependent zero,
// stores them, syncs and reads them transposed, grid (24, copies).
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
// What sets the lane and sublane forms' pace is the traffic of the
// gathered values, 13.4 MB an iteration, from shared memory, 128 bytes a
// clock an SM: about 0.40 us an iteration at 132 SMs and 1.98 GHz. Every
// value is read from a table that the TPU holds in vregs.
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

#include <algorithm>
#include <map>

#include "edge_tc.cuh"

namespace {

constexpr int LANES = 256;          // table lanes (hi|lo packed)
constexpr float DEP_LIMIT = 1e30f;  // _dep_scalar's threshold
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;

// gamd_gather_form's forms (code 2, the sublane form, has its own entry).
enum Form { LANE384 = 0, LANE128 = 1, TRANSPOSE = 3 };

// LANE: one edge a thread, LANE_ROWS rows of TT a block.
constexpr int LANE_THREADS = 256;
constexpr int LANE_ROWS = 32;
constexpr int SUB_WIDTH = 128;      // LANE128's sub-table width
// SUBLANE: a slice of SUB_W table lanes (every row) in shared memory,
// SUB_THREADS a block: SUB_ROW_T threads on a row of the slice (a float4
// each), SUB_AT_ONCE edges at once, at most SUB_UNITS edges a thread.
constexpr int SUB_W = 64;
constexpr int SUB_SLICES = LANES / SUB_W;
constexpr int SUB_THREADS = 4 * SUB_W;
constexpr int SUB_ROW_T = SUB_W / 4;
constexpr int SUB_AT_ONCE = SUB_THREADS / SUB_ROW_T;   // 16
constexpr int SUB_UNITS = 16;
constexpr int SM_SMEM = 233472;        // an SM's shared memory (228 KB)
constexpr int SMEM_RESERVED = 1024;    // the system's share of each block
constexpr int SUB_SM_THREADS = 512;    // an SM's: the launch bounds' own
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


// The width-128 form's column: three 128-wide sub-table indices,
// clip(j - 128 s, 0, 127), and two selects by j / 128, made on the index
// (on Hopper the three sub-tables are one row of shared memory, so the
// three loads and two selects of the values are one load).
__device__ __forceinline__ int sub128_column(int j) {
  const int p0 = min(max(j, 0), SUB_WIDTH - 1);
  const int p1 = SUB_WIDTH + min(max(j - SUB_WIDTH, 0), SUB_WIDTH - 1);
  const int p2 = 2 * SUB_WIDTH + min(max(j - 2 * SUB_WIDTH, 0),
                                     SUB_WIDTH - 1);
  const int blk = j / SUB_WIDTH;
  return blk == 0 ? p0 : (blk == 1 ? p1 : p2);
}

// Stages rows d0 .. d0 + 31 of TT [256, n_pad] into `slice` index-major
// (column j's 32 values at slice[32 j .. 32 j + 31], 128 bytes): lane l
// of each warp reads float4s of row d0 + l and writes them across four
// columns, so that the 32 lanes' stores fall on 32 banks.
__device__ __forceinline__ void stage_index_major(const float* __restrict__ tt,
                                                  int d0, int n_pad,
                                                  float* slice) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4* row =
      reinterpret_cast<const float4*>(tt + (size_t)(d0 + lane) * n_pad);
  for (int q = warp; q < n_pad / 4; q += LANE_THREADS / 32) {
    const float4 v = row[q];
    slice[(4 * q + 0) * LANE_ROWS + lane] = v.x;
    slice[(4 * q + 1) * LANE_ROWS + lane] = v.y;
    slice[(4 * q + 2) * LANE_ROWS + lane] = v.z;
    slice[(4 * q + 3) * LANE_ROWS + lane] = v.w;
  }
}

// grid slices * per_slice, block LANE_THREADS, dynamic shared memory
// LANE_ROWS * n_pad floats: block b stages slice b / per_slice (rows 32 s
// .. 32 s + 31 of TT, index-major) and gathers edges [e0, e0 + span) of
// the stream, span = ceil(rows / per_slice) <= LANE_THREADS, one a
// thread: a thread reads its column's 32 values as eight float4s, chunk
// (c + lane) % 8 at step c, so that the eight threads of each quarter
// warp read eight different 16-byte bank groups whatever their columns
// (a conflict-free gather of random columns).
template <bool SUB128>
__global__ void __launch_bounds__(LANE_THREADS)
lane_kernel(const int* __restrict__ idx, const float* __restrict__ tt,
            int rows, int n_pad, int iters, int per_slice,
            float* __restrict__ partials, float* __restrict__ g_out) {
  extern __shared__ __align__(16) float slice[];
  const int d0 = blockIdx.x / per_slice * LANE_ROWS;
  const int span = (rows + per_slice - 1) / per_slice;
  const int e = blockIdx.x % per_slice * span + threadIdx.x;
  stage_index_major(tt, d0, n_pad, slice);
  __syncthreads();

  float acc = 0.f;
  if (threadIdx.x < span && e < rows) {
    const int i = clamp_index(idx[e], n_pad);
    const int rot = threadIdx.x & 7;
    for (int it = 0; it < iters; ++it) {
      const int j = min(i + (acc > DEP_LIMIT ? 1 : 0), n_pad - 1);
      const int col = SUB128 ? sub128_column(j) : j;
      const float4* v4 = reinterpret_cast<const float4*>(slice) + col * 8;
      const bool keep = g_out != nullptr && it == iters - 1;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int q = (c + rot) & 7;
        const float4 v = v4[q];
        s0 += v.x;
        s1 += v.y;
        s2 += v.z;
        s3 += v.w;
        if (keep) {
          float* g = g_out + (size_t)(d0 + 4 * q) * rows + e;
          g[0] = v.x;
          g[(size_t)rows] = v.y;
          g[2 * (size_t)rows] = v.z;
          g[3 * (size_t)rows] = v.w;
        }
      }
      acc += (s0 + s1) + (s2 + s3);
    }
  }
  block_total<LANE_THREADS>(acc, partials + blockIdx.x);
}

// grid per_slice * SUB_SLICES, block SUB_THREADS, dynamic shared memory
// n_pad SUB_W floats: block b stages lanes c0 .. c0 + 63 of every table
// row, c0 = 64 (b / per_slice), row-major (row j's 64 values at slice[64
// j ..]), then gathers edges [e0, e0 + span) of the stream, e0 = span (b %
// per_slice): thread t reads float4 q = t % 16 of the rows of edges e0 +
// r, e0 + r + 16, ..., r = t / 16, while they lie in its span and the
// stream. A quarter warp reads 128 contiguous bytes of one row: no bank
// conflict whatever the rows.
__global__ void __launch_bounds__(SUB_THREADS, SUB_SM_THREADS / SUB_THREADS)
sublane_kernel(const int* __restrict__ idx, const float* __restrict__ tbl,
               int rows, int n_pad, int iters, int per_slice, int span,
               float* __restrict__ partials, float* __restrict__ g_out) {
  extern __shared__ __align__(16) float slice[];
  float4* s4 = reinterpret_cast<float4*>(slice);
  const int c4 = blockIdx.x / per_slice * SUB_ROW_T;   // its first float4
  const int e0 = blockIdx.x % per_slice * span;
  const float4* t4 = reinterpret_cast<const float4*>(tbl);
  for (int i = threadIdx.x; i < n_pad * SUB_ROW_T; i += SUB_THREADS)
    s4[i] = __ldg(t4 + (size_t)(i / SUB_ROW_T) * (LANES / 4) + c4
                  + i % SUB_ROW_T);

  const int q = threadIdx.x % SUB_ROW_T, r = threadIdx.x / SUB_ROW_T;
  int src[SUB_UNITS];
  int mine = 0;   // edges r, r + 16, ... of the block that the stream has
#pragma unroll
  for (int k = 0; k < SUB_UNITS; ++k) {
    const int e = r + SUB_AT_ONCE * k;
    const bool live = e < span && e0 + e < rows;
    src[k] = live ? clamp_index(idx[e0 + e], n_pad) : 0;
    mine += live ? 1 : 0;
  }
  __syncthreads();

  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    const int dep = acc > DEP_LIMIT ? 1 : 0;
    const bool keep = g_out != nullptr && it == iters - 1;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < SUB_UNITS; ++k) {
      if (k < mine) {
        const int j = min(src[k] + dep, n_pad - 1);
        const float4 v = s4[j * SUB_ROW_T + q];
        s += (v.x + v.y) + (v.z + v.w);
        if (keep)
          reinterpret_cast<float4*>(g_out)[
              (size_t)(e0 + r + SUB_AT_ONCE * k) * (LANES / 4) + c4 + q] = v;
      }
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

// Dynamic shared memory of `smem` bytes for both lane kernels.
cudaError_t configure_lane(size_t smem) {
  const cudaFuncAttribute max_smem =
      cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(lane_kernel<false>, max_smem,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(lane_kernel<true>, max_smem, (int)smem);
}

// Blocks of the lane kernel a slice of LANE_ROWS rows takes: the blocks
// the card holds at once spread over the slices (one wave, every SM the
// same share of the stream), at least enough that a block's span of the
// stream fits its threads; 0 if the card refuses the slice's shared
// memory. Both lane kernels are set to take it, and the blocks an SM
// holds with it are found, once per process and slice width.
int lane_per_slice(int rows, int n_pad) {
  static std::map<int, int> per_sm_of;   // n_pad -> blocks an SM holds
  auto it = per_sm_of.find(n_pad);
  if (it == per_sm_of.end()) {
    const size_t smem = sizeof(float) * LANE_ROWS * n_pad;
    int per_sm = 0;
    if (smem > (size_t)MAX_SMEM || configure_lane(smem) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, lane_kernel<false>, LANE_THREADS, smem)
               != cudaSuccess)
      per_sm = 0;
    it = per_sm_of.emplace(n_pad, per_sm).first;
  }
  if (it->second < 1) return 0;
  const int slices = LANES / LANE_ROWS;
  const int wave = it->second * tc::sm_count() / slices;
  return std::max(wave, (rows + LANE_THREADS - 1) / LANE_THREADS);
}

template <bool SUB128>
cudaError_t launch_lane(const int* idx, const float* tt, int rows, int n_pad,
                        int iters, float* partials, float* g_out,
                        cudaStream_t s, int* blocks) {
  const int per_slice = lane_per_slice(rows, n_pad);
  if (per_slice < 1) return cudaErrorInvalidValue;
  *blocks = per_slice * (LANES / LANE_ROWS);
  lane_kernel<SUB128><<<*blocks, LANE_THREADS,
                        sizeof(float) * LANE_ROWS * n_pad, s>>>(
      idx, tt, rows, n_pad, iters, per_slice, partials, g_out);
  return cudaGetLastError();
}

// The sublane form's launch, ops/gather_probe.py::sublane_plan:
// `per_slice` blocks of `span` edges on each of the four 64-lane slices,
// SUB_THREADS threads and n_pad SUB_W floats of shared memory a block. An
// SM holds the blocks of 512 threads (16 warps, which the launch bounds
// leave registers for) that its shared memory holds; the one wave's
// blocks spread over the slices, and a block takes at least one row of
// its threads (16 edges) and at most what their registers hold (256).
struct SublanePlan {
  int per_slice, span, threads, smem;
};

SublanePlan sublane_plan(int rows, int n_pad, int sms) {
  const int smem = 4 * n_pad * SUB_W;
  const int per_block = smem + SUB_THREADS / 8 + SMEM_RESERVED;
  const int per_sm = std::min(SM_SMEM / per_block,
                              SUB_SM_THREADS / SUB_THREADS);
  const int wave = std::max(per_sm * sms / SUB_SLICES, 1);
  const int span = std::min(std::max((rows + wave - 1) / wave, SUB_AT_ONCE),
                            SUB_AT_ONCE * SUB_UNITS);
  return {per_sm < 1 ? 0 : (rows + span - 1) / span, span, SUB_THREADS,
          smem};
}

cudaError_t launch_sublane(const int* idx, const float* tbl, int rows,
                           int n_pad, int iters, const SublanePlan& p,
                           float* partials, float* out, float* g_out,
                           cudaStream_t s) {
  // Once per process: the kernel may take what its static shared memory
  // leaves of a block's, and prefers the SM's largest carveout of shared
  // memory. Once per table size: whether the card holds the plan's blocks
  // an SM (cudaErrorInvalidConfiguration if it does not).
  static const cudaError_t allowed = [] {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, sublane_kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          sublane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          MAX_SMEM - (int)attr.sharedSizeBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          sublane_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (allowed != cudaSuccess) return allowed;
  static std::map<int, cudaError_t> fits_of;   // n_pad -> the check
  auto it = fits_of.find(n_pad);
  if (it == fits_of.end()) {
    const int per_block = p.smem + p.threads / 8 + SMEM_RESERVED;
    const int want = std::min(SM_SMEM / per_block, SUB_SM_THREADS / p.threads);
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sublane_kernel, p.threads, p.smem);
    if (e == cudaSuccess && per_sm < want) e = cudaErrorInvalidConfiguration;
    it = fits_of.emplace(n_pad, e).first;
  }
  if (it->second != cudaSuccess) return it->second;
  const int blocks = p.per_slice * SUB_SLICES;
  sublane_kernel<<<blocks, p.threads, p.smem, s>>>(
      idx, tbl, rows, n_pad, iters, p.per_slice, p.span, partials, g_out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  total_kernel<<<1, TOTAL_THREADS, 0, s>>>(partials, blocks, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Partials (fp32 scratch) one call of `form` needs.
int gamd_gather_form_partials(int form, int rows, int n_pad, int copies) {
  switch (form) {
    case LANE384:
    case LANE128:
      return lane_per_slice(rows, n_pad) * (LANES / LANE_ROWS);
    case TRANSPOSE:
      return (LANES / TILE) * (n_pad / TILE) / TR_TILES * copies;
    default: return 0;
  }
}

// One call of the probe: `iters` iterations of form `form` (0 lane over
// the whole row, 1 lane from three 128-wide sub-tables, 3 transpose; the
// sublane form, 2, has its own entry, gamd_sublane_gather), the total of
// their sums in out [8, 128]. idx [rows] int32 in [0, n_pad) (unused by
// the transpose); tbl the transposed table TT [256, n_pad], fp32;
// partials gamd_gather_form_partials(...) fp32; g_out the last
// iteration's result or null. Lane: rows a positive multiple of 256, n_pad
// a multiple of 4 (384 for form 1); transpose: n_pad a multiple of 32 with
// (n_pad / 32) * 8 a multiple of 4, `copies` transposes an iteration.
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

// One call of the sublane form: `iters` gathers out[e, :] = T[idx[e] +
// dep, :], the total of their sums in out [8, 128]. idx [rows] int32, rows
// positive (an index outside [0, n_pad) is clamped into it); tbl T [n_pad,
// 256] fp32; partials [per_slice * 4] fp32; g_out [rows, 256] fp32 or
// null. The plan (per_slice, span, threads, smem) is
// ops/gather_probe.py's sublane_plan for this card's SMs; any other is
// refused before any launch, and so is one whose blocks an SM the card
// does not hold.
int gamd_sublane_gather(const int* idx, const float* tbl, int rows,
                        int n_pad, int iters, float* partials, float* out,
                        float* g_out, int per_slice, int span, int threads,
                        int smem, void* stream) {
  if (rows <= 0 || n_pad <= 0 || iters < 0) return cudaErrorInvalidValue;
  const SublanePlan p = sublane_plan(rows, n_pad, tc::sm_count());
  if (p.per_slice < 1 || per_slice != p.per_slice || span != p.span
      || threads != p.threads || smem != p.smem || smem > MAX_SMEM)
    return cudaErrorInvalidValue;
  return launch_sublane(idx, tbl, rows, n_pad, iters, p, partials, out,
                        g_out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
