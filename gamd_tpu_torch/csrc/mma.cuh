// Warp-level tensor-core building blocks for Hopper (sm_90a), shared by
// the probe kernels mxu_probe.cu (scripts/bench_mxu.py's loop kernel) and
// onehot_gather.cu (scripts/probe_gather.py's one-hot gathers):
//   * a bf16 tile product, mma.sync m16n8k16, fp32 accumulator;
//   * an s8 tile product, mma.sync m16n8k32, s32 accumulator;
//   * their fragment loads from shared memory with ldmatrix: A from a
//     row-major tile (16 rows x 32 bytes: 16 bf16 or 32 s8 columns), B
//     from a row-major bf16 [K][N] tile with .trans, or from an s8 [N][K]
//     tile (the table transposed when it is staged: ldmatrix has no .trans
//     for 8-bit elements);
//   * a block sum in a fixed order, which adds into a per-block carry.
//
// Fragment layouts (PTX ISA, mma.sync): lane = 4 g + t. A bf16: a0 (row g,
// cols 2t, 2t+1), a1 (row g+8), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8,
// cols 2t+8, 2t+9). A s8: the same rows, four bytes at 4t (a0, a1) and
// 16+4t (a2, a3). B bf16: b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9).
// B s8: b0 (rows 4t..4t+3, col g), b1 (rows 16+4t..). C: c0, c1 (row g,
// cols 2t, 2t+1), c2, c3 (row g+8). wgmma and TMA are not used here.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulate.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment of the 16-row x 32-byte tile at `tile` (row stride
// `ld_bytes`, 16-byte aligned rows): bf16 m16n8k16 or s8 m16n8k32.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const void* tile,
                                       int ld_bytes) {
  const int lane = threadIdx.x & 31;
  const int row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const char* p = static_cast<const char*>(tile) + row * ld_bytes
                  + 16 * (lane >> 4);
  ldmatrix_x4(a, p);
}

// The B fragments of two adjacent n8 tiles, k16 x n16 of a row-major bf16
// [K][N] tile at `tile` (row stride `ld` elements): b[0], b[1] for columns
// 0-7 and b[2], b[3] for columns 8-15.
__device__ __forceinline__ void load_b_bf16(uint32_t (&b)[4],
                                            const __nv_bfloat16* tile,
                                            int ld) {
  const int lane = threadIdx.x & 31;
  const int k = (lane & 7) + 8 * ((lane >> 3) & 1);
  ldmatrix_x4_trans(b, tile + k * ld + 8 * (lane >> 4));
}

// The B fragments of two adjacent n8 tiles, k32 x n16 of an s8 tile stored
// transposed, [N][K] (row stride `ld_bytes`): b[0], b[1] for columns 0-7
// and b[2], b[3] for columns 8-15.
__device__ __forceinline__ void load_b_s8(uint32_t (&b)[4],
                                          const int8_t* tile_nk,
                                          int ld_bytes) {
  const int lane = threadIdx.x & 31;
  const int n = (lane & 7) + 8 * (lane >> 4);
  ldmatrix_x4(b, tile_nk + n * ld_bytes + 16 * ((lane >> 3) & 1));
}

// Two bf16 values packed as an A or B register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The sum over the block of v, in a fixed order (warp xor tree, then the
// warps' sums in order by thread 0), added to *carry by thread 0. `red`
// holds NWARPS values. Every thread must call it; the caller syncs before
// it reads *carry again.
template <int NWARPS, typename T>
__device__ __forceinline__ void block_sum_into(T v, T* red, float* carry) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL_MASK, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = red[0];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) s += red[w];
    *carry = __fadd_rn(*carry, static_cast<float>(s));
  }
}

}  // namespace
