// The one-hot gather probe for Hopper (sm_90a): the kernels behind
// gamd_tpu_torch.ops.gather_probe.onehot_gather and tools/probe_gather.py.
//
// Replaces three of scripts/probe_gather.py's Pallas kernels (pallas_call
// at lines 271-314), each a gather of node-table rows into the LJ-258 edge
// stream written as a one-hot matrix product, run `iters` times with a
// full reduction of every product folded into the carry:
//   * kernel_onehot (line 66): a bf16 one-hot [13056, 384] times a bf16
//     table [384, 256], fp32 accumulation (form BF16);
//   * kernel_onehot_int8 (line 84): an int8 one-hot, against an int8 table
//     with s32 accumulation (I8_I8, wgmma s8 k32), or against the bf16
//     table (I8_BF16): Hopper has no int8 x bf16 product, so this form
//     builds the one-hot's A fragments in bf16 (the same 0/1 values) and
//     runs the bf16 product;
//   * kernel_onehot_banded (line 113): eight tiles of 1,632 rows, each a
//     one-hot over a window of `band` table rows starting at starts[tile]
//     (BAND, band 256 or 208).
// As in the script, every iteration adds the carry's data-dependent zero
// to the table (`_dep_scalar`, line 60: 1 when the carry passes 1e30, else
// 0) before the product, then folds the product's full sum into the carry
// (`_acc_update`, line 52).
//
// Design. One wave: a persistent grid of `ctas` CTAs (at most the SM
// count, read by the wrapper from the device, and the row tiles), each
// keeping the whole table resident in shared memory for the call, as two
// halves of 128 lanes in the 128-byte swizzled K-major layout wgmma reads
// (bf16: 2 x 96 KB; int8: 2 x 48 KB). A unit of work is 64 edge rows x
// 256 lanes; CTA c walks the row tiles c, c + ctas, ... every iteration,
// alternating between its two consumer warpgroups (at 13,056 rows each
// warpgroup takes at most one). Each unit is a chain of wgmma m64n128
// products (bf16 k16 with fp32 accumulation; s8 k32 with s32 for I8_I8),
// two a k-step, one a half, both fed by the same A fragments in registers,
// over the unit's k-steps: all of n_pad, or for the bands the union of the
// windows of the band tiles its rows belong to (a row outside its window
// is a zero row, as in the script). Each thread builds its one-hot A
// fragments from its two edge rows' table indices on every k-step (the
// same 0/1 values the script's one-hot holds, in the form's type), so no
// one-hot is kept anywhere. The table's dependent zero: B is read from
// shared memory, so when the dependent scalar changes (never, at the
// script's values) the slice is restaged from the table with the scalar
// added in the table's type. Per iteration each thread sums its
// accumulators in a fixed order, the warps reduce by shuffles, and thread
// 0 adds the eight warp sums in order into the CTA's carry (fp32; int32
// for I8_I8, so exact); the dependent scalar is read from that carry.
// After the loop total_kernel adds the CTA partials in index order (fp32)
// and writes the total to out [8, 128] (every element, as the script's
// carry), so a call repeats bit for bit. The total equals JAX's carry up
// to the order of the fp32 sums (exactly for I8_I8 while the partials and
// the total stay below 2^24).
//
// What bounds it on this card: the products, 2.567 GFLOP an iteration at
// 989 TFLOP/s bf16 (2.595 us), the same at the int8 rate (1.297 us), 1.711
// and 1.390 GFLOP for the bands. The first form (a block of 32 rows x 128
// lanes by mma.sync, 816 blocks in 6.2 waves) took 13.6-13.9 us an
// iteration in bf16 and 22.4-22.6 in int8 x bf16; this one 4.4 in both
// (cuBLAS: 6.7-6.8), 2.4 in int8 x int8 and 3.5-3.8 for the bands. The
// one-hot written once a call to device memory (10.0 MB bf16, in L2) and
// streamed into a ring of stages by bulk copies took 5.0, 5.9, 2.9 and
// 4.9-5.5: its L2 stream is what building the fragments saves. A lane
// half a CTA (two CTAs a row tile) took 5.9-6.2, 5.9-6.0, 2.95-3.8 and
// 5.0 (H100 SXM, 700 W; PERF.md rows 12-14): each warpgroup then built
// the same fragments for half the products, and took up to two tiles. A
// branch between the wgmmas of a chunk makes ptxas serialize them, so
// every chunk issues all its k-steps (zero fragments past the unit's
// range) and the warpgroup index comes from lane 0.
//
// g_out, when given, receives the last iteration's product [rows, 256]
// fp32 (the gathered rows), so that a check can compare rows and not only
// the carry; timed calls pass none. The host computes the launch plan
// (ops/gather_probe.py::launch_plan) and allocates every buffer with
// torch.empty; the entry recomputes the plan and refuses one that differs,
// launches on PyTorch's current stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or plan it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "edge_tc.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int UM = 64;              // edge rows of a unit (wgmma M)
constexpr int NL = 128;             // table lanes of a half (wgmma N)
constexpr int LANES = 256;          // table lanes (hi|lo packed)
constexpr int WGS = 2;              // consumer warpgroups of a CTA
constexpr int THREADS = 128 * WGS;
constexpr int NWARPS = THREADS / 32;
constexpr int KSC = 4;              // k-steps of a chunk
constexpr int BLOCK_BYTES = NL * 128;   // a 128-byte K block of the slice
constexpr int TAIL_BYTES = 128;     // the warp sums and the carry
constexpr int MAX_SMEM = 232448;
constexpr unsigned FULL = 0xffffffffu;
constexpr float DEP_LIMIT = 1e30f;  // _dep_scalar's threshold

enum Form { BF16 = 0, I8_BF16 = 1, I8_I8 = 2, BAND = 3 };

// K values of a k-step and of a 128-byte block of the table slice.
__host__ __device__ constexpr int kstep_k(int form) {
  return form == I8_I8 ? 32 : 16;
}
__host__ __device__ constexpr int block_k(int form) {
  return form == I8_I8 ? 128 : 64;
}
__host__ __device__ inline int table_bytes(int form, int n_pad) {
  return (n_pad + block_k(form) - 1) / block_k(form) * BLOCK_BYTES;
}
// Dynamic shared memory: room to align to 1024, both halves of the table
// and the tail.
size_t smem_bytes(int form, int n_pad) {
  return 1024 + 2 * (size_t)table_bytes(form, n_pad) + TAIL_BYTES;
}

struct GatherArgs {
  const int* idx;      // [rows] node row of each edge
  const int* starts;   // [rows / tile_rows] window starts (BAND), or null
  const void* tbl;     // [n_pad, 256] bf16, or int8 (I8_I8)
  int rows, n_pad, k, tile_rows, iters;   // k: the one-hot's width
  int units;           // 64-row tiles of the stream
  int ksteps;          // n_pad / kstep_k, rounded up
  float* partials;     // [ctas] each CTA's carry
  float* g_out;        // [rows, 256] last product, or null
};

// A band's window start, clamped into the table (the script's never leave
// it), so that no read falls outside the table.
__device__ __forceinline__ int window(const GatherArgs& a, int t) {
  return min(max(a.starts[t], 0), a.n_pad - a.k);
}

// The table row that is hot in edge row r, or -1: outside the stream, the
// table or (BAND) the row's window.
template <int FORM>
__device__ __forceinline__ int hot_col(const GatherArgs& a, int r) {
  if (r >= a.rows) return -1;
  const int v = a.idx[r];
  if (FORM == BAND) {
    const int s = window(a, r / a.tile_rows);
    return (v >= s && v < s + a.k) ? v : -1;
  }
  return (v >= 0 && v < a.n_pad) ? v : -1;
}

// The k-steps [ks0, ks0 + nks) of unit u: all of the table, or the union
// of the windows of the band tiles of its rows.
template <int FORM>
__device__ __forceinline__ void unit_range(const GatherArgs& a, int u,
                                           int& ks0, int& nks) {
  if (FORM != BAND) {
    ks0 = 0;
    nks = a.ksteps;
    return;
  }
  const int r0 = u * UM, r1 = min(r0 + UM, a.rows) - 1;
  int lo = a.n_pad, hi = 0;
  for (int t = r0 / a.tile_rows; t <= r1 / a.tile_rows; ++t) {
    const int s = window(a, t);
    lo = min(lo, s);
    hi = max(hi, s + a.k);
  }
  ks0 = lo / 16;
  nks = (hi + 15) / 16 - ks0;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 A fragment of a k-step for rows g (hot at h0) and g + 8 (h1);
// c = the k-step's first K + 2t. bf16 1.0 is 0x3F80.
__device__ __forceinline__ void frag_bf16(uint32_t (&r)[4], int h0, int h1,
                                          int c) {
  r[0] = (h0 == c ? 0x3F80u : 0u) | (h0 == c + 1 ? 0x3F800000u : 0u);
  r[1] = (h1 == c ? 0x3F80u : 0u) | (h1 == c + 1 ? 0x3F800000u : 0u);
  r[2] = (h0 == c + 8 ? 0x3F80u : 0u) | (h0 == c + 9 ? 0x3F800000u : 0u);
  r[3] = (h1 == c + 8 ? 0x3F80u : 0u) | (h1 == c + 9 ? 0x3F800000u : 0u);
}

// Four s8 one-hot bytes from column c on: byte i is 1 where h == c + i.
__device__ __forceinline__ uint32_t hot4(int h, int c) {
  const unsigned d = static_cast<unsigned>(h - c);
  return d < 4u ? 1u << (8 * d) : 0u;
}
// The s8 A fragment of a k-step (k32); c = the k-step's first K + 4t.
__device__ __forceinline__ void frag_s8(uint32_t (&r)[4], int h0, int h1,
                                        int c) {
  r[0] = hot4(h0, c);
  r[1] = hot4(h1, c);
  r[2] = hot4(h0, c + 16);
  r[3] = hot4(h1, c + 16);
}

// ---------------------------------------------------------------------------
// wgmma with A from registers (the A fragment of each warp: rows 16 w + g
// and + 8 of the 64, as mma.sync's) and B from the swizzled K-major slice.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_s8(int (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
// Waits until at most N groups of this warpgroup's wgmmas are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ void fence_regs(T (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[KSC][4]) {
#pragma unroll
  for (int i = 0; i < KSC; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(r[i][q])::"memory");
}

// Half `half` of the table (128 lanes), plus dep in the table's type, into
// the swizzled K-major slice: lane n's K values in 128-byte rows, K block b at
// b * BLOCK_BYTES, the 16-byte chunk c of row n at chunk c ^ (n % 8).
// Each thread makes whole 16-byte chunks, neighbouring threads reading
// neighbouring lanes of a table row.
template <int FORM>
__device__ void stage_table(const GatherArgs& a, unsigned char* tb, int half,
                            int dep) {
  constexpr int KC = FORM == I8_I8 ? 16 : 8;   // K values of a chunk
  const int chunks = NL * ((a.n_pad + KC - 1) / KC);   // K past n_pad: 0
  for (int v = threadIdx.x; v < chunks; v += THREADS) {
    const int n = v % NL, k0 = KC * (v / NL);
    const int kin = k0 % block_k(FORM);
    unsigned char* dst = tb + (k0 / block_k(FORM)) * BLOCK_BYTES + n * 128
                         + (((kin / KC) ^ (n % 8)) << 4);
    const size_t col = (size_t)NL * half + n;
    uint32_t w[4];
    if constexpr (FORM == I8_I8) {
      const int8_t* t = static_cast<const int8_t*>(a.tbl);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t x = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = k0 + 4 * q + e;
          const int8_t b = kk < a.n_pad ? static_cast<int8_t>(
              t[(size_t)kk * LANES + col] + dep) : 0;
          x |= static_cast<uint32_t>(static_cast<uint8_t>(b)) << (8 * e);
        }
        w[q] = x;
      }
    } else {
      const bf16* t = static_cast<const bf16*>(a.tbl);
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = k0 + e < a.n_pad
            ? __bfloat162float(t[(size_t)(k0 + e) * LANES + col]) + dep
            : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = pack_bf16(x[2 * q], x[2 * q + 1]);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The products of a chunk from k-step ks with both halves of the table
// (half 1 at `second` bytes after half 0), the same A fragments feeding
// both, unconditionally (a branch between them would make ptxas serialize
// the wgmmas): past the unit's range the fragments are zero and the
// k-step is clamped into the table.
template <int FORM, typename Acc>
__device__ __forceinline__ void issue_chunk(Acc (&d0)[64], Acc (&d1)[64],
                                            const uint32_t (&f)[KSC][4],
                                            uint32_t tb, uint32_t second,
                                            int ks, int kmax) {
#pragma unroll
  for (int kk = 0; kk < KSC; ++kk) {
    const int k = min(ks + kk, kmax);
    const uint32_t b = tb + (k >> 2) * BLOCK_BYTES + (k & 3) * 32;
    if constexpr (FORM == I8_I8) {
      wgmma_rs_s8(d0, f[kk], tc::desc_sw128(b));
      wgmma_rs_s8(d1, f[kk], tc::desc_sw128(b + second));
    } else {
      wgmma_rs_bf16(d0, f[kk], tc::desc_sw128(b));
      wgmma_rs_bf16(d1, f[kk], tc::desc_sw128(b + second));
    }
  }
}

template <int FORM>
__global__ void __launch_bounds__(THREADS, 1)
onehot_gather_kernel(GatherArgs a) {
  typedef typename std::conditional<FORM == I8_I8, int, float>::type Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* tb = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t half_bytes = table_bytes(FORM, a.n_pad);
  Acc* red = reinterpret_cast<Acc*>(tb + 2 * half_bytes);
  Acc* carry = red + NWARPS;

  // The warpgroup from lane 0, so that the compiler knows it is uniform.
  const int wg = __shfl_sync(FULL, threadIdx.x >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t tb_addr = tc::smem_addr(tb);

  if (threadIdx.x == 0) *carry = 0;
  stage_table<FORM>(a, tb, 0, 0);
  stage_table<FORM>(a, tb + half_bytes, 1, 0);
  tc::proxy_fence();
  __syncthreads();

  int staged = 0;
  for (int it = 0; it < a.iters; ++it) {
    const int dep = static_cast<float>(*carry) > DEP_LIMIT ? 1 : 0;
    if (dep != staged) {   // never at the script's values
      stage_table<FORM>(a, tb, 0, dep);
      stage_table<FORM>(a, tb + half_bytes, 1, dep);
      tc::proxy_fence();
      __syncthreads();
      staged = dep;
    }
    Acc part = 0;
    for (int m = 0;; ++m) {
      const int u = blockIdx.x + gridDim.x * (2 * m + wg);
      if (u >= a.units) break;
      int ks0, nks;
      unit_range<FORM>(a, u, ks0, nks);
      const int r = u * UM + 16 * warp + g;
      const int h0 = hot_col<FORM>(a, r), h1 = hot_col<FORM>(a, r + 8);
      // The A fragments of chunk c, zero past the unit's k-steps.
      auto get = [&](uint32_t (&f)[KSC][4], int c) {
        const int n = max(0, min(KSC, nks - KSC * c));
#pragma unroll
        for (int kk = 0; kk < KSC; ++kk) {
          const int k = ks0 + KSC * c + kk;
          uint32_t v[4];
          if (FORM == I8_I8)
            frag_s8(v, h0, h1, 32 * k + 4 * t);
          else
            frag_bf16(v, h0, h1, 16 * k + 2 * t);
#pragma unroll
          for (int q = 0; q < 4; ++q) f[kk][q] = kk < n ? v[q] : 0u;
        }
      };
      Acc d0[64], d1[64];   // lanes 0-127 and 128-255
#pragma unroll
      for (int i = 0; i < 64; ++i) d0[i] = d1[i] = 0;
      fence_regs(d0);
      fence_regs(d1);
      // Two register sets, one group of products always in flight: chunk
      // c + 1's fragments are made while chunk c's products run.
      const int kmax = a.ksteps - 1;
      const int nch = (nks + KSC - 1) / KSC;
      uint32_t f0[KSC][4], f1[KSC][4];
      get(f0, 0);
      fence_regs(f0);
      tc::wgmma_fence();
      issue_chunk<FORM>(d0, d1, f0, tb_addr, half_bytes, ks0, kmax);
      tc::wgmma_commit();
      for (int c = 1; c < nch; c += 2) {
        get(f1, c);
        fence_regs(f1);
        tc::wgmma_fence();
        issue_chunk<FORM>(d0, d1, f1, tb_addr, half_bytes, ks0 + KSC * c,
                          kmax);
        tc::wgmma_commit();
        wgmma_wait<1>();   // chunk c - 1 done: f0 is free
        fence_regs(f0);
        if (c + 1 < nch) {
          get(f0, c + 1);
          fence_regs(f0);
          tc::wgmma_fence();
          issue_chunk<FORM>(d0, d1, f0, tb_addr, half_bytes,
                            ks0 + KSC * (c + 1), kmax);
          tc::wgmma_commit();
        }
        wgmma_wait<1>();   // chunk c done: f1 is free
        fence_regs(f1);
      }
      wgmma_wait<0>();
      fence_regs(f0);
      fence_regs(f1);
      fence_regs(d0);
      fence_regs(d1);
      Acc s = 0;
#pragma unroll
      for (int i = 0; i < 64; ++i) s += d0[i];
#pragma unroll
      for (int i = 0; i < 64; ++i) s += d1[i];
      part += s;
      if (a.g_out != nullptr && it == a.iters - 1) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r + 8 * h;
            if (row >= a.rows) continue;
            float* o = a.g_out + (size_t)row * LANES + 8 * j + 2 * t;
            *reinterpret_cast<float2*>(o) =
                make_float2(static_cast<float>(d0[4 * j + 2 * h]),
                            static_cast<float>(d0[4 * j + 2 * h + 1]));
            *reinterpret_cast<float2*>(o + NL) =
                make_float2(static_cast<float>(d1[4 * j + 2 * h]),
                            static_cast<float>(d1[4 * j + 2 * h + 1]));
          }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(FULL, part, off);
    if (lane == 0) red[threadIdx.x >> 5] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      Acc s = red[0];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) s += red[w];
      if constexpr (FORM == I8_I8)
        *carry += s;
      else
        *carry = __fadd_rn(*carry, s);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) a.partials[blockIdx.x] = static_cast<float>(*carry);
}

// out[0 .. 1024) = the sum of the n partials in index order.
__global__ void total_kernel(const float* partials, int n, float* out) {
  __shared__ float total;
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < n; ++i) s = __fadd_rn(s, partials[i]);
    total = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * 128; i += blockDim.x) out[i] = total;
}

template <int FORM>
int launch(const GatherArgs& a, int ctas, int smem, float* out,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      onehot_gather_kernel<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  onehot_gather_kernel<FORM><<<ctas, THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  total_kernel<<<1, 256, 0, stream>>>(a.partials, ctas, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One call of the probe: `iters` one-hot products of form `form` (0 bf16,
// 1 int8 one-hot x bf16 table, 2 int8 x int8, 3 banded bf16), the total of
// their sums in out [8, 128]. idx [rows] int32 in [0, n_pad) (BAND: each
// within its tile's window [starts[t], starts[t] + band)); tbl [n_pad, 256]
// bf16 (int8 for form 2); partials [ctas] fp32 scratch; g_out [rows, 256]
// fp32 or null. rows must be a positive multiple of 32; the one-hot's
// width (n_pad, or band for BAND) a multiple of 16 (32 for the int8
// forms); BAND tiles of tile_rows rows, a multiple of 32 that divides
// rows, with every window inside the table. The plan (ctas, threads,
// smem) is ops/gather_probe.py's launch_plan; any other is refused before
// any launch.
int gamd_onehot_gather(int form, const int* idx, const int* starts,
                       const void* tbl, int rows, int n_pad, int band,
                       int tile_rows, int iters, float* partials, float* out,
                       float* g_out, int ctas, int threads, int smem,
                       void* stream) {
  if (rows <= 0 || rows % 32 != 0 || n_pad <= 0 || iters < 0
      || form < BF16 || form > BAND)
    return cudaErrorInvalidValue;
  const int k = form == BAND ? band : n_pad;
  const int step = (form == I8_BF16 || form == I8_I8) ? 32 : 16;
  if (k <= 0 || k % step != 0 || k > n_pad || n_pad % step != 0)
    return cudaErrorInvalidValue;
  if (form == BAND && (tile_rows <= 0 || tile_rows % 32 != 0
                       || rows % tile_rows != 0 || starts == nullptr))
    return cudaErrorInvalidValue;
  // The plan: what launch_plan computes for this shape.
  const int units = (rows + UM - 1) / UM;
  const int ksteps = (n_pad + kstep_k(form) - 1) / kstep_k(form);
  int sms = 0, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    return cudaErrorInvalidValue;
  if (ctas <= 0 || ctas > units || ctas > sms || threads != THREADS
      || (size_t)smem != smem_bytes(form, n_pad) || smem > MAX_SMEM)
    return cudaErrorInvalidValue;
  const GatherArgs a{idx, starts, tbl, rows, n_pad, k,
                     form == BAND ? tile_rows : rows, iters, units, ksteps,
                     partials, g_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case BF16: return launch<BF16>(a, ctas, smem, out, s);
    case I8_BF16: return launch<I8_BF16>(a, ctas, smem, out, s);
    case I8_I8: return launch<I8_I8>(a, ctas, smem, out, s);
    default: return launch<BAND>(a, ctas, smem, out, s);
  }
}

}  // extern "C"
