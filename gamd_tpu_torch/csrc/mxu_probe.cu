// The tensor-core probe for Hopper (sm_90a): the kernel behind
// gamd_tpu_torch.ops.mxu_probe.mxu_loop and tools/bench_mxu.py.
//
// Replaces scripts/bench_mxu.py::loop_kernel (line 91, pallas_call at line
// 131): one stage of the megakernel's forward body run `iters` times on
// data that stays on the chip, the accumulator carried from iteration to
// iteration and written once after the loop, so that every iteration is
// live by data dependence. Here loop_kernel<Body> is that loop, templated
// on the body, with the five bodies bench_mxu.py's main() runs at the
// LJ-258 shapes (tile_n 16, k 48, D 128, n_pad 384):
//   * PeakTcBody (peak_body :150): four chained bf16 [512,512]@[512,512] products, fp32 accumulation, each
//     result rounded to bf16, then acc*0.5 + x;
//   * GatherMmBody (gmm_body :185): a prebuilt bf16 one-hot [rows, n_pad]
//     times the hi and lo node tables [n_pad, 128];
//   * GatherFullBody (gfull_body :215): the one-hot built from idx by
//     compare every iteration, the two gathers, and three affine products
//     of the gathered hi/lo rows with the bf16 hi/lo split of ws;
//   * EdgeMlpBody (emlp_body :247): four [rows,128]@[128,128] bf16
//     products with silu;
//   * RepeatBody (rep_body :264): the k-broadcast of [tile_n,128] rows to
//     [tile_n k, 128] (no product), a register-resident loop (below).
// The peak chain's products are wgmma m64n64k16 (edge_tc.cuh), both
// operands in shared memory; every other product is mma.sync (mma.cuh):
// bf16 m16n8k16 with fp32 accumulation, fragments by ldmatrix.
//
// Design. The output is cut by rows (tiles of 32 rows, 64 for peak) and
// by columns (a CTA owns `cols` of them), so that at the script's shapes
// 48-128 CTAs run at once, and everything that does not depend on the
// carry is loaded once before the loop and stays in shared memory or
// registers:
//   * peak and edge_mlp: a cluster of `cluster` CTAs shares a row tile,
//     each CTA keeping its column slice of the weight resident (peak's
//     w[:, 64 cols] is 64 KB). A product's input needs whole rows, so each
//     CTA sends its bf16 slice of every product (and of the first input,
//     a + keep) to every CTA of its cluster (Exchange: bulk copies through
//     distributed shared memory, completing on the receiver's mbarrier,
//     double-buffered; no cluster barrier in the loop). peak: 8 row tiles
//     of 64 x 8 CTAs of 64 columns = 64 CTAs on wgmma (PeakTcBody; the
//     same chain on 32-row mma.sync tiles, 16 clusters of 8 or 4, measured
//     15.6-29.7 us an iteration against 11.9-12.3). edge_mlp at 768 rows:
//     24 row tiles x 2 = 48 CTAs (measured faster than clusters of 4 or 8
//     or none). The e values at a thread's fragment positions stay in
//     registers.
//   * gather_full: a cluster shares a row tile the same way. A CTA keeps
//     its column slices of nh, nl and of ws hi and lo resident, builds the
//     one-hot A fragments from idx in registers (no one-hot in memory),
//     gathers its columns, and exchanges the gathered bf16 rows through
//     distributed shared memory, since the affine needs whole rows.
//   * gather_mm: no cluster (no product reads another CTA's columns). A
//     CTA owns `cols` columns and T row tiles, with their one-hot rows and
//     its column slices of nh and nl resident; the carry-dependent
//     bf16(nh + keep[c]) is made in the B fragments in registers. At 768
//     rows T = 1 (96 CTAs); at 8 x 768 rows T = 6 (128 persistent CTAs of
//     24 warps), where 192 one-block-a-tile CTAs would run in two waves.
//   * repeat: no shared memory and no barrier. A CTA of two warps owns 32
//     columns and 2 PER rows, a thread PER rows of one column that share
//     their dst row, with its dst values loaded before the loop; PER (1,
//     2, 4 or 8, dividing k) is the largest that keeps the CTAs at one
//     wave of the card's SMs or more: at 768 rows and k 48, PER 8, 192
//     CTAs (the first form: 24 blocks of 256 threads, a 32-row tile each,
//     two barriers and a shared-memory round trip of the tile's first row
//     an iteration).
// Python computes the launch plan (ops/mxu_probe.py::launch_plan: CTAs,
// cluster, rows and columns a CTA, threads, shared bytes) and passes it in;
// the entry recomputes every field from the body's split (SPLIT below) and
// refuses a plan that differs.
//
// The carry. JAX's keep-alive terms read the global acc[0:1, :] (or
// acc[0, 0]); CTAs here share nothing but their cluster, so each CTA reads
// the first row of its own row tile in its own columns (gather_full: its
// own tile's first element), except repeat, whose threads each carry the
// global row 0 of their column (its recurrence needs nothing else). The
// terms are numerically void in both (a + bf16(acc 1e-30) is a for a
// nonzero bf16 a; (int)(acc 1e-30) is 0), so the output equals JAX's
// loop, but the compiler cannot know it: the next iteration's inputs
// depend on the carry, and no iteration can be hoisted or dropped.
// tools/bench_mxu.py's calibration (per-iteration time at iters and
// iters/4, and the peak stage's rate against the card's 989 TFLOP/s)
// catches a collapse; chip_smoke.py phase 31 holds repeat's time an
// iteration between iters 200 and 2,000 to its bound.
//
// What bounds it on this card: the products at the dense bf16 rate (989
// TFLOP/s; 1.074 GFLOP an iteration for peak, 151 M for gather_mm, 226.5 M
// for gather_full, 100.7 M for edge_mlp); repeat by the latency of row 0's
// dependent multiply and three adds an iteration, since every iteration of
// every thread waits on it. The first form (a block a 32-row tile, B
// staged 32 rows at a time, 16-24 blocks) took 89.9 us an iteration for
// peak, 26.2-27.7 for gather_mm, 18 for gather_full and 10.5 for
// edge_mlp; this one 11.9-12.3, 2.4-2.5, 3.1-3.3 and 4.5-4.7 (H100 SXM,
// 700 W; chip_smoke.py phase 30 and PERF.md row 11, which also lists the
// splits tried). What holds it back now is latency: each product waits on
// the exchange before it, and at these shapes a CTA's products are short.
//
// Sums that the bit-for-bit comparison with the plain version relies on
// (gather_mm, repeat) use __fadd_rn/__fmul_rn, so no FMA contraction
// changes them. The host allocates the output with torch.empty and
// launches on PyTorch's current stream; the entry returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or plan it does
// not take.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "edge_tc.cuh"
#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int BM = 32;             // rows of a row tile
constexpr int D = 128;             // width of every stage but peak
constexpr int PEAK_N = 512;        // the peak chain's [512, 512]
constexpr int PAD = 8;             // bf16 elements of row padding (16 bytes)
constexpr int MAX_SMEM = 232448;   // a block's shared memory on Hopper
constexpr int REPEAT_THREADS = 64;   // two warps: 2 PER rows a CTA
constexpr int REPEAT_COLS = 32;      // a warp's columns, one a lane
constexpr float KEEP = 1e-30f;     // the keep-alive scale (bench_mxu.py)

enum Body { PEAK = 0, GATHER_MM = 1, GATHER_FULL = 2, EDGE_MLP = 3,
            REPEAT = 4 };

struct LoopArgs {
  const void* in0;
  const void* in1;
  const void* in2;
  const void* in3;
  const float* salt;   // [8, 128]; salt[0] enters the keep-alive term
  int rows;            // output rows
  int n_pad;           // node-table rows (gather bodies)
  int k;               // repeat factor (repeat)
  int iters;
  float* out;          // [rows, width] fp32
  int cluster;         // CTAs of a cluster (the column slices of a row tile)
  int tile_rows;       // rows a CTA (a multiple of BM; repeat 2 PER)
  int cols;            // columns a CTA
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// silu with the fast exponential and division (the forward's edge stage
// does the same): within a few ulp of x sigmoid(x).
__device__ __forceinline__ float silu_f32(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

// One warp's place in its CTA: warps are ordered (row group of 16, column
// group of 16), `ncg` column groups; the warp covers rows r16 .. r16 + 16
// and columns c16 .. c16 + 16 of the CTA's tile.
struct WarpPos {
  int r16, c16, g, t;
  __device__ __forceinline__ explicit WarpPos(int ncg) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    r16 = 16 * (w / ncg);
    c16 = 16 * (w % ncg);
    g = lane >> 2;
    t = lane & 3;
  }
  // Row and column in the CTA's tile of element q of n8 tile j.
  __device__ __forceinline__ int row(int q) const {
    return r16 + g + 8 * (q >> 1);
  }
  __device__ __forceinline__ int col(int j, int q) const {
    return c16 + 8 * j + 2 * t + (q & 1);
  }
};

typedef float Frag2[2][4];   // two n8 tiles of a warp's 16 x 16

__device__ __forceinline__ void zero(Frag2& c) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j][q] = 0.f;
}

// c += A (16 rows, row-major, ld `lda` elements) @ B (rows of a row-major
// [K][ldb] tile, 16 columns) over `ksteps` k-steps of 16: the even and the
// odd k-steps in two accumulators, added at the end, so that two chains of
// dependent mma run at once; unrolled, so the fragment loads run ahead.
__device__ __forceinline__ void mma_step(const bf16* a_tile, int lda,
                                         const bf16* b_tile, int ldb, int ks,
                                         Frag2& c) {
  uint32_t a[4], b[4];
  load_a(a, a_tile + ks * 16, lda * 2);
  load_b_bf16(b, b_tile + ks * 16 * ldb, ldb);
  mma_bf16_16816(c[0], a, b[0], b[1]);
  mma_bf16_16816(c[1], a, b[2], b[3]);
}
__device__ __forceinline__ void warp_mma(const bf16* a_tile, int lda,
                                         const bf16* b_tile, int ldb,
                                         int ksteps, Frag2& c) {
  Frag2 d;
  zero(d);
  int ks = 0;
#pragma unroll 2
  for (; ks + 1 < ksteps; ks += 2) {
    mma_step(a_tile, lda, b_tile, ldb, ks, c);
    mma_step(a_tile, lda, b_tile, ldb, ks + 1, d);
  }
  if (ks < ksteps) mma_step(a_tile, lda, b_tile, ldb, ks, c);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j][q] += d[j][q];
}

// The same A against two B tiles (the hi and lo parts).
__device__ __forceinline__ void warp_mma2(const bf16* a_tile, int lda,
                                          const bf16* b1, const bf16* b2,
                                          int ldb, int ksteps, Frag2& c1,
                                          Frag2& c2) {
#pragma unroll 4
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[4], b[4];
    load_a(a, a_tile + ks * 16, lda * 2);
    load_b_bf16(b, b1 + ks * 16 * ldb, ldb);
    mma_bf16_16816(c1[0], a, b[0], b[1]);
    mma_bf16_16816(c1[1], a, b[2], b[3]);
    load_b_bf16(b, b2 + ks * 16 * ldb, ldb);
    mma_bf16_16816(c2[0], a, b[0], b[1]);
    mma_bf16_16816(c2[1], a, b[2], b[3]);
  }
}

// bf16 x2 register + keep (fp32), rounded back to bf16 per element.
__device__ __forceinline__ uint32_t add_keep(uint32_t v, float keep) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 f = __bfloat1622float2(h);
  return pack_bf16(__fadd_rn(f.x, keep), __fadd_rn(f.y, keep));
}

// A barrier over the cluster (a CTA barrier when it has one CTA): at the
// start, so that every CTA's barriers exist before another sends to it,
// and at the end, so that no CTA leaves while a copy into it is in flight.
__device__ __forceinline__ void cluster_sync(int cs) {
  if (cs > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The shared::cluster address of shared address `addr` in CTA `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// One thread: `bytes` of this CTA's shared memory at `src` into another
// CTA's at `dst` (shared::cluster), completing on its barrier `bar`.
__device__ __forceinline__ void copy_to_cta(uint32_t dst, uint32_t src,
                                            uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The exchange of a cluster's column slices. A buffer holds whole rows as
// `cs` slices (slice r from CTA r; [BM][ld] rows, or a swizzled K block),
// two buffers by
// the exchange's parity, each with an mbarrier. Exchange e: the CTA's
// threads write their slice into buffer e % 2; thread `rank` arms the
// buffer's barrier for the other slices' bytes, and thread r sends the
// slice to the same place in CTA r by a bulk copy (the TMA engine, through
// distributed shared memory); every thread waits on the barrier. No
// cluster barrier: a CTA sends exchange e + 1 only after it has all of e,
// so a buffer is never written while a CTA still reads it, and the two
// barriers never see the bytes of two exchanges at once.
struct Exchange {
  bf16* buf;        // [2][cs][slice]
  uint32_t bars;    // shared address of the two barriers
  int cs, rank, slice, e;
  uint32_t bytes;
  __device__ void init(bf16* buffers, uint64_t* barriers, int cs_,
                       int slice_elems) {
    buf = buffers;
    bars = smem_addr(barriers);
    cs = cs_;
    rank = blockIdx.x % cs_;
    slice = slice_elems;
    bytes = slice * sizeof(bf16);
    e = 0;
    if (threadIdx.x == 0) {
      tc::mbar_init(bars, 1);
      tc::mbar_init(bars + 8, 1);
      tc::mbar_init_fence();
    }
  }
  // This CTA's slice of the next exchange's buffer.
  __device__ __forceinline__ bf16* mine() const {
    return buf + ((e & 1) * cs + rank) * slice;
  }
  // The whole rows of the last exchange, slice by slice.
  __device__ __forceinline__ const bf16* rows() const {
    return buf + ((e - 1) & 1) * cs * slice;
  }
  // After every thread wrote its part of mine(): the exchange.
  __device__ void run() {
    const int b = e & 1;
    tc::proxy_fence();
    __syncthreads();
    if (threadIdx.x < cs) {   // one thread a CTA of the cluster, at once
      const uint32_t bar = bars + 8 * b;
      const int r = threadIdx.x;
      if (r == rank) {
        tc::mbar_expect(bar, (cs - 1) * bytes);
      } else {
        const uint32_t src = smem_addr(mine());
        copy_to_cta(map_rank(src, r), src, bytes, map_rank(bar, r));
      }
    }
    tc::mbar_wait(bars + 8 * b, (e >> 1) & 1);
    ++e;
  }
};

// c += X @ B for the warp's 16 rows (from r16) of the whole rows X, held
// as cs slices of `cols` columns (row stride cols + PAD), and 16 columns
// of a row-major [cs cols][ldb] B.
__device__ __forceinline__ void slice_mma(const bf16* x, int cs, int cols,
                                          int r16, const bf16* b_tile,
                                          int ldb, Frag2& c) {
  const int ldx = cols + PAD;
  for (int s = 0; s < cs; ++s)
    warp_mma(x + (s * BM + r16) * ldx, ldx, b_tile + s * cols * ldb, ldb,
             cols / 16, c);
}
// Copies rows x `width` bf16 (16 bytes a thread) from global (row stride
// `gld`) into a shared tile (row stride `sld`).
__device__ __forceinline__ void copy_rows(bf16* dst, int sld, const bf16* src,
                                          int gld, int rows, int width) {
  const int per_row = width / 8;
  for (int v = threadIdx.x; v < rows * per_row; v += blockDim.x) {
    const int r = v / per_row, c = 8 * (v % per_row);
    *reinterpret_cast<uint4*>(dst + r * sld + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * gld + c);
  }
}

template <typename Carry>
__device__ __forceinline__ void store_out(float* out, int width, int row0,
                                          int col0, const WarpPos& wp,
                                          const Carry& acc) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 4; q += 2)
      *reinterpret_cast<float2*>(out + (size_t)(row0 + wp.row(q)) * width
                                 + col0 + wp.col(j, q)) =
          make_float2(acc[j][q], acc[j][q + 1]);
}

// ---- edge_mlp: a chain of four products over whole rows -----------------
// x0 = bf16(e + acc0 1e-30 + salt 1e-30), silu after the first three
// products, acc = acc 0.5 + last.
struct EdgeMlpBody {
  static constexpr int MAX_THREADS = 512;
  typedef Frag2 Carry;
  static size_t smem_bytes(int cols, int, int) {
    return 16 + ((size_t)D * (cols + PAD)
                 + 2 * (size_t)(D / cols) * BM * (cols + PAD)) * sizeof(bf16)
           + (size_t)cols * sizeof(float);
  }
  bf16* w;      // [D][cols + PAD] this CTA's column slice of bf16(w)
  float* row0;  // [cols] the carry's first row in this CTA's columns
  Exchange ex;  // the chain's operand, whole rows
  float in[2][4];   // e at the thread's fragment positions
  WarpPos wp;
  int cs, cols, ldw, row_base, col_base;
  float* out;
  float salt_term;
  __device__ EdgeMlpBody(const LoopArgs& a, unsigned char* smem)
      : wp(a.cols / 16) {
    cs = a.cluster;
    cols = a.cols;
    ldw = cols + PAD;
    row_base = (blockIdx.x / cs) * BM;
    col_base = (blockIdx.x % cs) * cols;
    out = a.out;
    w = reinterpret_cast<bf16*>(smem + 16);
    bf16* x = w + D * ldw;
    row0 = reinterpret_cast<float*>(x + 2 * cs * BM * ldw);
    ex.init(x, reinterpret_cast<uint64_t*>(smem), cs, BM * ldw);
    salt_term = __fmul_rn(a.salt[0], KEEP);
    const float* gw = static_cast<const float*>(a.in1);
    for (int v = threadIdx.x; v < D * cols; v += blockDim.x) {
      const int r = v / cols, c = v % cols;
      w[r * ldw + c] = __float2bfloat16_rn(gw[r * D + col_base + c]);
    }
    const bf16* src = static_cast<const bf16*>(a.in0);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        in[j][q] = __bfloat162float(src[(size_t)(row_base + wp.row(q)) * D
                                        + col_base + wp.col(j, q)]);
    for (int c = threadIdx.x; c < cols; c += blockDim.x) row0[c] = 0.f;
    cluster_sync(cs);
  }
  // The first product's input at element q of tile j.
  __device__ __forceinline__ float input(int j, int q) const {
    const float r0 = row0[wp.col(j, q)];
    return __fadd_rn(__fadd_rn(in[j][q], __fmul_rn(r0, KEEP)), salt_term);
  }
  // The pair (v0, v1) at element q of tile j of this CTA's slice.
  __device__ __forceinline__ void put(int j, int q, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(ex.mine() + wp.row(q) * ldw
                                 + wp.col(j, q)) = pack_bf16(v0, v1);
  }
  __device__ void step(Carry& acc) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      put(j, 0, input(j, 0), input(j, 1));
      put(j, 2, input(j, 2), input(j, 3));
    }
    ex.run();
    for (int p = 0; p < 4; ++p) {
      Frag2 c;
      zero(c);
      slice_mma(ex.rows(), cs, cols, wp.r16, w + wp.c16, ldw, c);
      if (p < 3) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; q += 2)
            put(j, q, silu_f32(c[j][q]), silu_f32(c[j][q + 1]));
        ex.run();
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[j][q] = __fadd_rn(__fmul_rn(acc[j][q], 0.5f), c[j][q]);
      }
    }
    if (wp.r16 == 0 && wp.g == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        row0[wp.col(j, 0)] = acc[j][0];
        row0[wp.col(j, 1)] = acc[j][1];
      }
    }
    __syncthreads();
  }
  __device__ void finish(const Carry& acc) {
    store_out(out, D, row_base, col_base, wp, acc);
    cluster_sync(cs);
  }
};

// ---- peak on wgmma: 64-row tiles, clusters of 8 CTAs x 64 columns ------
// One warpgroup a CTA; each product a chain of 32 wgmma m64n64k16 with both
// operands in shared memory in the 128-byte swizzled K-major layout
// (edge_tc.cuh): B is this CTA's w[:, 64 cols] transposed, 8 K blocks of
// 8 KB, resident; A is the chain's operand, 8 K blocks of 64 rows x 64
// columns, double-buffered. A CTA's 64 x 64 output is exactly K block
// `rank` of the next product's A, so the exchange sends one 8 KB block to
// each CTA of the cluster. 8 row tiles x 8 = 64 CTAs in 8 clusters.
struct PeakTcBody {
  static constexpr int MAX_THREADS = 128;
  static constexpr int TILE = 64, COLS = 64;
  static constexpr int BLOCK = TILE * 128;            // a K block, 8 KB
  static constexpr int OPERAND = PEAK_N / 64 * BLOCK; // 64 KB
  typedef float Carry[2 * tc::PAIRS];
  static size_t smem_bytes(int, int, int) {
    return 1024 + 16 + 3 * (size_t)OPERAND + COLS * sizeof(float);
  }
  unsigned char* wb;   // B: w^T slice, [8 K blocks][64 n][128 bytes]
  float* row0;         // [COLS] the carry's first row in this CTA's columns
  Exchange ex;         // A: [2][8 K blocks], block r from CTA r
  float in[2 * tc::PAIRS];   // a at the thread's accumulator positions
  tc::Frag f;
  int row_base, col_base;
  float salt_term;
  float* out;
  // Byte offset of (row, col) in a swizzled K block of 64-element rows.
  static __device__ __forceinline__ int swz(int row, int col) {
    return row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + 2 * (col & 7);
  }
  __device__ PeakTcBody(const LoopArgs& a, unsigned char* smem) {
    const int cs = a.cluster;
    row_base = (blockIdx.x / cs) * TILE;
    col_base = (blockIdx.x % cs) * COLS;
    out = a.out;
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem) + 16 + 1023) & ~uintptr_t(1023));
    wb = base;
    unsigned char* xb = base + OPERAND;
    row0 = reinterpret_cast<float*>(xb + 2 * OPERAND);
    ex.init(reinterpret_cast<bf16*>(xb), reinterpret_cast<uint64_t*>(smem),
            cs, BLOCK / 2);
    salt_term = bf16r(__fmul_rn(a.salt[0], KEEP));
    const bf16* w = static_cast<const bf16*>(a.in1);
    for (int v = threadIdx.x; v < COLS * PEAK_N / 8; v += blockDim.x) {
      const int n = v % COLS, k0 = 8 * (v / COLS);
      uint32_t q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bf16 lo = w[(size_t)(k0 + 2 * e) * PEAK_N + col_base + n];
        const bf16 hi = w[(size_t)(k0 + 2 * e + 1) * PEAK_N + col_base + n];
        q[e] = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&lo))
               | static_cast<uint32_t>(
                     *reinterpret_cast<const uint16_t*>(&hi)) << 16;
      }
      *reinterpret_cast<uint4*>(wb + (k0 >> 6) * BLOCK + swz(n, k0 & 63)) =
          make_uint4(q[0], q[1], q[2], q[3]);
    }
    const bf16* src = static_cast<const bf16*>(a.in0);
#pragma unroll
    for (int p = 0; p < tc::PAIRS; ++p)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        in[2 * p + e] = __bfloat162float(
            src[(size_t)(row_base + f.row(p)) * PEAK_N + col_base
                + (f.col(p) & 63) + e]);
    for (int c = threadIdx.x; c < COLS; c += blockDim.x) row0[c] = 0.f;
    tc::proxy_fence();
    cluster_sync(cs);
  }
  // The pair (v0, v1) at pair p of this CTA's block of the next operand.
  __device__ __forceinline__ void put(int p, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(ex.mine())
                                 + swz(f.row(p), f.col(p) & 63)) =
        pack_bf16(v0, v1);
  }
  __device__ __forceinline__ void product(float (&d)[2 * tc::PAIRS]) {
    const uint32_t a = smem_addr(ex.rows()), b = smem_addr(wb);
#pragma unroll
    for (int i = 0; i < 2 * tc::PAIRS; ++i) d[i] = 0.f;
    tc::fence_acc(d);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PEAK_N / 16; ++kk)
      tc::wgmma_ss(d, tc::desc_sw128(a + (kk >> 2) * BLOCK + (kk & 3) * 32),
                   tc::desc_sw128(b + (kk >> 2) * BLOCK + (kk & 3) * 32));
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_acc(d);
  }
  __device__ void step(Carry& acc) {
#pragma unroll
    for (int p = 0; p < tc::PAIRS; ++p) {
      const int c = f.col(p) & 63;
      const float k0 = bf16r(__fadd_rn(bf16r(row0[c] * KEEP), salt_term));
      const float k1 = bf16r(__fadd_rn(bf16r(row0[c + 1] * KEEP),
                                       salt_term));
      put(p, __fadd_rn(in[2 * p], k0), __fadd_rn(in[2 * p + 1], k1));
    }
    ex.run();
    for (int prod = 0; prod < 4; ++prod) {
      float d[2 * tc::PAIRS];
      product(d);
      if (prod < 3) {
#pragma unroll
        for (int p = 0; p < tc::PAIRS; ++p) put(p, d[2 * p], d[2 * p + 1]);
        ex.run();
      } else {
#pragma unroll
        for (int i = 0; i < 2 * tc::PAIRS; ++i)
          acc[i] = __fadd_rn(__fmul_rn(acc[i], 0.5f), bf16r(d[i]));
      }
    }
    if (f.r0 == 0) {   // warp 0, lanes of row 0 (even pairs)
#pragma unroll
      for (int p = 0; p < tc::PAIRS; p += 2) {
        row0[f.col(p) & 63] = acc[2 * p];
        row0[(f.col(p) & 63) + 1] = acc[2 * p + 1];
      }
    }
    __syncthreads();
  }
  __device__ void finish(const Carry& acc) {
#pragma unroll
    for (int p = 0; p < tc::PAIRS; ++p)
      *reinterpret_cast<float2*>(out + (size_t)(row_base + f.row(p)) * PEAK_N
                                 + col_base + (f.col(p) & 63)) =
          make_float2(acc[2 * p], acc[2 * p + 1]);
    cluster_sync(ex.cs);
  }
};

// ---- gather_mm: prebuilt one-hot x hi/lo node tables ----------------------
// A CTA: `cols` columns of T = tile_rows / BM row tiles; warps ordered
// (tile, row group, column group). keep[c] of a tile is bf16(bf16(acc0[c]
// 1e-30) + bf16(salt 1e-30)) from the tile's first row, double-buffered by
// the iteration's parity.
struct GatherMmBody {
  static constexpr int MAX_THREADS = 1024;
  typedef Frag2 Carry;
  static size_t smem_bytes(int cols, int tile_rows, int n_pad) {
    return ((size_t)tile_rows * (n_pad + PAD) + 2 * (size_t)n_pad
            * (cols + PAD)) * sizeof(bf16)
           + 2 * (size_t)(tile_rows / BM) * cols * sizeof(float);
  }
  bf16* oh;     // [tile_rows][n_pad + PAD] resident one-hot rows
  bf16* bh;     // [n_pad][cols + PAD] nh's column slice
  bf16* bl;     // [n_pad][cols + PAD] nl's column slice
  float* row0;  // [2][T][cols] each tile's first carry row
  WarpPos wp;
  int ldo, ldb, ksteps, cols, tiles, tile, row_base, col_base, rows, par;
  bool live;
  float salt_term;
  float* out;
  __device__ GatherMmBody(const LoopArgs& a, unsigned char* smem)
      : wp(a.cols / 16) {
    cols = a.cols;
    tiles = a.tile_rows / BM;
    const int slices = D / cols;
    row_base = (blockIdx.x / slices) * a.tile_rows;
    col_base = (blockIdx.x % slices) * cols;
    rows = a.rows;
    ldo = a.n_pad + PAD;
    ldb = cols + PAD;
    ksteps = a.n_pad / 16;
    tile = wp.r16 / BM;
    live = row_base + wp.r16 < rows;
    par = 0;
    out = a.out;
    oh = reinterpret_cast<bf16*>(smem);
    bh = oh + a.tile_rows * ldo;
    bl = bh + a.n_pad * ldb;
    row0 = reinterpret_cast<float*>(bl + a.n_pad * ldb);
    salt_term = bf16r(__fmul_rn(a.salt[0], KEEP));
    const int own = min(a.tile_rows, rows - row_base);
    copy_rows(oh, ldo, static_cast<const bf16*>(a.in0)
                           + (size_t)row_base * a.n_pad,
              a.n_pad, own, a.n_pad);
    copy_rows(bh, ldb, static_cast<const bf16*>(a.in1) + col_base, D,
              a.n_pad, cols);
    copy_rows(bl, ldb, static_cast<const bf16*>(a.in2) + col_base, D,
              a.n_pad, cols);
    for (int c = threadIdx.x; c < 2 * tiles * cols; c += blockDim.x)
      row0[c] = 0.f;
    __syncthreads();
  }
  __device__ void step(Carry& acc) {
    if (live) {
      const float* r0 = row0 + (par * tiles + tile) * cols;
      const float k0 = bf16r(__fadd_rn(bf16r(r0[wp.c16 + wp.g] * KEEP),
                                       salt_term));
      const float k1 = bf16r(__fadd_rn(bf16r(r0[wp.c16 + 8 + wp.g] * KEEP),
                                       salt_term));
      Frag2 ch, cl;
      zero(ch);
      zero(cl);
      const bf16* ap = oh + wp.r16 * ldo;
#pragma unroll 4
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t av[4], b[4];
        load_a(av, ap + ks * 16, ldo * 2);
        load_b_bf16(b, bh + ks * 16 * ldb + wp.c16, ldb);
        mma_bf16_16816(ch[0], av, add_keep(b[0], k0), add_keep(b[1], k0));
        mma_bf16_16816(ch[1], av, add_keep(b[2], k1), add_keep(b[3], k1));
        load_b_bf16(b, bl + ks * 16 * ldb + wp.c16, ldb);
        mma_bf16_16816(cl[0], av, b[0], b[1]);
        mma_bf16_16816(cl[1], av, b[2], b[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[j][q] = __fadd_rn(__fadd_rn(__fmul_rn(acc[j][q], 0.5f),
                                          ch[j][q]), cl[j][q]);
      if (wp.r16 % BM == 0 && wp.g == 0) {
        float* w0 = row0 + ((par ^ 1) * tiles + tile) * cols;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          w0[wp.col(j, 0)] = acc[j][0];
          w0[wp.col(j, 1)] = acc[j][1];
        }
      }
    }
    par ^= 1;
    __syncthreads();
  }
  __device__ void finish(const Carry& acc) {
    if (live) store_out(out, D, row_base, col_base, wp, acc);
  }
};

// ---- gather_full: compare one-hot + gathers + hi/lo source affine --------
// A cluster of D / cols CTAs shares a row tile. Each CTA gathers its
// columns of the hi and lo rows (the one-hot A fragments from idx + shift
// in registers), exchanges them as bf16 (exactly: they are table values)
// with the other CTAs of its cluster, and runs the affine for its columns
// over the whole rows.
struct GatherFullBody {
  static constexpr int MAX_THREADS = 512;
  typedef Frag2 Carry;
  static size_t smem_bytes(int cols, int, int n_pad) {
    return 16 + (2 * (size_t)n_pad * (cols + PAD)
                 + 2 * (size_t)D * (cols + PAD)
                 + 2 * (size_t)(D / cols) * BM * (2 * cols + 3 * PAD))
                    * sizeof(bf16)
           + 16;
  }
  bf16* bh;     // [n_pad][cols + PAD] nh's column slice
  bf16* bl;     // [n_pad][cols + PAD] nl's column slice
  bf16* wsh;    // [D][cols + PAD] bf16(ws) column slice
  bf16* wsl;    // [D][cols + PAD] bf16(ws - bf16(ws))
  float* acc00; // this CTA's first carry element
  Exchange ex;  // gathered rows: slices [BM][hi cols | PAD | lo cols | 2 PAD]
  WarpPos wp;
  int cs, cols, ldb, ksteps, row_base, col_base, idx0, idx1;
  float salt_term;
  float* out;
  __device__ GatherFullBody(const LoopArgs& a, unsigned char* smem)
      : wp(a.cols / 16) {
    cs = a.cluster;
    cols = a.cols;
    ldb = cols + PAD;
    ksteps = a.n_pad / 16;
    row_base = (blockIdx.x / cs) * BM;
    col_base = (blockIdx.x % cs) * cols;
    out = a.out;
    bh = reinterpret_cast<bf16*>(smem + 16);
    bl = bh + a.n_pad * ldb;
    wsh = bl + a.n_pad * ldb;
    wsl = wsh + D * ldb;
    bf16* g = wsl + D * ldb;
    // An exchanged slice holds the hi and the lo columns, its row stride
    // (2 cols + 3 PAD) x 2 bytes an odd multiple of 16 (no bank conflicts).
    ex.init(g, reinterpret_cast<uint64_t*>(smem), cs,
            BM * (2 * cols + 3 * PAD));
    acc00 = reinterpret_cast<float*>(g + 2 * cs * BM * (2 * cols + 3 * PAD));
    salt_term = __fmul_rn(a.salt[0], KEEP);
    copy_rows(bh, ldb, static_cast<const bf16*>(a.in1) + col_base, D,
              a.n_pad, cols);
    copy_rows(bl, ldb, static_cast<const bf16*>(a.in2) + col_base, D,
              a.n_pad, cols);
    const float* ws = static_cast<const float*>(a.in3);
    for (int v = threadIdx.x; v < D * cols; v += blockDim.x) {
      const int r = v / cols, c = v % cols;
      const float f = ws[r * D + col_base + c];
      const bf16 hi = __float2bfloat16_rn(f);
      wsh[r * ldb + c] = hi;
      wsl[r * ldb + c] = __float2bfloat16_rn(f - __bfloat162float(hi));
    }
    const int* gidx = static_cast<const int*>(a.in0);
    idx0 = gidx[row_base + wp.r16 + wp.g];
    idx1 = gidx[row_base + wp.r16 + wp.g + 8];
    if (threadIdx.x == 0) *acc00 = 0.f;
    cluster_sync(cs);
  }
  // The one-hot's A fragment at k-step ks: row g hot at column h0, row g + 8
  // at h1 (bf16 1.0 is 0x3F80).
  __device__ __forceinline__ void onehot_a(uint32_t (&av)[4], int ks, int h0,
                                           int h1) const {
    const int c = 16 * ks + 2 * wp.t;
    av[0] = (h0 == c ? 0x3F80u : 0u) | (h0 == c + 1 ? 0x3F800000u : 0u);
    av[1] = (h1 == c ? 0x3F80u : 0u) | (h1 == c + 1 ? 0x3F800000u : 0u);
    av[2] = (h0 == c + 8 ? 0x3F80u : 0u) | (h0 == c + 9 ? 0x3F800000u : 0u);
    av[3] = (h1 == c + 8 ? 0x3F80u : 0u) | (h1 == c + 9 ? 0x3F800000u : 0u);
  }
  __device__ void step(Carry& acc) {
    // (acc[0, 0] 1e-30 + salt 1e-30).astype(int32): truncation, here 0.
    const int shift = __float2int_rz(__fadd_rn(__fmul_rn(*acc00, KEEP),
                                               salt_term));
    const int h0 = idx0 + shift, h1 = idx1 + shift;
    Frag2 ch, cl;
    zero(ch);
    zero(cl);
#pragma unroll 4
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t av[4], b[4];
      onehot_a(av, ks, h0, h1);
      load_b_bf16(b, bh + ks * 16 * ldb + wp.c16, ldb);
      mma_bf16_16816(ch[0], av, b[0], b[1]);
      mma_bf16_16816(ch[1], av, b[2], b[3]);
      load_b_bf16(b, bl + ks * 16 * ldb + wp.c16, ldb);
      mma_bf16_16816(cl[0], av, b[0], b[1]);
      mma_bf16_16816(cl[1], av, b[2], b[3]);
    }
    // This CTA's slice: [BM][hi cols | PAD | lo cols | 2 PAD].
    const int lds = 2 * cols + 3 * PAD;
    bf16* mine = ex.mine();
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        bf16* p = mine + wp.row(q) * lds + wp.col(j, q);
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(ch[j][q], ch[j][q + 1]);
        *reinterpret_cast<uint32_t*>(p + cols + PAD) =
            pack_bf16(cl[j][q], cl[j][q + 1]);
      }
    ex.run();
    // The affine over whole rows: slice s holds columns s cols .. of the
    // hi rows at offset 0 and of the lo rows at cols + PAD.
    const bf16* g = ex.rows();
    Frag2 s1, s2, s3;
    zero(s1);
    zero(s2);
    zero(s3);
    for (int s = 0; s < cs; ++s) {
      const bf16* gs = g + (s * BM + wp.r16) * lds;
      warp_mma2(gs, lds, wsh + s * cols * ldb + wp.c16,
                wsl + s * cols * ldb + wp.c16, ldb, cols / 16, s1, s2);
      warp_mma(gs + cols + PAD, lds, wsh + s * cols * ldb + wp.c16, ldb,
               cols / 16, s3);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float src = __fadd_rn(__fadd_rn(s1[j][q], s2[j][q]), s3[j][q]);
        acc[j][q] = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(acc[j][q], 0.5f), src), ch[j][q]),
            cl[j][q]);
      }
    if (threadIdx.x == 0) *acc00 = acc[0][0];
    __syncthreads();
  }
  __device__ void finish(const Carry& acc) {
    store_out(out, D, row_base, col_base, wp, acc);
    cluster_sync(cs);
  }
};

// ---- repeat: the k-broadcast of the dst rows ------------------------------
// A CTA of two warps owns 2 PER rows and 32 columns; lane l of warp w
// holds PER consecutive rows of column col_base + l, which lie in one dst
// row because PER divides k (the plan's choice). Every thread also carries
// row 0 of its column in a register: JAX's keep-alive term reads the
// global acc[0:1], and row 0's recurrence depends on nothing but itself
// and dst[0], so each thread runs it with the same operations in the same
// order. The loop then reads no memory and has no barrier: per iteration
// a thread runs row 0's five operations, its rows' broadcast value x =
// (dst + keep) + salt once (JAX's body sums on the [tile_n, 128] rows
// before the repeat), and a multiply and an add a row. The empty asm
// keeps each row's carry opaque, so that the compiler cannot merge the
// rows it can prove equal: each row is carried, as in the TPU kernel.
template <int PER>
struct RepeatBody {
  static constexpr int MAX_THREADS = REPEAT_THREADS;
  typedef float Carry[PER];
  static size_t smem_bytes(int, int, int) { return 0; }
  float* out;
  float d, d0, carry0, salt_term;
  __device__ RepeatBody(const LoopArgs& a, unsigned char*) {
    constexpr int slices = D / REPEAT_COLS;
    const int c = (blockIdx.x % slices) * REPEAT_COLS + (threadIdx.x & 31);
    const int row = (blockIdx.x / slices) * a.tile_rows
                    + (threadIdx.x >> 5) * PER;
    const float* dst = static_cast<const float*>(a.in0);
    d0 = dst[c];
    d = dst[(size_t)(row / a.k) * D + c];
    salt_term = __fmul_rn(a.salt[0], KEEP);
    carry0 = 0.f;
    out = a.out + (size_t)row * D + c;
  }
  __device__ void step(Carry& acc) {
    const float keep = __fmul_rn(carry0, KEEP);
    const float x = __fadd_rn(__fadd_rn(d, keep), salt_term);
    carry0 = __fadd_rn(__fmul_rn(carry0, 0.5f),
                       __fadd_rn(__fadd_rn(d0, keep), salt_term));
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      acc[j] = __fadd_rn(__fmul_rn(acc[j], 0.5f), x);
      asm volatile("" : "+f"(acc[j]));
    }
  }
  __device__ void finish(const Carry& acc) {
#pragma unroll
    for (int j = 0; j < PER; ++j) out[(size_t)j * D] = acc[j];
  }
};

// The latency of row 0's dependent sequence on one thread, to price the
// repeat body's chain (chip_smoke.py::mxu_bound): `reps` steps of carry =
// carry 0.5 + ((d0 + carry 1e-30) + salt 1e-30), each waiting on the last
// through the multiply and the three adds. Replaces no TPU kernel; out[0]
// = the carry, RepeatBody's row 0 after `reps` iterations.
__global__ void __launch_bounds__(32)
repeat_chain_kernel(int reps, float d0, float salt, float* __restrict__ out) {
  if (threadIdx.x != 0) return;
  const float salt_term = __fmul_rn(salt, KEEP);
  float carry = 0.f;
  for (int r = 0; r < reps; ++r)
    carry = __fadd_rn(__fmul_rn(carry, 0.5f),
                      __fadd_rn(__fadd_rn(d0, __fmul_rn(carry, KEEP)),
                                salt_term));
  out[0] = carry;
}

template <typename T, int N>
__device__ __forceinline__ void zero_carry(T (&c)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j] = 0.f;
}
__device__ __forceinline__ void zero_carry(Frag2& c) { zero(c); }
__device__ __forceinline__ void zero_carry(float (&c)[2 * tc::PAIRS]) {
#pragma unroll
  for (int i = 0; i < 2 * tc::PAIRS; ++i) c[i] = 0.f;
}

// The loop: the carry in registers, `iters` steps of the body, the output
// written once after the loop (bench_mxu.py::loop_kernel).
template <class Body>
__global__ void __launch_bounds__(Body::MAX_THREADS)
loop_kernel(LoopArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  Body body(args, smem);
  typename Body::Carry acc;
  zero_carry(acc);
  for (int i = 0; i < args.iters; ++i) body.step(acc);
  body.finish(acc);
}

// The launch plan of a call: what the host computed and passes in.
struct Plan {
  int ctas, cluster, tile_rows, cols, threads, smem;
};

template <class Body>
int launch(const LoopArgs& a, const Plan& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      loop_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, loop_kernel<Body>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Each body's split: CTAs a cluster, columns a CTA, rows a CTA (0: chosen
// by the host from the SM count; gather_mm a multiple of BM, repeat 2 PER
// with PER 1, 2, 4 or 8 dividing k).
struct Split {
  int cluster, cols, tile_rows;
};
constexpr Split SPLIT[5] = {{PEAK_N / PeakTcBody::COLS, PeakTcBody::COLS,
                             PeakTcBody::TILE},
                            {1, 32, 0}, {4, 32, BM}, {2, 64, BM},
                            {1, REPEAT_COLS, 0}};

// Rows a thread of the repeat body at `tile_rows` rows a CTA and factor
// k, or 0 if the pair is not one it takes.
int repeat_per(int tile_rows, int k) {
  const int per = tile_rows / (REPEAT_THREADS / 32);
  const bool ok = (per == 1 || per == 2 || per == 4 || per == 8)
                  && tile_rows == per * (REPEAT_THREADS / 32) && k % per == 0;
  return ok ? per : 0;
}

// Recomputes the plan from the shape, the body's split and (gather_mm,
// repeat) the plan's rows a CTA, and compares every field: true if it is
// the plan this entry launches.
bool plan_ok(int body, int rows, int n_pad, int k, const Plan& p) {
  if (body < PEAK || body > REPEAT) return false;
  const Split sp = SPLIT[body];
  if (p.cluster != sp.cluster || p.cols != sp.cols || p.tile_rows <= 0)
    return false;
  const bool rows_ok =
      body == REPEAT ? repeat_per(p.tile_rows, k) && rows % p.tile_rows == 0
      : sp.tile_rows ? p.tile_rows == sp.tile_rows
                     : p.tile_rows % BM == 0;
  if (!rows_ok) return false;
  size_t smem = 0;
  int ctas = 0, threads = 0, max_threads = 0;
  switch (body) {
    case PEAK:
      ctas = rows / PeakTcBody::TILE * p.cluster;
      threads = max_threads = PeakTcBody::MAX_THREADS;
      smem = PeakTcBody::smem_bytes(0, 0, 0);
      break;
    case EDGE_MLP:
    case GATHER_FULL:
      ctas = rows / BM * p.cluster;
      threads = 2 * (p.cols / 16) * 32;
      smem = body == EDGE_MLP ? EdgeMlpBody::smem_bytes(p.cols, 0, 0)
                              : GatherFullBody::smem_bytes(p.cols, 0, n_pad);
      max_threads = body == EDGE_MLP ? EdgeMlpBody::MAX_THREADS
                                     : GatherFullBody::MAX_THREADS;
      break;
    case GATHER_MM:
      ctas = (rows + p.tile_rows - 1) / p.tile_rows * (D / p.cols);
      threads = (p.tile_rows / 16) * (p.cols / 16) * 32;
      smem = GatherMmBody::smem_bytes(p.cols, p.tile_rows, n_pad);
      max_threads = GatherMmBody::MAX_THREADS;
      break;
    default:   // REPEAT
      ctas = rows / p.tile_rows * (D / p.cols);
      threads = max_threads = REPEAT_THREADS;
      smem = RepeatBody<1>::smem_bytes(0, 0, 0);
  }
  return p.ctas == ctas && p.threads == threads && threads <= max_threads
         && (size_t)p.smem == smem && smem <= (size_t)MAX_SMEM;
}

}  // namespace

extern "C" {

// One call of the probe's loop: `iters` iterations of body `body` (0 peak,
// 1 gather_mm, 2 gather_full, 3 edge_mlp, 4 repeat) on the inputs, the
// carry written to out [rows, 512 for peak else 128] fp32.
//   peak:        in0 a [512,512] bf16, in1 w [512,512] bf16 (rows 512);
//   gather_mm:   in0 one-hot [rows, n_pad] bf16, in1 nh, in2 nl
//                [n_pad, 128] bf16;
//   gather_full: in0 idx [rows] int32, in1 nh, in2 nl [n_pad, 128] bf16,
//                in3 ws [128, 128] fp32;
//   edge_mlp:    in0 e [rows, 128] bf16, in1 w [128, 128] fp32;
//   repeat:      in0 dst [rows / k, 128] fp32.
// rows must be a positive multiple of 32, n_pad of 32. The plan (ctas,
// cluster, tile_rows, cols, threads, smem) is ops/mxu_probe.py's
// launch_plan (repeat: tile_rows / 2 rows a thread, dividing k); any
// other is refused before any launch.
int gamd_mxu_loop(int body, const void* in0, const void* in1, const void* in2,
                  const void* in3, const float* salt, int rows, int n_pad,
                  int k, int iters, float* out, int ctas, int cluster,
                  int tile_rows, int cols, int threads, int smem,
                  void* stream) {
  if (rows <= 0 || rows % BM != 0 || iters < 0) return cudaErrorInvalidValue;
  if ((body == GATHER_MM || body == GATHER_FULL)
      && (n_pad <= 0 || n_pad % 32 != 0))
    return cudaErrorInvalidValue;
  if (body == PEAK && rows != PEAK_N) return cudaErrorInvalidValue;
  if (body == REPEAT && (k <= 0 || rows % k != 0))
    return cudaErrorInvalidValue;
  const Plan p{ctas, cluster, tile_rows, cols, threads, smem};
  if (!plan_ok(body, rows, n_pad, k, p)) return cudaErrorInvalidValue;
  const LoopArgs a{in0, in1, in2, in3, salt, rows, n_pad, k, iters, out,
                   cluster, tile_rows, cols};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case PEAK: return launch<PeakTcBody>(a, p, s);
    case GATHER_MM: return launch<GatherMmBody>(a, p, s);
    case GATHER_FULL: return launch<GatherFullBody>(a, p, s);
    case EDGE_MLP: return launch<EdgeMlpBody>(a, p, s);
    case REPEAT:
      switch (repeat_per(p.tile_rows, k)) {
        case 1: return launch<RepeatBody<1>>(a, p, s);
        case 2: return launch<RepeatBody<2>>(a, p, s);
        case 4: return launch<RepeatBody<4>>(a, p, s);
        default: return launch<RepeatBody<8>>(a, p, s);
      }
    default: return cudaErrorInvalidValue;
  }
}

// One launch of repeat_chain_kernel (one thread): `reps` >= 1 steps of
// the repeat body's row 0 from 0 with dst[0] = d0 and salt[0] = salt,
// out[0] the carry.
int gamd_repeat_chain(int reps, float d0, float salt, float* out,
                      void* stream) {
  if (reps < 1) return cudaErrorInvalidValue;
  repeat_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      reps, d0, salt, out);
  return cudaGetLastError();
}

}  // extern "C"
