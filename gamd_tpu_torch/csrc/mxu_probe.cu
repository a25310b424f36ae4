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
//   * PeakBody (peak_body :150): four chained bf16 [512,512]@[512,512]
//     products, fp32 accumulation, each result rounded to bf16, then
//     acc*0.5 + x;
//   * GatherMmBody (gmm_body :185): a prebuilt bf16 one-hot [rows, n_pad]
//     times the hi and lo node tables [n_pad, 128];
//   * GatherFullBody (gfull_body :215): the one-hot built from idx by
//     compare every iteration, the two gathers, and three affine products
//     of the gathered hi/lo rows with the bf16 hi/lo split of ws;
//   * EdgeMlpBody (emlp_body :247): four [rows,128]@[128,128] bf16
//     products with silu;
//   * RepeatBody (rep_body :264): the k-broadcast of [tile_n,128] rows to
//     [tile_n k, 128] (no product).
// Every product is mma.sync (mma.cuh): bf16 m16n8k16 with fp32
// accumulation, fragments from shared memory by ldmatrix.
//
// The carry. JAX's keep-alive terms read the global acc[0:1, :] (or
// acc[0, 0]); blocks here share nothing, so each block reads its own
// tile's first row (or its acc[0, 0]) from shared memory. The terms are
// numerically void in both (a + bf16(acc 1e-30) is a for a nonzero bf16 a;
// (int)(acc 1e-30) is 0), so the output equals JAX's loop, but the
// compiler cannot know it: the next iteration's inputs depend on the
// carry, and no iteration can be hoisted or dropped. tools/bench_mxu.py's
// calibration (per-iteration time at iters and iters/4, and the peak
// stage's rate against the card's 989 TFLOP/s) catches a collapse.
// Weight conversions that do not depend on the carry (bf16(w) of the edge
// MLP, the hi/lo split of ws) are made once before the loop, as a
// compiler hoists them; the products, gathers and one-hot builds run
// every iteration.
//
// What bounds it on this card: the products at the dense bf16 rate (989
// TFLOP/s; 1.074 GFLOP an iteration for peak, 151 M for gather_mm, 226.5 M
// for gather_full, 100.7 M for edge_mlp), repeat by its 393 KB of output.
// The design is the simple one: a block owns 32 rows of the output (16
// blocks for peak, 24 for gather_mm at 768 rows), 8 warps of 16 rows x a
// quarter of the columns, B staged through shared memory 32 rows at a
// time, no double buffering. At these shapes it keeps at most 24 of the
// 132 SMs busy, each waiting on its staging loads: on an H100 SXM at 700 W
// the stages run at 0.6-1.7% of their bounds (peak 11.9 TFLOP/s, where
// cuBLAS takes the same chain at 74; gather_mm costs 27.7 us an iteration
// at 768 rows and 29.1 at 8 x 768; tools/bench_mxu.py, chip_smoke.py).
// wgmma, TMA and a split of the columns over more blocks are a later step.
//
// Sums that the bit-for-bit comparison with the plain version relies on
// (gather_mm, repeat) use __fadd_rn/__fmul_rn, so no FMA contraction
// changes them. The host allocates the output with torch.empty and
// launches on PyTorch's current stream; the entry returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it does not
// take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 32;             // output rows per block
constexpr int THREADS = 256;       // 8 warps: 2 row groups x 4 column groups
constexpr int KC = 32;             // rows of B staged at a time
constexpr int D = 128;             // width of every stage but peak
constexpr int PEAK_N = 512;        // the peak chain's [512, 512]
constexpr int PAD = 8;             // bf16 elements of row padding (16 bytes)
constexpr int MAX_SMEM = 232448;   // a block's shared memory on Hopper
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
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float silu_f32(float x) {
  return x * (1.0f / (1.0f + expf(-x)));
}

// Warp `warp` of the block: rows 16 (warp / 4) .. +16 of the block's tile.
__device__ __forceinline__ int warp_row() { return 16 * (threadIdx.x >> 7); }

// c[NT][4] += A (16 rows x 16 ksteps, row-major, ld `lda` elements) @ B
// (16 ksteps rows x 8 NT columns of a row-major [K][ldb] tile).
template <int NT>
__device__ __forceinline__ void warp_mma(const bf16* a_tile, int lda,
                                         const bf16* b_tile, int ldb,
                                         int ksteps, float (&c)[NT][4]) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[4];
    load_a(a, a_tile + ks * 16, lda * 2);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t b[4];
      load_b_bf16(b, b_tile + ks * 16 * ldb + j * 16, ldb);
      mma_bf16_16816(c[2 * j], a, b[0], b[1]);
      mma_bf16_16816(c[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// The same A against two B tiles at once (the hi and lo tables).
template <int NT>
__device__ __forceinline__ void warp_mma2(const bf16* a_tile, int lda,
                                          const bf16* b1, const bf16* b2,
                                          int ldb, int ksteps,
                                          float (&c1)[NT][4],
                                          float (&c2)[NT][4]) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[4];
    load_a(a, a_tile + ks * 16, lda * 2);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t b[4];
      load_b_bf16(b, b1 + ks * 16 * ldb + j * 16, ldb);
      mma_bf16_16816(c1[2 * j], a, b[0], b[1]);
      mma_bf16_16816(c1[2 * j + 1], a, b[2], b[3]);
      load_b_bf16(b, b2 + ks * 16 * ldb + j * 16, ldb);
      mma_bf16_16816(c2[2 * j], a, b[0], b[1]);
      mma_bf16_16816(c2[2 * j + 1], a, b[2], b[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j][q] = 0.f;
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j] = 0.f;
}

// The (row, col) in the block's tile of fragment element q of n8 tile j of
// the calling thread, for a warp whose columns start at n0.
__device__ __forceinline__ int frag_row(int q) {
  return warp_row() + ((threadIdx.x & 31) >> 2) + 8 * (q >> 1);
}
__device__ __forceinline__ int frag_col(int n0, int j, int q) {
  return n0 + 8 * j + 2 * (threadIdx.x & 3) + (q & 1);
}

// Writes the fragments as bf16 into a [BM][ld] shared tile.
template <int NT, typename F>
__device__ __forceinline__ void store_bf16(bf16* tile, int ld, int n0,
                                           const float (&c)[NT][4], F f) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * h;
      *reinterpret_cast<uint32_t*>(tile + frag_row(q) * ld
                                   + frag_col(n0, j, q)) =
          pack_bf16(f(c[j][q]), f(c[j][q + 1]));
    }
}

// The carry's row 0 (block row 0) into row0[]: held by the lanes g = 0 of
// the warps of row group 0.
template <int NT>
__device__ __forceinline__ void save_row0(float* row0, int n0,
                                          const float (&acc)[NT][4]) {
  if (threadIdx.x < 128 && (threadIdx.x & 31) < 4) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      row0[frag_col(n0, j, 0)] = acc[j][0];
      row0[frag_col(n0, j, 1)] = acc[j][1];
    }
  }
}

template <int NT>
__device__ __forceinline__ void store_out(float* out, int width, int row0,
                                          int n0, const float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; q += 2)
      *reinterpret_cast<float2*>(out + (size_t)(row0 + frag_row(q)) * width
                                 + frag_col(n0, j, q)) =
          make_float2(acc[j][q], acc[j][q + 1]);
}

// Copies `rows` rows of `width` bf16 from global (row stride `gld`) into a
// shared tile (row stride `sld`), 16 bytes a thread.
__device__ __forceinline__ void copy_rows(bf16* dst, int sld, const bf16* src,
                                          int gld, int rows, int width) {
  const int per_row = width / 8;
  for (int v = threadIdx.x; v < rows * per_row; v += THREADS) {
    const int r = v / per_row, c = 8 * (v % per_row);
    *reinterpret_cast<uint4*>(dst + r * sld + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * gld + c);
  }
}

// bf16(bf16(acc0 * 1e-30) + bf16(salt * 1e-30)) for each column: the
// keep-alive term of peak_body and gmm_body.
__device__ __forceinline__ void keep_terms(float* keep, const float* row0,
                                           int width, float salt0) {
  const float s = bf16r(salt0 * KEEP);
  for (int c = threadIdx.x; c < width; c += THREADS)
    keep[c] = bf16r(bf16r(row0[c] * KEEP) + s);
}

// ---- peak: four chained bf16 [512,512] products ---------------------------
struct PeakBody {
  static constexpr int NT = 16;    // a warp's 128 columns
  static constexpr int LD = PEAK_N + PAD;
  typedef float Carry[NT][4];
  static size_t smem_bytes(const LoopArgs&) {
    return 2 * (size_t)BM * LD * sizeof(bf16) + 2 * PEAK_N * sizeof(float);
  }
  bf16* x;   // [BM][LD] the chain's operand
  bf16* w;   // [KC][LD] staged rows of w
  float* row0;
  float* keep;
  const LoopArgs a;
  int n0;
  float salt0;
  __device__ PeakBody(const LoopArgs& args, unsigned char* smem) : a(args) {
    x = reinterpret_cast<bf16*>(smem);
    w = x + BM * LD;
    row0 = reinterpret_cast<float*>(w + KC * LD);
    keep = row0 + PEAK_N;
    n0 = 128 * ((threadIdx.x >> 5) & 3);
    salt0 = a.salt[0];
    for (int c = threadIdx.x; c < PEAK_N; c += THREADS) row0[c] = 0.f;
    __syncthreads();
  }
  __device__ void step(Carry& acc) {
    const bf16* ga = static_cast<const bf16*>(a.in0)
                     + (size_t)blockIdx.x * BM * PEAK_N;
    const bf16* gw = static_cast<const bf16*>(a.in1);
    keep_terms(keep, row0, PEAK_N, salt0);
    __syncthreads();
    for (int v = threadIdx.x; v < BM * PEAK_N; v += THREADS) {
      const int r = v / PEAK_N, c = v % PEAK_N;
      x[r * LD + c] = __float2bfloat16_rn(
          __bfloat162float(ga[(size_t)r * PEAK_N + c]) + keep[c]);
    }
    __syncthreads();
    for (int p = 0; p < 4; ++p) {
      float c[NT][4];
      zero(c);
      for (int k0 = 0; k0 < PEAK_N; k0 += KC) {
        copy_rows(w, LD, gw + (size_t)k0 * PEAK_N, PEAK_N, KC, PEAK_N);
        __syncthreads();
        warp_mma<NT>(x + warp_row() * LD + k0, LD, w + n0, LD, KC / 16, c);
        __syncthreads();
      }
      if (p < 3) {
        store_bf16(x, LD, n0, c, [](float v) { return v; });
        __syncthreads();
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[j][q] = __fadd_rn(__fmul_rn(acc[j][q], 0.5f), bf16r(c[j][q]));
      }
    }
    save_row0(row0, n0, acc);
    __syncthreads();
  }
  __device__ void store(const Carry& acc) {
    store_out(a.out, PEAK_N, blockIdx.x * BM, n0, acc);
  }
};

// ---- gather_mm: prebuilt one-hot x hi/lo node tables ----------------------
struct GatherMmBody {
  static constexpr int NT = 4;     // a warp's 32 columns
  static constexpr int LDB = D + PAD;
  typedef float Carry[NT][4];
  static size_t smem_bytes(const LoopArgs& a) {
    return ((size_t)BM * (a.n_pad + PAD) + 2 * KC * LDB) * sizeof(bf16)
           + 2 * D * sizeof(float);
  }
  bf16* oh;   // [BM][n_pad + PAD], loaded once
  bf16* bh;   // [KC][LDB] staged nh + keep
  bf16* bl;   // [KC][LDB] staged nl
  float* row0;
  float* keep;
  const LoopArgs a;
  int n0, ldo;
  float salt0;
  __device__ GatherMmBody(const LoopArgs& args, unsigned char* smem)
      : a(args) {
    ldo = a.n_pad + PAD;
    oh = reinterpret_cast<bf16*>(smem);
    bh = oh + BM * ldo;
    bl = bh + KC * LDB;
    row0 = reinterpret_cast<float*>(bl + KC * LDB);
    keep = row0 + D;
    n0 = 32 * ((threadIdx.x >> 5) & 3);
    salt0 = a.salt[0];
    copy_rows(oh, ldo, static_cast<const bf16*>(a.in0)
                           + (size_t)blockIdx.x * BM * a.n_pad,
              a.n_pad, BM, a.n_pad);
    for (int c = threadIdx.x; c < D; c += THREADS) row0[c] = 0.f;
    __syncthreads();
  }
  __device__ void step(Carry& acc) {
    const bf16* nh = static_cast<const bf16*>(a.in1);
    const bf16* nl = static_cast<const bf16*>(a.in2);
    keep_terms(keep, row0, D, salt0);
    __syncthreads();
    float ch[NT][4], cl[NT][4];
    zero(ch);
    zero(cl);
    for (int k0 = 0; k0 < a.n_pad; k0 += KC) {
      for (int v = threadIdx.x; v < KC * D; v += THREADS) {
        const int r = v / D, c = v % D;
        const size_t g = (size_t)(k0 + r) * D + c;
        bh[r * LDB + c] = __float2bfloat16_rn(__bfloat162float(nh[g])
                                              + keep[c]);
        bl[r * LDB + c] = nl[g];
      }
      __syncthreads();
      warp_mma2<NT>(oh + warp_row() * ldo + k0, ldo, bh + n0, bl + n0, LDB,
                    KC / 16, ch, cl);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[j][q] = __fadd_rn(__fadd_rn(__fmul_rn(acc[j][q], 0.5f), ch[j][q]),
                              cl[j][q]);
    save_row0(row0, n0, acc);
    __syncthreads();
  }
  __device__ void store(const Carry& acc) {
    store_out(a.out, D, blockIdx.x * BM, n0, acc);
  }
};

// ---- gather_full: compare one-hot + gathers + hi/lo source affine --------
struct GatherFullBody {
  static constexpr int NT = 4;
  static constexpr int LDB = D + PAD;
  typedef float Carry[NT][4];
  static size_t smem_bytes(const LoopArgs& a) {
    return ((size_t)BM * (a.n_pad + PAD) + 2 * KC * LDB + 2 * BM * LDB
            + 2 * D * LDB) * sizeof(bf16)
           + BM * sizeof(int) + 16;
  }
  bf16* oh;    // [BM][n_pad + PAD], rebuilt every iteration
  bf16* bh;    // [KC][LDB] staged nh
  bf16* bl;    // [KC][LDB] staged nl
  bf16* gh;    // [BM][LDB] gathered hi rows (bf16 exactly)
  bf16* gl;    // [BM][LDB] gathered lo rows
  bf16* wsh;   // [D][LDB] bf16(ws), made once
  bf16* wsl;   // [D][LDB] bf16(ws - bf16(ws))
  int* idx;    // [BM] the block's indices
  float* acc00;
  const LoopArgs a;
  int n0, ldo;
  float salt0;
  __device__ GatherFullBody(const LoopArgs& args, unsigned char* smem)
      : a(args) {
    ldo = a.n_pad + PAD;
    oh = reinterpret_cast<bf16*>(smem);
    bh = oh + BM * ldo;
    bl = bh + KC * LDB;
    gh = bl + KC * LDB;
    gl = gh + BM * LDB;
    wsh = gl + BM * LDB;
    wsl = wsh + D * LDB;
    idx = reinterpret_cast<int*>(wsl + D * LDB);
    acc00 = reinterpret_cast<float*>(idx + BM);
    n0 = 32 * ((threadIdx.x >> 5) & 3);
    salt0 = a.salt[0];
    const float* ws = static_cast<const float*>(a.in3);
    for (int v = threadIdx.x; v < D * D; v += THREADS) {
      const int r = v / D, c = v % D;
      const bf16 hi = __float2bfloat16_rn(ws[v]);
      wsh[r * LDB + c] = hi;
      wsl[r * LDB + c] = __float2bfloat16_rn(ws[v] - __bfloat162float(hi));
    }
    const int* gidx = static_cast<const int*>(a.in0);
    for (int r = threadIdx.x; r < BM; r += THREADS)
      idx[r] = gidx[blockIdx.x * BM + r];
    if (threadIdx.x == 0) *acc00 = 0.f;
    __syncthreads();
  }
  __device__ void step(Carry& acc) {
    const bf16* nh = static_cast<const bf16*>(a.in1);
    const bf16* nl = static_cast<const bf16*>(a.in2);
    // (acc[0, 0] 1e-30 + salt 1e-30).astype(int32): truncation, here 0.
    const int shift = __float2int_rz(__fadd_rn(__fmul_rn(*acc00, KEEP),
                                               __fmul_rn(salt0, KEEP)));
    const bf16 one = __float2bfloat16_rn(1.f), nil = __float2bfloat16_rn(0.f);
    for (int v = threadIdx.x; v < BM * a.n_pad; v += THREADS) {
      const int r = v / a.n_pad, c = v % a.n_pad;
      oh[r * ldo + c] = (c == idx[r] + shift) ? one : nil;
    }
    float ch[NT][4], cl[NT][4];
    zero(ch);
    zero(cl);
    for (int k0 = 0; k0 < a.n_pad; k0 += KC) {
      copy_rows(bh, LDB, nh + (size_t)k0 * D, D, KC, D);
      copy_rows(bl, LDB, nl + (size_t)k0 * D, D, KC, D);
      __syncthreads();
      warp_mma2<NT>(oh + warp_row() * ldo + k0, ldo, bh + n0, bl + n0, LDB,
                    KC / 16, ch, cl);
      __syncthreads();
    }
    store_bf16(gh, LDB, n0, ch, [](float v) { return v; });
    store_bf16(gl, LDB, n0, cl, [](float v) { return v; });
    __syncthreads();
    float s1[NT][4], s2[NT][4], s3[NT][4];
    zero(s1);
    zero(s2);
    zero(s3);
    warp_mma2<NT>(gh + warp_row() * LDB, LDB, wsh + n0, wsl + n0, LDB,
                  D / 16, s1, s2);
    warp_mma<NT>(gl + warp_row() * LDB, LDB, wsh + n0, LDB, D / 16, s3);
#pragma unroll
    for (int j = 0; j < NT; ++j)
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
  __device__ void store(const Carry& acc) {
    store_out(a.out, D, blockIdx.x * BM, n0, acc);
  }
};

// ---- edge_mlp: four 128-wide bf16 products with silu ----------------------
struct EdgeMlpBody {
  static constexpr int NT = 4;
  static constexpr int LDB = D + PAD;
  typedef float Carry[NT][4];
  static size_t smem_bytes(const LoopArgs&) {
    return ((size_t)BM * LDB + D * LDB) * sizeof(bf16) + D * sizeof(float);
  }
  bf16* x;   // [BM][LDB] the chain's operand
  bf16* w;   // [D][LDB] bf16(w), made once
  float* row0;
  const LoopArgs a;
  int n0;
  float salt0;
  __device__ EdgeMlpBody(const LoopArgs& args, unsigned char* smem)
      : a(args) {
    x = reinterpret_cast<bf16*>(smem);
    w = x + BM * LDB;
    row0 = reinterpret_cast<float*>(w + D * LDB);
    n0 = 32 * ((threadIdx.x >> 5) & 3);
    salt0 = a.salt[0];
    const float* gw = static_cast<const float*>(a.in1);
    for (int v = threadIdx.x; v < D * D; v += THREADS)
      w[(v / D) * LDB + v % D] = __float2bfloat16_rn(gw[v]);
    for (int c = threadIdx.x; c < D; c += THREADS) row0[c] = 0.f;
    __syncthreads();
  }
  __device__ void step(Carry& acc) {
    const bf16* e = static_cast<const bf16*>(a.in0)
                    + (size_t)blockIdx.x * BM * D;
    const float s = __fmul_rn(salt0, KEEP);
    for (int v = threadIdx.x; v < BM * D; v += THREADS) {
      const int r = v / D, c = v % D;
      x[r * LDB + c] = __float2bfloat16_rn(__fadd_rn(
          __fadd_rn(__bfloat162float(e[v]), __fmul_rn(row0[c], KEEP)), s));
    }
    __syncthreads();
    for (int p = 0; p < 4; ++p) {
      float z[NT][4];
      zero(z);
      warp_mma<NT>(x + warp_row() * LDB, LDB, w + n0, LDB, D / 16, z);
      __syncthreads();
      if (p < 3) {
        store_bf16(x, LDB, n0, z, silu_f32);
        __syncthreads();
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[j][q] = __fadd_rn(__fmul_rn(acc[j][q], 0.5f), z[j][q]);
      }
    }
    save_row0(row0, n0, acc);
    __syncthreads();
  }
  __device__ void store(const Carry& acc) {
    store_out(a.out, D, blockIdx.x * BM, n0, acc);
  }
};

// ---- repeat: the k-broadcast of the dst rows ------------------------------
struct RepeatBody {
  static constexpr int PER = BM * D / THREADS;   // 16 elements a thread
  typedef float Carry[PER];
  static size_t smem_bytes(const LoopArgs&) { return D * sizeof(float); }
  float* row0;
  const LoopArgs a;
  int c, r0;
  float salt0;
  __device__ RepeatBody(const LoopArgs& args, unsigned char* smem)
      : a(args) {
    row0 = reinterpret_cast<float*>(smem);
    c = threadIdx.x % D;
    r0 = threadIdx.x / D;
    salt0 = a.salt[0];
    if (threadIdx.x < D) row0[threadIdx.x] = 0.f;
    __syncthreads();
  }
  __device__ void step(Carry& acc) {
    const float* dst = static_cast<const float*>(a.in0);
    const float keep = __fmul_rn(row0[c], KEEP), s = __fmul_rn(salt0, KEEP);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int row = blockIdx.x * BM + r0 + 2 * j;
      const float x = __fadd_rn(__fadd_rn(dst[(row / a.k) * D + c], keep), s);
      acc[j] = __fadd_rn(__fmul_rn(acc[j], 0.5f), x);
    }
    __syncthreads();
    if (r0 == 0) row0[c] = acc[0];
    __syncthreads();
  }
  __device__ void store(const Carry& acc) {
#pragma unroll
    for (int j = 0; j < PER; ++j)
      a.out[(size_t)(blockIdx.x * BM + r0 + 2 * j) * D + c] = acc[j];
  }
};

// The loop: the carry in registers, `iters` steps of the body, the output
// written once after the loop (bench_mxu.py::loop_kernel).
template <class Body>
__global__ void __launch_bounds__(THREADS) loop_kernel(LoopArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  Body body(args, smem);
  typename Body::Carry acc;
  zero(acc);
  for (int i = 0; i < args.iters; ++i) body.step(acc);
  body.store(acc);
}

template <class Body>
int launch(const LoopArgs& a, cudaStream_t stream) {
  const size_t smem = Body::smem_bytes(a);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      loop_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  loop_kernel<Body><<<a.rows / BM, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
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
// rows must be a positive multiple of 32, n_pad of 32.
int gamd_mxu_loop(int body, const void* in0, const void* in1, const void* in2,
                  const void* in3, const float* salt, int rows, int n_pad,
                  int k, int iters, float* out, void* stream) {
  if (rows <= 0 || rows % BM != 0 || iters < 0) return cudaErrorInvalidValue;
  const LoopArgs a{in0, in1, in2, in3, salt, rows, n_pad, k, iters, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case PEAK:
      if (rows != PEAK_N) return cudaErrorInvalidValue;
      return launch<PeakBody>(a, s);
    case GATHER_MM:
    case GATHER_FULL:
      if (n_pad <= 0 || n_pad % KC != 0) return cudaErrorInvalidValue;
      return body == GATHER_MM ? launch<GatherMmBody>(a, s)
                               : launch<GatherFullBody>(a, s);
    case EDGE_MLP:
      return launch<EdgeMlpBody>(a, s);
    case REPEAT:
      if (k <= 0 || rows % k != 0) return cudaErrorInvalidValue;
      return launch<RepeatBody>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
