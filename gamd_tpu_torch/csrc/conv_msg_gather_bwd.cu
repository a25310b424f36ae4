// Backward of one conv layer's edge pipeline (conv_msg_gather.cu) for
// Hopper (sm_90a): given the cotangent g [M, D] of agg, the gradients of
// e, hn, src, dst and of the eight weights and biases.
//
// Replaces gamd_tpu/ops/pallas_mp.py::_conv_msg_gather_bwd_kernel (line 530,
// pallas_call at line 658; wrapper _conv_msg_gather_backward, line 624; the
// VJP at lines 713-724), which reads every width from its refs: here E
// = D, 128 or 256, and H 128, as in the forward
// (conv_msg_gather.cu). Per live edge (i, k) with source j = idx[i, k] it
// recomputes the forward (s1 = e W1 + b1, z1 = silu(s1), z2 = z1 W2 + b2 +
// src[j] + dst[i], a2 = silu(z2), s3 = a2 W3 + b3, z3 = silu(s3), m = z3
// W4 + b4) and sweeps back:
//   g_m = g[i] hn[j];  g_hsrc = g[i] m
//   g_s3 = (g_m W4^T) silu'(s3);  g_z2 = (g_s3 W3^T) silu'(z2)
//   g_s1 = (g_z2 W2^T) silu'(s1); ge = g_s1 W1^T (exactly 0 on masked slots)
//   gdst[i] = sum of g_z2 over the atom's live edges
//   ghn[j], gsrc[j] = sums of g_hsrc, g_z2 over the live edges from j
//   dW1..dW4 = sums over the live edges of e^T g_s1, z1^T g_z2, a2^T g_s3,
//   z3^T g_m; db1..db4 the sums of g_s1, g_z2, g_s3, g_m.
//
// What bounds it on this card: at the training slice (LJ-258, K=96, every
// width 128; about 5,500 live edges of 24,768 slots) the twelve 128 x 128
// products a live edge, as three bf16 passes on the tensor cores, are
// about 6.5 GFLOP, 6.6 us at 989 TFLOP/s, with the epilogues' fp32
// arithmetic about 0.5 us more; the compulsory bytes (e's live rows, ge at
// every slot, the node rows, the weights) are about 17 MB, 5 us at 3.35
// TB/s: operations-bound, at about 7 us.
//
// The design, on conv_tc.cuh's live-edge tiles (the forward's layout, its
// split weights and its partials buffer are handed over by the wrapper, so
// neither is made again):
// 1. dead_rows_kernel writes ge's masked rows as 0, and nothing else.
// 2. conv_bwd_tile_kernel (a persistent grid of one block an SM, each
//    taking tiles b, b + grid, ... of 64 live edges): per tile eight
//    products on the tensor cores, bf16 x 3 with fp32 accumulation
//    (edge_tc.cuh), the split weights streamed by TMA through a two-buffer
//    ring in the order W1, W2, W3, W4, W4, W3, W2, W1. The first four are
//    the forward's products with its epilogues (the same arithmetic on
//    the same inputs); the last four read the same split table MN-major,
//    so that the product is with W^T and no transpose is made.
//    silu'(s1), silu'(z2), silu'(s3) stay in registers from the recompute
//    to the sweep (96 a thread: shared memory holds the weight ring, the
//    activations and the g_z2 tile, 194 KB). Each of the eight activation
//    and gradient tiles (e, z1, a2, z3, g_s1, g_z2, g_s3, g_m), already
//    split into bf16 hi and lo in the tensor cores' swizzled layout, leaves
//    the block by one bulk copy into its compact plane (32 KB a tile, live
//    tiles only). The block writes ge's live rows, g_hsrc's and g_z2's rows
//    at their slots, and sums each atom's g_z2 rows in row order into gdst
//    or the tile's head and tail partials, as the forward sums agg.
// 3. source_sum_kernel: ghn and gsrc, each source node's rows summed in
//    the order of the wrapper's stable sort of the slots by source (its
//    run found by binary search in the sorted sources).
// 4. tile_fixup_kernel (conv_tc.cuh): gdst of the atoms that straddle
//    tiles, and 0 for those with no live edge.
// 5. wgrad_tc_kernel (grid N_RANGE x 4, a block for each range of tiles
//    and weight): act^T grad over the range's tiles on the tensor cores,
//    both operands read MN-major from the compact planes (bf16 x 3), and
//    the bias column sums (hi + lo) in row order.
// 6. wgrad_sum_kernel: the N_RANGE partials of each weight and bias summed
//    in range order.
// Launches 2-6 use programmatic dependent launch. No atomics anywhere: two
// runs give the same bits.
//
// At E or D = 256 every 128 x 128 block of the split table is a product of
// its own (the forward's six blocks at 256 / 128 / 256, so twelve products
// a tile): W1 runs over e's two column blocks into one accumulator and
// W4^T over g_m's two, each staged into the activations in turn; W4 and
// W1^T run a column block at a time with their own epilogues. The
// activation tile and the shared memory stay width 128's; the planes grow
// to e's and g_m's blocks (10), and the weight gradients to six blocks.
//
// Measured against this design on the H100 and dropped (PERF.md row 4):
// the first transcription (a block of one thread a channel on every
// chunk of 16 slots, dead ones included, fp32 FMAs against shared-memory
// tiles, the weight gradients summed on the CUDA cores from 8 fp32 planes
// over every slot), 2.8x slower at B=1; and this design with int32 sort
// keys and the runs' offsets from a search in PyTorch, 15 us slower.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; gamd_conv_msg_gather_bwd returns the first
// non-zero error.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tc.cuh"

namespace {

// N_RANGE and the planes size the host's scratch: gamd_tpu_torch/ops/
// conv_gather.py mirrors them (WGRAD_RANGES, bwd_planes). At e width 128
// EB and message width 128 DB the compact planes of a tile are e's EB
// column blocks, z1, a2, z3, then g_s1, g_z2, g_s3 and g_m's DB column
// blocks (8 at width 128, 10 at 256 / 128 / 256), and the weight blocks
// (split_blocks' order) EB + 2 + DB.
constexpr int N_RANGE = 32;        // tile ranges of the weight-gradient sums
constexpr int KSTEP_BYTES = 16 * 128;   // 16 rows of an MN-major operand
// Dynamic shared memory of a tile block (ops/edge_tiles.py BACKWARD_SMEM):
// two weight buffers, the activations and the fp32 g_z2 tile.
constexpr int BWD_SMEM = 2 * tc::SPLIT_BYTES + 2 * tc::A_BYTES + 1024;
// Of a weight-gradient block: two stages of an activation and a gradient
// tile.
constexpr int WG_SMEM = 2 * 2 * tc::A_BYTES + 1024;
constexpr int DEAD_WARPS = 8;      // slots a dead-row block takes at once

// ---------------------------------------------------------------------------
// MN-major operands
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of an MN-major operand in the 128-byte
// swizzle: a 1024-byte atom is 8 K-rows of 128 bytes (64 M or N values),
// the next 8 K-rows 1024 bytes on. Every operand here is 64 values wide,
// one atom, so the stride between atoms along M or N is never taken; both
// offsets hold the K-group stride.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d += A B for one k-step (m64n64k16, bf16, fp32 accumulation), A MN-major
// if TRANS_A, B MN-major if TRANS_B (K-major otherwise).
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_t(float (&d)[2 * tc::PAIRS],
                                        uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// acc = A W^T (acc += A W^T if not `zero`) for the calling warpgroup's 64
// output columns, bf16 x 3 as tc::product_x3: A the activation buffer
// (K-major), B the split weight's W^T [out][in] read MN-major, K = out
// down its rows: the warpgroup's columns are the half [64 wg, 64 wg + 64)
// of each part, k-step kk its rows 16 kk .. 16 kk + 15.
__device__ __forceinline__ void product_x3_t(float (&acc)[2 * tc::PAIRS],
                                             uint32_t a, uint32_t w, int wg,
                                             bool zero) {
  if (zero) {
#pragma unroll
    for (int i = 0; i < 2 * tc::PAIRS; ++i) acc[i] = 0.f;
  }
  tc::fence_acc(acc);
  tc::wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t a_part = a + (pass == 2 ? tc::A_PART_BYTES : 0);
    const uint32_t w_part =
        w + (pass == 1 ? tc::PART_BYTES : 0) + wg * tc::HALF_BYTES;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_t<0, 1>(acc,
                    tc::desc_sw128(a_part + (kk >> 2) * tc::A_HALF_BYTES +
                                   (kk & 3) * 32),
                    desc_mn(w_part + kk * KSTEP_BYTES));
  }
  tc::wgmma_commit();
  tc::wgmma_wait_all();
  tc::fence_acc(acc);
}

// acc0 += act^T grad and acc1 likewise over one tile's 64 rows, for the
// weight rows [64 h, 64 h + 64) (act's columns; the calling warpgroup's)
// and the weight columns [0, 64) and [64, 128) (grad's), bf16 x 3: act_hi
// grad_hi + act_hi grad_lo + act_lo grad_hi. Both tiles are in the
// activation buffer's layout, read MN-major with the rows as K.
__device__ __forceinline__ void wgrad_x3(float (&acc0)[2 * tc::PAIRS],
                                         float (&acc1)[2 * tc::PAIRS],
                                         uint32_t act, uint32_t grad,
                                         int h) {
  tc::fence_acc(acc0);
  tc::fence_acc(acc1);
  tc::wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t a_part =
        act + (pass == 2 ? tc::A_PART_BYTES : 0) + h * tc::A_HALF_BYTES;
    const uint32_t g_part = grad + (pass == 1 ? tc::A_PART_BYTES : 0);
#pragma unroll
    for (int kk = 0; kk < tc::TILE / 16; ++kk) {
      const uint64_t da = desc_mn(a_part + kk * KSTEP_BYTES);
      wgmma_t<1, 1>(acc0, da, desc_mn(g_part + kk * KSTEP_BYTES));
      wgmma_t<1, 1>(acc1, da, desc_mn(g_part + tc::A_HALF_BYTES +
                                      kk * KSTEP_BYTES));
    }
  }
  tc::wgmma_commit();
  tc::wgmma_wait_all();
  tc::fence_acc(acc0);
  tc::fence_acc(acc1);
}

// One thread: `bytes` of shared memory at `src` into global memory at
// `dst` (a bulk copy, committed as its own group).
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The issuing thread's bulk copies have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The issuing thread's bulk copies are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// 1. The dead rows of ge
// ---------------------------------------------------------------------------

// A warp a slot, grid-stride: ge's row (`width` floats) of every masked
// slot set to 0.
__global__ void __launch_bounds__(32 * DEAD_WARPS)
dead_rows_kernel(const uint8_t* __restrict__ mask, long long slots,
                 float* __restrict__ ge, int width) {
  tc::let_next_start();
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * DEAD_WARPS;
  for (long long s = (long long)blockIdx.x * DEAD_WARPS + (threadIdx.x >> 5);
       s < slots; s += step)
    if (!mask[s])
      for (int c = lane; c < width / 4; c += 32)
        reinterpret_cast<float4*>(ge + s * width)[c] =
            make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---------------------------------------------------------------------------
// 2. The edge tiles
// ---------------------------------------------------------------------------

// Product p's weight block (split_blocks' order: W1's EB row blocks, W2,
// W3, W4's DB column blocks): the NB blocks in order, then W4's blocks
// from the last, W3, W2 and W1's blocks (read as W^T): W1..W4, W4..W1 at
// width 128.
template <int EB, int DB>
__device__ __forceinline__ int bwd_weight(int p) {
  constexpr int NB = EB + 2 + DB;
  const int q = p % (2 * NB);
  if (q < NB) return q;
  const int r = q - NB;
  if (r < DB) return EB + 2 + DB - 1 - r;
  if (r < DB + 2) return EB + 1 - (r - DB);
  return r - DB - 2;
}

// silu(x) as the forward computes it (tc::silu_fast) and silu'(x) =
// sigma(x) (1 + x (1 - sigma(x))).
__device__ __forceinline__ float2 silu_and_grad(float x) {
  const float ex = __expf(-x);
  const float s = __fdividef(1.0f, 1.0f + ex);
  return make_float2(__fdividef(x, 1.0f + ex), s * (1.0f + x * (1.0f - s)));
}

__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

struct BwdArgs {
  TileArgs t;         // layout, e, dst, biases; agg = gdst, part its partials
  const float* g;     // [M, 128] the cotangent of agg
  float* ge;          // [M*K, E]
  float *ghs, *gz2;   // [M*K, D], [M*K, 128]: g_hsrc and g_z2 at the live
                      // slots
  uint8_t* planes;    // [planes][cap_tiles][A_BYTES] compact tiles
  int cap_tiles;      // ceil(M*K / 64)
};

// The tile block's shared memory (BWD_SMEM, 1024-byte aligned): two
// weight buffers, the activation buffer, the fp32 g_z2 tile `red`; and the
// ring of split weights in bwd_weight's order, as tc::WeightRing<2>.
template <int EB, int DB>
struct BwdRing {
  uint32_t w, a_s, bar;
  uint8_t* a;
  float* red;
  int n_products;

  // Barrier setup and the first two weights by thread 0; the caller syncs
  // before waiting on them.
  __device__ __forceinline__ BwdRing(uint8_t* smem, uint64_t* bars,
                                     const CUtensorMap* map, int count)
      : n_products(count) {
    const uint32_t base = tc::smem_addr(smem);
    w = (base + 1023u) & ~1023u;
    a_s = w + 2 * tc::SPLIT_BYTES;
    a = smem + (a_s - base);
    red = reinterpret_cast<float*>(a + tc::A_BYTES);
    bar = tc::smem_addr(bars);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int b = 0; b < 2; ++b) tc::mbar_init(bar + 8 * b, 1);
      tc::mbar_init_fence();
#pragma unroll
      for (int b = 0; b < 2; ++b)
        tc::load_split(w + b * tc::SPLIT_BYTES, map, bar + 8 * b,
                       bwd_weight<EB, DB>(b));
    }
  }

  // Product p of the calling warpgroup once its weight has landed: with W
  // (the forward's) or, if `transposed`, with W^T; added to acc if not
  // `zero`.
  __device__ __forceinline__ void product(float (&acc)[2 * tc::PAIRS], int p,
                                          int wg, bool transposed,
                                          bool zero = true) const {
    tc::mbar_wait(bar + 8 * (p & 1), (p >> 1) & 1);
    const uint32_t wb = w + (p & 1) * tc::SPLIT_BYTES;
    if (transposed)
      product_x3_t(acc, a_s, wb, wg, zero);
    else
      tc::product_x3(acc, a_s, wb, wg, 8, zero);
  }

  // After product p: the copy of the activations out has read them, both
  // warpgroups are done with them and with p's buffer; thread 0 refills
  // the buffer with product p + 2's weight.
  __device__ __forceinline__ void release(const CUtensorMap* map,
                                          int p) const {
    if (threadIdx.x == 0) bulk_wait_read();
    __syncthreads();
    if (threadIdx.x == 0 && p + 2 < n_products)
      tc::load_split(w + (p & 1) * tc::SPLIT_BYTES, map, bar + 8 * (p & 1),
                     bwd_weight<EB, DB>(p + 2));
  }
};

// The activations are written and fenced: thread 0 copies them into
// compact plane `plane` at tile t.
__device__ __forceinline__ void store_plane(const BwdArgs& a, int plane,
                                            int t, uint32_t a_s) {
  if (threadIdx.x == 0)
    bulk_store(a.planes + ((size_t)plane * a.cap_tiles + t) * tc::A_BYTES,
               a_s, tc::A_BYTES);
}

// The persistent backward tile kernel at e width 128 EB and message width
// 128 DB. grid plan.grid (at most one block an SM), block 256 (one tile at
// a time, its columns split between the two warpgroups), BWD_SMEM of
// dynamic shared memory; block b takes tiles b, b + grid, ... of the
// layout's ceil(total / 64). A product over a K wider than 128 (W1 over
// e's column blocks, W4^T over g_m's) stages its blocks into the
// activations in turn and adds them into one accumulator; a product with
// an output wider than 128 (W4, W1^T) runs a column block at a time, each
// with its own epilogue.
template <class Src, int EB, int DB>
__global__ void __launch_bounds__(tc::THREADS, 1)
conv_bwd_tile_kernel(const __grid_constant__ CUtensorMap wmap, BwdArgs a,
                     Src src) {
  constexpr int NP = 2 * (EB + 2 + DB);   // products a tile
  constexpr int EW = EB * CW, DW = DB * CW;
  // The planes (see N_RANGE above): z1, a2, z3 after e's blocks, then the
  // gradients.
  constexpr int Z1 = EB, GS1 = EB + 3, GZ2 = EB + 4, GS3 = EB + 5,
                GM = EB + 6;
  tc::let_next_start();
  tc::grid_wait();
  const TileArgs& ta = a.t;
  const int total = *ta.lay.total;
  const int tiles = (total + tc::TILE - 1) / tc::TILE;
  if ((int)blockIdx.x >= tiles) return;
  const int mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  extern __shared__ uint8_t tile_smem[];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ int atom_s[tc::TILE];     // each row's atom, -1 past total
  __shared__ uint8_t first_s[tc::TILE], last_s[tc::TILE];   // of its atom
  const CUtensorMap* map = &wmap;
  const BwdRing<EB, DB> ring(tile_smem, bars, map, NP * mine);
  float* red = ring.red;
  const tc::Frag f;
  // silu' of s1, z2 and s3 at the thread's fragment, from the recompute to
  // the sweep.
  float d1[2 * tc::PAIRS], d2[2 * tc::PAIRS], d3[2 * tc::PAIRS];
  int p = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * tc::TILE;
    bool live[2];
    int i[2], j[2], sl[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int g = row0 + f.r0 + 8 * s;
      live[s] = g < total;
      sl[s] = ta.lay.slot[live[s] ? g : row0];
      i[s] = sl[s] / ta.k;
      j[s] = src.row(i[s], sl[s]);
    }
    int row_atom = -1, row_off = 0, row_cnt = 0;
    const int g = row0 + threadIdx.x;
    if (threadIdx.x < tc::TILE && g < total) {
      row_atom = ta.lay.slot[g] / ta.k;
      row_off = ta.lay.off[row_atom];
      row_cnt = ta.lay.cnt[row_atom];
    }
    // e's column block eb of the tile's rows into the activations.
    auto stage_e = [&](int eb) {
#pragma unroll
      for (int q = 0; q < tc::PAIRS; ++q) {
        const int s = q & 1;
        const float2 v =
            live[s] ? ld2(ta.e + (size_t)sl[s] * EW + eb * CW + f.col(q))
                    : make_float2(0.f, 0.f);
        tc::store_pair(ring.a, f, q, v.x, v.y);
      }
    };
    stage_e(0);
    if (threadIdx.x < tc::TILE) {
      atom_s[threadIdx.x] = row_atom;
      first_s[threadIdx.x] = row_off == g;
      last_s[threadIdx.x] = row_off + row_cnt == g + 1;
    }
    tc::activations_ready();
    store_plane(a, 0, t, ring.a_s);

    // The products, each followed by its epilogue; an epilogue's tile that
    // a later product reads goes into the activations and out to its
    // plane. release's barrier (after the copy out has read the
    // activations) puts both warpgroups past their reads first.
    float acc[2 * tc::PAIRS];
    auto step = [&](bool transposed, bool zero = true) {
      ring.product(acc, p, f.wg, transposed, zero);
      ring.release(map, p);
      ++p;
    };
    // The tile in the activations is written: make it visible and copy it
    // out to its plane.
    auto ready = [&](int plane) {
      tc::activations_ready();
      store_plane(a, plane, t, ring.a_s);
    };
    // The recompute's hidden layers: s1 (l = 0), z2 (1, + src[j] +
    // dst[i]), s3 (2) from acc, their silu into the activations and
    // silu' into d.
    auto hidden = [&](int l, float (&d)[2 * tc::PAIRS]) {
      const float* bias = l == 0 ? ta.b1 : l == 1 ? ta.b2 : ta.b3;
#pragma unroll
      for (int q = 0; q < tc::PAIRS; ++q) {
        const int s = q & 1, c = f.col(q);
        float2 x = ld2(bias + c);
        x.x += acc[2 * q];
        x.y += acc[2 * q + 1];
        if (l == 1) {
          const float2 sv = ld2(src.src_row(j[s]) + c);
          const float2 dv = ld2(ta.dst + (size_t)i[s] * CW + c);
          x.x += sv.x + dv.x;
          x.y += sv.y + dv.y;
        }
        const float2 u = silu_and_grad(x.x), v = silu_and_grad(x.y);
        d[2 * q] = u.y;
        d[2 * q + 1] = v.y;
        tc::store_pair(ring.a, f, q, u.x, v.x);
      }
      ready(Z1 + l);
    };
    // acc times silu' (a gradient of the sweep) into the activations.
    auto sweep = [&](const float (&d)[2 * tc::PAIRS], int plane,
                     bool keep_red) {
#pragma unroll
      for (int q = 0; q < tc::PAIRS; ++q) {
        const int s = q & 1, c = f.col(q);
        const float2 out = make_float2(acc[2 * q] * d[2 * q],
                                       acc[2 * q + 1] * d[2 * q + 1]);
        if (keep_red) {   // g_z2: also the atom sums' tile and its rows
          *reinterpret_cast<float2*>(red + red_at(f.row(q), c)) = out;
          if (live[s]) st2(a.gz2 + (size_t)sl[s] * CW + c, out.x, out.y);
        }
        tc::store_pair(ring.a, f, q, out.x, out.y);
      }
      ready(plane);
    };

    // The recompute: W1 over e's column blocks, W2, W3.
#pragma unroll
    for (int eb = 0; eb < EB; ++eb) {
      if (eb > 0) {
        stage_e(eb);
        ready(eb);
      }
      step(false, eb == 0);
    }
    hidden(0, d1);
    step(false);
    hidden(1, d2);
    step(false);
    hidden(2, d3);
    // g_m = g[i] hn[j] of column block d into the activations.
    auto stage_gm = [&](int d, int q, float2 gi) {
      const float2 hv = ld2(src.hn_row(j[q & 1]) + d * CW + f.col(q));
      tc::store_pair(ring.a, f, q, gi.x * hv.x, gi.y * hv.y);
    };
    // W4 a column block at a time: m's block d and g_hsrc = g[i] m there;
    // after the last block (z3 read for good) g_m's last block goes into
    // the activations with the same g[i].
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      step(false);
#pragma unroll
      for (int q = 0; q < tc::PAIRS; ++q) {
        const int s = q & 1, c = d * CW + f.col(q);
        float2 x = ld2(ta.b4 + c);
        x.x += acc[2 * q];
        x.y += acc[2 * q + 1];
        float2 gi = make_float2(0.f, 0.f);
        if (live[s]) {
          gi = ld2(a.g + (size_t)i[s] * DW + c);
          st2(a.ghs + (size_t)sl[s] * DW + c, gi.x * x.x, gi.y * x.y);
        }
        if (d == DB - 1) stage_gm(d, q, gi);
      }
    }
    // The sweep: g_m through W4^T a column block at a time, from the last,
    // into one accumulator, then g_s3, g_z2, g_s1.
#pragma unroll
    for (int k = 0; k < DB; ++k) {
      const int d = DB - 1 - k;
      if (k > 0) {
#pragma unroll
        for (int q = 0; q < tc::PAIRS; ++q) {
          float2 gi = make_float2(0.f, 0.f);
          if (live[q & 1])
            gi = ld2(a.g + (size_t)i[q & 1] * DW + d * CW + f.col(q));
          stage_gm(d, q, gi);
        }
      }
      ready(GM + d);
      step(true, k == 0);
    }
    sweep(d3, GS3, false);
    step(true);
    sweep(d2, GZ2, true);
    step(true);
    sweep(d1, GS1, false);
    // ge = g_s1 W1^T, a column block of e at a time.
#pragma unroll
    for (int eb = 0; eb < EB; ++eb) {
      step(true);
#pragma unroll
      for (int q = 0; q < tc::PAIRS; ++q) {
        const int s = q & 1, c = eb * CW + f.col(q);
        if (live[s])
          st2(a.ge + (size_t)sl[s] * EW + c, acc[2 * q], acc[2 * q + 1]);
      }
    }

    // Each atom's g_z2 rows of the tile, summed in row order by the
    // column's thread of the first warpgroup (the forward's sum of agg).
    if (threadIdx.x < CW) {
      const int c = threadIdx.x, rows = min(tc::TILE, total - row0);
      int cur = atom_s[0], start = 0;
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const int at = atom_s[r];
        if (at != cur) {
          emit_run(ta, t, cur, first_s[start], last_s[r - 1], c, s);
          cur = at;
          start = r;
          s = 0.f;
        }
        s += red[red_at(r, c)];
      }
      emit_run(ta, t, cur, first_s[start], last_s[rows - 1], c, s);
    }
    __syncthreads();   // red and the row flags are rewritten by the next tile
  }
  if (threadIdx.x == 0) bulk_wait();
}

// ---------------------------------------------------------------------------
// 3. The sums by source node
// ---------------------------------------------------------------------------

// [q0, q1): the run of keys equal to v in the ascending keys[0, n), n >=
// 1. Two lower bounds (the count of keys below v, below v + 1) found
// together by halving steps, so that their loads overlap.
template <class Key>
__device__ __forceinline__ void key_run(const Key* __restrict__ keys, int n,
                                        int v, int& q0, int& q1) {
  q0 = q1 = 0;
  for (int step = 1 << (31 - __clz(n)); step > 0; step >>= 1) {
    if (q0 + step <= n && (int)keys[q0 + step - 1] < v) q0 += step;
    if (q1 + step <= n && (int)keys[q1 + step - 1] <= v) q1 += step;
  }
}

// grid M, block 128: ghn[j] ([128 DB]) and gsrc[j], the sums of the
// g_hsrc and g_z2 rows of the live edges whose source is node j, in the
// order of `order` over the run of keys equal to j (keys: the n = M*K
// slots' sources, sorted; a masked slot's key is M).
template <class Key, int DB>
__global__ void __launch_bounds__(CW)
source_sum_kernel(const long long* __restrict__ order,
                  const Key* __restrict__ keys, int n,
                  const float* __restrict__ ghs,
                  const float* __restrict__ gz2, float* __restrict__ ghn,
                  float* __restrict__ gsrc) {
  tc::let_next_start();
  tc::grid_wait();
  const int j = blockIdx.x, c = threadIdx.x;
  int q0, q1;
  key_run(keys, n, j, q0, q1);
  float sh[DB] = {}, ss = 0.f;
  for (int q = q0; q < q1; ++q) {
    const size_t r = (size_t)order[q];
#pragma unroll
    for (int d = 0; d < DB; ++d) sh[d] += ghs[(r * DB + d) * CW + c];
    ss += gz2[r * CW + c];
  }
#pragma unroll
  for (int d = 0; d < DB; ++d) ghn[((size_t)j * DB + d) * CW + c] = sh[d];
  gsrc[(size_t)j * CW + c] = ss;
}

// ---------------------------------------------------------------------------
// 5-6. The weight gradients
// ---------------------------------------------------------------------------

// grid (N_RANGE, blocks), block 256, WG_SMEM of dynamic shared memory.
// Block (q, w) takes range q of the live tiles (ceil(tiles / N_RANGE)
// each, in order) and adds, over their rows, act^T grad of weight block w
// (warpgroup h the block's rows [64 h, 64 h + 64)) and the bias sums of
// grad (hi + lo, in row order); partials to wpart [blocks, N_RANGE, 128,
// 128] and bpart [blocks, N_RANGE, 128]. For eb = EB: block w < eb (W1's
// row blocks) is e's block w against g_s1; W2 z1 against g_z2; W3 a2
// against g_s3; W4's block d z3 against g_m's block d (planes w and 4 + w
// at width 128). Tiles stream through two stages by bulk copies.
__global__ void __launch_bounds__(tc::THREADS, 1)
wgrad_tc_kernel(const uint8_t* __restrict__ planes, int cap_tiles,
                const int* __restrict__ total, float* __restrict__ wpart,
                float* __restrict__ bpart, int eb) {
  tc::let_next_start();
  tc::grid_wait();
  const int q = blockIdx.x, w = blockIdx.y;
  const int tiles = (*total + tc::TILE - 1) / tc::TILE;
  const int per = (tiles + N_RANGE - 1) / N_RANGE;
  const int t0 = min(q * per, tiles), t1 = min(t0 + per, tiles);
  extern __shared__ uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t bars[2];
  const uint32_t base = tc::smem_addr(wg_smem);
  const uint32_t buf = (base + 1023u) & ~1023u;
  const uint8_t* buf_g = wg_smem + (buf - base);
  const uint32_t bar = tc::smem_addr(bars);
  const int act_plane = min(w, eb + 2);
  const int grad_plane = w < eb ? eb + 3 : w + 4;
  const uint8_t* act = planes + (size_t)act_plane * cap_tiles * tc::A_BYTES;
  const uint8_t* grad = planes + (size_t)grad_plane * cap_tiles * tc::A_BYTES;
  auto load = [&](int t, int s) {
    const uint32_t dst = buf + s * 2 * tc::A_BYTES;
    tc::mbar_expect(bar + 8 * s, 2 * tc::A_BYTES);
    tc::bulk_load(dst, act + (size_t)t * tc::A_BYTES, tc::A_BYTES,
                  bar + 8 * s);
    tc::bulk_load(dst + tc::A_BYTES, grad + (size_t)t * tc::A_BYTES,
                  tc::A_BYTES, bar + 8 * s);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) tc::mbar_init(bar + 8 * s, 1);
    tc::mbar_init_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s)
      if (t0 + s < t1) load(t0 + s, s);
  }
  __syncthreads();

  float acc0[2 * tc::PAIRS], acc1[2 * tc::PAIRS];
#pragma unroll
  for (int i = 0; i < 2 * tc::PAIRS; ++i) acc0[i] = acc1[i] = 0.f;
  float bsum = 0.f;
  const int h = threadIdx.x >> 7, c = threadIdx.x;
  // Column c's byte offset in a row of the tile layout (its half, its
  // 16-byte chunk before the swizzle, its place in the chunk).
  const int half = (c >> 6) & 1, chunk = (c & 63) >> 3, in_chunk = 2 * (c & 7);
  for (int t = t0, n = 0; t < t1; ++t, ++n) {
    const int s = n & 1;
    tc::mbar_wait(bar + 8 * s, (n >> 1) & 1);
    const uint32_t act_s = buf + s * 2 * tc::A_BYTES;
    wgrad_x3(acc0, acc1, act_s, act_s + tc::A_BYTES, h);
    if (c < CW) {
      const uint8_t* gt = buf_g + s * 2 * tc::A_BYTES + tc::A_BYTES
                          + half * tc::A_HALF_BYTES + in_chunk;
#pragma unroll 8
      for (int r = 0; r < tc::TILE; ++r) {
        const int off = r * 128 + ((chunk ^ (r & 7)) << 4);
        bsum += __bfloat162float(
                    *reinterpret_cast<const __nv_bfloat16*>(gt + off)) +
                __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                    gt + tc::A_PART_BYTES + off));
      }
    }
    tc::proxy_fence();   // the generic reads before the stage is refilled
    __syncthreads();
    if (threadIdx.x == 0 && t + 2 < t1) load(t + 2, s);
  }

  const tc::Frag f;
  float* out = wpart + (size_t)(w * N_RANGE + q) * CW * CW;
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    const int row = 64 * h + f.row(p), col = 8 * (p >> 1) + 2 * f.q;
    st2(out + (size_t)row * CW + col, acc0[2 * p], acc0[2 * p + 1]);
    st2(out + (size_t)row * CW + 64 + col, acc1[2 * p], acc1[2 * p + 1]);
  }
  if (c < CW) bpart[(size_t)(w * N_RANGE + q) * CW + c] = bsum;
}

// grid (blocks, 129), block 128: gw[t][a][c] = sum over ranges q in order
// of wpart[t][q][a][c]; the last row of the grid does the biases into
// gb[t].
__global__ void __launch_bounds__(CW)
wgrad_sum_kernel(const float* __restrict__ wpart,
                 const float* __restrict__ bpart, float* __restrict__ gw,
                 float* __restrict__ gb) {
  tc::let_next_start();
  tc::grid_wait();
  const int t = blockIdx.x, a = blockIdx.y, c = threadIdx.x;
  float s = 0.f;
  if (a < CW) {
    for (int q = 0; q < N_RANGE; ++q)
      s += wpart[((size_t)(t * N_RANGE + q) * CW + a) * CW + c];
    gw[((size_t)t * CW + a) * CW + c] = s;
  } else {
    for (int q = 0; q < N_RANGE; ++q)
      s += bpart[(size_t)(t * N_RANGE + q) * CW + c];
    gb[(size_t)t * CW + c] = s;
  }
}

// Dynamic shared memory above 48 KB for the two tensor-core kernels, once
// per process and widths.
template <int EB, int DB>
cudaError_t configure_backward() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaFuncAttribute max_smem =
      cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(
           conv_bwd_tile_kernel<GatherSrc<DB * CW>, EB, DB>, max_smem,
           BWD_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(wgrad_tc_kernel, max_smem, WG_SMEM)) !=
          cudaSuccess)
    return err;
  done = true;
  return cudaSuccess;
}

// Pointers and sizes of a backward call, as the C entry takes them.
struct BwdCall {
  const float *g, *e;
  const int* idx;
  const uint8_t* mask;
  const float *hn, *src, *dst, *b1, *b2, *b3, *b4;
  int m, k;
  const SlotLayout* lay;
  void* wsplit;
  float* part;
  const long long* order;
  const void* keys;
  int key_bytes;
  void* planes;
  float *rows, *wpart, *bpart;
  int grid;
  float *ge, *ghn, *gsrc, *gdst, *gw, *gb;
  cudaStream_t s;
};

// Launches 1-6 at e width 128 EB and message width 128 DB.
template <int EB, int DB>
int backward_at(const BwdCall& c) {
  constexpr int BLOCKS = EB + 2 + DB;
  cudaError_t err = configure_backward<EB, DB>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = (long long)c.m * c.k;
  const long long cap = tc::tile_capacity(c.m, c.k);
  const long long dead_blocks = (slots + DEAD_WARPS - 1) / DEAD_WARPS;
  const int dead_grid = static_cast<int>(
      dead_blocks < 8LL * tc::sm_count() ? dead_blocks
                                         : 8LL * tc::sm_count());
  dead_rows_kernel<<<dead_grid, 32 * DEAD_WARPS, 0, c.s>>>(c.mask, slots,
                                                          c.ge, EB * CW);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  const int map_err = tc::encode_split_map(c.wsplit, BLOCKS, &map);
  if (map_err != 0) return map_err;
  float* ghs = c.rows;
  float* gz2 = c.rows + slots * DB * CW;
  const BwdArgs a{TileArgs{*c.lay, c.e, c.dst, c.b1, c.b2, c.b3, c.b4, c.gdst,
                           c.part, c.k},
                  c.g, c.ge, ghs, gz2, static_cast<uint8_t*>(c.planes),
                  static_cast<int>(cap)};
  if ((err = launch_pdl(conv_bwd_tile_kernel<GatherSrc<DB * CW>, EB, DB>,
                        dim3(c.grid), dim3(tc::THREADS), BWD_SMEM, c.s, map,
                        a, GatherSrc<DB * CW>{c.idx, c.hn, c.src})) !=
          cudaSuccess ||
      (err = c.key_bytes == 2
                 ? launch_pdl(source_sum_kernel<short, DB>, dim3(c.m),
                              dim3(CW), 0, c.s, c.order,
                              static_cast<const short*>(c.keys),
                              static_cast<int>(slots),
                              static_cast<const float*>(ghs),
                              static_cast<const float*>(gz2), c.ghn, c.gsrc)
                 : launch_pdl(source_sum_kernel<int, DB>, dim3(c.m),
                              dim3(CW), 0, c.s, c.order,
                              static_cast<const int*>(c.keys),
                              static_cast<int>(slots),
                              static_cast<const float*>(ghs),
                              static_cast<const float*>(gz2), c.ghn,
                              c.gsrc)) != cudaSuccess ||
      (err = launch_pdl(tile_fixup_kernel,
                        dim3((c.m + FIX_ATOMS - 1) / FIX_ATOMS),
                        dim3(32 * FIX_ATOMS), 0, c.s, *c.lay,
                        static_cast<const float*>(c.part), c.m, c.gdst,
                        CW)) != cudaSuccess ||
      (err = launch_pdl(wgrad_tc_kernel, dim3(N_RANGE, BLOCKS),
                        dim3(tc::THREADS), WG_SMEM, c.s,
                        static_cast<const uint8_t*>(c.planes),
                        static_cast<int>(cap),
                        static_cast<const int*>(c.lay->total), c.wpart,
                        c.bpart, EB)) != cudaSuccess ||
      (err = launch_pdl(wgrad_sum_kernel, dim3(BLOCKS, CW + 1), dim3(CW), 0,
                        c.s, static_cast<const float*>(c.wpart),
                        static_cast<const float*>(c.bpart), c.gw, c.gb)) !=
          cudaSuccess)
    return static_cast<int>(err);
  return 0;
}

}  // namespace

// Gradients of agg = conv_msg_gather(...) for the cotangent g [M, D]: ge
// [M*K, E], ghn [M, D], gsrc/gdst [M, 128], gw [blocks, 128, 128] and gb
// [blocks, 128] in split_blocks' order (W1's E/128 row blocks, W2, W3,
// W4's D/128 column blocks; the bias sums of W1's blocks are b1's, of W4's
// blocks b4's columns), E = D, 128 or 256. lay, wsplit and part are
// the forward call's layout, split weights and partials buffer
// (ops/edge_tiles.py::call_scratch), the first two as the forward left
// them. order [M*K] (int64) and keys [M*K] (int16 or int32, key_bytes 2 or
// 4) list the slots stably sorted by source, M for a masked one
// (ops/conv_gather.py::source_order). Scratch: planes [E/128 + D/128 + 6,
// ceil(M*K / 64), 32 KB], rows (g_hsrc [M*K, D] then g_z2 [M*K, 128]),
// wpart [blocks, N_RANGE, 128, 128], bpart [blocks, N_RANGE, 128]. The
// plan is ops/edge_tiles.py::backward_plan's. Returns 0, a cudaError_t
// (cudaErrorInvalidValue for a shape, width or plan it does not take), or
// 100000 + the CUresult of the TMA map's encoding.
extern "C" int gamd_conv_msg_gather_bwd(
    const float* g, const float* e, const int* idx, const uint8_t* mask,
    const float* hn, const float* src, const float* dst, const float* b1,
    const float* b2, const float* b3, const float* b4, int m, int k,
    int e_width, int d_width, const SlotLayout* lay, void* wsplit,
    float* part, const long long* order, const void* keys, int key_bytes,
    void* planes, float* rows, float* wpart, float* bpart, int grid,
    int threads, int smem, float* ge, float* ghn, float* gsrc, float* gdst,
    float* gw, float* gb, void* stream) {
  if (m <= 0 || k <= 0 || (long long)m * k >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (e_width != d_width || (d_width != CW && d_width != 2 * CW))
    return cudaErrorInvalidValue;
  const long long cap = tc::tile_capacity(m, k);
  const long long most = cap < tc::sm_count() ? cap : tc::sm_count();
  if (threads != tc::THREADS || smem != BWD_SMEM || grid < 1 || grid > most
      || (key_bytes != 2 && key_bytes != 4))
    return cudaErrorInvalidValue;
  const BwdCall c{g,      e,     idx,    mask,   hn,    src,  dst,
                  b1,     b2,    b3,     b4,     m,     k,    lay,
                  wsplit, part,  order,  keys,   key_bytes,   planes,
                  rows,   wpart, bpart,  grid,   ge,    ghn,  gsrc,
                  gdst,   gw,    gb,     static_cast<cudaStream_t>(stream)};
  return d_width == CW ? backward_at<1, 1>(c) : backward_at<2, 2>(c);
}
