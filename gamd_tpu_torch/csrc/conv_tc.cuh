// The conv message on the tensor cores, for Hopper (sm_90a): the live-edge
// layout from a mask, the edge tiles and the per-atom sums, shared by
// conv_msg_gather.cu (source rows by node id, row 3 of the port's kernel
// table), banded_msg.cu (source rows from a tile's band of the x-sorted
// frame, row 6), conv_msg.cu (rows gathered beforehand, row 8),
// conv_layer.cu (node ids read by JAX's rule, row 7) and edge_mlp_agg.cu
// (theta_edge alone on rows gathered beforehand, row 9). The source
// policies (GatherSrc, ClampedSrc, PreSrc, BandSrc) say where a slot's
// rows come from; the stage policies (ConvStages, ThetaStages) which
// products a tile runs. Per live slot (i, k) of M atoms, with j = src.row(
// i, i*K + k) its source row, ConvStages:
//   z  = silu(e[i,k] @ W1 + b1) @ W2 + b2 + src[j] + dst[i]
//   m  = silu(silu(z) @ W3 + b3) @ W4 + b4
// and ThetaStages (e the pre-activation edge_pre):
//   m  = silu(silu(e[i,k]) @ W1 + b1) @ W2 + b2
// then, for both,
//   agg[i] = sum over the live slots of hn[j] * m
// A masked slot is never read: it costs a byte of the layout and nothing
// else. Every width is 128, except that the conv message of GatherSrc also
// takes e and the message at 256 (E = D in {128, 256}, H = 128: the DFT
// model's 256 / 128 / 256): W1 [E, 128] is then E / 128 row blocks, run
// one after another into one accumulator over e's column blocks, and W4
// [128, D] D / 128 column blocks, each with its own gated product and
// per-atom sums into agg's columns of that block; each block is a 128 x
// 128 weight of the split table (SplitBlocks: six at 256 / 128 / 256), so
// no accumulator and no buffer grows past width 128's.
//
// The design, launch by launch:
// 1. mask_count_kernel (a warp an atom, 8 a block): per-atom live counts
//    and each block's total; then mask_slots_kernel (a thread an atom, 32
//    a block): each block's base (the totals of the count blocks before
//    it), an exclusive scan of its atoms' counts, and the live slot ids
//    compacted atom-major, in slot order within an atom. Integer sums: the
//    layout is exact, whatever the order. ops/mega.py::live_slot_layout is
//    its plain version.
// 2. split_conv_weights_kernel: the policy's weights (W1..W4, or W1 and
//    W2) as W^T bf16 hi and lo (x = hi + lo, lo = bf16(x - hi)), for the
//    TMA map over them.
// 3. conv_tile_kernel (a persistent grid of the plan's blocks, each taking
//    tiles b, b + grid, ... of 64 live edges): per tile the policy's
//    products (four, or two) on the tensor cores (edge_tc.cuh: wgmma
//    m64n64k16, bf16 x 3, fp32 accumulation; the two warpgroups split the
//    128 output columns), the
//    split weights staged by TMA into a ring that runs on across the
//    block's tiles, and fp32 epilogues: silu, the `+ src[j] + dst[i]` add
//    (ConvStages) and the gated product hn[j] * m. The ring has two
//    buffers (161 KB, a block an SM) where the layout's capacity is a few
//    waves of tiles, and one (97 KB, two blocks an SM that hide each
//    other's waits) past it (ops/edge_tiles.py::launch_plan). Two buffers
//    and two weights (ThetaStages) keep both weights resident: loaded
//    once a block, never refilled. The block then sums each atom's rows
//    of the tile through shared memory, in row order: an atom whose rows
//    all lie in the tile goes straight to agg; one that straddles a tile
//    boundary leaves its partial, the tile's head (rows from a tile
//    before) or tail (rows that go on past it).
// 4. tile_fixup_kernel (a warp an atom): an atom over tiles t0 < t1 gets
//    tail[t0] + head[t0 + 1] + ... + head[t1], in tile order; an atom with
//    no live edge gets 0.
// The count kernel and the split run in stream order; the slots, tile and
// fix-up kernels are launched with programmatic dependent launch (their
// blocks start while the previous kernel finishes and wait for it,
// griddepcontrol, before reading what it wrote).
//
// Measured against this design on the H100 and dropped: one message row a
// live edge summed per atom by a second kernel (at N=10,000 an 84 MB round
// trip, about 45 us more a call); and two tiles a block step sharing each
// weight load, the second tile's products under the first's epilogues (a
// block an SM: about 9% slower at N=10,000 and 22% at a batch of 16 than
// two single-buffer blocks an SM).
//
// What bounds the conv message on this card: the four products are
// 131,072 multiply-adds a live edge; as three bf16 passes that is about 65
// us at N=10,000 (about 164,000 live edges of 960,000 slots) against the
// 989 TFLOP/s tensor peak, and the epilogues' fp32 arithmetic about 5 us more; e's live rows
// are 84 MB (25 us at 3.35 TB/s): operations-bound. What bounds the design
// is latency: a tile's four products and epilogues run in sequence on one
// SM, and each tile loads its 256 KB of split weights from L2 (656 MB a
// call at N=10,000).
//
// Each atom's sums run in a fixed order (the tile's rows in order, then
// the partials in tile order; no atomics), and which block takes a tile
// does not enter them: two runs give the same bits.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_tc.cuh"

// The live-edge layout of M atoms (ops/edge_tiles.py allocates it; the
// ctypes Structure _SlotLayout mirrors it). Outside the unnamed namespace:
// the C entries take it.
struct SlotLayout {
  int* slot;       // [cap] slot id i*K + k of each live edge, atom-major
  int* off;        // [M] the atom's first row
  int* cnt;        // [M] its live edges
  int* total;      // [1] live edges in all
  int* block_sum;  // [ceil(M / 8)] live edges of each count block
};

namespace {

using tc::launch_pdl;
using tc::ld2;
using tc::plan_ok;
using tc::silu_fast;
using tc::sm_count;
using tc::TilePlan;

constexpr int CW = tc::WIDTH;             // a block of every width: 128
constexpr int COUNT_ATOMS = 8;            // atoms a count block, a warp each
constexpr int FIX_ATOMS = 8;              // atoms a fix-up block, a warp each
constexpr int N_WEIGHTS = 4;              // W1, W2, W3, W4 of the conv message
constexpr int MAX_BLOCKS = 6;             // split weights of the widest message

// The edge stage's weights, [in][out] row-major fp32, and biases: the
// first Stages::WEIGHTS of them (the others null).
struct EdgeWeights {
  const float *w[N_WEIGHTS], *b[N_WEIGHTS];
};

// The weights as the split table's 128 x 128 blocks, each [in][out]
// row-major fp32 at w[b] with rows ld floats apart. The conv message at
// E = D in {128, 256} and H = 128 has E / 128 blocks of W1 (its row
// blocks, one a K-block of e), W2, W3, and D / 128 of W4 (its column
// blocks, one an output block of the message): four at width 128, six at
// 256 / 128 / 256.
struct SplitBlocks {
  const float* w[MAX_BLOCKS];
  int ld[MAX_BLOCKS];
};

// The stage policies: the products a tile runs, how an e row is staged
// for the first, and whether `+ src[j] + dst[i]` follows the second.
// The conv message: four products on the raw e row.
struct ConvStages {
  static constexpr int WEIGHTS = N_WEIGHTS;
  static constexpr bool ADD_SRC_DST = true;
  static __device__ __forceinline__ float stage(float x) { return x; }
};

// theta_edge alone (fused_edge_mlp_aggregate): two products on
// silu(edge_pre), nothing added.
struct ThetaStages {
  static constexpr int WEIGHTS = 2;
  static constexpr bool ADD_SRC_DST = false;
  static __device__ __forceinline__ float stage(float x) {
    return silu_fast(x);
  }
};

// Source rows by node id: hn [M, DW], src [M, 128] and idx [M*K] (global
// ids).
template <int DW = CW>
struct GatherSrc {
  const int* idx;
  const float *hn, *src;
  __device__ __forceinline__ int row(int, int slot) const {
    return idx[slot];
  }
  __device__ __forceinline__ const float* hn_row(int j) const {
    return hn + (size_t)j * DW;
  }
  __device__ __forceinline__ const float* src_row(int j) const {
    return src + (size_t)j * CW;
  }
};

// Source rows by node id under JAX's rule for an id out of range (jnp
// indexing): a negative id counts from the end, then ids clamp into
// [0, n). hn, src [n, 128] and idx [n*K].
struct ClampedSrc {
  const int* idx;
  const float *hn, *src;
  int n;
  __device__ __forceinline__ int row(int, int slot) const {
    int j = idx[slot];
    if (j < 0) j += n;
    return min(max(j, 0), n - 1);
  }
  __device__ __forceinline__ const float* hn_row(int j) const {
    return hn + (size_t)j * CW;
  }
  __device__ __forceinline__ const float* src_row(int j) const {
    return src + (size_t)j * CW;
  }
};

// Rows gathered beforehand: h_src and src_code [M*K, 128], and slot
// (i, k) reads row i*K + k of each.
struct PreSrc {
  const float *h_src, *src_code;
  __device__ __forceinline__ int row(int, int slot) const { return slot; }
  __device__ __forceinline__ const float* hn_row(int j) const {
    return h_src + (size_t)j * CW;
  }
  __device__ __forceinline__ const float* src_row(int j) const {
    return src_code + (size_t)j * CW;
  }
};

// Source rows of a band: nodes [rows, 256] = [hn | src] of the x-sorted
// frame (extended by a replica of its head rows), and slot (i, k) reads
// row lo[i / tile_n] + idx_loc[i*K + k].
struct BandSrc {
  const int *idx_loc, *lo;
  const float* nodes;
  int tile_n;
  __device__ __forceinline__ int row(int i, int slot) const {
    return lo[i / tile_n] + idx_loc[slot];
  }
  __device__ __forceinline__ const float* hn_row(int j) const {
    return nodes + (size_t)j * 2 * CW;
  }
  __device__ __forceinline__ const float* src_row(int j) const {
    return nodes + (size_t)j * 2 * CW + CW;
  }
};

// ---------------------------------------------------------------------------
// 1. The layout
// ---------------------------------------------------------------------------

// grid ceil(M / 8), block 256: cnt of atom blockIdx.x * 8 + w by warp w
// (its K bytes, 32 a ballot), and block_sum of each block.
__global__ void __launch_bounds__(32 * COUNT_ATOMS)
mask_count_kernel(const uint8_t* __restrict__ mask, int m, int k,
                  SlotLayout lay) {
  __shared__ int warp_cnt[COUNT_ATOMS];
  tc::let_next_start();
  tc::grid_wait();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * COUNT_ATOMS + warp;
  int c = 0;
  if (i < m) {
#pragma unroll 4
    for (int k0 = 0; k0 < k; k0 += 32) {
      const int kk = k0 + lane;
      c += __popc(__ballot_sync(0xffffffffu,
                                kk < k && mask[(size_t)i * k + kk]));
    }
    if (lane == 0) lay.cnt[i] = c;
  }
  if (lane == 0) warp_cnt[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < COUNT_ATOMS; ++w) s += warp_cnt[w];
    lay.block_sum[blockIdx.x] = s;
  }
}

// grid ceil(M / 32), block 32: off of atom i = blockIdx.x * 32 + t (the
// block's base, the counts of the atoms before it from the count blocks'
// sums, plus an exclusive scan of its atoms' counts), the slot ids of its
// live edges by thread t, and total (by the last block). A row of K bytes
// is read as words where K % 4 == 0 and the mask is word-aligned.
__global__ void __launch_bounds__(32)
mask_slots_kernel(const uint8_t* __restrict__ mask, int m, int k,
                  SlotLayout lay) {
  tc::let_next_start();
  tc::grid_wait();
  const int t = threadIdx.x;
  int base = 0;
  const int before = blockIdx.x * (32 / COUNT_ATOMS);
#pragma unroll 4
  for (int b = t; b < before; b += 32) base += lay.block_sum[b];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    base += __shfl_xor_sync(0xffffffffu, base, o);
  const int i = blockIdx.x * 32 + t;
  const int c = i < m ? lay.cnt[i] : 0;
  int v = c;   // inclusive scan
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (t >= o) v += u;
  }
  if (blockIdx.x == gridDim.x - 1 && t == 31) *lay.total = base + v;
  if (i >= m) return;
  const int first = base + v - c;
  lay.off[i] = first;
  int* out = lay.slot + first;
  const int slot0 = i * k;
  if ((k & 3) == 0 && (reinterpret_cast<uintptr_t>(mask) & 3) == 0) {
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(mask + (size_t)slot0);
#pragma unroll 8
    for (int q = 0; q < k / 4; ++q) {
      const uint32_t x = row[q];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((x >> (8 * b)) & 0xffu) *out++ = slot0 + 4 * q + b;
    }
  } else {
    const uint8_t* row = mask + (size_t)slot0;
#pragma unroll 16
    for (int kk = 0; kk < k; ++kk)
      if (row[kk]) *out++ = slot0 + kk;
  }
}

// The layout of M atoms of K slots from their mask, on `s`: two launches,
// the first ordered after the stream's earlier work, the second by
// programmatic dependent launch.
cudaError_t launch_mask_layout(const uint8_t* mask, int m, int k,
                               const SlotLayout& lay, cudaStream_t s) {
  mask_count_kernel<<<(m + COUNT_ATOMS - 1) / COUNT_ATOMS, 32 * COUNT_ATOMS,
                      0, s>>>(mask, m, k, lay);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_pdl(mask_slots_kernel, dim3((m + 31) / 32), dim3(32), 0, s,
                    mask, m, k, lay);
}

// ---------------------------------------------------------------------------
// 2. The weight split
// ---------------------------------------------------------------------------

// grid (blocks, 16), block 256: 8 output rows of weight block m as W^T hi
// and lo bf16 ([2m] and [2m+1] of the table, each [128 out][128 in]), x =
// hi + lo, lo = bf16(x - hi); the transpose goes through shared memory.
__global__ void __launch_bounds__(256)
split_conv_weights_kernel(SplitBlocks p, __nv_bfloat16* __restrict__ out) {
  constexpr int ROWS = 8;
  __shared__ float tile[CW][ROWS + 1];
  const int m = blockIdx.x, o0 = ROWS * blockIdx.y, t = threadIdx.x;
  const float* w = p.w[m];
  const int ld = p.ld[m];
#pragma unroll
  for (int q = t; q < CW * ROWS; q += 256)
    tile[q / ROWS][q % ROWS] = w[(q / ROWS) * ld + o0 + q % ROWS];
  __syncthreads();
  __nv_bfloat16* hi = out + (size_t)(2 * m) * CW * CW;
  __nv_bfloat16* lo = hi + CW * CW;
#pragma unroll
  for (int q = t; q < CW * ROWS; q += 256) {
    const int o = q / CW, kin = q % CW;
    const float x = tile[kin][o];
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    hi[(o0 + o) * CW + kin] = h;
    lo[(o0 + o) * CW + kin] = __float2bfloat16_rn(x - __bfloat162float(h));
  }
}

// ---------------------------------------------------------------------------
// 3. The edge tiles
// ---------------------------------------------------------------------------

struct TileArgs {
  SlotLayout lay;
  const float *e, *dst;
  const float *b1, *b2, *b3, *b4;
  float* agg;    // [M, D]
  float* part;   // [tiles, 2, D]: each tile's head and tail partials
  int k;
};

// Column c of a tile's messages in the shared buffer `red` ([64][128]
// fp32 over the tile's activation buffer; the column XOR-swizzled by the
// row, so that the fragment stores and the column reads spread over the
// banks).
__device__ __forceinline__ int red_at(int row, int col) {
  return row * CW + (col ^ ((row & 7) << 3));
}

// The sum s of column c of an atom's rows in tile t into agg if the
// atom's rows all lie in the tile (it starts and ends there), else into
// the tile's head (rows from before the tile) or tail partial; agg and
// the partials `width` columns wide.
__device__ __forceinline__ void emit_run(const TileArgs& a, int t, int atom,
                                         bool starts, bool ends, int c,
                                         float s, int width = CW) {
  if (starts && ends)
    a.agg[(size_t)atom * width + c] = s;
  else
    a.part[((size_t)2 * t + (starts ? 1 : 0)) * width + c] = s;
}

// The persistent edge-tile kernel. grid plan.grid, block 256 (one tile at
// a time, its columns split between the two warpgroups), tc::smem_bytes(
// NBUF) of dynamic shared memory (NBUF weight buffers, the activations);
// block b takes tiles b, b + grid, ... of the layout's ceil(total / 64).
// With as many buffers as the tile has products, the weights stay
// resident: every product of the block reads its own buffer, loaded once.
//
// ConvStages at E = 128 EB and D = 128 DB (H = 128): W1 runs over e's EB
// K-blocks into one accumulator, each block staged into the activations
// in turn; W4 over its DB column blocks, each block's messages summed per
// atom into agg's columns [128 d, 128 d + 128). At EB = DB = 1 these are
// the four products of width 128, in the same arithmetic as every other
// conv_tc caller.
template <int NBUF, class Src, class Stages = ConvStages, int EB = 1,
          int DB = 1>
__global__ void __launch_bounds__(tc::THREADS, 3 - NBUF)
conv_tile_kernel(const __grid_constant__ CUtensorMap wmap, TileArgs a,
                 Src src) {
  static_assert(Stages::ADD_SRC_DST || (EB == 1 && DB == 1),
                "wide e or messages are the conv message's only");
  constexpr int NW = Stages::WEIGHTS + EB + DB - 2;   // products a tile
  constexpr int EW = EB * CW, DW = DB * CW;
  constexpr bool RESIDENT = NBUF == NW;
  tc::let_next_start();
  tc::grid_wait();
  const int total = *a.lay.total;
  const int tiles = (total + tc::TILE - 1) / tc::TILE;
  if ((int)blockIdx.x >= tiles) return;
  const int mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  extern __shared__ uint8_t tile_smem[];
  __shared__ __align__(8) uint64_t bars[NBUF];
  __shared__ int atom_s[tc::TILE];     // each row's atom, -1 past total
  __shared__ uint8_t first_s[tc::TILE], last_s[tc::TILE];   // of its atom
  const tc::WeightRing<NBUF> ring(tile_smem, bars, &wmap, 0, NW,
                                  RESIDENT ? NW : NW * mine);
  float* red = reinterpret_cast<float*>(ring.a);
  const tc::Frag f;
  int p = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * tc::TILE;
    bool live[2];
    int i[2], j[2], sl[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int g = row0 + f.r0 + 8 * s;
      live[s] = g < total;
      sl[s] = a.lay.slot[live[s] ? g : row0];
      i[s] = sl[s] / a.k;
      j[s] = src.row(i[s], sl[s]);
    }
    // Threads 0-63: their row's atom, and whether the row is its atom's
    // first or last (stored once the tile's e rows are).
    int row_atom = -1, row_off = 0, row_cnt = 0;
    const int g = row0 + threadIdx.x;
    if (threadIdx.x < tc::TILE && g < total) {
      row_atom = a.lay.slot[g] / a.k;
      row_off = a.lay.off[row_atom];
      row_cnt = a.lay.cnt[row_atom];
    }
    // e's columns [128 eb, 128 eb + 128) of the tile's rows into the
    // activations.
    auto stage_e = [&](int eb) {
#pragma unroll
      for (int q = 0; q < tc::PAIRS; ++q) {
        const int s = q & 1;
        const float2 v =
            live[s] ? ld2(a.e + (size_t)sl[s] * EW + eb * CW + f.col(q))
                    : make_float2(0.f, 0.f);
        tc::store_pair(ring.a, f, q, Stages::stage(v.x),
                       Stages::stage(v.y));
      }
    };
    stage_e(0);
    if (threadIdx.x < tc::TILE) {
      atom_s[threadIdx.x] = row_atom;
      first_s[threadIdx.x] = row_off == g;
      last_s[threadIdx.x] = row_off + row_cnt == g + 1;
    }
    tc::proxy_fence();
    __syncthreads();

    // The products, each followed by its epilogue: the bias (after the
    // second of ConvStages, + src[j] + dst[i]) and silu into the
    // activations; after the last, the message hn[j] * m (0 on a dead row)
    // into the shared buffer. release's barrier puts both warpgroups past
    // their reads of the activations first. Product p of the ring reads
    // its buffer in turn, or with the weights resident the tile's m-th.
    auto hidden = [&](const float (&acc)[2 * tc::PAIRS], int l) {
      const float* bias = l == 0 ? a.b1 : l == 1 ? a.b2 : a.b3;
#pragma unroll
      for (int q = 0; q < tc::PAIRS; ++q) {
        const int s = q & 1, c = f.col(q);
        float2 x = ld2(bias + c);
        x.x += acc[2 * q];
        x.y += acc[2 * q + 1];
        if (Stages::ADD_SRC_DST && l == 1) {
          const float2 sv = ld2(src.src_row(j[s]) + c);
          const float2 dv = ld2(a.dst + (size_t)i[s] * CW + c);
          x.x += sv.x + dv.x;
          x.y += sv.y + dv.y;
        }
        tc::store_pair(ring.a, f, q, silu_fast(x.x), silu_fast(x.y));
      }
      tc::proxy_fence();
      __syncthreads();
    };
    // Column block d of the last weight's output: the messages into `red`,
    // then each atom's rows of the tile summed in row order by the
    // column's thread of the first warpgroup.
    auto messages = [&](const float (&acc)[2 * tc::PAIRS], int d) {
      const float* bias = (Stages::WEIGHTS == 2 ? a.b2 : a.b4) + d * CW;
#pragma unroll
      for (int q = 0; q < tc::PAIRS; ++q) {
        const int s = q & 1, c = f.col(q);
        float2 x = ld2(bias + c);
        x.x += acc[2 * q];
        x.y += acc[2 * q + 1];
        float2 v = make_float2(0.f, 0.f);
        if (live[s]) {
          const float2 hv = ld2(src.hn_row(j[s]) + d * CW + c);
          v = make_float2(hv.x * x.x, hv.y * x.y);
        }
        *reinterpret_cast<float2*>(red + red_at(f.row(q), c)) = v;
      }
      __syncthreads();
      if (threadIdx.x < CW) {
        const int c = threadIdx.x, rows = min(tc::TILE, total - row0);
        int cur = atom_s[0], start = 0;
        float s = 0.f;
        for (int r = 0; r < rows; ++r) {
          const int at = atom_s[r];
          if (at != cur) {
            emit_run(a, t, cur, first_s[start], last_s[r - 1], d * CW + c, s,
                     DW);
            cur = at;
            start = r;
            s = 0.f;
          }
          s += red[red_at(r, c)];
        }
        emit_run(a, t, cur, first_s[start], last_s[rows - 1], d * CW + c, s,
                 DW);
      }
      __syncthreads();   // red and the row flags are rewritten next
    };

    float acc[2 * tc::PAIRS];
#pragma unroll
    for (int eb = 0; eb < EB; ++eb, ++p) {   // W1 over e's K-blocks
      if (eb > 0) {
        stage_e(eb);
        tc::activations_ready();
      }
      const int q = RESIDENT ? eb : p;
      ring.product(acc, q, f.wg, 8, eb == 0);
      ring.release(&wmap, q);
    }
    hidden(acc, 0);
#pragma unroll
    for (int l = 1; l + 1 < Stages::WEIGHTS; ++l, ++p) {   // W2, W3
      const int q = RESIDENT ? EB + l - 1 : p;
      ring.product(acc, q, f.wg);
      ring.release(&wmap, q);
      hidden(acc, l);
    }
    // The last weight's column blocks: every product before the first
    // message, whose buffer is the activations the products read.
    float held[2 * tc::PAIRS];
    if constexpr (DB > 1) {
      ring.product(held, p, f.wg);
      ring.release(&wmap, p);
      ++p;
    }
    const int q_last = RESIDENT ? NW - 1 : p;
    ring.product(acc, q_last, f.wg);
    ring.release(&wmap, q_last);
    ++p;
    if constexpr (DB > 1) messages(held, 0);
    messages(acc, DB - 1);
  }
}

// ---------------------------------------------------------------------------
// 4. The partials of atoms that straddle tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// grid ceil(M / 8), block 256: a warp an atom, 4 columns a lane in each
// block of 128 of agg's `width` (128 or 256; the partials as wide). An
// atom over tiles t0 < t1 gets tail[t0] + head[t0 + 1] + ... + head[t1];
// an atom with no live edge 0; the tile kernel wrote the others.
__global__ void __launch_bounds__(32 * FIX_ATOMS)
tile_fixup_kernel(SlotLayout lay, const float* __restrict__ part, int m,
                  float* __restrict__ agg, int width) {
  tc::let_next_start();
  tc::grid_wait();
  const int i = blockIdx.x * FIX_ATOMS + (threadIdx.x >> 5);
  if (i >= m) return;
  const int n = lay.cnt[i], o = lay.off[i];
  const int t0 = o / tc::TILE, t1 = (o + n - 1) / tc::TILE;
  for (int c = 4 * (threadIdx.x & 31); c < width; c += CW) {
    float4* out = reinterpret_cast<float4*>(agg + (size_t)i * width + c);
    if (n == 0) {
      *out = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    if (t0 == t1) return;
    const float4* head = reinterpret_cast<const float4*>(part + c);
    float4 s = head[(2 * t0 + 1) * (width / 4)];
    for (int t = t0 + 1; t <= t1; ++t) s = add4(s, head[2 * t * (width / 4)]);
    *out = s;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Dynamic shared memory above 48 KB for the tile kernels of Src, Stages
// and the widths, once per process.
template <class Src, class Stages, int EB, int DB>
cudaError_t configure_tiles() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaFuncAttribute max_smem =
      cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(conv_tile_kernel<1, Src, Stages, EB, DB>,
                                  max_smem, tc::smem_bytes(1)))
          != cudaSuccess ||
      (err = cudaFuncSetAttribute(conv_tile_kernel<2, Src, Stages, EB, DB>,
                                  max_smem, tc::smem_bytes(2)))
          != cudaSuccess)
    return err;
  done = true;
  return cudaSuccess;
}

// The split table's blocks of Stages' weights at E = 128 EB and D = 128
// DB, in the order of a tile's products: W1's row blocks, W2, W3, W4's
// column blocks (SplitBlocks).
template <class Stages, int EB, int DB>
SplitBlocks split_blocks(const EdgeWeights& w) {
  constexpr int LAST = Stages::WEIGHTS - 1;
  SplitBlocks b{};
  int n = 0;
  for (int e = 0; e < EB; ++e, ++n) {
    b.w[n] = w.w[0] + (size_t)e * CW * CW;
    b.ld[n] = CW;
  }
  for (int l = 1; l < LAST; ++l, ++n) {
    b.w[n] = w.w[l];
    b.ld[n] = CW;
  }
  for (int d = 0; d < DB; ++d, ++n) {
    b.w[n] = w.w[LAST] + d * CW;
    b.ld[n] = DB * CW;
  }
  return b;
}

// Launches 2-4 of a call on `s` over a layout already on the stream: the
// split (ordered after the stream's earlier work), the tile kernel and the
// fix-up, for the stage policy Stages at e width 128 EB and message width
// 128 DB. wsplit is the split table's scratch (2 * blocks * 128 * 128
// bf16, split_blocks' blocks), part the partials' [ceil(M*K / 64), 2, 128
// DB] fp32. Returns 0, a cudaError_t (cudaErrorInvalidValue for a plan
// the shape does not take), or 100000 + the CUresult of the TMA map's
// encoding.
template <class Src, class Stages = ConvStages, int EB = 1, int DB = 1>
int run_conv_tiles(const float* e, const float* dst, const EdgeWeights& w,
                   const Src& src, const SlotLayout& lay, void* wsplit,
                   float* part, int m, int k, const TilePlan& plan,
                   float* agg, cudaStream_t s) {
  constexpr int BLOCKS = Stages::WEIGHTS + EB + DB - 2;
  if (!plan_ok(plan, m, k)) return cudaErrorInvalidValue;
  cudaError_t err = configure_tiles<Src, Stages, EB, DB>();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_conv_weights_kernel<<<dim3(BLOCKS, CW / 8), 256, 0, s>>>(
      split_blocks<Stages, EB, DB>(w), static_cast<__nv_bfloat16*>(wsplit));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  const int map_err = tc::encode_split_map(wsplit, BLOCKS, &map);
  if (map_err != 0) return map_err;
  const TileArgs a{lay, e, dst, w.b[0], w.b[1], w.b[2], w.b[3], agg, part, k};
  err = plan.nbuf == 2
            ? launch_pdl(conv_tile_kernel<2, Src, Stages, EB, DB>,
                         dim3(plan.grid), dim3(tc::THREADS), plan.smem, s,
                         map, a, src)
            : launch_pdl(conv_tile_kernel<1, Src, Stages, EB, DB>,
                         dim3(plan.grid), dim3(tc::THREADS), plan.smem, s,
                         map, a, src);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_pdl(tile_fixup_kernel, dim3((m + FIX_ATOMS - 1) / FIX_ATOMS),
                   dim3(32 * FIX_ATOMS), 0, s, lay,
                   static_cast<const float*>(part), m, agg, DB * CW);
  return static_cast<int>(err);
}

}  // namespace
