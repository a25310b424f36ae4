// The stages of the whole-model forward for Hopper (sm_90a) and the host
// code that launches them: the live flags and the live-edge layout, the
// encoder's and each layer's edge tiles on the tensor cores, and the fused
// node stages (node_fused.cuh). Shared by mega_forward.cu (the edge
// stage's production forms, ABL_NONE, and the forward's launches),
// mega_encode.cu and mega_node.cu (the encoder's and the node stages'
// production forms) and the benchmark's
// forms of each stage (mega_ablate_encode.cu, mega_ablate_edge.cu,
// mega_ablate_node.cu), so that they build in parallel; each includes it
// once. What each stage computes, its design and its bound are written in
// mega_forward.cu.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "edge_tc.cuh"
#include "encode.cuh"
#include "mega.cuh"
#include "node_fused.cuh"
#include "tile.cuh"

// What an encoder-stage tile reads (the tile body's EncTileArgs, encode.cuh,
// inside).
struct EncArgs {
  const float* pos;
  const int *idx, *slot, *total;
  const float* bond;   // [R, N, K] bond channel (read with BOND only)
  float* e;
  int n, k, cap;
  EncTileArgs t;   // the tile body's centres, biases, affine and scalars
};


// What an edge-stage tile reads: the layout, e, the node rows and the
// layer's biases.
struct EdgeArgs {
  const int *idx, *slot, *total;
  const float *e, *hn, *src, *dst;
  const float *b_e1, *b_e2, *b_t1, *b_t2;   // the layer's biases
  const float* b_src;   // the layer's source bias (read by ABL_SRCAFF)
  float* msg;
  int n, k, cap;
  int cact;             // the conv activation's code (Act): which form
};


// The benchmark's forms of each stage (mega.cuh, Ablate): the switches
// that change the encoder, the edge stage and the node stages. A forward
// with switch s runs each stage's form for s where the stage has one, its
// production form elsewhere.
constexpr bool encode_has_form(int s) {
  return s == ABL_ACTS || s == ABL_GATHER_POS || s == ABL_RBF ||
         s == ABL_ENCMLP || s == ABL_LN;
}
constexpr bool edge_has_form(int s) {
  return s == ABL_ACTS || s == ABL_GATHER_CONV || s == ABL_SRCAFF ||
         s == ABL_EMLP || s == ABL_REPEAT || s == ABL_THETA;
}
constexpr bool node_has_form(int s) {
  return s == ABL_ACTS || s == ABL_LN || s == ABL_NODEOPS ||
         s == ABL_SRCAFF || s == ABL_AGG || s == ABL_DECODER;
}

// The encoder stage's production forms (mega_encode.cu, beside this
// file's other users so that they build in parallel): one weight buffer
// or two (one: the tiles outnumber the SMs twice), the bond channel's
// form where ea.bond is given, the MLP activation's form.
cudaError_t launch_encode_production(const CUtensorMap& map,
                                     const EncArgs& ea, dim3 tiles, bool one,
                                     cudaStream_t s);

// The node stages' production forms (mega_node.cu, likewise): b atoms a
// block, na's activation pair.
cudaError_t launch_node_production(const NodeArgs& na, int layer, int b,
                                   cudaStream_t s);

// The launches of the benchmark forms, each stage's in its own
// translation unit (mega_ablate_encode.cu, mega_ablate_edge.cu,
// mega_ablate_node.cu) so that nvcc builds them in parallel with the
// production forms: two weight buffers a tile block, 4 atoms a node
// block. Each returns cudaErrorInvalidValue for a switch its stage has no
// form of.
cudaError_t launch_encode_ablated(int ablate, const CUtensorMap& map,
                                  const EncArgs& ea, dim3 tiles,
                                  cudaStream_t s);
cudaError_t launch_edge_ablated(int ablate, const CUtensorMap& map,
                                const EdgeArgs& ga, int m0, dim3 tiles,
                                cudaStream_t s);
cudaError_t launch_node_ablated(int ablate, const NodeArgs& na, int layer,
                                cudaStream_t s);

namespace {

using tc::activations_ready;
using tc::launch_pdl;
using tc::ld2;
using tc::sm_count;

constexpr int LIVE_THREADS = 256;
constexpr int LAYOUT_THREADS = 1024;
constexpr int LAYOUT_FLAG_BYTES = 16 * 1024;   // live flags of one chunk

// Rows of a replica's live-edge list: N*K rounded up to the 64-row tile.
int layout_cap(int n, int k) {
  return (n * k + tc::TILE - 1) / tc::TILE * tc::TILE;
}

// Atoms of one chunk of the layout kernel: one a thread, their live flags
// within LAYOUT_FLAG_BYTES of shared memory.
int layout_chunk(int k) {
  return std::min(LAYOUT_THREADS, LAYOUT_FLAG_BYTES / std::max(k, 1));
}

// The live test of slot (i, j): bit for bit the plain version's float32
// arithmetic (no contraction), so the two layouts agree exactly.
__device__ __forceinline__ bool live_slot(const float* __restrict__ pos,
                                          int i, int j, float box,
                                          float cutoff2) {
  float d2 = 0.f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float x = __fsub_rn(pos[3 * j + d], pos[3 * i + d]);
    x = __fsub_rn(x, __fmul_rn(box, rintf(__fdiv_rn(x, box))));
    const float x2 = __fmul_rn(x, x);
    d2 = d == 0 ? x2 : __fadd_rn(d2, x2);
  }
  return d2 < cutoff2;
}

// The live flag of every slot. grid (ceil(N*K / 256), R), block 256: a
// thread a slot, spread over the card (the test's IEEE divisions are the
// layout's main cost).
__global__ void __launch_bounds__(LIVE_THREADS)
live_kernel(const float* __restrict__ pos, const int* __restrict__ idx,
            const uint8_t* __restrict__ bmask, int n, int k, float box,
            float cutoff2, uint8_t* __restrict__ live) {
  tc::let_next_start();
  tc::grid_wait();
  const int g = blockIdx.x * LIVE_THREADS + threadIdx.x;
  if (g >= n * k) return;
  const size_t rep = blockIdx.y;
  const size_t slot = rep * n * k + g;
  live[slot] = bmask[slot] &&
               live_slot(pos + rep * n * 3, g / k, idx[slot], box, cutoff2);
}

// The live-edge layout of one replica a block, from the live flags. grid
// R, block 1024, `chunk` * k bytes of dynamic shared memory. Per chunk of
// atoms: the block loads the chunk's flags, thread t counts atom t's, the
// block scans the counts (warp scans, then the warps' totals in order) and
// thread t writes atom t's live slots.
__global__ void __launch_bounds__(LAYOUT_THREADS)
layout_kernel(const uint8_t* __restrict__ live, int n, int k, int cap,
              int chunk, int* __restrict__ slot, int* __restrict__ off,
              int* __restrict__ cnt, int* __restrict__ total) {
  extern __shared__ uint8_t live_s[];
  __shared__ int warp_sum[LAYOUT_THREADS / 32];
  tc::let_next_start();
  tc::grid_wait();
  const int rep = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  live += (size_t)rep * n * k;
  slot += (size_t)rep * cap;
  off += (size_t)rep * n;
  cnt += (size_t)rep * n;

  int carry = 0;
  for (int base = 0; base < n; base += chunk) {
    const int atoms = min(chunk, n - base), slots = atoms * k;
    for (int q = t; q < slots; q += LAYOUT_THREADS)
      live_s[q] = live[base * k + q];
    __syncthreads();
    int c = 0;
    if (t < atoms)
      for (int kk = 0; kk < k; ++kk) c += live_s[t * k + kk];
    int v = c;   // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    int first = carry, chunk_total = 0;
    for (int w = 0; w < LAYOUT_THREADS / 32; ++w) {
      if (w < warp) first += warp_sum[w];
      chunk_total += warp_sum[w];
    }
    first += v - c;
    if (t < atoms) {
      const int i = base + t;
      off[i] = first;
      cnt[i] = c;
      for (int kk = 0; kk < k; ++kk)
        if (live_s[t * k + kk]) slot[first++] = i * k + kk;
    }
    carry += chunk_total;
    __syncthreads();   // live_s and warp_sum are rewritten by the next chunk
  }
  if (t == 0) total[rep] = carry;
}

// Stage 1 of a forward: the live flags, then the layout.
cudaError_t launch_layout(const float* pos, const int* idx,
                          const uint8_t* bmask, int r, int n, int k,
                          float box, float cutoff2, const MegaScratch* s,
                          cudaStream_t stream) {
  cudaError_t err =
      launch_pdl(live_kernel,
                 dim3((n * k + LIVE_THREADS - 1) / LIVE_THREADS, r),
                 dim3(LIVE_THREADS), 0, stream, pos, idx, bmask, n, k, box,
                 cutoff2, s->live);
  if (err != cudaSuccess) return err;
  const int chunk = layout_chunk(k);
  return launch_pdl(layout_kernel, dim3(r), dim3(LAYOUT_THREADS), chunk * k,
                    stream, static_cast<const uint8_t*>(s->live), n, k,
                    layout_cap(n, k), chunk, s->slot, s->off, s->cnt,
                    s->total);
}

// Weight m of the split table: w_rbf, w1, w2, then w_e1, w_e2, w_t1, w_t2
// of each layer, all [128 in][128 out] fp32.
__device__ __forceinline__ const float* edge_weight(const MegaWeights& p,
                                                    int m) {
  if (m == 0) return p.w_rbf;
  if (m == 1) return p.w1;
  if (m == 2) return p.w2;
  const size_t lw = (size_t)((m - 3) / 4) * W * W;
  switch ((m - 3) % 4) {
    case 0: return p.w_e1 + lw;
    case 1: return p.w_e2 + lw;
    case 2: return p.w_t1 + lw;
    default: return p.w_t2 + lw;
  }
}

// grid (3 + 4L, 4), block (32, 8): 32 output rows of weight m as W^T hi
// and lo bf16 ([2m] and [2m+1] of the table, each [128 out][128 in]), x =
// hi + lo, lo = bf16(x - hi). The transpose goes through shared memory, so
// that reads and writes are both coalesced.
__global__ void __launch_bounds__(256)
split_weights_kernel(MegaWeights p, __nv_bfloat16* __restrict__ out) {
  __shared__ float tile[W][33];
  const int m = blockIdx.x, o0 = 32 * blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* w = edge_weight(p, m);
  for (int kin = ty; kin < W; kin += 8) tile[kin][tx] = w[kin * W + o0 + tx];
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

// The two rows of a tile the calling thread holds (fragment rows r0, r0 +
// 8): live (inside the replica's list), centre atom i, source atom j
// (indices within the replica) and the row in the replica-major arrays.
struct TileRows {
  bool live[2];
  int i[2], j[2];
  size_t row[2];
};

__device__ __forceinline__ TileRows tile_rows(const tc::Frag& f,
                                              const int* __restrict__ slot,
                                              const int* __restrict__ idx,
                                              int rep, int row0, int count,
                                              int n, int k, int cap) {
  TileRows t;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int g = row0 + f.r0 + 8 * s;
    t.live[s] = g < count;
    const int sl = slot[(size_t)rep * cap + (t.live[s] ? g : row0)];
    t.i[s] = sl / k;
    t.j[s] = idx[(size_t)rep * n * k + sl];
    t.row[s] = (size_t)rep * cap + g;
  }
  return t;
}

// Encoder over live edges. grid (cap / 64, R), block 256 (one tile, its
// columns split between the two warpgroups), tc::smem_bytes(NBUF) of
// dynamic shared memory; split weights 0 (w_rbf), 1 (w1), 2 (w2). The
// tile body is encode.cuh's, shared with edge_encoder.cu; BOND reads the
// bond channel at each row's slot; MACT is the MLP activation (Act), the
// kernel's form of a.t.mact. ABL (Ablate) is the production form
// (ABL_NONE) or a benchmark form of this stage: ABL_GATHER_POS takes atom
// 0's position for every neighbour (the layout still from the true list),
// ABL_RBF, ABL_ENCMLP and ABL_LN the tile body's (encode.cuh), whose ring
// then holds w1, w2 or w_rbf alone.
template <int NBUF, bool BOND, int ABL, int MACT>
__global__ void __launch_bounds__(tc::THREADS, 3 - NBUF)
encode_tile_kernel(const __grid_constant__ CUtensorMap wmap, EncArgs a) {
  tc::let_next_start();
  tc::grid_wait();
  const int rep = blockIdx.y, row0 = blockIdx.x * tc::TILE;
  const int count = a.total[rep];
  if (row0 >= count) return;
  extern __shared__ uint8_t tile_smem[];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ float red[2][2][tc::TILE];   // [stat][warpgroup][row]
  constexpr int first = ABL == ABL_RBF ? 1 : 0;
  constexpr int products = ABL == ABL_RBF ? 2 : (ABL == ABL_ENCMLP ? 1 : 3);
  const tc::WeightRing<NBUF> sm(tile_smem, bars, &wmap, first, products,
                                products);
  const tc::Frag f;
  const TileRows t = tile_rows(f, a.slot, a.idx, rep, row0, count, a.n, a.k,
                               a.cap);
  float geo[2][4];   // ux, uy, uz, standardised distance of each row
#pragma unroll
  for (int s = 0; s < 2; ++s)
    edge_geometry(a.pos + ((size_t)rep * a.n + t.i[s]) * 3,
                  a.pos + ((size_t)rep * a.n +
                           (ABL == ABL_GATHER_POS ? 0 : t.j[s])) * 3,
                  a.t, geo[s]);
  if constexpr (BOND) {
    // The bond of each row's slot (a dead row reads the tile's first
    // slot, in bounds, and its value is never written).
    float bond[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int g = row0 + f.r0 + 8 * s;
      const int sl = a.slot[(size_t)rep * a.cap + (t.live[s] ? g : row0)];
      bond[s] = a.bond[(size_t)rep * a.n * a.k + sl];
    }
    encode_tile<NBUF, false, 0, true, ABL, MACT>(sm, &wmap, 0, f, a.t, geo,
                                                 t.live, t.row, red, a.e,
                                                 bond);
  } else {
    encode_tile<NBUF, false, 0, false, ABL, MACT>(sm, &wmap, 0, f, a.t, geo,
                                                  t.live, t.row, red, a.e);
  }
}

// Edge stage of one layer over live edges. grid (cap / 64, R), block 256
// (one tile, its columns split between the two warpgroups),
// tc::smem_bytes(NBUF) of dynamic shared memory; split weights m0 .. m0 +
// 3 are the layer's W_e1, W_e2, W_t1, W_t2.
//   z = act(e @ W_e1 + b) @ W_e2 + b + src[j] + dst[i]
//   g = act(act(z) @ W_t1 + b) @ W_t2 + b
//   msg[row] = hn[j] * g
// act is the conv activation CACT (silu or tanh-gelu, the fast forms;
// Act, the kernel's form of a.cact), fixed at compile time. ABL
// (Ablate) is the production form or a benchmark form of this stage:
// ABL_GATHER_CONV reads src and hn of atom 0 for every edge, ABL_SRCAFF
// adds b_src for src[j], ABL_EMLP takes z = e + src[j] + dst[i] (no W_e1,
// W_e2), ABL_REPEAT adds atom 0's dst, ABL_THETA takes g = z (no W_t1,
// W_t2), ABL_ACTS takes act = 0.5 x; the ring holds the products the form
// runs.
template <int NBUF, int ABL, int CACT>
__global__ void __launch_bounds__(tc::THREADS, 3 - NBUF)
edge_tile_kernel(const __grid_constant__ CUtensorMap wmap, EdgeArgs a,
                 int m0) {
  constexpr bool EMLP = ABL != ABL_EMLP, THETA = ABL != ABL_THETA;
  constexpr int products = EMLP && THETA ? 4 : 2;
  constexpr int t1 = EMLP ? 2 : 0;   // W_t1's product
  tc::let_next_start();
  tc::grid_wait();
  const int rep = blockIdx.y, row0 = blockIdx.x * tc::TILE;
  const int count = a.total[rep];
  if (row0 >= count) return;
  extern __shared__ uint8_t tile_smem[];
  __shared__ __align__(8) uint64_t bars[2];
  const tc::WeightRing<NBUF> sm(tile_smem, bars, &wmap, EMLP ? m0 : m0 + 2,
                                products, products);
  const tc::Frag f;
  const TileRows t = tile_rows(f, a.slot, a.idx, rep, row0, count, a.n, a.k,
                               a.cap);
  const size_t node0 = (size_t)rep * a.n;
  int src_j[2], dst_i[2];   // the rows whose src/hn and dst an edge reads
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    src_j[s] = ABL == ABL_GATHER_CONV ? 0 : t.j[s];
    dst_i[s] = ABL == ABL_REPEAT ? 0 : t.i[s];
  }
  float acc[2 * tc::PAIRS];
  const auto act = act_of<true, ABL, CACT>();
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    const int s = p & 1;
    const float2 v = t.live[s] ? ld2(a.e + t.row[s] * W + f.col(p))
                               : make_float2(0.f, 0.f);
    if constexpr (EMLP) {
      tc::store_pair(sm.a, f, p, v.x, v.y);
    } else {   // z starts from e itself
      acc[2 * p] = v.x;
      acc[2 * p + 1] = v.y;
    }
  }
  if constexpr (EMLP) {
    activations_ready();
    sm.product(acc, 0, f.wg);
    sm.release(&wmap, 0);
#pragma unroll
    for (int p = 0; p < tc::PAIRS; ++p) {
      const float2 b = ld2(a.b_e1 + f.col(p));
      tc::store_pair(sm.a, f, p, act(acc[2 * p] + b.x),
                     act(acc[2 * p + 1] + b.y));
    }
    activations_ready();
    sm.product(acc, 1, f.wg);
    sm.release(&wmap, 1);
  }
  // z = (the edge MLP's output + b) + src[j] + dst[i]; act(z) into the
  // tile, or, in ABL_THETA's form, z kept for the message.
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    const int s = p & 1, c = f.col(p);
    const float2 b = EMLP ? ld2(a.b_e2 + c) : make_float2(0.f, 0.f);
    const float2 sv = ABL == ABL_SRCAFF
                          ? ld2(a.b_src + c)
                          : ld2(a.src + (node0 + src_j[s]) * W + c);
    const float2 dv = ld2(a.dst + (node0 + dst_i[s]) * W + c);
    const float z0 = EMLP ? acc[2 * p] + b.x + sv.x + dv.x
                          : acc[2 * p] + sv.x + dv.x;
    const float z1 = EMLP ? acc[2 * p + 1] + b.y + sv.y + dv.y
                          : acc[2 * p + 1] + sv.y + dv.y;
    if constexpr (THETA) {
      tc::store_pair(sm.a, f, p, act(z0), act(z1));
    } else {
      acc[2 * p] = z0;
      acc[2 * p + 1] = z1;
    }
  }
  if constexpr (THETA) {
    activations_ready();
    sm.product(acc, t1, f.wg);
    sm.release(&wmap, t1);
#pragma unroll
    for (int p = 0; p < tc::PAIRS; ++p) {
      const float2 b = ld2(a.b_t1 + f.col(p));
      tc::store_pair(sm.a, f, p, act(acc[2 * p] + b.x),
                     act(acc[2 * p + 1] + b.y));
    }
    activations_ready();
    sm.product(acc, t1 + 1, f.wg);
  }
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    const int s = p & 1, c = f.col(p);
    if (!t.live[s]) continue;
    const float2 b = THETA ? ld2(a.b_t2 + c) : make_float2(0.f, 0.f);
    const float2 hv = ld2(a.hn + (node0 + src_j[s]) * W + c);
    *reinterpret_cast<float2*>(a.msg + t.row[s] * W + c) =
        THETA ? make_float2(hv.x * (acc[2 * p] + b.x),
                            hv.y * (acc[2 * p + 1] + b.y))
              : make_float2(hv.x * acc[2 * p], hv.y * acc[2 * p + 1]);
  }
}

// Shared memory of a stage kernel above 48 KB, set once per process.
template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
