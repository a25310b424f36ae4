// Whole-model GAMD forward for Hopper (sm_90a): wrapped positions, a
// build-time neighbour list and packed weights in, per-atom forces out.
//
// Replaces gamd_tpu/ops/pallas_model.py::_mega_kernel (line 677; its body is
// _forward_body, lines 291-600), reached through mega_forward there. It
// computes the same function: min-image geometry in round form, the live
// mask (build mask and d^2 < cutoff^2), RBF + rank-1 geometric terms into
// the tanh-gelu encoder MLP and the edge LayerNorm, L edge-gated conv
// layers (pre-norm LayerNorm or folded BatchNorm, silu), and the tanh-gelu
// decoder whose last affine already holds the force denormalisation. Like
// the TPU kernel (grid = replicas), it takes R independent systems in one
// call.
//
// The design, stage by stage (launches of one forward of any R, 12 at L=4;
// the host entry gamd_mega_forward adds the weight split, so 13 a call,
// and the MD window, mega_md_steps.cu, splits once a window):
// 1. live_kernel (a thread a slot): the live mask of every slot; then
//    layout_kernel (grid R): per-atom live counts, an exclusive scan in a
//    fixed order, and the compacted list of live slots, atom-major and in
//    slot order within an atom (gamd_tpu_torch/ops/mega.py::
//    live_edge_layout is its plain version, equal to it). Replica r's list
//    starts at row r * cap; it is cut into tiles of 64 rows that never
//    cross a replica.
// 2. encode_tile_kernel (grid tiles x R, a block a tile): per tile of 64
//    live edges the geometry, the RBF over the model's n_rbf centres
//    (rounded up to the tensor core's depth of 16) and the two MLP
//    products on the tensor cores, the rank-1 terms, gelu and the
//    LayerNorm with its affine in fp32 epilogues; it writes the embedding
//    of live edges only.
// 3. node_fused_kernel (node_fused.cuh), once before the first layer: h =
//    h0 and the first layer's norm, src and dst codes.
// 4. per layer, edge_tile_kernel (grid tiles x R): per tile the four edge
//    products W_e1, W_e2, W_t1, W_t2 on the tensor cores (edge_tc.cuh:
//    wgmma, bf16 x 3, fp32 accumulation: JAX's edge_hilo arithmetic),
//    silu, the `+ src[j] + dst[i]` add and the gated product
//    hn[j] * g in fp32 epilogues, and one message row per live edge; then
//    node_fused_kernel: the update (the atom's message rows summed in
//    compacted order, a fixed order, no atomics), then the next layer's
//    norm and codes in the same launch, or the decoder after the last.
// Tiles past a replica's live count exit at once: dead slots cost a thread
// of the live-flag kernel and nothing else. Every kernel after the split
// is launched with programmatic dependent launch: its blocks start while
// the previous kernel finishes and wait for it (griddepcontrol) before
// reading what it wrote; a node block stages its first weights before that
// wait, and the node prologue, which reads only h0 and weights, runs beside
// the encoder and waits for it at its end.
//
// Shared memory: a tile block (256 threads, its two warpgroups splitting
// the tile's 128 output columns, wgmma m64n64k16 each) holds two split
// weights (hi + lo bf16, 64 KB each), staged by TMA (cp.async.bulk.tensor,
// 128-byte swizzle, one mbarrier a buffer), the next weight in flight
// while the current one computes, and the tile's activations as bf16 hi +
// lo (32 KB), which each epilogue writes in the layout wgmma reads: 161 KB
// of dynamic shared memory, above the 48 KB default, one block an SM. When
// the tiles outnumber twice the SMs (8 replicas), a block holds one weight
// buffer (97 KB), so that two blocks share an SM and hide each other's
// waits. A node block holds two fp32 weights (128 KB) and two activation
// tiles.
//
// What bounds it on this card: per force call at LJ-258 (N=258, K=48,
// widths 128, L=4, 40 RBF centres) a 100 K frame has about 5,500 live
// edges of the 12,384 slots. The edge products (RBF, two encoder, four a
// layer: about 300k multiply-adds a live edge) run as three bf16 passes,
// about 9.9 GFLOP against the 989 TFLOP/s bf16 tensor peak (10 us); the
// node products (about 0.18 GFLOP) and the epilogues' fp32 arithmetic run
// on the CUDA cores against the 67 TFLOP/s fp32 peak (about 3 us); the
// compulsory bytes (weights and inputs read once, about 2.3 MB) take under
// 1 us. So about 13 us a forward: operations-bound. What bounds the design
// instead is latency: a tile's products and epilogues run in sequence on
// one SM (two warpgroups, one or two blocks an SM for their shared
// memory), each tile loads 256 KB of weights a layer from L2, every node
// block reads all of its layer's node weights (320 KB), and 12 launches
// depend on each other. chip_smoke.py computes the bound from each run's
// live edges.
//
// Every atom's arithmetic is the same whichever tile or block holds it and
// at any R (a replica's list has the same tiles as a single call's; a node
// block's width B does not enter an atom's sums), so each replica's forces
// equal those of a single call bit for bit, and two runs give the same
// bits. The host passes every pointer, allocates all scratch with
// torch.empty and launches on PyTorch's current stream.

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

namespace {

// A launch on `stream` with programmatic dependent launch: the kernel's
// blocks may start while the previous kernel finishes (each kernel here
// waits for it, tc::grid_wait, before reading what it wrote).
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, dim3 block,
                   size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

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
      launch(live_kernel, dim3((n * k + LIVE_THREADS - 1) / LIVE_THREADS, r),
             dim3(LIVE_THREADS), 0, stream, pos, idx, bmask, n, k, box,
             cutoff2, s->live);
  if (err != cudaSuccess) return err;
  const int chunk = layout_chunk(k);
  return launch(layout_kernel, dim3(r), dim3(LAYOUT_THREADS), chunk * k,
                stream, static_cast<const uint8_t*>(s->live), n, k,
                layout_cap(n, k), chunk, s->slot, s->off, s->cnt, s->total);
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

__device__ __forceinline__ float2 ld2(const float* __restrict__ p) {
  return *reinterpret_cast<const float2*>(p);
}

// silu of the edge epilogues with the fast exponential and division: their
// float32 error stays far below the products' bf16 x 3 error of 2^-16.
__device__ __forceinline__ float silu_fast(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

// A tile block's shared memory and weight ring: NBUF buffers of split
// weights (product p reads buffer p % NBUF; with two, the next weight
// loads while the current one computes), then the activation buffer, all
// 1024-byte aligned. Weights m0 .. m0 + n_mats - 1 are the products' in
// order.
template <int NBUF>
struct TileSmem {
  uint32_t w;      // weight buffer 0 (shared address); the others follow
  uint32_t a_s;    // the activation buffer's shared address
  uint8_t* a;      // and a generic pointer to it
  uint32_t bar;    // mbarrier of weight buffer 0; the others' follow
  int m0, n_mats;

  // Barrier setup and the first NBUF weights, by thread 0. The caller
  // syncs before waiting on them.
  __device__ __forceinline__ TileSmem(uint8_t* smem, uint64_t* bars,
                                      const CUtensorMap* map, int first,
                                      int count)
      : m0(first), n_mats(count) {
    const uint32_t base = tc::smem_addr(smem);
    w = (base + 1023u) & ~1023u;
    a_s = w + NBUF * tc::SPLIT_BYTES;
    a = smem + (a_s - base);
    bar = tc::smem_addr(bars);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int b = 0; b < NBUF; ++b) tc::mbar_init(bar + 8 * b, 1);
      tc::mbar_init_fence();
#pragma unroll
      for (int b = 0; b < NBUF; ++b)
        tc::load_split(w + b * tc::SPLIT_BYTES, map, bar + 8 * b, m0 + b);
    }
  }

  // Product p of the calling warpgroup, once its weight has landed.
  __device__ __forceinline__ void product(float (&acc)[2 * tc::PAIRS],
                                          int p, int wg,
                                          int ksteps = 8) const {
    tc::mbar_wait(bar + 8 * (p % NBUF), (p / NBUF) & 1);
    tc::product_x3(acc, a_s, w + (p % NBUF) * tc::SPLIT_BYTES, wg, ksteps);
  }

  // After product p: both warpgroups are done with the activations and
  // with p's buffer; thread 0 refills the buffer with weight p + NBUF.
  __device__ __forceinline__ void release(const CUtensorMap* map,
                                          int p) const {
    __syncthreads();
    const int next = p + NBUF;
    if (threadIdx.x == 0 && next < n_mats)
      tc::load_split(w + (p % NBUF) * tc::SPLIT_BYTES, map,
                     bar + 8 * (p % NBUF), m0 + next);
  }
};

// The activations are written: make them visible to the tensor cores and
// to the other warpgroup.
__device__ __forceinline__ void activations_ready() {
  tc::proxy_fence();
  __syncthreads();
}

struct EncArgs {
  const float* pos;
  const int *idx, *slot, *total;
  const float *centers, *w_geo, *b0, *b1, *b2, *eln_s, *eln_b;
  float* e;
  int n, k, cap, n_rbf, flip_dir;
  float box, length_mean, length_std, gamma;
};

// Encoder over live edges. grid (cap / 64, R), block 256 (one tile, its
// columns split between the two warpgroups), tc::smem_bytes(NBUF) of
// dynamic shared memory; split weights 0 (w_rbf), 1 (w1), 2 (w2).
template <int NBUF>
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
  const TileSmem<NBUF> sm(tile_smem, bars, &wmap, 0, 3);
  const tc::Frag f;
  const TileRows t = tile_rows(f, a.slot, a.idx, rep, row0, count, a.n, a.k,
                               a.cap);
  float geo[2][4];   // ux, uy, uz, standardised distance of each row
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float* pi = a.pos + ((size_t)rep * a.n + t.i[s]) * 3;
    const float* pj = a.pos + ((size_t)rep * a.n + t.j[s]) * 3;
    float rx = pj[0] - pi[0], ry = pj[1] - pi[1], rz = pj[2] - pi[2];
    rx -= a.box * rintf(rx / a.box);
    ry -= a.box * rintf(ry / a.box);
    rz -= a.box * rintf(rz / a.box);
    const float dist = sqrtf(rx * rx + ry * ry + rz * rz);
    const float inv = (a.flip_dir ? -1.0f : 1.0f) / (dist + 1e-8f);
    geo[s][0] = rx * inv;
    geo[s][1] = ry * inv;
    geo[s][2] = rz * inv;
    geo[s][3] = (dist - a.length_mean) / a.length_std;
  }
  // RBF operand: column c < n_rbf holds exp(-gamma (std - centre_c)^2).
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    float v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = f.col(p) + u;
      const float d = geo[p & 1][3] - a.centers[c];
      v[u] = c < a.n_rbf ? expf(-a.gamma * d * d) : 0.f;
    }
    tc::store_pair(sm.a, f, p, v[0], v[1]);
  }
  activations_ready();

  float acc[2 * tc::PAIRS];
  sm.product(acc, 0, f.wg, (a.n_rbf + 15) / 16);
  sm.release(&wmap, 0);
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    const int c = f.col(p), s = p & 1;
    float v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      v[u] = gelu_tanh(acc[2 * p + u] + geo[s][0] * a.w_geo[c + u] +
                       geo[s][1] * a.w_geo[W + c + u] +
                       geo[s][2] * a.w_geo[2 * W + c + u] +
                       geo[s][3] * a.w_geo[3 * W + c + u] + a.b0[c + u]);
    tc::store_pair(sm.a, f, p, v[0], v[1]);
  }
  activations_ready();
  sm.product(acc, 1, f.wg);
  sm.release(&wmap, 1);
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    const float2 b = ld2(a.b1 + f.col(p));
    tc::store_pair(sm.a, f, p, gelu_tanh(acc[2 * p] + b.x),
                   gelu_tanh(acc[2 * p + 1] + b.y));
  }
  activations_ready();
  sm.product(acc, 2, f.wg);

  // + b2, then LayerNorm of each row over its 128 values: the quad's four
  // threads of each warpgroup, then the two warpgroups, in a fixed order.
  float stat[2] = {0.f, 0.f};
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    const float2 b = ld2(a.b2 + f.col(p));
    acc[2 * p] += b.x;
    acc[2 * p + 1] += b.y;
    stat[p & 1] += acc[2 * p] + acc[2 * p + 1];
  }
  float mean[2], rstd[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    stat[s] += __shfl_xor_sync(0xffffffffu, stat[s], 1);
    stat[s] += __shfl_xor_sync(0xffffffffu, stat[s], 2);
    if (f.q == 0) red[0][f.wg][f.r0 + 8 * s] = stat[s];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r = f.r0 + 8 * s;
    mean[s] = (red[0][0][r] + red[0][1][r]) * (1.0f / W);
    stat[s] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    acc[2 * p] -= mean[p & 1];
    acc[2 * p + 1] -= mean[p & 1];
    stat[p & 1] += acc[2 * p] * acc[2 * p] + acc[2 * p + 1] * acc[2 * p + 1];
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    stat[s] += __shfl_xor_sync(0xffffffffu, stat[s], 1);
    stat[s] += __shfl_xor_sync(0xffffffffu, stat[s], 2);
    if (f.q == 0) red[1][f.wg][f.r0 + 8 * s] = stat[s];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r = f.r0 + 8 * s;
    rstd[s] = rsqrtf((red[1][0][r] + red[1][1][r]) * (1.0f / W) + LN_EPS);
  }
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    const int s = p & 1, c = f.col(p);
    if (!t.live[s]) continue;
    const float2 sc = ld2(a.eln_s + c), sh = ld2(a.eln_b + c);
    *reinterpret_cast<float2*>(a.e + t.row[s] * W + c) =
        make_float2(acc[2 * p] * rstd[s] * sc.x + sh.x,
                    acc[2 * p + 1] * rstd[s] * sc.y + sh.y);
  }
}

struct EdgeArgs {
  const int *idx, *slot, *total;
  const float *e, *hn, *src, *dst;
  const float *b_e1, *b_e2, *b_t1, *b_t2;   // the layer's biases
  float* msg;
  int n, k, cap;
};

// Edge stage of one layer over live edges. grid (cap / 64, R), block 256
// (one tile, its columns split between the two warpgroups),
// tc::smem_bytes(NBUF) of dynamic shared memory; split weights m0 .. m0 +
// 3 are the layer's W_e1, W_e2, W_t1, W_t2.
//   z = silu(e @ W_e1 + b) @ W_e2 + b + src[j] + dst[i]
//   g = silu(silu(z) @ W_t1 + b) @ W_t2 + b
//   msg[row] = hn[j] * g
template <int NBUF>
__global__ void __launch_bounds__(tc::THREADS, 3 - NBUF)
edge_tile_kernel(const __grid_constant__ CUtensorMap wmap, EdgeArgs a,
                 int m0) {
  tc::let_next_start();
  tc::grid_wait();
  const int rep = blockIdx.y, row0 = blockIdx.x * tc::TILE;
  const int count = a.total[rep];
  if (row0 >= count) return;
  extern __shared__ uint8_t tile_smem[];
  __shared__ __align__(8) uint64_t bars[2];
  const TileSmem<NBUF> sm(tile_smem, bars, &wmap, m0, 4);
  const tc::Frag f;
  const TileRows t = tile_rows(f, a.slot, a.idx, rep, row0, count, a.n, a.k,
                               a.cap);
  const size_t node0 = (size_t)rep * a.n;
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    const int s = p & 1;
    const float2 v = t.live[s] ? ld2(a.e + t.row[s] * W + f.col(p))
                               : make_float2(0.f, 0.f);
    tc::store_pair(sm.a, f, p, v.x, v.y);
  }
  activations_ready();

  float acc[2 * tc::PAIRS];
  sm.product(acc, 0, f.wg);
  sm.release(&wmap, 0);
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    const float2 b = ld2(a.b_e1 + f.col(p));
    tc::store_pair(sm.a, f, p, silu_fast(acc[2 * p] + b.x),
                   silu_fast(acc[2 * p + 1] + b.y));
  }
  activations_ready();
  sm.product(acc, 1, f.wg);
  sm.release(&wmap, 1);
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    const int s = p & 1, c = f.col(p);
    const float2 b = ld2(a.b_e2 + c);
    const float2 sv = ld2(a.src + (node0 + t.j[s]) * W + c);
    const float2 dv = ld2(a.dst + (node0 + t.i[s]) * W + c);
    tc::store_pair(sm.a, f, p, silu_fast(acc[2 * p] + b.x + sv.x + dv.x),
                   silu_fast(acc[2 * p + 1] + b.y + sv.y + dv.y));
  }
  activations_ready();
  sm.product(acc, 2, f.wg);
  sm.release(&wmap, 2);
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    const float2 b = ld2(a.b_t1 + f.col(p));
    tc::store_pair(sm.a, f, p, silu_fast(acc[2 * p] + b.x),
                   silu_fast(acc[2 * p + 1] + b.y));
  }
  activations_ready();
  sm.product(acc, 3, f.wg);
#pragma unroll
  for (int p = 0; p < tc::PAIRS; ++p) {
    const int s = p & 1, c = f.col(p);
    if (!t.live[s]) continue;
    const float2 b = ld2(a.b_t2 + c);
    const float2 hv = ld2(a.hn + (node0 + t.j[s]) * W + c);
    *reinterpret_cast<float2*>(a.msg + t.row[s] * W + c) =
        make_float2(hv.x * (acc[2 * p] + b.x), hv.y * (acc[2 * p + 1] + b.y));
  }
}

// Dynamic shared memory above 48 KB, set once per process.
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaFuncAttribute max_smem =
      cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(encode_tile_kernel<1>, max_smem,
                                  tc::smem_bytes(1))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(encode_tile_kernel<2>, max_smem,
                                  tc::smem_bytes(2))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(edge_tile_kernel<1>, max_smem,
                                  tc::smem_bytes(1))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(edge_tile_kernel<2>, max_smem,
                                  tc::smem_bytes(2))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(node_fused_kernel<4>, max_smem,
                                  node_smem_bytes(4))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(node_fused_kernel<8>, max_smem,
                                  node_smem_bytes(8))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(node_fused_kernel<16>, max_smem,
                                  node_smem_bytes(16))) != cudaSuccess)
    return err;
  done = true;
  return cudaSuccess;
}

// The card's SM count, read once.
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// Atoms a node block takes: the smallest of 4, 8, 16 whose grid fits in
// one wave (one block an SM: their 128 KB of weights leave room for no
// second).
int node_width(int atoms) {
  for (int b = NODE_MIN_B; b < NODE_MAX_B; b *= 2)
    if ((atoms + b - 1) / b <= sm_count()) return b;
  return NODE_MAX_B;
}

// Weight buffers of a tile block. Two (161 KB: one block an SM) load the
// next weight while the current one computes; one (97 KB) lets two blocks
// share an SM and hide each other's waits, which pays once the tiles
// outnumber the SMs. The grid's tile count bounds the live tiles.
int tile_buffers(int tiles) { return tiles > 2 * sm_count() ? 1 : 2; }

cudaError_t launch_node(const NodeArgs& na, int layer, int b,
                        cudaStream_t s) {
  const dim3 blocks((na.atoms + b - 1) / b);
  switch (b) {
    case 4:
      return launch(node_fused_kernel<4>, blocks, dim3(W), node_smem_bytes(4),
                    s, na, layer);
    case 8:
      return launch(node_fused_kernel<8>, blocks, dim3(W), node_smem_bytes(8),
                    s, na, layer);
    default:
      return launch(node_fused_kernel<16>, blocks, dim3(W),
                    node_smem_bytes(16), s, na, layer);
  }
}

}  // namespace

int mega_split_weights(const MegaWeights* weights, int n_layers,
                       const MegaScratch* s, CUtensorMap* map,
                       cudaStream_t stream) {
  const int n_mats = 3 + 4 * n_layers;
  split_weights_kernel<<<dim3(n_mats, W / 32), dim3(32, 8), 0, stream>>>(
      *weights, static_cast<__nv_bfloat16*>(s->wsplit));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(n_mats) * 2 * W};
  const cuuint64_t strides[1] = {W * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(W)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, s->wsplit, dims, strides,
      box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 100000 + static_cast<int>(res);
}

int mega_forward_run(const float* pos, const int* idx, const uint8_t* bmask,
                     const float* h0, const MegaWeights* weights,
                     const CUtensorMap* map, int r, int n, int k,
                     int n_layers, int n_rbf, int use_ln, int flip_dir,
                     float box, float cutoff2, float length_mean,
                     float length_std, float gamma, const MegaScratch* s,
                     float* out, cudaStream_t stream) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  const MegaWeights& p = *weights;
  const int cap = layout_cap(n, k);
  const dim3 tiles(cap / tc::TILE, r);

  if ((err = launch_layout(pos, idx, bmask, r, n, k, box, cutoff2, s,
                           stream)) != cudaSuccess)
    return static_cast<int>(err);

  const EncArgs ea{pos, idx, s->slot, s->total, p.centers, p.w_geo, p.b0,
                   p.b1, p.b2, p.eln_s, p.eln_b, s->e, n, k, cap, n_rbf,
                   flip_dir, box, length_mean, length_std, gamma};
  const bool one = tile_buffers(tiles.x * tiles.y) == 1;
  err = one ? launch(encode_tile_kernel<1>, tiles, dim3(tc::THREADS),
                     tc::smem_bytes(1), stream, *map, ea)
            : launch(encode_tile_kernel<2>, tiles, dim3(tc::THREADS),
                     tc::smem_bytes(2), stream, *map, ea);
  if (err != cudaSuccess) return static_cast<int>(err);

  const NodeArgs na{p, h0, s->off, s->cnt, s->msg, s->h, s->hn, s->src,
                    s->dst, out, r * n, n, cap, n_layers, use_ln};
  const int b = node_width(r * n);
  if ((err = launch_node(na, -1, b, stream)) != cudaSuccess)
    return static_cast<int>(err);
  for (int layer = 0; layer < n_layers; ++layer) {
    const size_t lb = (size_t)layer * W;
    const EdgeArgs ga{idx, s->slot, s->total, s->e, s->hn, s->src, s->dst,
                      p.b_e1 + lb, p.b_e2 + lb, p.b_t1 + lb, p.b_t2 + lb,
                      s->msg, n, k, cap};
    err = one ? launch(edge_tile_kernel<1>, tiles, dim3(tc::THREADS),
                       tc::smem_bytes(1), stream, *map, ga, 3 + 4 * layer)
              : launch(edge_tile_kernel<2>, tiles, dim3(tc::THREADS),
                       tc::smem_bytes(2), stream, *map, ga, 3 + 4 * layer);
    if (err != cudaSuccess) return static_cast<int>(err);
    if ((err = launch_node(na, layer, b, stream)) != cudaSuccess)
      return static_cast<int>(err);
  }
  return 0;
}

// One forward of r replicas of n atoms on `stream` (arrays [r, n, ...],
// replica-major): the weight split, then mega_forward_run. Returns 0, a
// cudaError_t, or 100000 + the CUresult of the TMA map's encoding.
extern "C" int gamd_mega_forward(
    const float* pos, const int* idx, const uint8_t* bmask, const float* h0,
    const MegaWeights* weights, int r, int n, int k, int n_layers, int n_rbf,
    int use_ln, int flip_dir, float box, float cutoff2, float length_mean,
    float length_std, float gamma, const MegaScratch* scratch, float* out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map;
  const int err = mega_split_weights(weights, n_layers, scratch, &map, s);
  if (err != 0) return err;
  return mega_forward_run(pos, idx, bmask, h0, weights, &map, r, n, k,
                          n_layers, n_rbf, use_ln, flip_dir, box, cutoff2,
                          length_mean, length_std, gamma, scratch, out, s);
}

// The live-edge layout alone (stage 1) into scratch->live, slot, off, cnt
// and total. Returns 0 or the cudaError_t of a launch.
extern "C" int gamd_mega_layout(const float* pos, const int* idx,
                                const uint8_t* bmask, int r, int n, int k,
                                float box, float cutoff2,
                                const MegaScratch* s, void* stream) {
  return static_cast<int>(launch_layout(pos, idx, bmask, r, n, k, box,
                                        cutoff2, s,
                                        static_cast<cudaStream_t>(stream)));
}
