// Tensor-core building blocks of the port's edge-tile kernels (the
// whole-model forward's, mega_forward.cu, and the conv message's,
// conv_tc.cuh): a tile of 64 rows (live edges) times a 128 x 128 fp32
// weight, fp32-faithful on the bf16 tensor cores.
//
// The product is JAX's edge_hilo arithmetic (gamd_tpu/ops/pallas_model.py
// :359-381): both operands split into bf16 hi + lo parts, x = hi + lo with
// lo = bf16(x - hi), and three bf16 passes with fp32 accumulation,
//   a w ~ a_hi w_hi + a_hi w_lo + a_lo w_hi
// (lo x lo, about 2^-18 of |a||w|, is dropped): about 2^-16 relative, the
// fp32 function to the tolerances the port holds. Not TF32: the physics
// stays out of TF32 (ROADMAP), and TF32's 10-bit mantissa is coarser than
// the split. Not single-pass bf16 either: that is JAX's f32_edges=False
// mode, a different function from the fp32 one the port computes.
//
// A block takes one tile of 64 rows with two warpgroups (256 threads):
// warpgroup w computes output columns [64 w, 64 w + 64) of every product,
// wgmma.m64n64k16 with both operands in shared memory, so that a tile's
// products and epilogues are split across twice the threads and a tile
// needs one SM, not two tiles' worth of one.
// * A: the tile's activations [64 rows][128 in] as bf16 hi and lo, each two
//   64-column halves of 8 KB in the 128-byte swizzled K-major layout (row r
//   at 128 r bytes, its 16-byte chunk c at chunk c ^ (r % 8)). An epilogue
//   writes its warpgroup's columns, which are exactly one half.
// * Accumulator fragments: thread (warp w of its warpgroup, lane l, q = l %
//   4) holds rows r0 = 16 w + l / 4 and r1 = r0 + 8; pair p (0..15) is row
//   (p odd ? r1 : r0), columns 8 (p / 2) + 2 q + {0, 1} of the
//   warpgroup's 64, at acc[2p], acc[2p + 1].
// * B: a split weight, [hi | lo], each part W^T [128 out][128 in] as two
//   64-column halves of 16 KB in the same swizzled layout, which TMA
//   writes (cp.async.bulk.tensor, box {64, 128}, SWIZZLE_128B); warpgroup
//   w reads rows [64 w, 64 w + 64) of it. Buffers are 1024-byte aligned.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int TILE = 64;                        // rows a tile (wgmma M)
constexpr int WIDTH = 128;                      // every feature width
constexpr int THREADS = 256;                    // two warpgroups a block
constexpr int PAIRS = 16;                       // fp32 pairs a thread holds
constexpr int HALF_BYTES = WIDTH * 64 * 2;      // weight half, 16 KB
constexpr int PART_BYTES = 2 * HALF_BYTES;      // weight hi or lo, 32 KB
constexpr int SPLIT_BYTES = 2 * PART_BYTES;     // weight hi + lo, 64 KB
constexpr int A_HALF_BYTES = TILE * 64 * 2;     // activation half, 8 KB
constexpr int A_PART_BYTES = 2 * A_HALF_BYTES;  // activation hi or lo
constexpr int A_BYTES = 2 * A_PART_BYTES;       // activation hi + lo, 32 KB
// Dynamic shared memory of a tile block with `nbuf` weight buffers: the
// buffers, the activation buffer, and room to align them.
constexpr int smem_bytes(int nbuf) {
  return nbuf * SPLIT_BYTES + A_BYTES + 1024;
}

// Fragment coordinates of the calling thread: its warpgroup wg, rows r0
// and r0 + 8, and the tile column of pair p.
struct Frag {
  int wg, r0, q;
  __device__ __forceinline__ Frag() {
    const int lane = threadIdx.x & 31;
    wg = threadIdx.x >> 7;
    r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    q = lane & 3;
  }
  __device__ __forceinline__ int row(int p) const { return r0 + 8 * (p & 1); }
  __device__ __forceinline__ int col(int p) const {
    return 64 * wg + 8 * (p >> 1) + 2 * q;
  }
};

// a = hi + lo, both bf16 pairs packed (the lower column in the low half).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Pair p of the calling thread (columns f.col(p), f.col(p) + 1) into the
// activation buffer `a` (a generic pointer to shared memory) as hi and lo.
__device__ __forceinline__ void store_pair(uint8_t* a, const Frag& f, int p,
                                           float x0, float x1) {
  uint32_t hi, lo;
  split2(x0, x1, hi, lo);
  const int row = f.row(p);
  const int off = f.wg * A_HALF_BYTES + row * 128 +
                  ((((p >> 1) ^ (row & 7)) << 4) | (4 * f.q));
  *reinterpret_cast<uint32_t*>(a + off) = hi;
  *reinterpret_cast<uint32_t*>(a + A_PART_BYTES + off) = lo;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Orders this thread's earlier shared-memory accesses before later
// asynchronous-proxy (TMA) writes to the same buffer.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One thread: split weight `m` (rows (2m + part) * 128 of the split table,
// hi then lo) into the buffer at `dst`, completing on `bar`.
__device__ __forceinline__ void load_split(uint32_t dst,
                                           const CUtensorMap* map,
                                           uint32_t bar, int m) {
  mbar_expect(bar, SPLIT_BYTES);
#pragma unroll
  for (int part = 0; part < 2; ++part)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      tma_load_2d(dst + part * PART_BYTES + half * HALF_BYTES, map, bar,
                  half * 64, (2 * m + part) * WIDTH);
}

// One thread: `bytes` (a multiple of 16) of contiguous global memory into
// shared memory at `dst`, completing on `bar` (expect_tx set by the
// caller).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// Programmatic dependent launch: a kernel launched with it may start while
// the previous kernel on the stream finishes; grid_wait() waits for that
// kernel's completion and memory, and let_next_start() lets the next
// kernel start early. Without the launch attribute both are no-ops.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor: 128-byte swizzle, K-major, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of the accumulator across the
// asynchronous wgmma boundary.
__device__ __forceinline__ void fence_acc(float (&d)[2 * PAIRS]) {
#pragma unroll
  for (int i = 0; i < 2 * PAIRS; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B for one k-step: A [64 x 16] and B [16 x 64] bf16 from shared
// memory descriptors, fp32 accumulation.
__device__ __forceinline__ void wgmma_ss(float (&d)[2 * PAIRS], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// acc = A W for the calling warpgroup's 64 output columns over `ksteps`
// k-steps (16 deep each, at most 8), bf16 x 3: a_hi w_hi, then a_hi w_lo,
// then a_lo w_hi, all into one fp32 accumulator. `a` is the activation
// buffer, `w` the buffer of a split weight ([hi | lo]), both shared-memory
// addresses; the activations must be written and fenced (proxy_fence,
// then a barrier) before. ksteps is the same in every thread.
__device__ __forceinline__ void product_x3(float (&acc)[2 * PAIRS],
                                           uint32_t a, uint32_t w, int wg,
                                           int ksteps = 8) {
#pragma unroll
  for (int i = 0; i < 2 * PAIRS; ++i) acc[i] = 0.f;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t a_part = a + (pass == 2 ? A_PART_BYTES : 0);
    const uint32_t w_part = w + (pass == 1 ? PART_BYTES : 0) + wg * 8192;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      if (kk < ksteps)
        wgmma_ss(acc,
                 desc_sw128(a_part + (kk >> 2) * A_HALF_BYTES + (kk & 3) * 32),
                 desc_sw128(w_part + (kk >> 2) * HALF_BYTES + (kk & 3) * 32));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(acc);
}

// ---------------------------------------------------------------------------
// Shared by the tile kernels (mega_forward.cu's, conv_tc.cuh's)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 ld2(const float* __restrict__ p) {
  return *reinterpret_cast<const float2*>(p);
}

// silu of the edge epilogues with the fast exponential and division: their
// float32 error stays far below the products' bf16 x 3 error of 2^-16.
__device__ __forceinline__ float silu_fast(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

// The activations are written: make them visible to the tensor cores and
// to the other warpgroup.
__device__ __forceinline__ void activations_ready() {
  proxy_fence();
  __syncthreads();
}

// A tile block's shared memory and weight ring: NBUF buffers of split
// weights, then the activation buffer, all 1024-byte aligned. Product p
// (p < n_products) reads split weight m0 + p % period from buffer p % NBUF;
// with two buffers the next weight loads while the current one computes.
// A block that runs its products over several tiles has the ring run on
// from one tile into the next (period: the products of a tile).
template <int NBUF>
struct WeightRing {
  uint32_t w;      // weight buffer 0 (shared address); the others follow
  uint32_t a_s;    // the activation buffer's shared address
  uint8_t* a;      // and a generic pointer to it
  uint32_t bar;    // mbarrier of weight buffer 0; the others' follow
  int m0, period, n_products;

  // Barrier setup and the first NBUF weights (fewer when the block runs
  // fewer products), by thread 0. The caller syncs before waiting on them.
  __device__ __forceinline__ WeightRing(uint8_t* smem, uint64_t* bars,
                                        const CUtensorMap* map, int first,
                                        int per_tile, int count)
      : m0(first), period(per_tile), n_products(count) {
    const uint32_t base = smem_addr(smem);
    w = (base + 1023u) & ~1023u;
    a_s = w + NBUF * SPLIT_BYTES;
    a = smem + (a_s - base);
    bar = smem_addr(bars);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int b = 0; b < NBUF; ++b) mbar_init(bar + 8 * b, 1);
      mbar_init_fence();
#pragma unroll
      for (int b = 0; b < NBUF; ++b)
        if (b < n_products)
          load_split(w + b * SPLIT_BYTES, map, bar + 8 * b, m0 + b % period);
    }
  }

  // Product p of the calling warpgroup, once its weight has landed.
  __device__ __forceinline__ void product(float (&acc)[2 * PAIRS], int p,
                                          int wg, int ksteps = 8) const {
    mbar_wait(bar + 8 * (p % NBUF), (p / NBUF) & 1);
    product_x3(acc, a_s, w + (p % NBUF) * SPLIT_BYTES, wg, ksteps);
  }

  // After product p: both warpgroups are done with the activations and
  // with p's buffer; thread 0 refills the buffer with product p + NBUF's
  // weight.
  __device__ __forceinline__ void release(const CUtensorMap* map,
                                          int p) const {
    __syncthreads();
    const int next = p + NBUF;
    if (threadIdx.x == 0 && next < n_products)
      load_split(w + (p % NBUF) * SPLIT_BYTES, map, bar + 8 * (p % NBUF),
                 m0 + next % period);
  }
};

// A launch on `stream` with programmatic dependent launch: the kernel's
// blocks may start while the previous kernel finishes (each kernel so
// launched waits for it, grid_wait, before reading what it wrote).
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
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

// The card's SM count, read once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// A launch of a persistent tile kernel (conv_tc.cuh's, edge_encoder.cu's;
// ops/edge_tiles.py::launch_plan): `grid` blocks of `threads` threads with
// `smem` bytes of dynamic shared memory and `nbuf` weight buffers.
struct TilePlan {
  int grid, threads, smem, nbuf;
};

// Tiles of 64 rows that M atoms of K slots may need: ceil(M*K / 64).
inline long long tile_capacity(int m, int k) {
  return ((long long)m * k + TILE - 1) / TILE;
}

// The plan's check (ops/edge_tiles.py::check_plan): 256 threads, one or
// two weight buffers with their shared memory, and 1 to the least of the
// tiles and the blocks the card holds at once (3 - nbuf an SM).
inline bool plan_ok(const TilePlan& p, int m, int k) {
  if (p.threads != THREADS || (p.nbuf != 1 && p.nbuf != 2)
      || p.smem != smem_bytes(p.nbuf))
    return false;
  const long long most = (long long)(3 - p.nbuf) * sm_count();
  const long long tiles = tile_capacity(m, k);
  return p.grid >= 1 && p.grid <= (tiles < most ? tiles : most);
}

// The TMA map over a split table of n_mats weights ([2 n_mats * 128][128]
// bf16, each W^T hi then lo): boxes of 64 x 128 with the 128-byte swizzle
// (the B layout above). Returns 0, or 100000 + the CUresult.
inline int encode_split_map(void* table, int n_mats, CUtensorMap* map) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(WIDTH),
                              static_cast<cuuint64_t>(n_mats) * 2 * WIDTH};
  const cuuint64_t strides[1] = {WIDTH * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(WIDTH)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, table, dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 100000 + static_cast<int>(res);
}

}  // namespace tc
