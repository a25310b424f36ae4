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
//     with s32 accumulation (I8_I8, mma.sync m16n8k32 s8), or against the
//     bf16 table (I8_BF16): Hopper has no int8 x bf16 mma, so this form
//     converts the int8 one-hot to bf16 fragments in registers and runs
//     the bf16 mma;
//   * kernel_onehot_banded (line 113): eight tiles of 1,632 rows, each a
//     one-hot over a 16-aligned window of `band` table rows starting at
//     starts[tile] (BAND, band 256 or 208 = 13 k-steps of 16).
// As in the script, the one-hot is filled once before the loop (`fill`,
// lines 67-73) and every iteration adds the carry's data-dependent zero to
// the table (`_dep_scalar`, line 60: 1 when the carry passes 1e30, else 0)
// before the product, then folds the product's full sum into the carry
// (`_acc_update`, line 52).
//
// Design. A block owns 32 edge rows and one half (128 lanes) of the table,
// grid (rows / 32, 2): the whole one-hot (10.0 MB in bf16, 5.0 MB in int8)
// does not fit in a block, so each block keeps its rows' one-hot resident
// in shared memory from the fill on, with its half of the table (or of its
// band window; the int8 table transposed, [lanes][K], because ldmatrix has
// no .trans for 8-bit elements): 129.6 KB for BF16, 117 KB for I8_BF16,
// 64 KB for I8_I8, 86.5 and 70.4 KB for the bands. 8 warps each compute
// 16 rows x 32 lanes by mma.sync (mma.cuh), the table's dependent zero
// added to each B fragment in registers (__hadd2, or __vadd4 on s8). Blocks
// share nothing, so each block carries its own partial: the product's sum
// over its 32 x 128 outputs, in a fixed order (block_sum_into), added into
// its carry every iteration, and the dependent zero read from it. After
// the loop a second launch adds the partials in block order and writes the
// total to out [8, 128] (every element, as the script's carry), so a call
// repeats bit for bit. The total equals JAX's carry up to the order of the
// fp32 sums (exactly for I8_I8 while the sums stay below 2^24).
//
// What bounds it on this card: the products, 2.567 GFLOP an iteration at
// 989 TFLOP/s bf16 (2.595 us), the same at the int8 rate (1.297 us), 1.711
// and 1.390 GFLOP for the bands. On an H100 SXM at 700 W this simple form
// takes 13.9 us an iteration in bf16, 6.7 in int8 x int8 and 7.4 and 5.9
// for the bands (19-24% of the bounds), 22.6 for int8 x bf16, whose
// conversion in registers costs more than the int8 storage saves
// (tools/probe_gather.py, chip_smoke.py). Each iteration waits on one
// block reduction, and every B fragment comes from shared memory.
//
// g_out, when given, receives the last iteration's product [rows, 256]
// fp32 (the gathered rows), so that a check can compare rows and not only
// the carry; timed calls pass none. The host allocates every buffer with
// torch.empty and launches on PyTorch's current stream; the entry returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it does not
// take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 32;              // edge rows per block
constexpr int HALF = 128;           // table lanes per block
constexpr int LANES = 256;          // table lanes (hi|lo packed)
constexpr int THREADS = 256;        // 8 warps: 2 row groups x 4 lane groups
constexpr int NWARPS = THREADS / 32;
constexpr int NT = 4;               // n8 tiles of a warp's 32 lanes
constexpr int MAX_SMEM = 232448;
constexpr float DEP_LIMIT = 1e30f;  // _dep_scalar's threshold

enum Form { BF16 = 0, I8_BF16 = 1, I8_I8 = 2, BAND = 3 };

struct GatherArgs {
  const int* idx;      // [rows] node row of each edge
  const int* starts;   // [rows / tile_rows] window starts (BAND), or null
  const void* tbl;     // [n_pad, 256] bf16, or int8 (I8_I8)
  int rows, n_pad, k, tile_rows, iters;   // k: the one-hot's width
  float* partials;     // [gridDim.x * 2] each block's carry
  float* g_out;        // [rows, 256] last product, or null
};

template <int FORM>
struct Layout {
  static constexpr bool kOhInt8 = FORM == I8_BF16 || FORM == I8_I8;
  static constexpr bool kTblInt8 = FORM == I8_I8;
  // Row strides (elements) of the one-hot tile and of the table tile.
  static __host__ __device__ int ld_oh(int k) {
    return kOhInt8 ? k + 16 : k + 8;
  }
  static __host__ __device__ int ld_tb(int k) {
    return kTblInt8 ? k + 16 : HALF + 8;
  }
  static __host__ __device__ size_t oh_bytes(int k) {
    return (size_t)BM * ld_oh(k) * (kOhInt8 ? 1 : 2);
  }
  static __host__ __device__ size_t tb_bytes(int k) {
    return kTblInt8 ? (size_t)HALF * ld_tb(k) : (size_t)k * ld_tb(k) * 2;
  }
  static size_t smem_bytes(int k) {
    return oh_bytes(k) + tb_bytes(k) + NWARPS * sizeof(float) + 16;
  }
};

// Fragment sums in a fixed order (tile j, then element q).
__device__ __forceinline__ float frag_sum(const float (&c)[NT][4]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) s = __fadd_rn(s, c[j][q]);
  return s;
}
__device__ __forceinline__ int frag_sum(const int (&c)[NT][4]) {
  int s = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) s += c[j][q];
  return s;
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(int v) { return (float)v; }

template <int FORM>
__global__ void __launch_bounds__(THREADS)
onehot_gather_kernel(GatherArgs a) {
  typedef Layout<FORM> L;
  typedef typename std::conditional<FORM == I8_I8, int, float>::type Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = a.k, ldo = L::ld_oh(k), ldt = L::ld_tb(k);
  unsigned char* oh = smem;
  unsigned char* tb = smem + L::oh_bytes(k);
  Acc* red = reinterpret_cast<Acc*>(tb + L::tb_bytes(k));
  float* carry = reinterpret_cast<float*>(red + NWARPS);

  const int row0 = blockIdx.x * BM, lane0 = blockIdx.y * HALF;
  // A window that would leave the table is clamped into it (the script's
  // starts never do), so no read falls outside the table.
  const int s = FORM == BAND
      ? min(max(a.starts[row0 / a.tile_rows], 0), a.n_pad - k) : 0;

  // fill: the block's one-hot rows, and its half of the table (window).
  for (int v = threadIdx.x; v < BM * k; v += THREADS) {
    const int r = v / k, c = v % k;
    const bool hot = c == a.idx[row0 + r] - s;
    if (L::kOhInt8)
      reinterpret_cast<int8_t*>(oh)[r * ldo + c] = hot ? 1 : 0;
    else
      reinterpret_cast<bf16*>(oh)[r * ldo + c] =
          __float2bfloat16_rn(hot ? 1.f : 0.f);
  }
  if (L::kTblInt8) {
    const int8_t* t = static_cast<const int8_t*>(a.tbl);
    for (int v = threadIdx.x; v < k * HALF; v += THREADS) {
      const int r = v / HALF, c = v % HALF;
      reinterpret_cast<int8_t*>(tb)[c * ldt + r] =
          t[(size_t)(s + r) * LANES + lane0 + c];
    }
  } else {
    const bf16* t = static_cast<const bf16*>(a.tbl);
    for (int v = threadIdx.x; v < k * HALF / 8; v += THREADS) {
      const int r = v / (HALF / 8), c = 8 * (v % (HALF / 8));
      *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(tb) + r * ldt + c) =
          *reinterpret_cast<const uint4*>(t + (size_t)(s + r) * LANES
                                          + lane0 + c);
    }
  }
  if (threadIdx.x == 0) *carry = 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = 16 * (warp >> 2), n0 = 32 * (warp & 3);
  const int g = lane >> 2, t4 = lane & 3;
  for (int it = 0; it < a.iters; ++it) {
    const bool dep = *carry > DEP_LIMIT;
    Acc c[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[j][q] = 0;
    if constexpr (FORM == I8_I8) {
      const uint32_t dep4 = dep ? 0x01010101u : 0u;
      const int8_t* ohp = reinterpret_cast<const int8_t*>(oh) + wr * ldo;
      const int8_t* tbp = reinterpret_cast<const int8_t*>(tb) + n0 * ldt;
      for (int ks = 0; ks < k / 32; ++ks) {
        uint32_t av[4];
        load_a(av, ohp + ks * 32, ldo);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t b[4];
          load_b_s8(b, tbp + 16 * j * ldt + ks * 32, ldt);
#pragma unroll
          for (int q = 0; q < 4; ++q) b[q] = __vadd4(b[q], dep4);
          mma_s8_16832(c[2 * j], av, b[0], b[1]);
          mma_s8_16832(c[2 * j + 1], av, b[2], b[3]);
        }
      }
    } else {
      const __nv_bfloat162 dep2 = __float2bfloat162_rn(dep ? 1.f : 0.f);
      const bf16* tbp = reinterpret_cast<const bf16*>(tb) + n0;
      for (int ks = 0; ks < k / 16; ++ks) {
        uint32_t av[4];
        if constexpr (FORM == I8_BF16) {
          // The int8 one-hot to bf16 fragments in registers.
          const int8_t* p = reinterpret_cast<const int8_t*>(oh)
                            + (wr + g) * ldo + ks * 16 + 2 * t4;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int8_t* e = p + (q & 1) * 8 * ldo + (q >> 1) * 8;
            av[q] = pack_bf16((float)e[0], (float)e[1]);
          }
        } else {
          load_a(av, reinterpret_cast<const bf16*>(oh) + wr * ldo + ks * 16,
                 ldo * 2);
        }
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t b[4];
          load_b_bf16(b, tbp + ks * 16 * ldt + 16 * j, ldt);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&b[q]);
            v = __hadd2(v, dep2);
            b[q] = *reinterpret_cast<uint32_t*>(&v);
          }
          mma_bf16_16816(c[2 * j], av, b[0], b[1]);
          mma_bf16_16816(c[2 * j + 1], av, b[2], b[3]);
        }
      }
    }
    if (a.g_out != nullptr && it == a.iters - 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const int r = row0 + wr + g + 4 * q;
          const int col = lane0 + n0 + 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(a.g_out + (size_t)r * LANES + col) =
              make_float2(as_float(c[j][q]), as_float(c[j][q + 1]));
        }
    }
    block_sum_into<NWARPS>(frag_sum(c), red, carry);
    __syncthreads();
  }
  if (threadIdx.x == 0)
    a.partials[blockIdx.y * gridDim.x + blockIdx.x] = *carry;
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
int launch(const GatherArgs& a, float* out, cudaStream_t stream) {
  const size_t smem = Layout<FORM>::smem_bytes(a.k);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      onehot_gather_kernel<FORM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.rows / BM, LANES / HALF);
  onehot_gather_kernel<FORM><<<grid, THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  total_kernel<<<1, 256, 0, stream>>>(a.partials, grid.x * grid.y, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One call of the probe: `iters` one-hot products of form `form` (0 bf16,
// 1 int8 one-hot x bf16 table, 2 int8 x int8, 3 banded bf16), the total of
// their sums in out [8, 128]. idx [rows] int32 in [0, n_pad) (BAND: each
// within its tile's window [starts[t], starts[t] + band)); tbl [n_pad, 256]
// bf16 (int8 for form 2); partials [rows / 32 * 2] fp32 scratch; g_out
// [rows, 256] fp32 or null. rows must be a positive multiple of 32; the
// one-hot's width (n_pad, or band for BAND) a multiple of 16 (32 for the
// int8 forms); BAND tiles of tile_rows rows, a multiple of 32 that divides
// rows, with every window inside the table.
int gamd_onehot_gather(int form, const int* idx, const int* starts,
                       const void* tbl, int rows, int n_pad, int band,
                       int tile_rows, int iters, float* partials, float* out,
                       float* g_out, void* stream) {
  if (rows <= 0 || rows % BM != 0 || n_pad <= 0 || iters < 0)
    return cudaErrorInvalidValue;
  const int k = form == BAND ? band : n_pad;
  const int step = (form == I8_BF16 || form == I8_I8) ? 32 : 16;
  if (k <= 0 || k % step != 0 || k > n_pad) return cudaErrorInvalidValue;
  if (form == BAND && (tile_rows <= 0 || tile_rows % BM != 0
                       || rows % tile_rows != 0 || starts == nullptr))
    return cudaErrorInvalidValue;
  const GatherArgs a{idx, starts, tbl, rows, n_pad, k,
                     form == BAND ? tile_rows : rows, iters, partials, g_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case BF16: return launch<BF16>(a, out, s);
    case I8_BF16: return launch<I8_BF16>(a, out, s);
    case I8_I8: return launch<I8_I8>(a, out, s);
    case BAND: return launch<BAND>(a, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
