// The gathered, gated, masked neighbour sum for Hopper (sm_90a): the kernel
// behind gamd_tpu_torch.ops.message's pallas_gather_multiply_aggregate.
//
// Replaces gamd_tpu/ops/pallas_mp.py::_gather_agg_kernel (line 49,
// pallas_call at line 78); its XLA oracle is gamd_tpu/ops/aggregate.py.
// Per row i of N nodes, channel c < D:
//   out[i][c] = sum over k with mask[i,k] of h[r][c] * e[i,k][c]
// with r = idx[i,k] read as JAX reads it (negative from the end, then
// clamped into [0, N)). A masked slot contributes exactly 0 and its rows
// of h and e are never read, so NaN or wild ids there are harmless.
//
// What bounds it on this card: 2 FLOP a live edge and channel against e
// at the live slots, h, the live ids, the mask and out (the op library's
// LJ-258 graph, K=96, D=128: 5,482 live slots of 24,768, 3.1 MB, 0.93 us
// at 3.35 TB/s): bytes. At that size the real limit is latency: a row's
// work is a chain of a read of its mask and ids, then reads of its live
// rows, so the kernel has to put all of a row's reads in flight at once,
// over enough rows to cover the card.
//
// What the design does about it. One block of ROW_WARPS warps a row:
//  * the row's mask bytes and ids are read once, as coalesced 32-slot
//    vectors, the ids beside the mask (not after it: an id read never
//    waits for its mask byte), and normalised once;
//  * the live slots are compacted into shared memory with __ballot_sync
//    and __popc (WINDOW slots at a time, so any K), so only live rows are
//    read;
//  * the warps split the compacted list into ROW_WARPS contiguous runs;
//    each lane reads 16 bytes of a row (float4: a warp reads a 128-wide
//    row in one instruction) and holds BATCH live slots' h and e rows in
//    flight before it adds them;
//  * the ROW_WARPS partial sums are added in warp order in shared memory.
// Any D: a slab of 32 * VEC channels at a time; float4 loads when D % 4
// == 0 and h, e are 16-byte aligned, else one float a lane.
//
// Sum order: each warp adds its run of each window's live slots in
// ascending k from 0, one fused multiply-add a slot; out = ((p0 + p1) +
// p2) + p3. Fixed, so a
// repeat gives the same bits; against the single ascending sum of the
// first transcription it is a re-association over at most K terms.
//
// The host allocates out with torch.empty and launches on PyTorch's
// current stream; gamd_gather_agg returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_WARPS = 4;            // warps that share one row's slots
constexpr int THREADS = ROW_WARPS * 32;
constexpr int WINDOW = 256;             // slots compacted at a time
constexpr int CHUNKS = WINDOW / 32;     // 32-slot ballots of a window
constexpr int BATCH = 8;                // live slots a lane has in flight

__device__ __forceinline__ void load(float4& v, const float* p) {
  v = __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void load(float& v, const float* p) {
  v = __ldg(p);
}
__device__ __forceinline__ void fma_into(float4& s, const float4& a,
                                         const float4& b) {
  s.x = fmaf(a.x, b.x, s.x);
  s.y = fmaf(a.y, b.y, s.y);
  s.z = fmaf(a.z, b.z, s.z);
  s.w = fmaf(a.w, b.w, s.w);
}
__device__ __forceinline__ void fma_into(float& s, float a, float b) {
  s = fmaf(a, b, s);
}
__device__ __forceinline__ void zero(float4& v) {
  v = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero(float& v) { v = 0.f; }
__device__ __forceinline__ void put(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// grid N, block THREADS. V is float4 (VEC 4) or float (VEC 1).
template <typename V, int VEC>
__global__ void __launch_bounds__(THREADS)
gather_agg_kernel(const float* __restrict__ h, const float* __restrict__ e,
                  const int* __restrict__ idx,
                  const uint8_t* __restrict__ mask, int n, int k, int d,
                  float* __restrict__ out) {
  constexpr int SPAN = 32 * VEC;        // channels of a slab
  __shared__ int slot_of[WINDOW], row_of[WINDOW];
  __shared__ int count[CHUNKS];
  __shared__ __align__(16) float part[ROW_WARPS][SPAN];
  const int i = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = static_cast<size_t>(i) * k;

  for (int c0 = 0; c0 < d; c0 += SPAN) {
    const int c = c0 + lane * VEC;
    const bool on = c < d;              // VEC 4: d % 4 == 0, all four in
    V acc;
    zero(acc);
    for (int w0 = 0; w0 < k; w0 += WINDOW) {
      const int span = min(WINDOW, k - w0);
      // The window's chunks, each one warp's ballot over 32 slots.
      unsigned bal[CHUNKS / ROW_WARPS];
      int id[CHUNKS / ROW_WARPS];
#pragma unroll
      for (int q = 0; q < CHUNKS / ROW_WARPS; ++q) {
        const int ch = warp + q * ROW_WARPS, s = ch * 32 + lane;
        uint8_t m = 0;
        id[q] = 0;
        if (s < span) {
          m = mask[row0 + w0 + s];
          id[q] = idx[row0 + w0 + s];
        }
        bal[q] = __ballot_sync(0xffffffffu, m != 0);
        if (lane == 0) count[ch] = __popc(bal[q]);
      }
      __syncthreads();
      int total = 0;
#pragma unroll
      for (int ch = 0; ch < CHUNKS; ++ch) total += count[ch];
#pragma unroll
      for (int q = 0; q < CHUNKS / ROW_WARPS; ++q) {
        const int ch = warp + q * ROW_WARPS;
        if (bal[q] >> lane & 1u) {
          int off = 0;
          for (int p = 0; p < ch; ++p) off += count[p];
          const int at = off + __popc(bal[q] & ((1u << lane) - 1u));
          int j = id[q];
          if (j < 0) j += n;
          slot_of[at] = w0 + ch * 32 + lane;
          row_of[at] = min(max(j, 0), n - 1);
        }
      }
      __syncthreads();
      // This warp's run of the compacted list, BATCH slots in flight.
      const int lo = total * warp / ROW_WARPS;
      const int hi = total * (warp + 1) / ROW_WARPS;
      if (on) {
        for (int b = lo; b < hi; b += BATCH) {
          V hv[BATCH], ev[BATCH];
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            zero(hv[u]);
            zero(ev[u]);
            if (b + u < hi) {
              load(hv[u], h + static_cast<size_t>(row_of[b + u]) * d + c);
              load(ev[u], e + (row0 + slot_of[b + u]) * d + c);
            }
          }
#pragma unroll
          for (int u = 0; u < BATCH; ++u)
            if (b + u < hi) fma_into(acc, hv[u], ev[u]);
        }
      }
      __syncthreads();   // the list is read before the next window's
    }
    if (on) put(&part[warp][lane * VEC], acc);
    __syncthreads();
    for (int t = threadIdx.x; t < SPAN && c0 + t < d; t += THREADS) {
      float s = part[0][t];
#pragma unroll
      for (int w = 1; w < ROW_WARPS; ++w) s += part[w][t];
      out[static_cast<size_t>(i) * d + c0 + t] = s;
    }
    __syncthreads();     // part is read before the next slab's
  }
}

}  // namespace

// out [N, D] from h [N, D], e [N*K, D], idx [N*K] and mask [N*K]. Returns
// 0, or the cudaError_t seen after the launch.
extern "C" int gamd_gather_agg(const float* h, const float* e, const int* idx,
                               const uint8_t* mask, int n, int k, int d,
                               float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(h) |
                    reinterpret_cast<uintptr_t>(e)) % 16 == 0;
  if (vec)
    gather_agg_kernel<float4, 4><<<n, THREADS, 0, s>>>(h, e, idx, mask, n, k,
                                                       d, out);
  else
    gather_agg_kernel<float, 1><<<n, THREADS, 0, s>>>(h, e, idx, mask, n, k,
                                                      d, out);
  return static_cast<int>(cudaGetLastError());
}
