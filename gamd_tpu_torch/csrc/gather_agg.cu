// The gathered, gated, masked neighbour sum for Hopper (sm_90a): the kernel
// behind gamd_tpu_torch.ops.message's pallas_gather_multiply_aggregate.
//
// Replaces gamd_tpu/ops/pallas_mp.py::_gather_agg_kernel (line 49,
// pallas_call at line 78); its XLA oracle is gamd_tpu/ops/aggregate.py.
// Per row i of N nodes, channel c < D:
//   out[i][c] = sum over k with mask[i,k] of h[r][c] * e[i,k][c]
// with r = idx[i,k] read as JAX reads it (negative from the end, then
// clamped into [0, N)). A masked slot contributes exactly 0 and is not
// read.
//
// What bounds it on this card: 2 FLOP a live edge and channel against e
// at the live slots, h, idx, mask and out (at the training slice, about
// 5,500 live edges, D=128: 3.2 MB, about 1 us at 3.35 TB/s):
// bytes-bound.
//
// What the design does about it, for now: one thread per channel, a block
// of W threads per row and chunk of W channels (any D), a loop over K in
// order (a fixed-order sum, the same from run to run) that skips masked
// slots before any read. Loads of e and of h's rows are coalesced across
// the block; idx and mask are read once per warp. The TPU kernel's
// VMEM-resident copy of the whole of h has no counterpart: rows are read
// from device memory where they are needed, and L2 holds h. One launch a
// call.
//
// The host allocates out with torch.empty and launches on PyTorch's
// current stream; gamd_gather_agg returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

// grid (N, ceil(D/W)), block W.
__global__ void __launch_bounds__(W)
gather_agg_kernel(const float* __restrict__ h, const float* __restrict__ e,
                  const int* __restrict__ idx,
                  const uint8_t* __restrict__ mask, int n, int k, int d,
                  float* __restrict__ out) {
  const int i = blockIdx.x, c = blockIdx.y * W + threadIdx.x;
  if (c >= d) return;
  const size_t row0 = (size_t)i * k;
  float s = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    if (!mask[row0 + kk]) continue;
    int j = idx[row0 + kk];
    if (j < 0) j += n;
    j = min(max(j, 0), n - 1);
    s += h[(size_t)j * d + c] * e[(row0 + kk) * d + c];
  }
  out[(size_t)i * d + c] = s;
}

}  // namespace

// out [N, D] from h [N, D], e [N*K, D], idx [N*K] and mask [N*K]. Returns
// 0, or the cudaError_t seen after the launch.
extern "C" int gamd_gather_agg(const float* h, const float* e, const int* idx,
                               const uint8_t* mask, int n, int k, int d,
                               float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather_agg_kernel<<<dim3(n, (d + W - 1) / W), W, 0, s>>>(h, e, idx, mask, n,
                                                           k, d, out);
  return static_cast<int>(cudaGetLastError());
}
