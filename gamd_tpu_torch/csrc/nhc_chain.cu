// The Nose-Hoover chain (NHC) half-step for Hopper (sm_90a): the kernels
// behind gamd_tpu_torch.ops.nhc's nhc_half_step (the MD path: two launches
// per NHC step) and nhc_chain_probe (tools/probe_nhc_kernel.py).
//
// Replaces scripts/probe_nhc_kernel.py's two Pallas kernels, which ask
// whether the chain of gamd_tpu/md/integrators.py::_nhc_propagate can run
// inside a kernel:
//   * _make_kernel_scalar (line 77, pallas_call at line 102), the chain as
//     SMEM scalars: here nhc_half_step_kernel, which is that form fused
//     with what surrounds the chain in _nhc_propagate, and
//     nhc_probe_scalar_kernel, the probe's `reps` loop of the chain alone;
//   * _make_kernel_vector (line 112, pallas_call at line 154), the chain
//     as [1, 128] lane vectors: here nhc_probe_warp_kernel, one warp with
//     lane j holding element j.
// The chain math is nhc.cuh's; its order is _nhc_propagate's, in fp32 with
// expf and IEEE division, every operation rounded on its own as the plain
// version's element-wise PyTorch operations are (no fast math, no FMA).
//
// What bounds it on this card: not bytes and not the FLOP rate. A half-step
// moves 28 bytes an atom (v read and written, the mass read; 7.2 KB at
// LJ-258) and does 12 FLOP an atom plus the chain's n_sub (18 M - 2) + 2
// operations (4,452 at M = 10, n_c = n_ys = 5), nanoseconds of the card's
// roofline. The chain itself is one dependent sequence: 25 substeps x 19
// expf and 10 IEEE divisions, each waiting on the last, so its latency on
// one thread is the bound that shows: 16.5 us of the 20.8 us a call takes
// on an H100 SXM at 700 W (the probe's scalar form against the whole
// half-step, tools/probe_nhc_kernel.py and tools/profile_step.py).
//
// What the design does about it: one launch in place of the plain
// version's ~4,000 (one PyTorch launch per element-wise update of the
// chain). nhc_half_step_kernel runs one block of 256 threads per chain
// (R chains, R blocks; the MD path has R = 1): (a) the block sums
// ke2 = sum m v^2 over its atoms, the fp32 products added in fp64, each
// thread over a fixed stride and then a fixed-order tree in shared memory,
// and rounds it once to fp32, so the sum repeats bit for bit and equals the
// plain version's (the same products summed in fp64 in PyTorch's order) but
// for the rarest rounding ties (skipped when ke2 is given); (b) thread 0
// runs the chain in registers (M a template argument, 1 to 16) over the
// substeps, writes xi, vxi and g, and puts scale in shared memory; (c)
// every thread scales its velocities. The warp form takes each expf on
// all lanes at once and brings the neighbouring element's value over with
// __shfl_sync, keeping the sequential order of the updates: it answers
// which representation is faster for a chain that is sequential by nature.
//
// The host allocates every buffer with torch.empty and launches on
// PyTorch's current stream; each entry returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take (M outside
// [1, NHC_MAX_M], no substep, no chain or atom, reps < 1).

#include <cuda_runtime.h>
#include <stddef.h>

#include "nhc.cuh"

namespace {

constexpr int NHC_THREADS = 256;
constexpr unsigned FULL_WARP = 0xffffffffu;

struct HalfStepArgs {
  const float* vel;      // [R, N, 3]
  const float* masses;   // [N]
  const float* ke2;      // [R] or null: summed from vel
  const float* xi;       // [R, M]
  const float* vxi;
  const float* g;
  const float* q;        // [M]
  const float* wdts;     // [n_sub]
  int n, n_sub;
  float kt, ndf_kt;
  float* vel_out;
  float* xi_out;
  float* vxi_out;
  float* g_out;
};

struct ProbeArgs {
  const float* xi;       // [M]
  const float* vxi;
  const float* g;
  const float* ke2;      // [1]
  const float* q;
  const float* wdts;
  int m, n_sub, reps;
  float kt, ndf_kt;
  float* xi_out;
  float* vxi_out;
  float* g_out;
  float* tail;           // [2]: product of the scales, last ke2
};

template <int M>
__global__ void __launch_bounds__(NHC_THREADS)
    nhc_half_step_kernel(const HalfStepArgs a) {
  __shared__ double part[NHC_THREADS];
  __shared__ float scale_shared;
  const int t = threadIdx.x;
  const size_t r = blockIdx.x;
  const size_t base = r * static_cast<size_t>(a.n) * 3;
  const float* v = a.vel + base;

  // (a) ke2 of this chain's atoms.
  float ke2;
  if (a.ke2 != nullptr) {
    ke2 = a.ke2[r];
  } else {
    double acc = 0.0;
    for (int i = t; i < a.n; i += NHC_THREADS) {
      const float mi = a.masses[i];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float vd = v[3 * i + d];
        acc += static_cast<double>(nhc_mul(nhc_mul(mi, vd), vd));
      }
    }
    part[t] = acc;
    __syncthreads();
    for (int s = NHC_THREADS / 2; s > 0; s >>= 1) {
      if (t < s) part[t] += part[t + s];
      __syncthreads();
    }
    ke2 = __double2float_rn(part[0]);
  }

  // (b) the chain, on one thread.
  if (t == 0) {
    const size_t c0 = r * M;
    NhcChain<M> c;
    nhc_load<M>(c, a.xi + c0, a.vxi + c0, a.g + c0, a.q);
    scale_shared = nhc_chain_half_step<M>(c, a.wdts, a.n_sub, ke2, a.kt,
                                          a.ndf_kt);
    nhc_store<M>(c, a.xi_out + c0, a.vxi_out + c0, a.g_out + c0);
  }
  __syncthreads();

  // (c) the scaling.
  const float scale = scale_shared;
  const int n3 = 3 * a.n;
  for (int i = t; i < n3; i += NHC_THREADS) {
    a.vel_out[base + i] = nhc_mul(v[i], scale);
  }
}

// The probe's scalar form: `reps` half-steps of the chain on one thread,
// ke2 <- scale^2 ke2 after each; tail = (product of the scales, ke2).
template <int M>
__global__ void nhc_probe_scalar_kernel(const ProbeArgs a) {
  NhcChain<M> c;
  nhc_load<M>(c, a.xi, a.vxi, a.g, a.q);
  float ke2 = a.ke2[0], total = 1.0f;
  for (int rep = 0; rep < a.reps; ++rep) {
    const float scale = nhc_chain_half_step<M>(c, a.wdts, a.n_sub, ke2, a.kt,
                                               a.ndf_kt);
    ke2 = nhc_mul(nhc_mul(scale, scale), ke2);
    total = nhc_mul(total, scale);
  }
  nhc_store<M>(c, a.xi_out, a.vxi_out, a.g_out);
  a.tail[0] = total;
  a.tail[1] = ke2;
}

// The probe's warp form: lane j holds xi[j], vxi[j], g[j] and q[j]; each
// expf is taken by every lane at once and the one the update needs comes
// from its lane by __shfl_sync, in nhc.cuh's order.
__global__ void nhc_probe_warp_kernel(const ProbeArgs a) {
  const int lane = threadIdx.x, m = a.m;
  const bool in = lane < m;
  float x = in ? a.xi[lane] : 0.0f;
  float v = in ? a.vxi[lane] : 0.0f;
  float gg = in ? a.g[lane] : 0.0f;
  const float ql = in ? a.q[lane] : 1.0f;
  const float q0 = __shfl_sync(FULL_WARP, ql, 0);
  const float q_prev = __shfl_up_sync(FULL_WARP, ql, 1);   // q[lane - 1]
  float ke2 = a.ke2[0], total = 1.0f;
  for (int rep = 0; rep < a.reps; ++rep) {
    float scale = 1.0f;
    if (lane == 0) gg = nhc_div(nhc_sub(ke2, a.ndf_kt), q0);
    for (int s = 0; s < a.n_sub; ++s) {
      const float wdt = a.wdts[s];
      const float quarter = nhc_mul(0.25f, wdt);
      const float eighth = nhc_mul(-0.125f, wdt);
      const float half = nhc_mul(0.5f, wdt);
      if (lane == m - 1) v = nhc_add(v, nhc_mul(quarter, gg));
      for (int j = m - 2; j >= 0; --j) {
        const float aa = __shfl_sync(FULL_WARP, expf(nhc_mul(eighth, v)),
                                     j + 1);
        if (lane == j) v = nhc_kick(aa, v, quarter, gg);
      }
      scale = nhc_mul(scale, __shfl_sync(FULL_WARP,
                                         expf(nhc_mul(-half, v)), 0));
      x = nhc_add(x, nhc_mul(half, v));
      if (lane == 0) {
        gg = nhc_div(nhc_sub(nhc_mul(nhc_mul(scale, scale), ke2), a.ndf_kt),
                     q0);
      }
      for (int j = 0; j < m - 1; ++j) {
        const float aa = __shfl_sync(FULL_WARP, expf(nhc_mul(eighth, v)),
                                     j + 1);
        if (lane == j) v = nhc_kick(aa, v, quarter, gg);
        const float vj = __shfl_sync(FULL_WARP, v, j);
        if (lane == j + 1) {
          gg = nhc_div(nhc_sub(nhc_mul(nhc_mul(q_prev, vj), vj), a.kt), ql);
        }
      }
      if (lane == m - 1) v = nhc_add(v, nhc_mul(quarter, gg));
    }
    ke2 = nhc_mul(nhc_mul(scale, scale), ke2);
    total = nhc_mul(total, scale);
  }
  if (in) {
    a.xi_out[lane] = x;
    a.vxi_out[lane] = v;
    a.g_out[lane] = gg;
  }
  if (lane == 0) {
    a.tail[0] = total;
    a.tail[1] = ke2;
  }
}

// Launches the instance of M == m (1 <= m <= NHC_MAX_M).
template <int M = 1>
void launch_half_step(int m, int r, cudaStream_t s, const HalfStepArgs& a) {
  if constexpr (M <= NHC_MAX_M) {
    if (m == M) {
      nhc_half_step_kernel<M><<<r, NHC_THREADS, 0, s>>>(a);
    } else {
      launch_half_step<M + 1>(m, r, s, a);
    }
  }
}

template <int M = 1>
void launch_probe_scalar(int m, cudaStream_t s, const ProbeArgs& a) {
  if constexpr (M <= NHC_MAX_M) {
    if (m == M) {
      nhc_probe_scalar_kernel<M><<<1, 1, 0, s>>>(a);
    } else {
      launch_probe_scalar<M + 1>(m, s, a);
    }
  }
}

}  // namespace

// The latency of the chain's two dependent steps on one thread, to price
// the chain's sequence (the bound of the half-step, tools/probe_nhc_kernel.
// py): `reps` steps chained through x, each waiting on the last. op 0, a
// step of the backward sweep: x = kick(expf(c0 x), x, c1, c2), the path
// from vxi[j + 1] to vxi[j]; op 1, a step of the forward sweep: v =
// kick(c3, 1, c1, x), x = (v v - 1) / c2, the path from g[j] to g[j + 1].
// Replaces no TPU kernel: it measures what bounds nhc_half_step_kernel
// and the probe's scalar form. One thread; out[0] = the last x.
__global__ void __launch_bounds__(32)
chain_latency_kernel(int op, int reps, float x, float c0, float c1,
                     float c2, float c3, float* __restrict__ out) {
  if (threadIdx.x != 0) return;
  for (int r = 0; r < reps; ++r) {
    if (op == 0) {
      x = nhc_kick(expf(nhc_mul(c0, x)), x, c1, c2);
    } else {
      const float v = nhc_kick(c3, 1.0f, c1, x);
      x = nhc_div(nhc_sub(nhc_mul(v, v), 1.0f), c2);
    }
  }
  out[0] = x;
}

extern "C" int gamd_nhc_half_step(
    const float* vel, const float* masses, const float* ke2, const float* xi,
    const float* vxi, const float* g, const float* q, const float* wdts,
    int r, int n, int m, int n_sub, float kt, float ndf_kt, float* vel_out,
    float* xi_out, float* vxi_out, float* g_out, void* stream) {
  if (r < 1 || n < 1 || m < 1 || m > NHC_MAX_M || n_sub < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const HalfStepArgs a{vel, masses, ke2, xi, vxi, g, q, wdts, n, n_sub, kt,
                       ndf_kt, vel_out, xi_out, vxi_out, g_out};
  launch_half_step(m, r, static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

// One launch of chain_latency_kernel (one thread): op 0 or 1, `reps` >= 1
// chained steps from x with the constants c0 .. c3 (the chain's -wdt/8,
// wdt/4, a force or mass ratio, a damping factor), out[0] the last x.
extern "C" int gamd_nhc_chain_latency(int op, int reps, float x, float c0,
                                      float c1, float c2, float c3,
                                      float* out, void* stream) {
  if (op < 0 || op > 1 || reps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  chain_latency_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      op, reps, x, c0, c1, c2, c3, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gamd_nhc_chain_probe(
    const float* xi, const float* vxi, const float* g, const float* ke2,
    const float* q, const float* wdts, int m, int n_sub, int reps, int form,
    float kt, float ndf_kt, float* xi_out, float* vxi_out, float* g_out,
    float* tail, void* stream) {
  if (m < 1 || m > NHC_MAX_M || n_sub < 1 || reps < 1 || form < 0 ||
      form > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ProbeArgs a{xi, vxi, g, ke2, q, wdts, m, n_sub, reps, kt, ndf_kt,
                    xi_out, vxi_out, g_out, tail};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    launch_probe_scalar(m, s, a);
  } else {
    nhc_probe_warp_kernel<<<1, 32, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
