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
// every thread scales its velocities.
//
// The probe's two forms answer which representation is faster for a
// chain that is sequential by nature; both are bound by the same
// dependent sequence (tools/probe_nhc_kernel.py::chain_bound, 13.8-14.1
// us a half-step at M = 10 on an H100 SXM at 700 W). The scalar form holds
// the chain on one thread (16.1-16.7 us, 84-88% of it). The warp form
// holds element j on lane j and runs the vector work across lanes; the
// math has one dependence between neighbours a step of each sweep, so it
// crosses one lane once a step (a shuffle, 450 a half-step), takes the
// forward sweep's exponentials as one vector expf off the chain, keeps
// the scale on lane 0, and updates by selects so that the warp never
// diverges: 23.8 us (58-59%), the chain plus about 22 ns a crossing.
// Measured and dropped (PERF.md): the first transcription, an expf on
// every lane and an indexed shuffle a step, a second shuffle a forward
// step and the scale broadcast to every lane, with a run-time M (43.97-
// 44.31 us); the same schedule as now with each update under `if (lane
// == j)` (31.76 us: a branch a step, which the warp leaves and rejoins
// around every shuffle).
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

// The probe's warp form: lane j holds xi[j], vxi[j], g[j] and q[j] of a
// chain of M (a template argument, so that every lane test and loop bound
// is a constant), and the vector work runs across lanes: the xi update,
// the forward sweep's exponentials and the masked updates. Each
// dependence between neighbouring elements crosses one lane once a step:
// in the backward sweep lane j + 1's new vxi goes down to lane j, in the
// forward sweep lane j's new vxi goes up to lane j + 1 for g[j + 1]. The
// forward sweep's M - 1 factors exp(-wdt/8 vxi[j + 1]) read vxi as the
// backward sweep left it, so they are one vector expf and one shuffle,
// taken before the sweep and off its critical path. Every lane computes
// each update and keeps it by a select where it is the lane updated: the
// warp never diverges, so no shuffle waits for it to reconverge (the
// other lanes' scale stays 1, so that their divisions take the fast
// path too). The scale, ke2 and the product of the scales are lane 0's,
// the only lane that uses them. Every operation is nhc.cuh's, in its
// order and rounding, so the outputs are the scalar form's bit for bit.
// The next substep's weight is loaded a substep ahead, off the chain.
template <int M>
__global__ void __launch_bounds__(32) nhc_probe_warp_kernel(
    const ProbeArgs a) {
  const int lane = threadIdx.x;
  const bool in = lane < M;
  float x = in ? a.xi[lane] : 0.0f;
  float v = in ? a.vxi[lane] : 0.0f;
  float gg = in ? a.g[lane] : 0.0f;
  const float ql = in ? a.q[lane] : 1.0f;
  const float q_prev = __shfl_up_sync(FULL_WARP, ql, 1);   // q[lane - 1]
  float ke2 = a.ke2[0], total = 1.0f;   // lane 0's are the chain's
  float w_next = a.wdts[0];
  for (int rep = 0; rep < a.reps; ++rep) {
    float scale = 1.0f;
    const float g0 = nhc_div(nhc_sub(ke2, a.ndf_kt), ql);
    gg = lane == 0 ? g0 : gg;
    for (int s = 0; s < a.n_sub; ++s) {
      const float wdt = w_next;
      w_next = a.wdts[s + 1 < a.n_sub ? s + 1 : 0];
      const float quarter = nhc_mul(0.25f, wdt);
      const float eighth = nhc_mul(-0.125f, wdt);
      const float half = nhc_mul(0.5f, wdt);
      const float top = nhc_add(v, nhc_mul(quarter, gg));
      v = lane == M - 1 ? top : v;
#pragma unroll
      for (int j = M - 2; j >= 0; --j) {
        const float up = __shfl_down_sync(FULL_WARP, v, 1);   // vxi[j + 1]
        const float kicked = nhc_kick(expf(nhc_mul(eighth, up)), v, quarter,
                                      gg);
        v = lane == j ? kicked : v;
      }
      const float sv = expf(nhc_mul(-half, v));
      scale = nhc_mul(scale, lane == 0 ? sv : 1.0f);   // 1 off lane 0
      x = nhc_add(x, nhc_mul(half, v));
      const float aa = __shfl_down_sync(FULL_WARP, expf(nhc_mul(eighth, v)),
                                        1);   // exp(-wdt/8 vxi[lane + 1])
      const float g_first = nhc_div(
          nhc_sub(nhc_mul(nhc_mul(scale, scale), ke2), a.ndf_kt), ql);
      gg = lane == 0 ? g_first : gg;
#pragma unroll
      for (int j = 0; j < M - 1; ++j) {
        const float kicked = nhc_kick(aa, v, quarter, gg);
        v = lane == j ? kicked : v;
        const float down = __shfl_up_sync(FULL_WARP, v, 1);   // vxi[j]
        const float g_next = nhc_div(
            nhc_sub(nhc_mul(nhc_mul(q_prev, down), down), a.kt), ql);
        gg = lane == j + 1 ? g_next : gg;
      }
      const float bottom = nhc_add(v, nhc_mul(quarter, gg));
      v = lane == M - 1 ? bottom : v;
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

template <int M = 1>
void launch_probe_warp(int m, cudaStream_t s, const ProbeArgs& a) {
  if constexpr (M <= NHC_MAX_M) {
    if (m == M) {
      nhc_probe_warp_kernel<M><<<1, 32, 0, s>>>(a);
    } else {
      launch_probe_warp<M + 1>(m, s, a);
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
    launch_probe_warp(m, s, a);
  }
  return static_cast<int>(cudaGetLastError());
}
