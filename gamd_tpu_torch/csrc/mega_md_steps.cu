// A whole window of BAOAB Langevin MD with the GAMD forward inside, for
// Hopper (sm_90a): state, neighbour list and packed weights in, the state
// after n_steps and the kinetic energy of every step out, in one host call.
//
// Replaces gamd_tpu/ops/pallas_model.py::_mega_md_kernel (line 707,
// pallas_call at line 952), reached through mega_md_steps there. Like the
// TPU kernel (grid = replicas), a call advances R independent systems of
// N atoms that share the weights, masses and noise amplitudes; each has
// its own list, state and kinetic energies. Each step is the same as
// there and as md/integrators.py::baoab_langevin:
//   B  v += hdt f / m
//   A  x += hdt v
//   O  v  = c1 v + c2col xi        (xi standard normal)
//   A  x += hdt v
//      f  = forward(x)              (mega_forward_run, mega_forward.cu)
//   B  v += hdt f / m
//      ke[r, s] = 1/2 sum m v^2 over replica r's atoms
// Positions are not wrapped inside the window; the forward takes minimum
// images. The TPU kernel draws xi from the core's own PRNG, which Hopper
// lacks: here it is Philox4x32-10 (Random123) with key (seed, 0) and
// counter (atom, step, replica, 0), the four words of one call going
// through Box-Muller to the atom's x, y (cos, sin of one pair) and z (cos
// of the other pair); replica 0 draws what a single system draws.
// gamd_tpu_torch/ops/philox.py draws the same numbers on the host. The
// seed is read from device memory, so drawing a window's seed never waits
// for the device. The water model's bond channel, when given, is fixed for
// the window, as the list is. The activations (silu or tanh-gelu, conv and
// MLP) and the benchmark's stage switch (`ablate`, JAX's; the `noise`
// form here, the forward's in mega_ablate_{encode,edge,node}.cu) are the
// caller's.
//
// What bounds it on this card: the window is the forward n_steps times.
// At LJ-258 (N=258, K=48, widths 128, 4 layers) a step's forward needs,
// for the live edges of a 100 K frame, about 9.9 GFLOP of edge products as
// three bf16 tensor-core passes (989 TFLOP/s) and about 0.2 GFLOP of fp32
// node products and epilogues (67 TFLOP/s): about 13 us, so about 0.26 ms
// for a 20-step window, operations-bound. The integrator moves about 20 KB
// a step (positions, velocities, forces, masses), nothing next to that.
//
// What the design does about it: the forward is mega_forward.cu's (live
// edges only, the edge products on the tensor cores, fused node stages);
// its edge-stage weights are split into bf16 hi/lo once a window
// (mega_split_weights), not once a step. The host call runs the window on
// PyTorch's current stream with no host sync: the split, then per step a
// baoab_open kernel (B A O A and the Philox draw, over all R x N atoms),
// the 12 launches of the forward writing straight into the force buffer,
// and a baoab_close kernel (the last B and the KE, one block a replica
// summing its atoms in a fixed order) -- 14 launches a step, whatever R.
// Every atom's arithmetic is the same at any R, so replica 0 of a call
// equals a single-system call bit for bit. No atomics, so the result is
// the same from run to run; no allocation, as the host passes every
// buffer. What bounds it instead is what bounds the forward (latency:
// dependent launches, one warpgroup a tile). Capturing the window as a
// CUDA graph or one persistent launch is later work. gamd_mega_md_steps
// returns the first non-zero cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mega.cuh"

namespace {

constexpr int OPEN_THREADS = 128;
constexpr int CLOSE_THREADS = 256;
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;
constexpr float TWO_PI = 6.283185307179586f;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += PHILOX_W0;
      k.y += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// u1 = ((w >> 8) + 1) 2^-24 in (0, 1]: the log never sees 0.
__device__ __forceinline__ float open_unit(uint32_t w) {
  return static_cast<float>((w >> 8) + 1u) * 0x1p-24f;
}

// u2 = (w >> 8) 2^-24 in [0, 1).
__device__ __forceinline__ float half_open_unit(uint32_t w) {
  return static_cast<float>(w >> 8) * 0x1p-24f;
}

// B A O A of one step for every atom of every replica. grid
// ceil(R*N/128), block 128: thread i takes atom i % N of replica i / N.
// NOISE false is the benchmark's `noise` form (ABL_NOISE): zero draws, no
// Philox and no Box-Muller.
template <bool NOISE = true>
__global__ void __launch_bounds__(OPEN_THREADS)
baoab_open_kernel(float* __restrict__ pos, float* __restrict__ vel,
                  const float* __restrict__ force,
                  const float* __restrict__ masses,
                  const float* __restrict__ c2col,
                  const int* __restrict__ seed, int r, int n, int step,
                  float c1, float hdt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r * n) return;
  const int rep = i / n, a = i - rep * n;
  float xi[3] = {0.f, 0.f, 0.f};
  if constexpr (NOISE) {
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>(a), static_cast<uint32_t>(step),
                   static_cast<uint32_t>(rep), 0u),
        make_uint2(static_cast<uint32_t>(seed[0]), 0u));
    const float ra = sqrtf(-2.0f * logf(open_unit(w.x)));
    const float rb = sqrtf(-2.0f * logf(open_unit(w.z)));
    const float ta = TWO_PI * half_open_unit(w.y);
    const float tb = TWO_PI * half_open_unit(w.w);
    xi[0] = ra * cosf(ta);
    xi[1] = ra * sinf(ta);
    xi[2] = rb * cosf(tb);
  }

  const float invm = 1.0f / masses[a];
  const float c2 = c2col[a];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float v = vel[3 * i + d] + hdt * invm * force[3 * i + d];   // B
    float x = pos[3 * i + d] + hdt * v;                          // A
    v = c1 * v + c2 * xi[d];                                     // O
    x = x + hdt * v;                                             // A
    pos[3 * i + d] = x;
    vel[3 * i + d] = v;
  }
}

// The last B of one step and its kinetic energy, one block of 256 threads
// a replica (grid R): block r walks replica r's atoms (thread t takes
// atoms t, t + 256, ...) and sums in a fixed order into ke[r * n_steps +
// step]: the same result every run.
__global__ void __launch_bounds__(CLOSE_THREADS)
baoab_close_kernel(float* __restrict__ vel, const float* __restrict__ force,
                   const float* __restrict__ masses, int n, float hdt,
                   int n_steps, int step, float* __restrict__ ke) {
  __shared__ float red[CLOSE_THREADS / 32];
  vel += (size_t)blockIdx.x * 3 * n;
  force += (size_t)blockIdx.x * 3 * n;
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += CLOSE_THREADS) {
    const float m = masses[i];
    const float invm = 1.0f / m;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float v = vel[3 * i + d] + hdt * invm * force[3 * i + d];
      vel[3 * i + d] = v;
      acc += m * v * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < CLOSE_THREADS / 32; ++q) s += red[q];
    ke[blockIdx.x * n_steps + step] = 0.5f * s;
  }
}

}  // namespace

// n_steps of the window for r replicas of n atoms on `stream` (state
// arrays [r, n, 3]; masses and c2col [n], shared; bond [r, n, k] or null).
// pos0/vel0/f0 are read once and copied into pos/vel/force, which then
// carry the state; ke gets [r, n_steps] values. scratch is the forward's
// (see mega.cuh); conv_act and mlp_act are activation codes (Act,
// encode.cuh), ablate the benchmark's stage switch (Ablate, mega.cuh: the
// forward's forms, or ABL_NOISE's zero draws). Returns 0, or the first
// non-zero error code seen after a copy, a launch or the weight split
// (mega_split_weights).
extern "C" int gamd_mega_md_steps(
    const float* pos0, const float* vel0, const float* f0, const int* idx,
    const uint8_t* bmask, const float* bond, const float* h0,
    const MegaWeights* weights,
    const int* seed, const float* masses, const float* c2col, int r, int n,
    int k, int n_layers, int n_rbf, int use_ln, int flip_dir, int conv_act,
    int mlp_act, int ablate, float box, float cutoff2, float length_mean,
    float length_std, float gamma, int n_steps, float c1, float hdt,
    const MegaScratch* scratch, float* pos, float* vel, float* force,
    float* ke, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t state_bytes = sizeof(float) * 3 * r * n;
  const int open_blocks = (r * n + OPEN_THREADS - 1) / OPEN_THREADS;
  cudaError_t err;
  if ((err = cudaMemcpyAsync(pos, pos0, state_bytes, cudaMemcpyDeviceToDevice,
                             s)) != cudaSuccess ||
      (err = cudaMemcpyAsync(vel, vel0, state_bytes, cudaMemcpyDeviceToDevice,
                             s)) != cudaSuccess ||
      (err = cudaMemcpyAsync(force, f0, state_bytes, cudaMemcpyDeviceToDevice,
                             s)) != cudaSuccess)
    return static_cast<int>(err);
  CUtensorMap map;
  const int split = mega_split_weights(weights, n_layers, scratch, &map, s);
  if (split != 0) return split;
  for (int step = 0; step < n_steps; ++step) {
    if (ablate == ABL_NOISE)
      baoab_open_kernel<false><<<open_blocks, OPEN_THREADS, 0, s>>>(
          pos, vel, force, masses, c2col, seed, r, n, step, c1, hdt);
    else
      baoab_open_kernel<<<open_blocks, OPEN_THREADS, 0, s>>>(
          pos, vel, force, masses, c2col, seed, r, n, step, c1, hdt);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int fwd = mega_forward_run(
        pos, idx, bmask, bond, h0, weights, &map, r, n, k, n_layers, n_rbf,
        use_ln, flip_dir, conv_act, mlp_act, ablate, box, cutoff2,
        length_mean, length_std, gamma, scratch, force, s);
    if (fwd != 0) return fwd;
    baoab_close_kernel<<<r, CLOSE_THREADS, 0, s>>>(vel, force, masses, n, hdt,
                                                   n_steps, step, ke);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
