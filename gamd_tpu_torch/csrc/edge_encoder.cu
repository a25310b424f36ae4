// Edge featurisation and encoder for Hopper (sm_90a), batched: wrapped
// positions of B frames, their neighbour lists and the model's encoder
// weights in, the edge embedding e [B, N, K, W] (fp32) and the live mask
// [B, N, K] out. The entry of gamd_tpu_torch.ops.encoder.fused_edge_encoder
// on a CUDA tensor (GAMDNet's use_pallas_encoder path).
//
// Replaces gamd_tpu/ops/pallas_encoder.py::_encoder_kernel (line 46,
// pallas_call at line 199), which the JAX model runs per frame under vmap.
// The device code is encode.cuh's encode_kernel, the same code that
// mega_forward.cu launches as its first stage; what it computes, and its
// precision (fp32 CUDA-core FMAs, no TF32, fp32 out), is written there.
// Here the frame is grid z and idx holds per-frame indices, so B frames
// are one launch; the RBF product runs over the model's own n_rbf rows of
// w0 (no padding to 128 rows).
//
// What bounds it on this card: at the LJ deployment (LJ-258, K=96, widths
// 128, 40 RBF centres) a frame has about 5,500 live edges; the three
// encoder products need 2 ((4 + 40) 128 + 128 128 + 128 128) FLOP per
// edge, about 0.42 GFLOP, about 6.3 us at the 67 TFLOP/s fp32 peak, against
// writing e for every slot (12.7 MB, about 3.8 us at 3.35 TB/s):
// operations-bound, with the two close.
//
// What the design does about it, for now: nothing beyond fusion. Every
// slot, dead ones included, runs through the three products as the TPU
// kernel does (a chunk of KC=16 slots per block of 128 threads, one thread
// per output channel, fp32 FMAs against shared-memory tiles), and e goes
// to device memory once. Skipping dead chunks, bf16 e and wgmma are later
// work. One launch a call; gamd_edge_encoder returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode.cuh"
#include "tile.cuh"

extern "C" int gamd_edge_encoder(const float* pos, const int* idx,
                                 const uint8_t* bmask,
                                 const EncoderWeights* weights, int n_rbf,
                                 int b, int n, int k, int flip_dir, float box,
                                 float cutoff2, float length_mean,
                                 float length_std, float gamma, float* e,
                                 uint8_t* live, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((k + KC - 1) / KC, n, b);
  encode_kernel<uint8_t><<<grid, W, 0, s>>>(
      pos, idx, bmask, *weights, n_rbf, n, k, flip_dir, box, cutoff2,
      length_mean, length_std, gamma, e, live);
  return static_cast<int>(cudaGetLastError());
}
