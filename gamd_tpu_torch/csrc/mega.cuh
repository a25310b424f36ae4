// Shared by the port's CUDA sources: the packed-weights struct, the whole-
// model forward's scratch, and its host entries (defined in
// mega_forward.cu), which the fused MD window (mega_md_steps.cu) calls:
// the weight split once a window, the forward once a step.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The benchmark's stage switches (tools/bench_ablate.py): stage s of
// gamd_tpu_torch.ops.mega.ABLATE_STAGES is s's index + 1, 0 none. Each
// neutralises its stage as the plain version (ops/mega.py) does: a
// template form of each stage kernel it changes (mega_stages.cuh,
// encode.cuh, node_fused.cuh), ABL_NOISE of baoab_open's
// (mega_md_steps.cu).
enum Ablate {
  ABL_NONE = 0, ABL_ACTS, ABL_GATHER_POS, ABL_RBF, ABL_ENCMLP, ABL_LN,
  ABL_NODEOPS, ABL_GATHER_CONV, ABL_SRCAFF, ABL_EMLP, ABL_REPEAT,
  ABL_THETA, ABL_AGG, ABL_DECODER, ABL_NOISE
};

// One device pointer per field of gamd_tpu_torch.ops.mega.MegaParams, in
// the same order (the ctypes Structure _MegaWeights mirrors it).
struct MegaWeights {
  const float *centers, *w_geo, *w_rbf, *b0, *w1, *b1, *w2, *b2, *eln_s,
      *eln_b;
  const float *nln_s, *nln_b, *w_src, *b_src, *w_dst, *b_dst, *w_e1, *b_e1,
      *w_e2, *b_e2, *w_t1, *b_t1, *w_t2, *b_t2, *w_pd, *b_pd, *w_pe, *b_pe,
      *w_p, *b_p;
  const float *wd0, *bd0, *wd1, *bd1;
};

// The forward's scratch, allocated by the host (gamd_tpu_torch.ops.mega.
// _forward_scratch; the ctypes Structure _MegaScratch mirrors it). cap is
// N*K rounded up to the 64-row tile: replica r's compacted list lives at
// rows [r*cap, r*cap + total[r]).
struct MegaScratch {
  uint8_t* live;  // [R*N*K] live flag of every slot
  int* slot;      // [R*cap] slot id i*K + k of each live edge, atom-major
  int* off;       // [R*N] first row of atom i in its replica's list
  int* cnt;       // [R*N] live edges of atom i
  int* total;     // [R] live edges of the replica
  float* e;       // [R*cap, 128] edge embeddings of the live edges
  float* msg;     // [R*cap, 128] one message row per live edge
  float *h, *hn, *src, *dst;   // [R*N, 128] node rows
  void* wsplit;   // bf16 [3 + 4L][2][128][128]: each edge-stage weight W^T
                  // as hi, lo (mega_split_weights)
};

// Splits the edge-stage weights (w_rbf, w1, w2, then w_e1, w_e2, w_t1,
// w_t2 of each layer) into s->wsplit and encodes the TMA map over it.
// Returns 0, or a cudaError_t, or 100000 + a CUresult of the map's
// encoding.
int mega_split_weights(const MegaWeights* weights, int n_layers,
                       const MegaScratch* s, CUtensorMap* map,
                       cudaStream_t stream);

// All launches of one forward of r replicas of n atoms on `stream`
// (positions to forces `out`, every array replica-major; bond, the water
// model's [r, n, k] bond channel, or null for none), reading the split
// weights through `map`. conv_act and mlp_act are activation codes (Act,
// encode.cuh); ablate a stage switch (Ablate): each stage it changes runs
// its benchmark form (no bond channel with a switch). Returns 0, or the
// first non-zero cudaError_t seen.
int mega_forward_run(const float* pos, const int* idx, const uint8_t* bmask,
                     const float* bond, const float* h0,
                     const MegaWeights* weights,
                     const CUtensorMap* map, int r, int n, int k,
                     int n_layers, int n_rbf, int use_ln, int flip_dir,
                     int conv_act, int mlp_act, int ablate,
                     float box, float cutoff2, float length_mean,
                     float length_std, float gamma, const MegaScratch* s,
                     float* out, cudaStream_t stream);
