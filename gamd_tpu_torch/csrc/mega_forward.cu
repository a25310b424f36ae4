// Whole-model GAMD forward for Hopper (sm_90a): wrapped positions, a
// build-time neighbour list and packed weights in, per-atom forces out.
//
// Replaces gamd_tpu/ops/pallas_model.py::_mega_kernel (line 677; its body is
// _forward_body, lines 291-600), reached through mega_forward there. It
// computes the same function: min-image geometry in round form, the live
// mask (build mask and d^2 < cutoff^2), RBF + rank-1 geometric terms into
// the encoder MLP and the edge LayerNorm, L edge-gated conv layers (pre-
// norm LayerNorm or folded BatchNorm), and the decoder whose last affine
// already holds the force denormalisation; the conv layers' activation and
// the MLPs' are silu or tanh-gelu each (JAX's conv_act and mlp_act,
// pallas_model.py:354-355): a template form of each stage kernel for each,
// which the host picks at launch (silu/gelu's the code it was). Like the
// TPU kernel (grid = replicas), it takes R independent systems in one
// call. The water model's bond channel (an
// optional [R, N, K] float input, the O-H indicator of each slot, read at
// the live slots only) adds bond * w_geo[4] to each live edge's encoder
// input, as the TPU kernel's bond_ref does (pallas_model.py:443); without
// it the encoder stage is the LJ code (a template switch), bit for bit.
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
//    products on the tensor cores, the rank-1 terms (the bond's too, with
//    a bond channel), gelu and the LayerNorm with its affine in fp32
//    epilogues; it writes the embedding of live edges only.
// 3. node_fused_kernel (node_fused.cuh), once before the first layer: h =
//    h0 and the first layer's norm, src and dst codes.
// 4. per layer, edge_tile_kernel (grid tiles x R): per tile the four edge
//    products W_e1, W_e2, W_t1, W_t2 on the tensor cores (edge_tc.cuh:
//    wgmma, bf16 x 3, fp32 accumulation: JAX's edge_hilo arithmetic),
//    the activation, the `+ src[j] + dst[i]` add and the gated product
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
// live edges. At TIP3P-774 (water, K=96, 4.2 A cutoff, the same widths and
// depth) a frame has about 4 times LJ-258's live edges and the bond adds
// one rank-1 term and 4 bytes a slot: the same operations-bound shape.
//
// The benchmark's stage switches (tools/bench_ablate.py; JAX's `ablate`,
// pallas_model.py:307-317) are template forms of the stage kernels
// (Ablate, mega.cuh), each stage's built in its own file
// (mega_ablate_encode.cu, mega_ablate_edge.cu, mega_ablate_node.cu) and
// launched in place of the production form of the stage a switch
// changes; the production forms are the code they were. The forms hold
// the production choices at LJ-258 (two weight buffers a tile block, 4
// atoms a node block), and a forward whose choices differ refuses a
// switch. The stage kernels live in mega_stages.cuh, which those files,
// mega_encode.cu and mega_node.cu (the encoder's and the node stages'
// production forms) and this one include, and which nvcc builds in
// parallel.
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

#include "mega.cuh"
#include "mega_stages.cuh"

namespace {

// The production edge kernel of NBUF buffers and conv activation CACT.
template <int NBUF, int CACT>
auto edge_kernel() {
  return edge_tile_kernel<NBUF, ABL_NONE, CACT>;
}

// Dynamic shared memory above 48 KB of the edge stage's production forms,
// set once per process.
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  const int one = tc::smem_bytes(1), two = tc::smem_bytes(2);
  cudaError_t err;
  if ((err = allow_smem(edge_kernel<1, ACT_SILU>(), one)) ||
      (err = allow_smem(edge_kernel<2, ACT_SILU>(), two)) ||
      (err = allow_smem(edge_kernel<1, ACT_GELU>(), one)) ||
      (err = allow_smem(edge_kernel<2, ACT_GELU>(), two)))
    return err;
  done = true;
  return cudaSuccess;
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

// The encoder stage over the layout's tiles (mega_encode.cu), or the
// benchmark form of switch `ablate`.
cudaError_t launch_encode(const CUtensorMap& map, const EncArgs& ea,
                          dim3 tiles, bool one, int ablate, cudaStream_t s) {
  if (encode_has_form(ablate))
    return launch_encode_ablated(ablate, map, ea, tiles, s);
  return launch_encode_production(map, ea, tiles, one, s);
}

// The edge stage of one layer (its split weights from m0): one weight
// buffer or two, the conv activation's form; or the benchmark form.
cudaError_t launch_edge(const CUtensorMap& map, const EdgeArgs& ga, int m0,
                        dim3 tiles, bool one, int ablate, cudaStream_t s) {
  if (edge_has_form(ablate))
    return launch_edge_ablated(ablate, map, ga, m0, tiles, s);
  const dim3 threads(tc::THREADS);
  const int smem = tc::smem_bytes(one ? 1 : 2);
  const auto kernel = ga.cact == ACT_SILU
                          ? (one ? edge_kernel<1, ACT_SILU>()
                                 : edge_kernel<2, ACT_SILU>())
                          : (one ? edge_kernel<1, ACT_GELU>()
                                 : edge_kernel<2, ACT_GELU>());
  return launch_pdl(kernel, tiles, threads, smem, s, map, ga, m0);
}

// The node stage after `layer` (-1: the prologue) with B = b atoms a block
// (mega_node.cu), or the benchmark form of switch `ablate`.
cudaError_t launch_node(const NodeArgs& na, int layer, int b, int ablate,
                        cudaStream_t s) {
  if (node_has_form(ablate)) return launch_node_ablated(ablate, na, layer, s);
  return launch_node_production(na, layer, b, s);
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
  return tc::encode_split_map(s->wsplit, n_mats, map);
}

int mega_forward_run(const float* pos, const int* idx, const uint8_t* bmask,
                     const float* bond, const float* h0,
                     const MegaWeights* weights,
                     const CUtensorMap* map, int r, int n, int k,
                     int n_layers, int n_rbf, int use_ln, int flip_dir,
                     int conv_act, int mlp_act, int ablate,
                     float box, float cutoff2, float length_mean,
                     float length_std, float gamma, const MegaScratch* s,
                     float* out, cudaStream_t stream) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (conv_act < ACT_SILU || conv_act > ACT_GELU || mlp_act < ACT_SILU ||
      mlp_act > ACT_GELU)   // the codes that have forms
    return static_cast<int>(cudaErrorInvalidValue);
  const MegaWeights& p = *weights;
  const int cap = layout_cap(n, k);
  const dim3 tiles(cap / tc::TILE, r);
  const bool one = tile_buffers(tiles.x * tiles.y) == 1;
  const int b = node_width(r * n);
  // The benchmark's forms take no bond and hold two weight buffers a tile
  // block and 4 atoms a node block: elsewhere a switch would change the
  // launches as well as its stage.
  if (ablate != ABL_NONE && (bond != nullptr || one || b != NODE_MIN_B))
    return static_cast<int>(cudaErrorInvalidValue);

  if ((err = launch_layout(pos, idx, bmask, r, n, k, box, cutoff2, s,
                           stream)) != cudaSuccess)
    return static_cast<int>(err);

  const EncArgs ea{pos, idx, s->slot, s->total, bond, s->e, n, k, cap,
                   {p.centers, p.w_geo, p.b0, p.b1, p.b2, p.eln_s, p.eln_b,
                    n_rbf, flip_dir, box, length_mean, length_std, gamma,
                    mlp_act}};
  if ((err = launch_encode(*map, ea, tiles, one, ablate, stream)) !=
      cudaSuccess)
    return static_cast<int>(err);

  const NodeArgs na{p, h0, s->off, s->cnt, s->msg, s->h, s->hn, s->src,
                    s->dst, out, r * n, n, cap, n_layers, use_ln, conv_act,
                    mlp_act};
  if ((err = launch_node(na, -1, b, ablate, stream)) != cudaSuccess)
    return static_cast<int>(err);
  for (int layer = 0; layer < n_layers; ++layer) {
    const size_t lb = (size_t)layer * W;
    const EdgeArgs ga{idx, s->slot, s->total, s->e, s->hn, s->src, s->dst,
                      p.b_e1 + lb, p.b_e2 + lb, p.b_t1 + lb, p.b_t2 + lb,
                      p.b_src + lb, s->msg, n, k, cap, conv_act};
    if ((err = launch_edge(*map, ga, 3 + 4 * layer, tiles, one, ablate,
                           stream)) != cudaSuccess ||
        (err = launch_node(na, layer, b, ablate, stream)) != cudaSuccess)
      return static_cast<int>(err);
  }
  return 0;
}

// One forward of r replicas of n atoms on `stream` (arrays [r, n, ...],
// replica-major; bond [r, n, k] or null; conv_act and mlp_act activation
// codes, Act): the weight split, then mega_forward_run. Returns 0, a
// cudaError_t, or 100000 + the CUresult of the TMA map's encoding.
extern "C" int gamd_mega_forward(
    const float* pos, const int* idx, const uint8_t* bmask,
    const float* bond, const float* h0, const MegaWeights* weights, int r,
    int n, int k, int n_layers, int n_rbf, int use_ln, int flip_dir,
    int conv_act, int mlp_act, float box, float cutoff2, float length_mean,
    float length_std, float gamma, const MegaScratch* scratch, float* out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map;
  const int err = mega_split_weights(weights, n_layers, scratch, &map, s);
  if (err != 0) return err;
  return mega_forward_run(pos, idx, bmask, bond, h0, weights, &map, r, n, k,
                          n_layers, n_rbf, use_ln, flip_dir, conv_act,
                          mlp_act, ABL_NONE, box, cutoff2, length_mean,
                          length_std, gamma, scratch, out, s);
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
