"""Smoke run of the PyTorch/CUDA port (gamd_tpu_torch) on one NVIDIA H100.

Drives the port's two paths of GNN-driven BAOAB Langevin MD of the
258-atom LJ fluid with the full-width GAMD-small model (seeded, untrained
weights): per step, every force call through the hand-written CUDA kernel
mega_forward; megastep, every 20-step window through the hand-written CUDA
kernel mega_md_steps (Philox noise and the forward inside). Then its
training path: LJ-258 training steps of GAMD-small (use_pallas, as
`train_gamd.py --system lj --use_pallas --use_layer_norm --relabel`), every
conv layer's edge pipeline through the hand-written CUDA kernel pair
conv_msg_gather (forward) and conv_msg_gather_bwd (backward). Then its
LJ deployment on the committed checkpoint results/ckpts/
lj_relabel_latest.msgpack (trained LJ-258 GAMD-small; cutoff 7.5 A, skin
1.25 A, K=96): GNNForceField with use_pallas and use_pallas_encoder, whose
edges come from the hand-written CUDA kernel edge_encoder and whose conv
layers go through conv_msg_gather, for predict / predict_batch and MD, and
the port's run_md and analyze_rollout CLIs. Then its large-N path:
x-sorted frames whose edges are encoded over their live slots by the same
edge_encoder kernel and whose conv layers read their source rows from
per-tile bands through the hand-written CUDA kernel banded_msg
(GNNForceField.banded_force_fn, the cell list, run_md --banded and
bench_large). Then its thermostat integrators: Nose-Hoover chain MD, each
chain half-step one launch of the hand-written CUDA kernel nhc_half_step
(the per-step path, analyze_rollout's default NHC rollout on the
checkpoint, run_md, run_recorded), the chain probe's two forms
(tools/probe_nhc_kernel.py), Andersen and NVE. Then the rest of its
message-passing op library (ops/message.py), each entry point a
hand-written CUDA kernel: pallas_gather_multiply_aggregate (gather_agg),
fused_edge_mlp_aggregate (edge_mlp_agg), fused_conv_message (conv_msg) and
fused_conv_layer (conv_layer), driven through GAMDNet's forward with every
conv layer in one form of the library (tools/op_library.py). Then its
tensor-core probes, each product an mma.sync or wgmma in a hand-written
CUDA kernel: tools/bench_mxu.py (scripts/bench_mxu.py's loop kernel, five stage
bodies through mxu_loop) and tools/probe_gather.py (scripts/probe_gather.py's
one-hot gathers, five forms through onehot_gather), whose lane, sublane and
transpose forms are the hand-written CUDA kernels lane_gather (two widths),
sublane_gather and transpose_probe. Then its replica path: R=8 LJ-258
systems in one call of mega_forward and of mega_md_steps,
Simulation.run_replicas under megastep Langevin and per-step NHC, and
tools/bench_replicas.py. Then its water deployment on the committed
checkpoint results/ckpts/tip3p_final.msgpack (TIP3P-774, 4 x 128, cutoff
4.2 A, K=96): mega_forward and mega_md_steps with the O-H bond channel,
and `run_md --system tip3p --megakernel`, rigid water under SETTLE/RATTLE
with every force call one mega_forward launch. Then its LJ data
generation (physics.generate.generate_lj_dataset: FIRE, then NHC frames
with every chain half-step one nhc_half_step launch) and the dataset's
pack cache through the native packer. Then the repository's verify loop on
that set: tools.train_gamd (the epoch loop, every conv layer through the
conv_msg_gather pair), tools.evaluate and tools.run_md --megakernel on the
checkpoint it wrote; and water training at tip3p_final's shape through the
same pair, rolled out rigidly through mega_forward. Then the reference
protocol's water: the Ewald physics on the card, tools.generate_data
--system tip3p (constrained replicas under full Ewald), tools.
train_gamd --longrange --relabel --rigid_jitter through the
conv_msg_gather pair, and the committed long-range checkpoint
results/ckpts/tip3p_rj_best.msgpack through mega_forward plus the
analytic k-space term in tools.run_md and tools.analyze_rollout (NHC:
nhc_half_step). Then the DFT system: rows 3-4 at the DFT model's widths
(256 / 128 / 256) on surrogate frames, tools.train_gamd --system dft
--use_pallas through them and tools.run_md --system dft on the result,
and the committed results/ckpts/dftlarge_final.msgpack through
tools.evaluate --system dft and tools.run_md --system dft. Then
data-parallel training (parallel.mesh: two ranks, each with its share of
every batch, through the conv_msg_gather pair), and the profiling and
distillation tools (tools.trace_force through conv_msg_gather,
tools.profile_md, and tools.distill_rollout through nhc_half_step).
Phases, one flushed line or more each:

  0. card (nvidia-smi name and power limit), torch and nvcc versions;
  1. build the CUDA sources with nvcc (or reuse the hashed library);
  2. mega_forward against its plain PyTorch version at full width; its
     bound on the tensor cores (the edge products as three bf16 passes
     at 989 TFLOP/s, the rest as fp32 at 67) beside the fp32 CUDA-core
     bound of the same function;
  3. the per-step path: Simulation(GNNForceField.force_fn(megakernel=True)),
     20 warm-up and 200 timed steps, with the kernels' launch counts;
  4. mega_md_steps against its plain version: one 20-step window from the
     start frame, noise off and on;
  5. the megastep path: Simulation(..., megastep_fn=ff.megastep_fn()),
     20 warm-up and 400 timed steps, with the kernels' launch counts;
  6. conv_msg_gather against its plain version on layer 0's real inputs
     (start frame) and layer 1's (a displaced frame, after one conv layer,
     whose rows differ) at the training slice's shapes (N=258, K=96,
     widths 128), two calls bit for bit, its live-edge layout from the
     mask (edge_tiles.mask_layout) equal to the plain one; timed on layer
     0's: CUDA events, the device time (torch.profiler, exclusive), the
     bound on the tensor cores (the four products as three bf16 passes at
     989 TFLOP/s, the epilogues in fp32 at 67, e's live rows) beside the
     fp32 CUDA-core bound of the same function;
  7. conv_msg_gather_bwd against autograd through the plain version on
     the same two inputs, with a seeded cotangent, all 12 grads, two calls
     bit for bit; timed on layer 0's: CUDA events, one backward launch a
     call, the device time by kernel (its tensor-core kernels, the
     first transcription's gone), the bound on the tensor cores (the twelve products as three
     bf16 passes at 989 TFLOP/s, the epilogues in fp32 at 67, against e's
     live rows, ge at every slot and the node rows) beside the fp32
     CUDA-core bound;
  8. one training step, kernel path against plain path, from the same
     seeded state and generator: the same augmented positions, loss,
     grads and parameters after Adam;
  9. the training path: 30 steps on 4 relabelled frames through the
     kernel pair (and the plain path, for its time), with the launch
     counts, the loss of each step and the loss falling;
 10. edge_encoder (fused_edge_encoder, every slot) against its plain
     version on LJ-258 frames with the checkpoint's weights and list
     (K=96): one frame with cutoff=None and with the 7.5 A cutoff, and 16
     frames in one call against 16 calls; its times at B=1 and 16 (CUDA
     events, device time), its bound on the tensor cores (the products as
     three bf16 passes, the epilogues in fp32, e written for every slot)
     beside the fp32 CUDA-core bound, and the share reached;
 11. the deployment force path: force_fn on the card against the same force
     field on the CPU (plain versions), predict and predict_batch (40
     frames at batch size 16) against per-frame predict, and the force
     MAE against the classical LJ labels, on frames of a classical
     Langevin run (the port's LJ forces) from the FIRE-minimised lattice;
 12. the deployment MD path: Simulation(ff.force_fn()) with the trained
     weights, 20 warm-up and 400 timed Langevin steps at 100 K, 25/ps,
     with the kernels' launch counts and the band on mean T;
 13. the port CLIs in process: tools.run_md (--megastep, 2000 steps;
     --use_pallas, 200 steps) and tools.analyze_rollout (--megastep, 4000
     steps, --classical_baseline --pe) against phase 11's classical frames
     as ground truth: thermo log format, RDF, temperature, PE;
 14. banded_msg against its plain version at N=10,000 (tools/
     bench_large.py's LJ fluid at reduced density 0.5, displaced by a
     seeded 0.1 A jitter; seeded GAMD-small; the cell list at 8.0 A with
     K=96; the auto band 2,304) on the real inputs of layers 0 and 1, two
     calls bit for bit, the layout kernels equal to the plain layout;
     timed on layer 0's as phase 6 (CUDA events, device time, both
     bounds); and a band too narrow: the flag set, the forces NaN;
 15. on the same frame, the banded path's encoder: live_edge_encoder
     (edge_encoder over the live slots of the route's layout) against its
     plain version on the live rows, two calls bit for bit, the banded
     forward with e's buffer filled with NaN (finite forces within 5e-3
     std(F) of reference_forward, the dead rows still NaN), its times and
     bounds; then GNNForceField.banded_force_fn against reference_forward
     on the card on the same frame and list, at N=10,000, with one
     live_edge_encoder, one layout and four banded_msg launches a call;
 16. the large-N MD path: Simulation(ff.banded_force_fn(), ...,
     nbr_method="cell") at N=4,096 and 10,000, 20 warm-up and 100 timed
     Langevin steps at 100 K, with banded_msg's, the layout's and
     live_edge_encoder's launch counts, then 20 steps traced
     (torch.profiler): the banded message's and the encoder's device time
     a step and their shares of the step's device time;
 17. the entry points: tools.run_md --banded (200 steps, the committed
     checkpoint, N=258 on the dense list), its forces at the last frame
     against the checkpoint's eager force_fn, and tools.bench_large
     (classical LJ at N=10,000; GNN-MD cell-list at N=4,096; GNN-MD
     banded at N=4,096 and 10,000), with the encoder's launches (one a
     force call on the banded paths);
 18. nhc_half_step against its plain version at N=258, N=10,000 and
     N=258 with R=3 chains (M=10, n_c = n_ys = 5, 100 K, 25/ps, 2 fs, a
     seeded chain): one half-step and 20 consecutive ones, a repeat bit
     for bit, ke2 given equal to ke2 summed, M=17 refused, and the times;
 19. tools.probe_nhc_kernel in process: both forms of nhc_chain_probe
     (scalar, warp) at reps 3 against the plain chain and microseconds
     per half-step at reps 400; the chain's bound, the latency of its
     dependent sequence priced by one-thread chains of its steps
     (ops.nhc.chain_latency, held against its plain version), and each
     form's share of it; the warp form's five outputs the scalar form's
     bit for bit at reps 3 and 400;
 20. the NHC per-step path: Simulation(ff.force_fn(megakernel=True)) with
     nose_hoover on the slice, 20 warm-up and 200 timed steps: one
     mega_forward and two nhc_half_step launches a step;
 21. tools.analyze_rollout with its default integrator (nose_hoover)
     --megakernel --steps 4000 --classical_baseline --pe on the
     checkpoint against phase 11's classical frames: mean T, the RDF peak
     against the classical NHC baseline's, PE, the bath energies of the
     final state;
 22. tools.run_md --integrator nose_hoover --use_pallas, 200 steps;
 23. Andersen, 400 steps on the checkpoint (eager kernel path): mean T;
 24. NVE on the port's classical LJ forces (shifted to zero at the list's
     7.5 A cutoff), 1,000 steps: the relative drift of the total energy;
 25. Simulation.run_recorded under NHC on classical LJ-258, 10 frames
     every 20 steps: frame 0 is the start, the shapes, finite values;
 26. the op-library path: GAMD-small (seeded, plain-path model) on the
     training slice's frame 1 (N=258, K=96, widths 128), one forward with
     every conv layer through each form of tools/op_library.py
     (gather_aggregate, edge_mlp_aggregate, conv_message, conv_layer)
     against the model's plain forward, with the four kernels' launch
     counts (one per layer in its form);
 27. gather_agg, edge_mlp_agg, conv_msg and conv_layer against their plain
     versions on phase 6's two layers' real inputs (h_src = hn[idx],
     src_code = src[idx], edge_pre = edge_affine(e) + src_code + dst, the
     gate theta(edge_pre)), gather_agg within 1e-6 of max |out| (fp32
     re-association over at most K terms; the others 1e-4); conv_msg
     equal to conv_msg_gather bit for bit
     (the same live-edge tiles on equal rows), edge_mlp_agg(edge_pre) (on
     the same tiles with theta_edge's two products) and gather_agg(hn,
     gate) within 1e-5 of conv_msg's plain agg (fp32, on the card), two
     calls of edge_mlp_agg bit for bit, conv_layer equal to GAMDNet's own
     layer on the plain path and to its plain version with a bf16 e and
     with ids out of range (negative, N and past it) in live and masked
     slots; gather_agg on layer 0's inputs with such ids and NaN in every
     masked gate, an all-masked row (exactly 0), D = 96 and 130, a table
     off 16-byte alignment (the aligned call's bits) and a repeat bit for
     bit, each within 1e-6 of max |out| of its plain version;
 28. the gradients of edge_mlp_agg, conv_msg and conv_layer (autograd
     Functions whose backward recomputes through the plain version, as
     JAX's custom_vjp) against autograd through the plain version, with a
     seeded cotangent, on both layers; gather_agg's refusal of an input
     that requires grad;
 29. the four kernels' times at layer 0's inputs against their plain
     versions and bounds (conv_msg, conv_layer and edge_mlp_agg on the
     tensor-core basis, the fp32 CUDA-core basis beside it), and their
     device time by kernel (torch.profiler, exclusive);
 30. tools.bench_mxu in process at its defaults (iters 200, tile_n 16,
     k 48, n 258): each stage's us/iter, TFLOP/s and launch (CTAs,
     cluster), the calibration line (required OK), the launches by body,
     and cuBLAS on each body's products in their order: the bf16
     four-product chain, gather_mm's two products (768 and 6,144 rows),
     gather_full's two gathers and three affines, edge_mlp's four
     products, and repeat_interleave (iters calls replayed from a CUDA
     graph: the library times);
 31. each mxu_loop body against its plain version at iters 2 on the
     tool's inputs (gather_mm and repeat bit for bit; repeat also at the
     tool's iters), repeating bit for bit, and the plain versions' times
     at the tool's iters; repeat's bound, the larger of the instructions
     it must issue (a multiply and an add an output element and
     iteration, its broadcast value's two adds once a dst element) at one
     a lane a clock, iters x the latency of row 0's dependent multiply and
     three adds (tools.bench_mxu.repeat_chain_bound: one thread's chain,
     held bit for bit against its plain version) and its bytes, beside the
     first form's roofline; and its collapse check: the time an iteration
     between iters 200 and 2,000 (CUDA events) no less than that bound's
     time an iteration;
 32. tools.probe_gather in process at its defaults (iters 2000): every
     one-hot variant status OK with its carry equal to iters sum T[idx]
     (1e-5), the launches by form, each form's launch (persistent CTAs),
     and the library times: the same products by
     cuBLAS and torch.index_select(tbl, 0, idx);
 33. each one-hot form against its plain version at iters 2: the gathered
     rows (the last product) bit for bit and equal to T[idx], the carry
     within 1e-5 of iters sum |T[idx]| (int8 x int8 exact), repeating bit
     for bit; the plain versions' times at iters 2000;
 34. the lane, sublane and transpose forms of phase 32's run: each loop
     live (status OK, collapse ratio 2.8-5.2), its carry iters x its sum
     (1e-5), its launches, and at iters 2 against its plain version on the
     card: the last result ([256, 13056], [13056, 256] or [384, 256]) bit
     for bit, the carry within 1e-5 of iters x one iteration's sum of
     magnitudes, a repeat bit for bit; the times beside the plain
     version's, the library's (torch.gather, index_select, one copy of 34
     transposed views, iters calls replayed from a CUDA graph) and the
     bound, and the bound on the data each form moves (SMs x 128 bytes a
     clock at the largest SM clock) with each form's share of it: the
     lane and sublane forms' gathered values read from shared memory
     (each from a slice of its table staged there once a call), the
     transpose's values stored and read once in shared memory;
 35. mega_forward on 8 LJ-258 frames [8, 258, 3] (the start frame and 7
     jittered copies, each with its own list) in one launch against 8
     single launches (bit for bit counted) and the plain version, each
     within 5e-3 std(F); the times against the single call's;
 36. mega_md_steps at R=8, one 20-step window noise off and on, against
     the plain window at R=8 (2e-4 in x and v, KE rtol 1e-4), replica 0
     bit for bit the single-system window of its inputs; the times;
 37. Simulation.run_replicas at R=8, megastep Langevin and per-step NHC
     (force_fn(megakernel=True)), 20 warm-up and 200 timed steps: the
     aggregate steps/s, the launches (one window or one forward a step for
     all replicas), the shapes, replicas apart, the Langevin mean T;
 38. tools.bench_replicas 8 100 in process under each integrator;
 39. the forward's live-edge layout: its first stage alone (mega_layout,
     one launch) at phase 2's frame and phase 35's 8 frames, equal to
     live_edge_layout exactly (offsets, counts, totals, the compacted
     slots), with the 64-row tiles it cuts;
 40. the forward's per-stage device time (torch.profiler, each kernel's
     exclusive time grouped by stage, tools/profile_step.py's
     FORWARD_STAGES) and its launches a forward, at R=1 and R=8, for
     mega_forward calls and a mega_md_steps window;
 41. water: the start of run_md --system tip3p (water_box, 1,500 FIRE
     steps on the flexible TIP3P forces, project_initial) with
     tip3p_final's weights, the K=96 list and its bond channel;
     mega_forward with the bond channel against its plain version (5e-3
     std(F)), a bond of zeros the bits of no bond, f32_edges the same
     bits, R=2 bit for bit its single calls; its time, device time,
     bound (the bond one more rank-1 term and 4 bytes a slot) and share;
 42. mega_md_steps with the bond channel: one 20-step window at c2col = 0
     against md_steps_reference (2e-4 in x, KE rtol 1e-4; in v 2e-4 or,
     if larger, twice the distance of the plain window with the kernel's
     bf16 x 3 edge products from the fp32 one: hydrogen's light mass turns
     the forward's 3e-5 std(F) into some 5e-4 A/t0 over a window); its time
     with noise, the plain window's and the bound;
 43. run_md --system tip3p --ckpt results/ckpts/tip3p_final.msgpack
     --megakernel --friction 25 --steps 2000 in process (rigid g-BAOAB at
     300 K, 2 fs, the water deployment's 25/ps: at the preset's 1/ps the
     model's force noise heats the box to about 430 K within 4 ps): steps/s
     on the host clock, every force finite, no overflow,
     the mean T of the second half within 300 +- 20 K, the residual under
     1e-5 A, the O-O RDF's first peak (second half) within 2.6-3.0 A, one
     mega_forward launch a force call;
 44. the eager water GAMDNet with use_pallas (conv_msg_gather a layer)
     against the plain model on the water start (1e-4 std(F));
 45. run_md --system tip3p --megastep --no-rigid, 100 steps from phase
     41's start: steps/s, finite state, one mega_md_steps a window;
 46. the banded path with the bond channel on phase 41's water start:
     live_edge_encoder with the sorted frame's bond (row 5's BOND form)
     against its plain version on the live rows (1e-4 of max |e|), a bond
     of zeros the bits of no bond there; GNNForceField.banded_force_fn
     (one live_edge_encoder and four banded_msg launches a call) against
     mega_forward with the bond on the same frame (5e-3 std(F)); row 5's
     time, device time, bound and share with the bond; then run_md
     --system tip3p --ckpt results/ckpts/tip3p_final.msgpack --banded
     --friction 25 --steps 2000 in process (dense list, band 512) with
     phase 43's checks, its steps/s and rows 5 and 6's launches a force
     call;
 47. the benchmark's stage switches: mega_md_steps under each of the 14
     `ablate` names (ops/mega.py::ABLATE_STAGES) against its plain
     ablated window, phase 4's 20-step window at c2col = 0 (2e-4 in x and
     v), and a one-step window's forces within 5e-3 std(F). ln's window
     there blows up from its first step (velocities of 1e9 A/t0, where
     the plain windows with fp32 and with the kernel's bf16 x 3 products
     part by 9e3 A/t0): it is reported, and ln's window is held to 2e-4
     on LN_WINDOW's case (LJ-64, two layers, 4 steps), where its plain
     windows agree; each form's forces
     unlike the full window's, and `noise` at a real amplitude the bits
     of the full window at c2col = 0; then tools.bench_ablate in process
     (--steps 400 --reps 1): each stage's us a step, device us, delta and
     floor, the summary;
 48. the activation pairs: mega_forward under each of silu/gelu,
     gelu/gelu, silu/silu and gelu/silu (conv/MLP) against its plain
     version (5e-3 std(F)) on phase 2's frame, silu/gelu the bits of the
     default call, and one 20-step window under gelu/silu against its
     plain window at c2col = 0 (2e-4 in x and v);
 49. LJ data generation, `generate_data --system lj`'s protocol through
     physics.generate.generate_lj_dataset on the card: 1 seed, 2,000 FIRE
     steps, 20 frames every 50 NHC steps (chain 10/5/5, 100 K, every
     chain half-step one nhc_half_step launch): its seconds and frames/s,
     and FIRE's seconds alone (timed again on the same start);
     the npz layout (pos, vel, forces float32 [258, 3]), each frame's
     forces within 1e-4 of max |F| of lj_forces_dense of its pos on the
     card, the mean T of the frames within 100 +- 15 K, the launches;
     TrajectoryDataset's pack cache, the native packer's pack
     (train/native_io.py, built with g++) and the numpy pack bit for bit,
     the 90/10 split's sizes; the set stays for phase 50;
 50. the verify loop on phase 49's set, at GAMD-small's full width
     (128/128/128, 4 conv layers, LayerNorm, K=96): tools.train_gamd
     --system lj --use_pallas --use_layer_norm --relabel (18 train and 2
     test frames, 3 epochs at batch 2, a checkpoint every epoch): finite
     metrics every epoch, the checkpoint files, the ms a step of the epoch
     loop, rows 3-4's launches (four of each a step, four forward a
     validation batch); the last checkpoint reloaded (load_self_describing,
     GNNForceField with use_pallas) against the trained module's eval
     forces on a test frame (1e-4 of max |F|: row 3's 1e-4 of max |agg|
     carried to forces); a resume from checkpoint_1 at --start_epoch 2:
     epoch 2's metrics bit for bit and its checkpoint byte for byte the
     straight run's; tools.evaluate --use_pallas on the last checkpoint
     (finite metrics, four conv_msg_gather launches) and tools.run_md
     --megakernel 200 steps on it (finite T, one mega_forward a force
     call); the launches of rows 1-5 on each part of the path;
 51. water training at tip3p_final's shape (TIP3P-774, 4.2 A, K=96, widths
     128, 4 layers, LayerNorm, drop_edge, the bond channel): six frames
     (phase 41's relaxed start and copies displaced by 0.01 A, labelled by
     the flexible TIP3P forces in kJ/mol/nm) written as data_0_{t}.npz;
     one training step of the CLI's configuration on its first training
     frame through rows 3-4 against the plain path from the same seed
     (phase 8's bars: the same augmented positions, the loss within 1e-4,
     each grad within 1e-3 x its max, the parameters after Adam within
     1e-5 for 99.9% and 2 lr for all; four launches of each of rows 3-4);
     tools.train_gamd --system tip3p --use_pallas, 2 epochs of 5 steps,
     through rows 3-4; then tools.run_md --system tip3p --megakernel
     --friction 25 100 steps on the result from phase 41's start: finite
     losses and T, the constraint residual under 1e-5 A, the launches;
 52. reference-protocol water, the Ewald physics: TIP3P-774 and TIP4P-753
     (water_box starts jittered by 0.05 A, box 20 A) rigid Ewald energy,
     forces and the k-space force (make_longrange_force_fn) in float32 on
     the card with TF32 switched on globally, against the same functions
     in float64 on the CPU (energy 1e-5 relative, forces 1e-4 of max
     |F|), the same phases as one TF32 matmul as the control that TF32
     was live; the force call's and the k-space force's times;
 53. tools.generate_data --system tip3p (2 seeds as constrained replicas
     of one Langevin run, 300 FIRE steps a start, the 5,000
     thermalisation steps, 6 frames every 20 steps): the files, the
     frames' mean T within 300 +- 20 K, the SETTLE residual under 1e-5 A,
     the recorded forces within 1e-4 of the rigid Ewald forces of their
     positions, no kernel launched; the seconds, frames/s and a lockstep
     step of the two replicas timed alone (--system tip4p, the same
     protocol at 1 seed, runs as tests/test_torch_cuda.py::
     test_tip4p_generation_on_the_card);
 54. one training step of train_gamd --system tip3p --longrange --relabel
     --rigid_jitter --use_layer_norm on phase 53's first training frame
     through rows 3-4 against the plain path (phase 51's bars), then the
     CLI with --use_pallas, 2 epochs at batch 1: finite losses, the
     checkpoint's longrange, the launches of rows 3-4;
 55. results/ckpts/tip3p_rj_best.msgpack (4 x 128, longrange) on a phase
     53 frame: force_fn(megakernel=True), row 1 plus the k-space term,
     against its plain version (5e-3 std(F)), its long-range term alone
     the channel's (1e-6 of max |F|), the use_pallas force_fn (row 3)
     against the plain force_fn (1e-4 std(F)), times with and without the
     term; tools.run_md --system tip3p --megakernel --friction 25 200
     steps from the frame (steps/s, the term's share, mean T of the
     second half 300 +- 20 K, residual, 201 launches of row 1); then
     tools.analyze_rollout --system tip3p --megakernel
     --classical_baseline --pe, 400 NHC steps on phase 53's frames (row
     1 and row 18's launches, finite report);
 56. rows 3-4 at E = D = 256, H = 128 (tools/time_conv.py::dft_inputs:
     layer 0 of the seeded DFT model on the first 1 and 4 training frames
     of md_dataset/RPBE-surrogate.npz, each at its own box, K=192 at 9.5
     bohr): the forward within 1e-4 of max |agg| of batched_reference
     and bit for bit from run to run, each of the 12 grads within 1e-3
     of its max of autograd through it; the events and device times, the
     bound (six 128 x 128 blocks a live edge, three bf16 passes) and its
     share, the live edges; then the LJ slice's 128-wide layer 0 through
     the wide instance with zero second blocks, its first 128 columns bit
     for bit the 128-wide call's;
 57. one training step of train_gamd --system dft --use_layer_norm's
     configuration (256 / 128 / 256, 5 layers) on the first training
     frame of a 24 + 8 frame cut of the surrogate at its own box, rows
     3-4 against the plain path (phase 51's bars, five launches of each);
     the CLI with --use_pallas, 2 epochs at batch 1 (finite losses, the
     launches, the checkpoint's DFT system); run_md's DFT closure on it
     at the start with --use_pallas against the plain path (1e-4
     std(F)); tools.run_md --system dft --use_pallas 100 rigid steps on
     it (finite, residual under 1e-5 A, 505 launches of row 3), from the
     CLI's FIRE start, computed once for phases 57 and 58;
 58. tools.evaluate --system dft on dftlarge_final, all 300 test frames:
     cosine, MAE and RMSE beside JAX's recorded ones (results/
     dftlarge_eval_r4.json, a TPU run; no bar); the card's predict
     against the port's plain path on the CPU at 4 frames (1e-4 std(F));
     tools.run_md --system dft on dftlarge_final, 200 rigid steps at
     25/ps (finite, residual under 1e-5 A; steps/s and the second half's
     mean T reported); each phase's seconds;
 59. data-parallel training on the card: two gloo ranks spawned on cuda:0
     (NCCL takes one rank a card), each holding one frame of every batch
     of 2 of the training slice (LJ-258 GAMD-small, 128/128/128, 4 layers,
     LayerNorm, use_pallas, dropout, rotation, jitter and the LJ relabel)
     from create_train_state(seed=0) broadcast from rank 0; three steps
     (make_train_step with the mesh: draws at the global batch's shape,
     the scalers, the loss and the gradients all-reduced) against the
     one-process steps at batch 2 on the same batches: rank 0's loss each
     step within 1e-5 (relative), its parameters within 1e-5 x max |p|,
     both ranks' parameters equal bit for bit, rows 3-4 launched on each
     rank (counts set to 0 in the rank just before its steps); ms a step
     of one process and of the ranks over ten more steps, and the share of
     rank 0's step spent inside all_reduce (host clock);
 60. tools.trace_force float32 pallas in process: 200 force calls traced
     with utils.profiling.profile_trace, the device time a step and the
     top kernels, row 3's tile kernel among them and launched;
 61. tools.profile_md float32 in process (500 steps a body, one run): its
     six lines, finite;
 62. tools.distill_rollout --system lj on results/ckpts/
     lj_distill_best.msgpack: 2 seeds as NHC replicas (each chain
     half-step one nhc_half_step launch), 20 thermalisation steps, 4 frames
     every 10 steps: finite frames, labels within 1e-5 of max |F| of
     lj_forces_dense of the written positions on the card, row 18
     launched (and row 3, were the checkpoint use_pallas);
then the kernels line (JSON; rows 1-2 with their water, ablate and
activation figures, rows 3-4 with their DFT-width figures, row 5 with its
water banded figures, row 10 with its cases), and the result line (JSON)
last.

Run from the repository root: `python3 chip_smoke.py`. It needs one CUDA
card; without one it exits non-zero and prints no result. Any failed check
raises, and a hang ends with a traceback at the deadline.
"""

import dataclasses
import faulthandler
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gamd_tpu_torch.core import space, units
from gamd_tpu_torch.core.config import MDConfig, ModelConfig, get_preset
from gamd_tpu_torch.core.device import card_line
from gamd_tpu_torch.md import integrators as integ
from gamd_tpu_torch.md.integrators import maxwell_boltzmann_velocities
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.neighbors.dense import (build_nbrs, dense_neighbor_list,
                                            refresh_mask)
from gamd_tpu_torch.neighbors.cell_list import cell_list_neighbor_list
from gamd_tpu_torch.ops import (banded, build, edge_tiles, gather_probe,
                                message, mxu_probe, nhc)
from gamd_tpu_torch.ops import mega as mega_module
from gamd_tpu_torch.ops.conv_gather import (batched_reference,
                                            fused_conv_gather_message)
from gamd_tpu_torch.ops.encoder import (edge_encoder_reference,
                                        fused_edge_encoder,
                                        live_edge_encoder,
                                        live_edge_encoder_reference)
from gamd_tpu_torch.ops.mega import (layout_tiles, live_edge_layout,
                                     md_steps_reference, mega_forward,
                                     mega_layout, mega_md_steps, pack_params,
                                     reference_forward)
from gamd_tpu_torch.physics.lennard_jones import (LJParams, lj_energy_dense,
                                                  lj_fluid_box, lj_force_fn,
                                                  lj_forces_dense)
from gamd_tpu_torch.physics.minimize import fire_minimize
from gamd_tpu_torch.physics.rdf import radial_distribution
from gamd_tpu_torch.tools import (analyze_rollout, bench_large, bench_mxu,
                                  bench_replicas, op_library, probe_gather,
                                  probe_nhc_kernel, run_md)
from gamd_tpu_torch.tools.bench_large import (LARGE_MD, banded_layer_inputs,
                                              lj_large, seeded_force_field)
from gamd_tpu_torch.tools.bench_mxu import graph_ms
from gamd_tpu_torch.tools.bounds import (BF16_FLOPS, FP32_FLOPS,
                                         HBM_BYTES_PER_S, INT8_OPS,
                                         forward_ops)
from gamd_tpu_torch.tools.lj_slice import K_MODEL, lj_slice
from gamd_tpu_torch.tools.lj_train_slice import lj_train_slice
from gamd_tpu_torch.tools.profile_step import (BANDED_KERNELS,
                                               CONV_BWD_KERNELS,
                                               ENCODER_KERNELS,
                                               FORWARD_STAGES,
                                               exclusive_times,
                                               forward_stages, traced_spans)
from gamd_tpu_torch.tools.time_conv import conv_inputs, op_inputs
from gamd_tpu_torch.tools.time_probes import nhc_case, smem_bound
from gamd_tpu_torch.train.checkpoint import load_self_describing
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.loop import make_train_step
from gamd_tpu_torch.train.state import create_train_state, init_params

DEADLINE_S = 1100         # the whole script, build included
WARMUP_STEPS = 20
PER_STEP_STEPS, MEGASTEP_STEPS = 200, 400     # timed steps of each path
TOLERANCE = 5e-3          # max |F_kernel - F_plain| / std(F_plain)
WINDOW_ATOL = 2e-4        # max |dx| (A) and |dv| (A/t0), kernel vs plain
WINDOW_KE_RTOL = 1e-4     # ke per step, kernel vs plain
T_BAND = 10.0             # |mean T - 100 K| of the megastep path
TRAIN_STEPS = 30          # steps of the training path
CONV_RTOL = 1e-4          # max |d agg| / max |agg|, kernel vs plain
CONV_GRAD_RTOL = 1e-3     # per grad: max |d| / max |grad|, kernel vs plain
PARAM_ATOL = 1e-5         # training step, kernel vs plain: at least
PARAM_SHARE = 0.999       # this share of parameters within PARAM_ATOL, and
                          # all within 2 * lr (Adam on a rounding-level grad)
GRAD_NAMES = ("e", "hn", "src_nodes", "dst_code",
              "w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")
CKPT = os.path.join("results", "ckpts", "lj_relabel_latest.msgpack")
ENCODER_RTOL = 1e-4       # max |de| / max |e|, kernel vs plain
ENCODER_BATCH = 16        # frames of the batched encoder call (predict_batch)
PREDICT_FRAMES, PREDICT_BATCH = 40, 16   # predict_batch's pad path (40 % 16)
PREDICT_RTOL = 1e-5       # predict_batch vs per-frame predict, / std(F)
DEPLOY_STEPS = 400        # timed steps of the deployment MD path
CLASSICAL_EQUIL, CLASSICAL_STEPS = 1000, 2000   # ground-truth run: 100 frames
RUN_MD_STEPS = {"--megastep": 2000, "--use_pallas": 200}   # phase 13's runs
ANALYZE_STEPS = 4000      # analyze_rollout's rollout (200 windows)
LARGE_N = (4096, 10_000)  # atoms of the large-N MD runs (phase 16)
LARGE_K = 96              # bench_large's K at 7.5 + 0.5 A
LARGE_STEPS = 100         # timed steps of each large-N MD run
SHARE_STEPS = 20          # traced steps of each (the message's share)
RUN_MD_BANDED_STEPS = 200  # phase 17's run_md --banded
BENCH_LARGE_ARGV = ["--sizes", "10000", "--gnn_size", "4096",
                    "--gnn_banded_sizes", "4096", "10000", "--steps", "80"]
NHC_SHAPES = ((258, None), (10_000, None), (258, 3))   # phase 18's (N, R)
NHC_RTOL = 1e-5           # max |d| / max |x| per tensor, kernel vs plain
NHC_CHAIN_CALLS = 20      # consecutive half-steps, each side its own state
NHC_ANALYZE_STEPS = 4000  # phase 21's per-step NHC rollout
ANDERSEN_STEPS, NVE_STEPS = 400, 1000   # phases 23 and 24
RECORD_FRAMES, RECORD_INTERVAL = 10, 20  # phase 25
OP_FORCE_RTOL = 1e-4      # op-library forms vs the plain forward, / std(F)
OP_AGG_RTOL = 1e-5        # staged forms vs conv_msg's plain agg, / max
OP_GRAD_RTOL = 1e-5       # per grad: max |d| / max |grad|, Function vs plain
GATHER_RTOL = 1e-6        # gather_agg vs plain, / max |out|: fp32 re-association
GATHER_WIDTHS = (96, 130)  # gather_agg's other widths (float4 lanes; scalar)
GEN_FRAMES, GEN_INTERVAL, GEN_FIRE = 20, 50, 2000   # phase 49's protocol
GEN_FORCE_RTOL = 1e-4     # recorded forces vs recomputed, / max |F|
GEN_T_BAND = 15.0         # |mean T of the frames - 100 K|, phase 49
THERMO_HEADER = ('#"Step"\t"Time (ps)"\t"Kinetic Energy (kJ/mole)"\t'
                 '"Temperature (K)"')
PROBE_CARRY_RTOL = 1e-5   # one-hot carry vs plain, / (iters sum |T[idx]|)
PROBE_CHECK_ITERS = 2     # phases 31, 33 and 34
REPLICAS = 8              # phases 35-38
REPLICA_STEPS = 200       # timed steps of each run_replicas path (phase 37)
BENCH_REPLICAS_STEPS = 100  # phase 38's n_steps


def say(*parts):
    print(*parts, flush=True)


def require(ok, message):
    """A failed check of the run: raise (kept under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {message}")


def nvcc_release():
    out = subprocess.run([build.find_nvcc(), "--version"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def time_ms(fn, reps=20, warmup=3):
    """Median of `reps` single-call device times (CUDA events), in ms, after
    `warmup` untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def forward_flops(edges, n, n_rbf, model_cfg):
    """fp32 operations (2 per multiply-add) of one forward over `edges`
    edges and n atoms: the encoder's n_rbf RBF rows and 4 geometric rows
    (unit vector, standardised length), its two MLP layers, each layer's
    edge MLPs and gated product, and the node-level products (norm codes,
    update, decoder)."""
    d, h, e = (model_cfg.encoding_size, model_cfg.hidden_dim,
               model_cfg.edge_embedding_dim)
    layers = model_cfg.conv_layers
    per_edge = (n_rbf + 4) * h + h * h + h * e \
        + layers * (e * h + h * h + h * h + h * d + d)
    per_node = layers * (2 * d * h + 2 * d * h + h * d) + d * h + h * 3
    return 2.0 * (edges * per_edge + n * per_node)


def roofline(flops, nbytes, rate=FP32_FLOPS):
    """(least ms, "operations" or "bytes"): `flops` against `rate` (the
    fp32 peak unless given), `nbytes` against HBM, the larger of the
    two."""
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_flops(live_edges, width=128):
    """fp32 operations of one conv layer's edge pipeline over `live_edges`
    edges: four width x width products (2 per multiply-add) and the gated
    masked sum; activations not counted."""
    return live_edges * (4 * 2 * width * width + 2 * width)


#: fp32 operations of the conv message's epilogues a live edge and column
#: as the tensor-core kernel runs them: the first and third products' bias
#: and silu (4 each: silu as exp, add, divide), the second's bias, src and
#: dst adds and silu (6), the last bias, gated product and sum (3).
EPILOGUE_OPS = 17


def conv_tc_ops(live_edges, width=128):
    """(tensor-core FLOP, fp32 FLOP) of one conv message as the live-edge
    kernels (rows 3 and 6) compute it: the four products over the live
    edges as three bf16 passes each, and the epilogues on the CUDA cores."""
    return (3.0 * 4 * 2 * width * width * live_edges,
            float(EPILOGUE_OPS * width * live_edges))


def live_rows_only(nbytes, n, k, live_edges, width=128):
    """A message's compulsory bytes with e's rows and the indices read at
    the live slots only, as the live-edge kernels read them (the mask is
    still read whole): nbytes less the dead slots' e rows and ids."""
    return nbytes - (n * k - live_edges) * (4 * width + 4)


def tc_conv_bound(live_edges, nbytes, ops=conv_tc_ops):
    """(least ms, "operations" or "bytes") of one conv message (or, with
    conv_bwd_tc_ops, its backward) on the tensor-core basis: ops(live
    edges) against the bf16 tensor peak and the fp32 peak (their times
    add), nbytes against HBM; the larger."""
    tc_flops, fp32_flops = ops(live_edges)
    t_ops = (tc_flops / BF16_FLOPS + fp32_flops / FP32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


#: fp32 operations of the conv backward's epilogues a live edge and column
#: as its tensor-core kernels run them (silu counted as the forward's 3,
#: silu' as 5 more: a divide for sigma, then 4): the recomputed first and
#: third products' bias, silu and silu' (9 each), the second's with the
#: src and dst adds (11), the last's bias and the two products with g (3);
#: the sweep's products with silu' (3) and gdst's sum (1); the sums by
#: source of g_hsrc and g_z2 (2); the four bias sums of hi + lo (8).
BWD_EPILOGUE_OPS = 46


def conv_bwd_tc_ops(live_edges, width=128):
    """(tensor-core FLOP, fp32 FLOP) of one conv backward as the tensor-core
    kernels (row 4) compute it: twelve products a live edge (the recompute's
    four, the sweep's four with W^T, the four weight gradients) as three
    bf16 passes each, and the epilogues on the CUDA cores."""
    return (3.0 * 12 * 2 * width * width * live_edges,
            float(BWD_EPILOGUE_OPS * width * live_edges))


def tc_conv_bwd_bound(live_edges, nbytes):
    """(least ms, "operations" or "bytes") of one conv backward on the
    tensor-core basis: conv_bwd_tc_ops against nbytes (tc_conv_bound)."""
    return tc_conv_bound(live_edges, nbytes, conv_bwd_tc_ops)


def conv_bytes(n, k, width=128, backward=False):
    """Bytes the kernel pair must move, each input read and each output
    written once: e, idx, mask, hn, src, dst and the weights in, agg out;
    the backward also reads the cotangent and writes ge, the three node
    grads and the weight grads."""
    weights = 4 * (4 * width * width + 4 * width)
    nodes = 4 * n * width
    io = 4 * n * k * width + 5 * n * k + 3 * nodes + weights
    if backward:
        return io + nodes + 4 * n * k * width + 3 * nodes + weights
    return io + nodes


def forward_bytes(n, k, mp, model_cfg, state_io=False, bond=False):
    """Bytes one forward, or with state_io one MD window, must move: each
    input read once and each output written once (a window also reads
    velocities, forces, masses, noise amplitudes and the seed, and writes
    positions, velocities, forces and the KE); the bond channel adds 4
    bytes a slot."""
    weight_bytes = sum(t.numel() * t.element_size() for t in mp)
    io_bytes = n * 3 * 4 + n * k * (4 + 1 + 4 * bond) \
        + n * model_cfg.encoding_size * 4 + n * 3 * 4
    if state_io:
        io_bytes += 2 * n * 3 * 4 + 2 * n * 4 + 4 + 3 * n * 3 * 4
    return weight_bytes + io_bytes


def bound(flops, n, k, mp, model_cfg, state_io=False):
    """(least ms, "operations" or "bytes") of one forward, or with
    state_io of one MD window, on the fp32 CUDA cores: `flops` against the
    fp32 peak, forward_bytes against HBM."""
    return roofline(flops, forward_bytes(n, k, mp, model_cfg, state_io))


def tc_bound(ops, n, k, mp, model_cfg, state_io=False, bond=False):
    """(least ms, "operations" or "bytes") of one forward, or with
    state_io of one MD window, as the kernel computes it: `ops` =
    (tensor-core FLOP, fp32 FLOP) from forward_ops, the first against the
    bf16 tensor peak and the second against the fp32 peak (their times
    add), forward_bytes against HBM; the larger."""
    t_ops = (ops[0] / BF16_FLOPS + ops[1] / FP32_FLOPS) * 1e3
    t_bytes = forward_bytes(n, k, mp, model_cfg, state_io, bond) \
        / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def layout_equal(got, want):
    """A card layout (rows past total unwritten) equal to the plain one:
    offsets, counts, the total and the compacted slots."""
    total = int(want.total[0])
    return (torch.equal(got.total.cpu(), want.total)
            and torch.equal(got.offset.cpu(), want.offset)
            and torch.equal(got.count.cpu(), want.count)
            and torch.equal(got.slot[0, :total].cpu(), want.slot[0, :total]))


def grads_of(fn, args, g):
    """(out, the 12 grads of sum(out * g)) with respect to e, hn, src, dst
    and the 8 weights, and the leaves, for timing the backward again."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (args[0], *args[3:])]
    e, hn, src, dst, *ws = leaves
    out = fn(e, args[1], args[2], hn, src, dst, *ws)
    return out, leaves, torch.autograd.grad(out, leaves, g,
                                            retain_graph=True)


def train_steps(dev, use_pallas, n_steps):
    """n_steps of the training slice on the kernel or plain path from
    create_train_state(seed=0), cycling over the 4 frames; returns (state,
    per-step metrics, seconds, the slice)."""
    sl = lj_train_slice(dev, use_pallas=use_pallas)
    state = create_train_state(sl.model_cfg, sl.system, sl.train_cfg,
                               len(sl.batches), seed=0, device=dev)
    step = make_train_step(state.model, sl.system, sl.train_cfg,
                           relabel_fn=sl.relabel_fn)
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_steps):
        state, m = step(state, sl.batches[i % len(sl.batches)])
        metrics.append(m)
    torch.cuda.synchronize()
    return state, metrics, time.perf_counter() - t0, sl


def step_agreement(kernel, plain, lr):
    """One training step on the kernel path against the plain path from
    the same state, batch and generator, each given as (state, metrics):
    requires the same augmented positions, the losses within 1e-4
    (relative), each parameter's grad within CONV_GRAD_RTOL x its max
    |grad|, and the parameters after Adam within PARAM_ATOL for a share
    PARAM_SHARE of them and within 2 lr all. Returns the line that says
    so."""
    (sk, mk), (sp, mp_) = kernel, plain
    require(torch.equal(mk["pos"], mp_["pos"]),
            "the two paths drew different augmentations")
    loss_rel = abs(float(mk["loss"]) - float(mp_["loss"])) \
        / abs(float(mp_["loss"]))
    grad_rel, worst = 0.0, None
    for (name, a), b in zip(sk.model.named_parameters(),
                            sp.model.parameters()):
        require(a.grad is not None and b.grad is not None,
                f"no grad for {name}")
        require(bool(torch.isfinite(a.grad).all()), f"non-finite grad {name}")
        err = float((a.grad - b.grad).abs().max())
        mx = float(b.grad.abs().max())
        require(err <= CONV_GRAD_RTOL * mx,
                f"the two paths' grads of {name} disagree: max |d| {err} "
                f"vs max |grad| {mx}")
        if mx and err / mx >= grad_rel:
            grad_rel, worst = err / mx, name
    diffs = torch.cat([(a - b).detach().abs().reshape(-1) for a, b in
                       zip(sk.model.parameters(), sp.model.parameters())])
    share = float((diffs <= PARAM_ATOL).float().mean())
    line = (f"augmented positions identical; loss {float(mk['loss']):.6f} "
            f"vs {float(mp_['loss']):.6f} (rel {loss_rel:.3e}, tolerance "
            f"1e-4); worst grad max |d| / max |grad| {grad_rel:.3e} "
            f"({worst}; tolerance {CONV_GRAD_RTOL} per grad); params after "
            f"Adam: {share:.5%} within {PARAM_ATOL}, max |d| "
            f"{float(diffs.max()):.3e} (bound 2 lr = {2 * lr})")
    require(loss_rel <= 1e-4, "the two paths' losses disagree")
    require(share >= PARAM_SHARE and float(diffs.max()) <= 2 * lr,
            "the two paths' parameters disagree")
    return line


def training_phases(dev, card):
    """Phases 6-9 (module docstring). Returns the two kernels' entries of
    the kernels line."""
    fused = fused_conv_gather_message

    # -- phase 6: the forward kernel against its plain version ----------
    cases = conv_inputs(dev)
    fwd_err = 0.0
    for layer, (case, case_live, *_) in enumerate(cases):
        hn = case[3]
        spread = float((hn - hn[:, :1]).abs().max())
        with torch.no_grad():
            before = fused.launches
            agg = fused(*case)
            torch.cuda.synchronize()
            require(fused.launches == before + 1, "conv_msg_gather did not "
                    "launch")
            ref = batched_reference(*case)
        err = float((agg - ref).abs().max())
        scale = float(ref.abs().max())
        require(bool(torch.isfinite(agg).all()), "non-finite agg")
        n, k = case[1].shape[1:]
        say(f"phase 6: conv_msg_gather vs plain at N={n} K={k} width 128 "
            f"({case_live} live edges of {n * k} slots), layer {layer} of "
            f"the training slice (max |hn - hn[0]| over rows {spread:.3e}): "
            f"max |d agg| {err:.3e}, max |agg| {scale:.3e} (tolerance "
            f"{CONV_RTOL} x max)")
        require(err <= CONV_RTOL * scale,
                f"conv_msg_gather disagrees: {err} vs {scale}")
        fwd_err = max(fwd_err, err)
    require(spread > 1e-2, "layer 1's rows are nearly identical: the "
            "check cannot see a gather from the wrong node")
    (args, live, *_), _ = cases
    n, k = args[1].shape[1:]
    with torch.no_grad():
        same = torch.equal(fused(*args), fused(*args))
        got = edge_tiles.mask_layout(args[2])
        want = edge_tiles.mask_layout(args[2].cpu())
        torch.cuda.synchronize()
    layout_same = layout_equal(got, want)
    say(f"phase 6: two calls bit for bit {same}; the layout kernels "
        f"({int(want.total[0])} live slots) equal to the plain layout "
        f"{layout_same}")
    require(same, "conv_msg_gather differs from run to run")
    require(layout_same, "the layout kernels differ from the plain layout")
    with torch.no_grad():
        fwd_ms = time_ms(lambda: fused(*args))
        fwd_plain_ms = time_ms(lambda: batched_reference(*args))
        fwd_us, fwd_kernels = device_us(lambda: fused(*args))
    fwd_bound, fwd_by = tc_conv_bound(
        live, live_rows_only(conv_bytes(n, k), n, k, live))
    fwd_fp32, _ = roofline(conv_flops(live), conv_bytes(n, k))
    tc_flops, ep_flops = conv_tc_ops(live)
    say(f"phase 6: conv_msg_gather {fwd_ms:.4f} ms/call, "
        f"{fwd_us:.2f} us of device time a call "
        f"{json.dumps({key: round(v, 2) for key, v in fwd_kernels.items()})}"
        f", plain {fwd_plain_ms:.4f} ms/call; bound {fwd_bound:.4f} ms "
        f"({fwd_by}; {tc_flops / 1e9:.4f} GFLOP bf16 x 3 at "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s and {ep_flops / 1e9:.4f} GFLOP "
        f"fp32 at {FP32_FLOPS / 1e12:.0f}, for {live} live edges), device "
        f"time at {fwd_bound * 1e3 / fwd_us:.2%} of it; fp32 CUDA-core "
        f"bound {fwd_fp32:.4f} ms ({conv_flops(live) / 1e9:.4f} GFLOP); "
        f"CUDA events, median of 20 [{card}]")

    # -- phase 7: the backward kernel against autograd through plain -----
    bwd_err = 0.0
    for layer, (case, *_) in enumerate(cases):
        g = torch.randn((1, n, case[3].shape[-1]), device=dev,
                        generator=torch.Generator(dev).manual_seed(7))
        before = fused.backward_launches
        out_k, leaves_k, grads_k = grads_of(fused, case, g)
        torch.cuda.synchronize()
        require(fused.backward_launches == before + 1,
                "conv_msg_gather_bwd did not launch")
        _, _, again = grads_of(fused, case, g)
        out_p, leaves_p, grads_p = grads_of(batched_reference, case, g)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(grads_k, again))
        say(f"phase 7: layer {layer}: two backward calls bit for bit {same}")
        require(same, "conv_msg_gather_bwd differs from run to run")
        for name, a, b in zip(GRAD_NAMES, grads_k, grads_p):
            err, mx = float((a - b).abs().max()), float(b.abs().max())
            say(f"phase 7: layer {layer} grad {name:9s} {tuple(a.shape)}: "
                f"max |d| {err:.3e}, max |grad| {mx:.3e}")
            require(bool(torch.isfinite(a).all()), f"non-finite grad {name}")
            require(err <= CONV_GRAD_RTOL * mx,
                    f"conv_msg_gather_bwd disagrees on {name}: {err} vs "
                    f"{mx}")
            bwd_err = max(bwd_err, err)
        if layer == 0:      # timed on layer 0's inputs
            timed = (out_k, leaves_k, out_p, leaves_p, g)
    out_k, leaves_k, out_p, leaves_p, g = timed
    bwd_call = lambda: torch.autograd.grad(out_k, leaves_k, g,
                                           retain_graph=True)
    bwd_ms = time_ms(bwd_call)
    bwd_plain_ms = time_ms(lambda: torch.autograd.grad(out_p, leaves_p, g,
                                                       retain_graph=True))
    before = fused.backward_launches
    bwd_call()
    require(fused.backward_launches == before + 1,
            "not one backward launch a call")
    bwd_us, bwd_kernels = device_us(bwd_call)
    missing = set(CONV_BWD_KERNELS) - set(bwd_kernels)
    old = {"bwd_edge_kernel", "wgrad_kernel", "bwd_node_kernel"} \
        & set(bwd_kernels)
    require(bwd_us is not None and not missing and not old,
            f"the backward's kernels: {sorted(bwd_kernels)} (missing "
            f"{sorted(missing)}, the first transcription's {sorted(old)})")
    # e's rows and the ids read at the live slots only, ge at every slot.
    bwd_bytes = live_rows_only(conv_bytes(n, k, backward=True), n, k, live)
    bwd_bound, bwd_by = tc_conv_bwd_bound(live, bwd_bytes)
    bwd_fp32, _ = roofline(3 * conv_flops(live),
                           conv_bytes(n, k, backward=True))
    bwd_tc, bwd_ep = conv_bwd_tc_ops(live)
    say(f"phase 7: conv_msg_gather_bwd {bwd_ms:.4f} ms/call (CUDA events, "
        f"with the wrapper's sort of the live slots by source), "
        f"{bwd_us:.2f} us of device time a call "
        f"{json.dumps({key: round(v, 2) for key, v in bwd_kernels.items()})}"
        f", one backward launch a call, plain autograd {bwd_plain_ms:.4f} "
        f"ms/call; bound {bwd_bound:.4f} ms ({bwd_by}; {bwd_tc / 1e9:.4f} "
        f"GFLOP bf16 x 3 at {BF16_FLOPS / 1e12:.0f} TFLOP/s and "
        f"{bwd_ep / 1e9:.4f} GFLOP fp32 at {FP32_FLOPS / 1e12:.0f}, against "
        f"{bwd_bytes / 1e6:.2f} MB, for {live} live edges), device time at {bwd_bound * 1e3 / bwd_us:.2%} of it; fp32 "
        f"CUDA-core bound {bwd_fp32:.4f} ms "
        f"({3 * conv_flops(live) / 1e9:.4f} GFLOP: recompute, input and "
        f"weight grads) (tolerance "
        f"{CONV_GRAD_RTOL} x max per grad); CUDA events, median of 20 "
        f"[{card}]")
    del out_k, out_p, leaves_k, leaves_p, grads_k, grads_p, timed, again

    # -- phase 8: one training step, kernel path against plain path ------
    runs = {flag: train_steps(dev, flag, 1) for flag in (True, False)}
    (sk, mk, _, sl), (sp, mp_, _, _) = runs[True], runs[False]
    say("phase 8: one training step, kernel vs plain path, same seed: "
        + step_agreement((sk, mk[0]), (sp, mp_[0]), sl.train_cfg.lr))
    del runs, sk, sp

    # -- phase 9: the training path --------------------------------------
    fused.launches = fused.backward_launches = 0
    state, metrics, seconds, sl = train_steps(dev, True, TRAIN_STEPS)
    train_launches = (fused.launches, fused.backward_launches)
    _, plain_metrics, plain_seconds, _ = train_steps(dev, False,
                                                     TRAIN_STEPS)
    losses = [float(m["loss"]) for m in metrics]
    layers = sl.model_cfg.conv_layers
    require(all(np.isfinite(float(v)) for m in metrics
                for key, v in m.items() if key != "pos"),
            "non-finite training metrics")
    require(not any(bool(m["nbr_overflow"]) for m in metrics),
            "neighbour overflow in training")
    require(train_launches == (layers * TRAIN_STEPS, layers * TRAIN_STEPS),
            f"launches {train_launches}: want {layers} forward and "
            f"{layers} backward per step")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    say(f"phase 9: training path, {TRAIN_STEPS} steps (LJ-258, GAMD-small "
        f"use_pallas, LayerNorm, K={sl.system.nbr_capacity}, 4 frames, "
        f"rotation, jitter, dropout, relabel): kernel path "
        f"{seconds * 1e3 / TRAIN_STEPS:.3f} ms/step, plain path "
        f"{plain_seconds * 1e3 / TRAIN_STEPS:.3f} ms/step; launches "
        f"(forward, backward) {train_launches}; loss first 5 {first:.5f}, "
        f"last 5 {last:.5f} [{card}]")
    say("phase 9: loss per step " + " ".join(f"{x:.5f}" for x in losses))
    say("phase 9: plain path loss per step " + " ".join(
        f"{float(m['loss']):.5f}" for m in plain_metrics))
    require(last < first, "the training loss did not fall")

    common = {"route": "cuda", "library_ms": None}
    return [{
        "name": "conv_msg_gather", **common,
        "source": "gamd_tpu_torch/csrc/conv_msg_gather.cu",
        "replaces": "gamd_tpu/ops/pallas_mp.py:370",
        "launches": train_launches[0],
        "launches_by_path": {"train": train_launches[0]},
        "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
        "bound_ms": fwd_bound, "bound_by": fwd_by, "device_us": fwd_us,
        "fp32_bound_ms": fwd_fp32,
    }, {
        "name": "conv_msg_gather_bwd", **common,
        "source": "gamd_tpu_torch/csrc/conv_msg_gather_bwd.cu",
        "replaces": "gamd_tpu/ops/pallas_mp.py:530",
        "launches": train_launches[1],
        "launches_by_path": {"train": train_launches[1]},
        "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound, "bound_by": bwd_by, "device_us": bwd_us,
        "fp32_bound_ms": bwd_fp32,
    }]


def encoder_bound(live_edges, n, k, n_rbf, width=128):
    """(least ms, "operations" or "bytes") of one edge_encoder call on one
    frame on the fp32 CUDA-core basis: the three encoder products over the
    live edges (2 per multiply-add), against e written in fp32 for every
    slot, the live mask written, and pos, idx, the build mask and the
    weights read once."""
    flops = 2.0 * live_edges * ((4 + n_rbf) * width + width * width
                                + width * width)
    return roofline(flops, encoder_bytes(n, k, n_rbf, width)), flops


def encoder_bytes(n, k, n_rbf, width=128):
    """Bytes of one fused_edge_encoder call on one frame, each input read
    and each output written once: e for every slot and the live mask out;
    pos, idx, the build mask and the weights in."""
    weights = 4 * ((4 + n_rbf) * width + 2 * width * width + 5 * width)
    return 4 * n * k * width + n * k + 4 * n * 3 + 4 * n * k + n * k \
        + weights


#: fp32 operations of the encoder's epilogues a row and column as the
#: tensor-core kernel (csrc/encode.cuh) runs them: the rank-1 geometric
#: terms (8), three biases (3), two tanh-gelus (8 each) and the LayerNorm
#: with its affine (7); and of the RBF a row and centre (4: a difference,
#: two products, the exponential).
ENCODER_EPILOGUE_OPS, RBF_OPS = 34, 4


def encoder_tc_ops(rows, n_rbf, width=128):
    """(tensor-core FLOP, fp32 FLOP) of the encoder over `rows` rows as the
    tensor-core kernel computes them: the products 2 ((4 + n_rbf) width +
    2 width^2) a row as three bf16 passes, the epilogues and the RBF on
    the CUDA cores."""
    return (3.0 * 2 * rows * ((4 + n_rbf) * width + 2 * width * width),
            float(rows * (ENCODER_EPILOGUE_OPS * width + RBF_OPS * n_rbf)))


def encoder_tc_bound(rows, nbytes, n_rbf):
    """(least ms, "operations" or "bytes") of the encoder on the
    tensor-core basis: encoder_tc_ops over `rows` against the bf16 tensor
    peak and the fp32 peak (their times add), nbytes against HBM; the
    larger."""
    tc_flops, fp32_flops = encoder_tc_ops(rows, n_rbf)
    t_ops = (tc_flops / BF16_FLOPS + fp32_flops / FP32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def live_encoder_bytes(n, live_edges, n_rbf, width=128):
    """Bytes of one live_edge_encoder call: pos, the layout's slot ids and
    the live slots' ids and weights read once, e's live rows written."""
    weights = 4 * ((4 + n_rbf) * width + 2 * width * width + 5 * width)
    return 4 * n * 3 + live_edges * (4 + 4 + 4 * width) + weights


def classical_frames(dev, system):
    """Frames of a classical LJ run with the port's forces: the FCC lattice
    minimised by 1000 FIRE steps (as run_md starts), then BAOAB Langevin at
    the system's temperature and 25/ps, CLASSICAL_EQUIL steps discarded and
    one wrapped frame every 20 steps of CLASSICAL_STEPS kept."""
    _, lattice = lj_fluid_box(system.n_atoms, 0.5)
    pos, _ = fire_minimize(lambda p: lj_forces_dense(p, system.box),
                           torch.as_tensor(lattice, device=dev),
                           n_steps=1000)
    md = MDConfig(integrator="langevin", temperature=system.temperature,
                  dt_fs=system.dt_fs, friction_per_ps=25.0,
                  rebuild_every=20)
    sim = Simulation(lj_force_fn(system.box), system, md, device=dev)
    state = sim.init_state(pos, rng=torch.Generator(dev).manual_seed(3))
    equil = sim.run(state, CLASSICAL_EQUIL)
    run = sim.run(equil.state, CLASSICAL_STEPS)
    require(not equil.overflow and not run.overflow,
            "neighbour overflow in the classical run")
    temps = run.thermo.temperature
    return run.positions, float(temps.mean())


def encoder_phase(dev, card, state, model_cfg, system):
    """Phase 10 (module docstring). Returns the kernel's entry fields."""
    fused = fused_edge_encoder
    p = state.params
    weights = [torch.as_tensor(p[name], device=dev) for name in (
        "edge_encoder_w0", "edge_encoder_b0", "edge_encoder_w1",
        "edge_encoder_b1", "edge_encoder_w2", "edge_encoder_b2",
        "edge_ln_scale", "edge_ln_bias")]
    kw = dict(rbf_low=model_cfg.rbf_low, rbf_high=model_cfg.rbf_high,
              rbf_gap=model_cfg.rbf_gap, flip_dir=model_cfg.flip_dir)
    scales = (state.length_stat.safe_mean, max(state.length_stat.std, 1e-12))
    _, lattice = lj_fluid_box(system.n_atoms, 0.5)
    rng = np.random.default_rng(10)
    frames = lattice[None] + rng.normal(0.0, 0.1, (ENCODER_BATCH,
                                                   *lattice.shape))
    pos = space.wrap(torch.as_tensor(frames.astype(np.float32), device=dev),
                     system.box)
    lists = [build_nbrs(f, system) for f in pos]
    require(not any(bool(t[2]) for t in lists),
            "neighbour overflow at the encoder's frames")
    idx = torch.stack([t[0] for t in lists])
    mask = torch.stack([t[1] for t in lists])
    n, k = idx.shape[1:]

    def call(fn, b, cutoff):
        sl = slice(0, b)
        return fn(pos[sl], idx[sl], mask[sl], system.box, cutoff, *scales,
                  *weights, **kw)

    err_max = 0.0
    for cutoff in (None, system.cutoff):
        before = fused.launches
        e, live = call(fused, 1, cutoff)
        torch.cuda.synchronize()
        require(fused.launches == before + 1, "edge_encoder did not launch")
        e_ref, live_ref = call(edge_encoder_reference, 1, cutoff)
        err, scale = float((e - e_ref).abs().max()), float(e_ref.abs().max())
        require(bool(torch.isfinite(e).all()), "non-finite e")
        require(torch.equal(live, live_ref), f"live masks differ (cutoff "
                f"{cutoff})")
        say(f"phase 10: edge_encoder vs plain at N={n} K={k} width "
            f"{e.shape[-1]}, cutoff {cutoff} ({int(live.sum())} live of "
            f"{n * k} slots, build mask {int(mask[0].sum())}): max |de| "
            f"{err:.3e}, max |e| {scale:.3e} (tolerance {ENCODER_RTOL} x "
            "max), live masks identical")
        require(err <= ENCODER_RTOL * scale,
                f"edge_encoder disagrees: {err} vs {scale}")
        err_max = max(err_max, err)
    live_edges = int(live.sum())          # the frame at the 7.5 A cutoff

    before = fused.launches
    e_b, live_b = call(fused, ENCODER_BATCH, system.cutoff)
    singles = [fused(pos[f], idx[f], mask[f], system.box, system.cutoff,
                     *scales, *weights, **kw) for f in range(ENCODER_BATCH)]
    torch.cuda.synchronize()
    require(fused.launches == before + 1 + ENCODER_BATCH,
            "edge_encoder did not launch")
    e_bref, live_bref = call(edge_encoder_reference, ENCODER_BATCH,
                             system.cutoff)
    vs_single = max(float((e_b[f] - s[0]).abs().max())
                    for f, s in enumerate(singles))
    same_live = all(torch.equal(live_b[f], s[1])
                    for f, s in enumerate(singles))
    err_b = float((e_b - e_bref).abs().max())
    scale_b = float(e_bref.abs().max())
    say(f"phase 10: edge_encoder B={ENCODER_BATCH} in one call vs "
        f"{ENCODER_BATCH} single-frame calls: max |de| {vs_single:.3e}, "
        f"live masks identical {same_live}; vs plain: max |de| {err_b:.3e}"
        f", max |e| {scale_b:.3e}")
    require(same_live and torch.equal(live_b, live_bref),
            "batched live masks differ")
    require(vs_single <= ENCODER_RTOL * scale_b
            and err_b <= ENCODER_RTOL * scale_b,
            "the batched call disagrees with single calls or plain")
    err_max = max(err_max, err_b)

    ms = time_ms(lambda: call(fused, 1, system.cutoff))
    plain_ms = time_ms(lambda: call(edge_encoder_reference, 1,
                                    system.cutoff))
    batch_ms = time_ms(lambda: call(fused, ENCODER_BATCH, system.cutoff))
    dev_us, dev_kernels = device_us(lambda: call(fused, 1, system.cutoff))
    batch_us, _ = device_us(lambda: call(fused, ENCODER_BATCH,
                                         system.cutoff))
    n_rbf = model_cfg.n_rbf
    nbytes = encoder_bytes(n, k, n_rbf)
    live_batch = int(live_b.sum())
    bound_ms, bound_by = encoder_tc_bound(live_edges, nbytes, n_rbf)
    batch_bound, batch_by = encoder_tc_bound(live_batch,
                                             ENCODER_BATCH * nbytes, n_rbf)
    every_ms, every_by = encoder_tc_bound(n * k, nbytes, n_rbf)
    (fp32_ms, fp32_by), flops = encoder_bound(live_edges, n, k, n_rbf)
    tc_flops, ep_flops = encoder_tc_ops(live_edges, n_rbf)
    say(f"phase 10: edge_encoder {ms:.4f} ms/call (B=1), {batch_ms:.4f} "
        f"ms/call (B={ENCODER_BATCH}), plain {plain_ms:.4f} ms/call (B=1); "
        f"CUDA events, median of 20; device time {dev_us:.2f} us a call "
        f"(B=1) "
        f"{json.dumps({key: round(v, 2) for key, v in dev_kernels.items()})}"
        f", {batch_us:.2f} us (B={ENCODER_BATCH}) [{card}]")
    say(f"phase 10: edge_encoder bound on the tensor-core basis {bound_ms:.4f}"
        f" ms at B=1 ({bound_by}; {tc_flops / 1e9:.4f} GFLOP bf16 x 3 at "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s and {ep_flops / 1e9:.4f} GFLOP "
        f"fp32 at {FP32_FLOPS / 1e12:.0f} for {live_edges} live edges, e "
        f"fp32 for {n * k} slots, {nbytes / 1e6:.2f} MB), device time at "
        f"{bound_ms * 1e3 / dev_us:.2%} of it; {batch_bound:.4f} ms at "
        f"B={ENCODER_BATCH} ({batch_by}; {live_batch} live edges), at "
        f"{batch_bound * 1e3 / batch_us:.2%}; fp32 CUDA-core basis "
        f"{fp32_ms:.4f} ms ({fp32_by}; {flops / 1e9:.4f} GFLOP); the "
        f"products over every slot, which the kernel computes, "
        f"{every_ms:.4f} ms ({every_by})")
    return {"max_abs_err": err_max, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "device_us": dev_us,
            "fp32_bound_ms": fp32_ms, "every_slot_bound_ms": every_ms,
            "b16": {"ms": batch_ms, "device_us": batch_us,
                    "bound_ms": batch_bound, "bound_by": batch_by}}


def deployment_phases(dev, card):
    """Phases 10-13 (module docstring). Returns (the edge_encoder entry of
    the kernels line, launches by path of the deployment's runs, phase 11's
    classical frames)."""
    state, model_cfg, system = load_self_describing(
        CKPT, use_pallas=True, use_pallas_encoder=True)
    require(model_cfg.hidden_dim == model_cfg.edge_embedding_dim
            == model_cfg.encoding_size == 128 and model_cfg.conv_layers == 4,
            f"the checkpoint is not GAMD-small: {model_cfg}")
    kernel = encoder_phase(dev, card, state, model_cfg, system)
    unit = system.force_unit_to_internal
    enc, conv = fused_edge_encoder, fused_conv_gather_message
    launches = {}

    # -- phase 11: the deployment force path --------------------------------
    t0 = time.perf_counter()
    traj, t_classical = classical_frames(dev, system)
    say(f"phase 11: classical run (port LJ forces, 1000 FIRE steps, "
        f"{CLASSICAL_EQUIL} + {CLASSICAL_STEPS} Langevin steps, 25/ps): "
        f"{traj.shape[0]} frames, mean T {t_classical:.2f} K, "
        f"{time.perf_counter() - t0:.1f} s")
    ff = GNNForceField(state, system, model_cfg, device=dev)
    ff_cpu = GNNForceField(state, system, model_cfg, device="cpu")
    pos = traj[-1]
    idx, mask, _ = dense_neighbor_list(pos, system.box, system.cutoff,
                                       system.nbr_capacity)
    before = (enc.launches, conv.launches)
    f_card = ff.force_fn()(pos, idx, mask)
    torch.cuda.synchronize()
    per_call = (enc.launches - before[0], conv.launches - before[1])
    f_cpu = ff_cpu.force_fn()(pos.cpu(), idx.cpu(), mask.cpu())
    err = float((f_card.cpu() - f_cpu).abs().max())
    scale = float(f_cpu.std())
    say(f"phase 11: force_fn (use_pallas, use_pallas_encoder) on the card "
        f"vs on the CPU (plain versions), trained LJ-258: max |dF| "
        f"{err:.3e} kJ/mol/A, std(F) {scale:.3e} (tolerance {TOLERANCE} x "
        f"std); launches per force call: edge_encoder {per_call[0]}, "
        f"conv_msg_gather {per_call[1]}")
    require(per_call == (1, model_cfg.conv_layers),
            f"launches per force call {per_call}")
    require(err < TOLERANCE * scale, "the card's forces disagree")

    sel = np.round(np.linspace(0, traj.shape[0] - 1,
                               PREDICT_FRAMES)).astype(int)
    frames = traj[torch.as_tensor(sel, device=dev)]
    one = ff.predict(frames[0])
    t0 = time.perf_counter()
    batch = ff.predict_batch(frames, batch_size=PREDICT_BATCH)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    singles = torch.stack([ff.predict(f) for f in frames])
    labels = lj_forces_dense(frames, system.box) / unit     # kJ/mol/nm
    scale_ds = float(labels.std())
    vs_single = float((batch - singles).abs().max())
    mae = float((batch - labels).abs().mean())
    mean_label = float(labels.abs().mean())
    require(bool(torch.isfinite(batch).all()) and batch.shape
            == (PREDICT_FRAMES, system.n_atoms, 3), "predict_batch output")
    require(torch.equal(one, singles[0]), "predict is not deterministic")
    say(f"phase 11: predict_batch of {PREDICT_FRAMES} frames at batch size "
        f"{PREDICT_BATCH} ({batch_s:.3f} s) vs per-frame predict: max |dF| "
        f"{vs_single:.3e} kJ/mol/nm, std(F_label) {scale_ds:.3e} "
        f"(tolerance {PREDICT_RTOL} x std); force MAE vs LJ labels "
        f"{mae:.4f} kJ/mol/nm, mean |F_label| {mean_label:.4f} "
        f"(relative MAE {mae / mean_label:.4f}) [{card}]")
    require(vs_single <= PREDICT_RTOL * scale_ds,
            "predict_batch disagrees with predict")
    require(mae < mean_label, "the force MAE is not below mean |F_label|")

    # -- phase 12: the deployment MD path ------------------------------------
    md = MDConfig(integrator="langevin", temperature=system.temperature,
                  dt_fs=system.dt_fs, friction_per_ps=25.0,
                  rebuild_every=20)
    sim = Simulation(ff.force_fn(), system, md, device=dev)
    gen = torch.Generator(dev).manual_seed(4)
    enc.launches = conv.launches = 0
    mega_forward.launches = mega_md_steps.launches = 0
    st = sim.init_state(pos, rng=gen)
    warm = sim.run(st, WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(warm.state, DEPLOY_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    deploy = {"edge_encoder": enc.launches,
              "conv_msg_gather": conv.launches,
              "mega_forward": mega_forward.launches,
              "mega_md_steps": mega_md_steps.launches}
    launches["deploy_md"] = deploy
    calls = 1 + WARMUP_STEPS + DEPLOY_STEPS
    temps = res.thermo.temperature
    mean_t = float(temps.mean())
    require(bool(torch.isfinite(res.state.pos).all())
            and bool(torch.isfinite(temps).all()), "non-finite MD state")
    require(not warm.overflow and not res.overflow,
            "neighbour overflow (deployment MD)")
    require(deploy == {"edge_encoder": calls,
                       "conv_msg_gather": model_cfg.conv_layers * calls,
                       "mega_forward": 0, "mega_md_steps": 0},
            f"launches {deploy} for {calls} force calls")
    say(f"phase 12: deployment MD (trained LJ-258 GAMD-small, "
        f"use_pallas_encoder, K={system.nbr_capacity} at cutoff + skin "
        f"{system.cutoff + system.skin:.2f} A), {DEPLOY_STEPS} Langevin "
        f"steps in {seconds:.4f} s = {DEPLOY_STEPS / seconds:.1f} steps/s; "
        f"mean T {mean_t:.2f} K (band 100 +- {T_BAND} K); launches "
        f"{deploy} for {calls} force calls [{card}]")
    require(abs(mean_t - md.temperature) <= T_BAND,
            f"mean temperature {mean_t} K outside 100 +- {T_BAND} K")

    # -- phase 13: the port CLIs ---------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        gt = os.path.join(tmp, "gt")
        os.mkdir(gt)
        for t, frame in enumerate(traj.cpu().numpy()):
            np.savez(os.path.join(gt, f"data_0_{200 + t}.npz"), pos=frame)
        steps = RUN_MD_STEPS["--megastep"]
        runs = [("--megastep", steps, "run_md_megastep",
                 ("mega_md_steps", steps // 20))]
        steps = RUN_MD_STEPS["--use_pallas"]
        runs.append(("--use_pallas", steps, "run_md_use_pallas",
                     ("conv_msg_gather", model_cfg.conv_layers * (steps + 1))))
        for flag, steps, name, (kernel_name, expected) in runs:
            log = os.path.join(tmp, f"{name}.txt")
            out = os.path.join(tmp, f"{name}.npy")
            enc.launches = conv.launches = 0
            mega_forward.launches = mega_md_steps.launches = 0
            t0 = time.perf_counter()
            run_md.main(["--ckpt", CKPT, flag, "--steps", str(steps),
                         "--log", log, "--out_traj", out])
            seconds = time.perf_counter() - t0
            counts = {"edge_encoder": enc.launches,
                      "conv_msg_gather": conv.launches,
                      "mega_forward": mega_forward.launches,
                      "mega_md_steps": mega_md_steps.launches}
            launches[name] = counts
            lines = open(log).read().splitlines()
            temps = [float(line.split("\t")[3]) for line in lines[1:]]
            final = np.load(out)
            say(f"phase 13: run_md --ckpt {CKPT} {flag} --steps {steps}: "
                f"{seconds:.1f} s with the FIRE start; {len(lines) - 1} "
                f"thermo rows, last T {temps[-1]:.2f} K, mean "
                f"{np.mean(temps):.2f} K; launches {counts}")
            require(lines[0] == THERMO_HEADER
                    and len(lines) == 1 + steps // 100,
                    f"thermo log format ({flag})")
            require(all(math.isfinite(t) for t in temps)
                    and final.shape == (system.n_atoms, 3)
                    and np.isfinite(final).all(), f"run_md output ({flag})")
            require(counts[kernel_name] == expected,
                    f"launches {counts} ({flag})")

        report_path = os.path.join(tmp, "report.json")
        enc.launches = conv.launches = 0
        mega_forward.launches = mega_md_steps.launches = 0
        t0 = time.perf_counter()
        analyze_rollout.main([
            "--ckpt", CKPT, "--data_dir", gt, "--integrator", "langevin",
            "--friction", "25", "--megastep", "--steps", str(ANALYZE_STEPS),
            "--classical_baseline", "--pe", "--json_out", report_path])
        seconds = time.perf_counter() - t0
        launches["analyze_rollout_megastep"] = {
            "mega_forward": mega_forward.launches,
            "mega_md_steps": mega_md_steps.launches}
        with open(report_path) as f:
            report = json.load(f)
        with open(report_path + "_pe.tsv") as f:
            pe_rows = len(f.read().splitlines()) - 1
    bin_width = system.box / 2 / len(report["r"])
    keys = ("rdf_l2", "rdf_l2_vs_classical_rollout", "rdf_peak_pos_gnn",
            "rdf_peak_pos_gt", "rdf_peak_gnn", "rdf_peak_gt",
            "rdf_peak_classical_rollout", "temperature_mean",
            "classical_temperature_mean", "pe_gnn_mean_kj_mol",
            "pe_classical_mean_kj_mol", "pe_gnn_std_kj_mol",
            "pe_classical_std_kj_mol", "pe_gnn_drift_kj_mol_ps",
            "diffusion_m2_s", "classical_diffusion_m2_s", "n_rollout_frames",
            "n_gt_frames")
    say(f"phase 13: analyze_rollout --megastep --steps {ANALYZE_STEPS} "
        f"--classical_baseline --pe ({seconds:.1f} s; ground truth: phase "
        f"11's {traj.shape[0]} classical frames; {pe_rows} PE rows): "
        + ", ".join(f"{key} {report.get(key)}" for key in keys)
        + f"; launches {launches['analyze_rollout_megastep']} [{card}]")
    require(all(math.isfinite(v) for v in report.values()
                if isinstance(v, float)), "non-finite report values")
    require(abs(report["rdf_peak_pos_gnn"] - report["rdf_peak_pos_gt"])
            <= bin_width * 1.001,
            "the GNN's RDF peak is more than one bin from the classical one")
    require(abs(report["temperature_mean"] - system.temperature) <= T_BAND,
            "analyze_rollout's mean temperature is outside the band")
    require(launches["analyze_rollout_megastep"]["mega_md_steps"]
            == ANALYZE_STEPS // 20,
            "analyze_rollout did not run the megastep kernel")

    entry = {"name": "edge_encoder", "route": "cuda",
             "source": "gamd_tpu_torch/csrc/edge_encoder.cu",
             "replaces": "gamd_tpu/ops/pallas_encoder.py:46",
             "launches": deploy["edge_encoder"],
             "launches_by_path": {"deploy_md": deploy["edge_encoder"]},
             **kernel, "library_ms": None}
    return entry, launches, traj


def banded_bytes(n, k, rows, n_tiles, width=128):
    """Bytes banded_msg must move, each input read and each output written
    once: e, idx_loc, mask, lo, the extended node array [rows, 2 width],
    dst and the weights in, agg out."""
    weights = 4 * (4 * width * width + 4 * width)
    return 4 * n * k * width + 5 * n * k + 4 * n_tiles \
        + 4 * rows * 2 * width + 2 * 4 * n * width + weights


def large_frame(dev, n, seed):
    """bench_large's LJ fluid of n atoms displaced by a seeded 0.1 A
    jitter, its cell list at cutoff + skin (K=96) and the seeded
    GAMD-small force field."""
    system, lattice = lj_large(n, LARGE_K, dev)
    jitter = np.random.default_rng(seed).normal(0.0, 0.1, lattice.shape)
    pos = torch.remainder(lattice + torch.as_tensor(
        jitter.astype(np.float32), device=dev), system.box)
    idx, mask, ovf = cell_list_neighbor_list(
        pos, system.box, system.cutoff + system.skin, LARGE_K)
    require(not bool(ovf), f"cell-list overflow at the N={n} frame")
    return pos, idx, mask, seeded_force_field(system, dev)


def live_encoder_phase(ff, pos, idx, mask, card):
    """Phase 15's check of live_edge_encoder on phase 14's frame: the
    route's layout from the true-cutoff mask, two calls against the plain
    version on the live rows and against each other, the banded forward
    with e's buffer filled with NaN, and the times. Returns its fields of
    the edge_encoder entry."""
    system, cfg = ff.system, ff.model_cfg
    n, k = idx.shape
    mp = ff._kernel_params("banded")
    length_mean, length_std = ff._length_scale()
    perm, inv, idx_s = banded.sort_by_x(pos, idx)
    pos_s, idx32 = pos[perm], idx_s.to(torch.int32)
    _, _, live = banded.banded_geometry(pos_s, idx_s, mask[perm],
                                        system.box, system.cutoff)
    layout = edge_tiles.mask_layout(live)
    kw = dict(rbf_gap=cfg.rbf_gap, flip_dir=cfg.flip_dir)

    def encode(out=None):
        return live_edge_encoder(pos_s, idx32, layout, mp, system.box,
                                 length_mean, length_std, n_rbf=cfg.n_rbf,
                                 out=out, **kw)

    before = live_edge_encoder.launches
    e1, e2 = encode(), encode()
    torch.cuda.synchronize()
    require(live_edge_encoder.launches == before + 2,
            "live_edge_encoder did not launch")
    ref = live_edge_encoder_reference(pos_s, idx32, layout, mp, system.box,
                                      length_mean, length_std, **kw)
    err = float((e1[live] - ref[live]).abs().max())
    scale = float(ref[live].abs().max())
    same = torch.equal(e1[live], e2[live])
    n_live = int(live.sum())
    say(f"phase 15: live_edge_encoder vs plain at N={n} K={k} on the "
        f"route's layout ({n_live} live slots of {n * k}): max |de| "
        f"{err:.3e}, max |e| {scale:.3e} (tolerance {ENCODER_RTOL} x max) "
        f"on the live rows; two calls bit for bit {same}")
    require(bool(torch.isfinite(e1[live]).all()), "non-finite live rows")
    require(err <= ENCODER_RTOL * scale, "live_edge_encoder disagrees")
    require(same, "live_edge_encoder differs from run to run")

    # e's buffer filled with NaN: the dead rows are neither written nor read.
    poisoned = torch.full((n, k, 128), float("nan"), device=pos.device)
    band = ff.banded_force_fn().banded_band
    f_s, ovf = banded.banded_forward(
        pos_s, idx_s, mask[perm], ff._node_h0()[perm], mp, system.box,
        system.cutoff, length_mean, length_std, band,
        use_ln=cfg.use_layer_norm, mlp_act=cfg.mlp_activation,
        e_out=poisoned, **kw)
    f = f_s[inv]
    ref_f = reference_forward(pos, idx, mask, ff._node_h0(), mp, system.box,
                              system.cutoff, length_mean, length_std,
                              rbf_gap=cfg.rbf_gap)
    f_err, f_scale = float((f - ref_f).abs().max()), float(ref_f.std())
    dead_nan = bool(torch.isnan(poisoned[~live]).all())
    say(f"phase 15: banded_forward with e's buffer filled with NaN: forces "
        f"finite {bool(torch.isfinite(f).all())}, max |dF| vs "
        f"reference_forward {f_err:.3e}, std(F) {f_scale:.3e}, ratio "
        f"{f_err / f_scale:.3e} (tolerance {TOLERANCE}); the dead rows still"
        f" NaN {dead_nan}, no overflow {not bool(ovf)}")
    require(bool(torch.isfinite(f).all()) and not bool(ovf),
            "a dead row of e reached the forces")
    require(f_err <= TOLERANCE * f_scale, "the poisoned forces disagree")
    require(dead_nan, "live_edge_encoder wrote a dead row")
    del poisoned, f_s, f, ref_f

    with torch.no_grad():
        ms = time_ms(encode)
        plain_ms = time_ms(lambda: live_edge_encoder_reference(
            pos_s, idx32, layout, mp, system.box, length_mean, length_std,
            **kw))
        dev_us, dev_kernels = device_us(encode)
    nbytes = live_encoder_bytes(n, n_live, cfg.n_rbf)
    bound_ms, bound_by = encoder_tc_bound(n_live, nbytes, cfg.n_rbf)
    fp32_ms = roofline(2.0 * n_live * ((4 + cfg.n_rbf) * 128
                                       + 2 * 128 * 128), nbytes)[0]
    tc_flops, ep_flops = encoder_tc_ops(n_live, cfg.n_rbf)
    say(f"phase 15: live_edge_encoder {ms:.4f} ms/call, {dev_us:.2f} us of "
        f"device time a call "
        f"{json.dumps({key: round(v, 2) for key, v in dev_kernels.items()})}"
        f", plain {plain_ms:.4f} ms/call; bound {bound_ms:.4f} ms "
        f"({bound_by}; {tc_flops / 1e9:.4f} GFLOP bf16 x 3 at "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s and {ep_flops / 1e9:.4f} GFLOP "
        f"fp32 at {FP32_FLOPS / 1e12:.0f}, e's {n_live} live rows "
        f"{nbytes / 1e6:.1f} MB), device time at "
        f"{bound_ms * 1e3 / dev_us:.2%} of it; fp32 CUDA-core basis "
        f"{fp32_ms:.4f} ms; CUDA events, median of 20 [{card}]")
    return {"live_slots": {"n": n, "k": k, "live": n_live, "max_abs_err":
                           err, "ms": ms, "plain_ms": plain_ms,
                           "device_us": dev_us, "bound_ms": bound_ms,
                           "bound_by": bound_by, "fp32_bound_ms": fp32_ms}}


def large_n_phases(dev, card):
    """Phases 14-17 (module docstring). Returns (the banded_msg entry of
    the kernels line, live_edge_encoder's launches by path, its check's
    fields)."""
    call = banded.banded_conv_message
    n = LARGE_N[-1]

    # -- phase 14: banded_msg against its plain version --------------------
    pos, idx, mask, ff = large_frame(dev, n, seed=14)
    err_max = 0.0
    for layer in (0, 1):
        args = banded_layer_inputs(ff, pos, idx, mask, layer)
        e, idx_loc, mask_s, lo, nodes, dst, _, mp, band, tile_n = args
        before = call.launches
        agg = call(*args)
        torch.cuda.synchronize()
        require(call.launches == before + 1, "banded_msg did not launch")
        weights = banded.layer_weights(mp, layer)
        ref = banded.banded_msg_reference(e, idx_loc, mask_s, lo, nodes,
                                          dst, *weights, tile_n=tile_n)
        err, scale = float((agg - ref).abs().max()), float(ref.abs().max())
        live = int(mask_s.sum())
        spread = float((nodes[:n, :128] - nodes[:1, :128]).abs().max())
        require(bool(torch.isfinite(agg).all()), "non-finite banded agg")
        say(f"phase 14: banded_msg vs plain at N={n} K={LARGE_K} band "
            f"{band} tile {tile_n}, layer {layer} of a displaced frame "
            f"({live} live edges of {n * LARGE_K} slots; max |hn - hn[0]| "
            f"over rows {spread:.3e}): max |d agg| {err:.3e}, max |agg| "
            f"{scale:.3e} (tolerance {CONV_RTOL} x max)")
        require(err <= CONV_RTOL * scale,
                f"banded_msg disagrees: {err} vs {scale}")
        err_max = max(err_max, err)
        if layer == 0:
            timed = args, weights, live
    require(spread > 1e-2, "layer 1's rows are nearly identical: the check "
            "cannot see a read from the wrong row")
    args, weights, live = timed
    layout = edge_tiles.mask_layout(args[2])
    same = torch.equal(call(*args, layout=layout), call(*args))
    layout_same = layout_equal(layout, edge_tiles.mask_layout(args[2].cpu()))
    say(f"phase 14: two calls (the layout given, and computed in the call) "
        f"bit for bit {same}; the layout kernels ({live} live slots of "
        f"{n * LARGE_K}) equal to the plain layout {layout_same}")
    require(same, "banded_msg differs from run to run")
    require(layout_same, "the layout kernels differ from the plain layout")
    with torch.no_grad():
        ms = time_ms(lambda: call(*args, layout=layout))
        plain_ms = time_ms(lambda: banded.banded_msg_reference(
            *args[:6], *weights, tile_n=args[9]))
        dev_us, dev_kernels = device_us(lambda: call(*args, layout=layout))
        layout_us, _ = device_us(lambda: edge_tiles.mask_layout(args[2]))
    nodes, lo = args[4], args[3]
    nbytes = banded_bytes(n, LARGE_K, nodes.shape[0], lo.shape[0])
    bound_ms, bound_by = tc_conv_bound(
        live, live_rows_only(nbytes, n, LARGE_K, live))
    fp32_ms, _ = roofline(conv_flops(live), nbytes)
    tc_flops, ep_flops = conv_tc_ops(live)
    say(f"phase 14: banded_msg {ms:.4f} ms/call, {dev_us:.2f} us of device "
        f"time a call "
        f"{json.dumps({key: round(v, 2) for key, v in dev_kernels.items()})}"
        f" over a given layout (the layout, once a force call: "
        f"{layout_us:.2f} us), plain {plain_ms:.4f} ms/call; bound "
        f"{bound_ms:.4f} ms ({bound_by}; {tc_flops / 1e9:.4f} GFLOP bf16 x 3"
        f" at {BF16_FLOPS / 1e12:.0f} TFLOP/s and {ep_flops / 1e9:.4f} "
        f"GFLOP fp32 at {FP32_FLOPS / 1e12:.0f}, for {live} live edges), "
        f"device time at {bound_ms * 1e3 / dev_us:.2%} of it; fp32 "
        f"CUDA-core bound {fp32_ms:.4f} ms ({conv_flops(live) / 1e9:.4f} "
        f"GFLOP); CUDA events, median of 20 [{card}]")
    # The same list in a band too narrow: the flag, and NaN forces.
    _, _, flag = banded.band_layout(banded.sort_by_x(pos, idx)[2], args[2],
                                    n, 256, args[9])
    f_narrow = ff.banded_force_fn(band=256)(pos, idx, mask)
    say(f"phase 14: band 256 (too narrow): overflow flag {bool(flag)}, "
        f"forces all NaN {bool(torch.isnan(f_narrow).all())}")
    require(bool(flag) and bool(torch.isnan(f_narrow).all()),
            "a band overflow did not poison the forces")
    del args, timed, f_narrow

    # -- phase 15: the encoder over live slots, the banded force path ------
    live_entry = live_encoder_phase(ff, pos, idx, mask, card)
    fn = ff.banded_force_fn()
    system, cfg = ff.system, ff.model_cfg
    before = (call.launches, live_edge_encoder.launches,
              edge_tiles.mask_layout.launches)
    f = fn(pos, idx, mask)
    torch.cuda.synchronize()
    per_call = (call.launches - before[0],
                live_edge_encoder.launches - before[1],
                edge_tiles.mask_layout.launches - before[2])
    ref = reference_forward(pos, idx, mask, ff._node_h0(),
                            ff._kernel_params("banded"), system.box,
                            system.cutoff, *ff._length_scale(),
                            rbf_gap=cfg.rbf_gap)
    err, scale = float((f - ref).abs().max()), float(ref.std())
    say(f"phase 15: banded_force_fn (band {fn.banded_band}) vs "
        f"reference_forward on the card, N={n}, seeded GAMD-small: max |dF| "
        f"{err:.3e}, std(F) {scale:.3e}, ratio {err / scale:.3e} "
        f"(tolerance {TOLERANCE}); launches per call: banded_msg "
        f"{per_call[0]}, live_edge_encoder {per_call[1]}, mask_layout "
        f"{per_call[2]}")
    require(bool(torch.isfinite(f).all()), "non-finite banded forces")
    require(per_call == (cfg.conv_layers, 1, 1),
            f"{per_call} launches per call")
    require(err <= TOLERANCE * scale, "the banded forces disagree")
    del f, ref

    # -- phase 16: the large-N MD path -------------------------------------
    launches, enc_launches = {}, {}
    for size in LARGE_N:
        system, pos = lj_large(size, LARGE_K, dev)
        bfn = seeded_force_field(system, dev).banded_force_fn()
        sim = Simulation(bfn, system, LARGE_MD, nbr_method="cell",
                         device=dev)
        call.launches = edge_tiles.mask_layout.launches = 0
        live_edge_encoder.launches = 0
        mega_forward.launches = mega_md_steps.launches = 0
        st = sim.init_state(pos, rng=torch.Generator(dev).manual_seed(16))
        warm = sim.run(st, WARMUP_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run(warm.state, LARGE_STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        calls = 1 + WARMUP_STEPS + LARGE_STEPS
        launches[f"large_n_md_{size}"] = call.launches
        enc_launches[f"large_n_md_{size}"] = live_edge_encoder.launches
        temps = res.thermo.temperature
        mean_t = float(temps.mean())
        sps = LARGE_STEPS / seconds
        say(f"phase 16: large-N MD N={size} (band {bfn.banded_band}, cell "
            f"list K={LARGE_K}, rebuild every {LARGE_MD.rebuild_every}): "
            f"{LARGE_STEPS} Langevin steps in {seconds:.4f} s = {sps:.2f} "
            f"steps/s, {sps * size:.0f} atom-steps/s; mean T {mean_t:.2f} K "
            f"(band 100 +- {T_BAND} K); banded_msg launches {call.launches}, "
            f"live_edge_encoder {live_edge_encoder.launches} for {calls} "
            f"force calls [{card}]")
        require(not warm.overflow and not res.overflow,
                f"neighbour overflow (large-N MD, N={size})")
        require(bool(torch.isfinite(res.state.pos).all())
                and bool(torch.isfinite(res.state.force).all()),
                f"non-finite large-N MD state (N={size})")
        require(call.launches == cfg.conv_layers * calls
                and edge_tiles.mask_layout.launches == calls
                and live_edge_encoder.launches == calls
                and mega_forward.launches == mega_md_steps.launches == 0,
                f"launches {call.launches}, {live_edge_encoder.launches} for "
                f"{calls} force calls")
        require(abs(mean_t - LARGE_MD.temperature) <= T_BAND,
                f"mean temperature {mean_t} K outside 100 +- {T_BAND} K")
        kernels, _ = exclusive_times(traced_spans(
            lambda: sim.run(res.state, SHARE_STEPS), 1))
        step_us = sum(v["us"] for v in kernels.values()) / SHARE_STEPS
        msg_us = sum(v["us"] for key, v in kernels.items()
                     if key in BANDED_KERNELS) / SHARE_STEPS
        enc_us = sum(v["us"] for key, v in kernels.items()
                     if key in ENCODER_KERNELS) / SHARE_STEPS
        say(f"phase 16: N={size}: {step_us:.1f} us of device time a step, "
            f"the banded message (layout, splits, tiles, fix-ups) "
            f"{msg_us:.1f} us = {msg_us / step_us:.2%} of it, the encoder "
            f"over live slots (split, tiles) {enc_us:.1f} us = "
            f"{enc_us / step_us:.2%}, one launch a force call "
            f"(torch.profiler, {SHARE_STEPS} steps, exclusive times) "
            f"[{card}]")
        require(msg_us > 0, "the profiler saw no banded message kernel")
        require(enc_us > 0, "the profiler saw no encoder kernel")
        del sim, st, warm, res

    # -- phase 17: the entry points ----------------------------------------
    state, model_cfg, system = load_self_describing(
        CKPT, use_pallas=True, use_pallas_encoder=True)
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "run_md_banded.txt")
        out = os.path.join(tmp, "run_md_banded.npy")
        call.launches = live_edge_encoder.launches = 0
        t0 = time.perf_counter()
        run_md.main(["--ckpt", CKPT, "--banded", "--steps",
                     str(RUN_MD_BANDED_STEPS), "--log", log, "--out_traj",
                     out])
        seconds = time.perf_counter() - t0
        launches["run_md_banded"] = call.launches
        enc_launches["run_md_banded"] = live_edge_encoder.launches
        lines = open(log).read().splitlines()
        final = np.load(out)
    temps = [float(line.split("\t")[3]) for line in lines[1:]]
    require(lines[0] == THERMO_HEADER
            and len(lines) == 1 + RUN_MD_BANDED_STEPS // 100,
            "thermo log format (--banded)")
    require(all(math.isfinite(t) for t in temps)
            and final.shape == (system.n_atoms, 3)
            and np.isfinite(final).all(), "run_md --banded output")
    require(call.launches == model_cfg.conv_layers
            * (RUN_MD_BANDED_STEPS + 1)
            and live_edge_encoder.launches == RUN_MD_BANDED_STEPS + 1,
            f"launches {call.launches}, {live_edge_encoder.launches} "
            "(run_md --banded)")
    ff = GNNForceField(state, system, model_cfg, device=dev)
    pos = space.wrap(torch.as_tensor(final, device=dev), system.box)
    idx, mask, _ = build_nbrs(pos, system)
    f_banded = ff.banded_force_fn()(pos, idx, mask)
    f_eager = ff.force_fn()(pos, idx, refresh_mask(pos, system.box,
                                                   system.cutoff, idx, mask))
    err, scale = float((f_banded - f_eager).abs().max()), \
        float(f_eager.std())
    say(f"phase 17: run_md --ckpt {CKPT} --banded --steps "
        f"{RUN_MD_BANDED_STEPS}: {seconds:.1f} s with the FIRE start; "
        f"{len(lines) - 1} thermo rows, mean T {np.mean(temps):.2f} K; "
        f"banded_msg launches {launches['run_md_banded']}, "
        f"live_edge_encoder {enc_launches['run_md_banded']}; at its last "
        f"frame banded vs "
        f"eager force_fn (use_pallas_encoder) max |dF| {err:.3e}, std(F) "
        f"{scale:.3e}, ratio {err / scale:.3e} (tolerance {TOLERANCE})")
    require(err <= TOLERANCE * scale,
            "run_md --banded's forces disagree with the eager force field")

    call.launches = live_edge_encoder.launches = 0
    t0 = time.perf_counter()
    rows = bench_large.main(BENCH_LARGE_ARGV)
    seconds = time.perf_counter() - t0
    launches["bench_large"] = call.launches
    enc_launches["bench_large"] = live_edge_encoder.launches
    say(f"phase 17: bench_large {' '.join(BENCH_LARGE_ARGV)}: {len(rows)} "
        f"rows in {seconds:.1f} s, banded_msg launches {call.launches}, "
        f"live_edge_encoder {live_edge_encoder.launches} [{card}]")
    require(len(rows) == 4 and not any("error" in row for row in rows),
            f"bench_large rows {rows}")
    require(live_edge_encoder.launches > 0 and call.launches
            == model_cfg.conv_layers * live_edge_encoder.launches,
            "bench_large's banded rows did not encode once a force call")

    return {"name": "banded_msg", "route": "cuda",
            "source": "gamd_tpu_torch/csrc/banded_msg.cu",
            "replaces": "gamd_tpu/ops/banded.py:58",
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": err_max, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "device_us": dev_us,
            "fp32_bound_ms": fp32_ms, "library_ms": None}, \
        enc_launches, live_entry


def nhc_args(case, vel, chain):
    return (vel, *chain, case["masses"], case["kt"], case["ndf"], case["q"],
            case["wdts"])


def chain_ops(m, n_sub):
    """fp32 operations of one chain half-step (nhc.cuh, each exp counted as
    one): 18 M - 2 a substep, 2 for the first g[0]."""
    return n_sub * (18 * m - 2) + 2


def nhc_half_step_bound(n, r, m, n_sub):
    """(least ms, bound by, FLOP) of one nhc_half_step call: v read and
    written, the masses, the chain read and written, q and the schedule,
    against the sum of m v^2 (3 FLOP a component), the scaling and the
    chains' operations at the fp32 peak."""
    nbytes = 4 * (2 * r * n * 3 + n + 6 * r * m + m + n_sub)
    flops = r * (3 * n * 3 + 3 * n + chain_ops(m, n_sub))
    return (*roofline(flops, nbytes), flops)


def rel_errors(out, ref):
    """max |a - b| / max |b| of each pair of tensors."""
    return [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(out, ref)]


def nhc_kernel_phases(dev, card):
    """Phases 18-19 (module docstring). Returns the kernels-line entries of
    nhc_half_step and the two forms of nhc_chain_probe (launches filled in
    by the paths that run them)."""
    call = nhc.nhc_half_step
    m, n_sub = 10, 25

    # -- phase 18: nhc_half_step against its plain version -----------------
    shapes = {}
    err_max = 0.0
    for n, r in NHC_SHAPES:
        case = nhc_case(dev, n, r, m)
        args = nhc_args(case, case["vel"], case["chain"])
        before = call.launches
        out = call(*args)
        torch.cuda.synchronize()
        require(call.launches == before + 1, "nhc_half_step did not launch")
        ref = nhc.nhc_half_step_reference(*args)
        one = rel_errors(out, ref)
        require(all(bool(torch.isfinite(t).all()) for t in out),
                "non-finite nhc_half_step output")
        again = call(*args)
        repeat = all(torch.equal(a, b) for a, b in zip(out, again))
        ke2 = nhc.twice_kinetic_energy(case["vel"], case["masses"])
        given = call(*args, ke2=ke2)
        given_same = all(torch.equal(a, b) for a, b in zip(given, out))
        k_state = p_state = (case["vel"], *case["chain"])
        for _ in range(NHC_CHAIN_CALLS):
            k_state = call(*nhc_args(case, k_state[0], k_state[1:]))
            p_state = nhc.nhc_half_step_reference(
                *nhc_args(case, p_state[0], p_state[1:]))
        chained = rel_errors(k_state, p_state)
        abs_err = max(float((a - b).abs().max())
                      for a, b in zip((*out, *k_state), (*ref, *p_state)))
        err_max = max(err_max, abs_err)
        label = f"N={n}" + ("" if r is None else f" R={r}")
        say(f"phase 18: nhc_half_step vs plain at {label}, M={m}, "
            f"{n_sub} substeps: max |d| / max (vel, xi, vxi, g) one call "
            + " ".join(f"{e:.3e}" for e in one) + f"; after "
            f"{NHC_CHAIN_CALLS} consecutive calls "
            + " ".join(f"{e:.3e}" for e in chained)
            + f" (tolerance {NHC_RTOL}); repeat bit for bit {repeat}; "
            f"ke2 given = computed bit for bit {given_same}")
        require(max(one + chained) <= NHC_RTOL,
                f"nhc_half_step disagrees with its plain version ({label})")
        require(repeat, f"nhc_half_step does not repeat ({label})")
        require(given_same, f"nhc_half_step with ke2 given differs ({label})")
        ms = time_ms(lambda: call(*args))
        plain_ms = time_ms(lambda: nhc.nhc_half_step_reference(*args),
                           reps=3)
        bound_ms, bound_by, flops = nhc_half_step_bound(
            n, 1 if r is None else r, m, n_sub)
        shapes[label] = {"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        say(f"phase 18: nhc_half_step at {label} {ms:.4f} ms/call, plain "
            f"{plain_ms:.4f} ms/call (median of 3), bound {bound_ms:.6f} ms "
            f"({bound_by}; {flops} FLOP, of them {chain_ops(m, n_sub)} a "
            f"chain in one dependent sequence with {n_sub * (2 * m - 1)} "
            f"expf); CUDA events, median of 20 [{card}]")
    long_case = nhc_case(dev, 258, None, m=17)
    before = call.launches
    try:
        call(*nhc_args(long_case, long_case["vel"], long_case["chain"]))
        refused = False
    except ValueError as exc:
        refused = "M=17" in str(exc)
    say(f"phase 18: M=17 refused {refused}, launches {call.launches - before}")
    require(refused and call.launches == before, "M > 16 was not refused")

    # -- phase 19: the probe, both forms ------------------------------------
    nhc.nhc_chain_probe.launches = dict.fromkeys(nhc.FORMS, 0)
    t0 = time.perf_counter()
    results = probe_nhc_kernel.main(["--reps", "400"])
    seconds = time.perf_counter() - t0
    chain = results.pop("chain_bound")
    probe_launches = dict(nhc.nhc_chain_probe.launches)
    say(f"phase 19: tools.probe_nhc_kernel --reps 400 in process "
        f"({seconds:.1f} s): " + "; ".join(
            f"{form} parity {res['parity_err']:.3e}, "
            f"{res['us_per_half_step']:.3f} us per half-step"
            for form, res in results.items())
        + f" (parity tolerance {probe_nhc_kernel.PARITY_ATOL}); launches "
        f"{probe_launches} [{card}]")
    require(all(res["parity_err"] <= probe_nhc_kernel.PARITY_ATOL
                for res in results.values()),
            "a probe form disagrees with the plain chain")
    chain_ms = chain["us_per_half_step"] / 1e3
    say(f"phase 19: the chain's dependent sequence on one thread: "
        + ", ".join(f"{op} {v:.2f} ns" for op, v in chain["ns"].items())
        + f" a step; {probe_nhc_kernel.N_C * probe_nhc_kernel.N_YS} x "
        f"{probe_nhc_kernel.M - 1} x (backward + forward) = "
        f"{chain['us_per_half_step']:.3f} us a half-step (a lower bound, "
        f"beside the roofline's); the probe's scalar form "
        f"{results['scalar']['us_per_half_step']:.3f} us a half-step, the "
        f"bound at "
        f"{chain_ms * 1e3 / results['scalar']['us_per_half_step']:.2%} of "
        f"it [{card}]")
    say(f"phase 19: chain_latency_kernel against its plain version over "
        f"{probe_nhc_kernel.CHECK_REPS} steps of each op: max |d| "
        f"{chain['max_abs_err']:.3e} (tolerance "
        f"{probe_nhc_kernel.CHECK_ATOL})")
    require(chain["max_abs_err"] <= probe_nhc_kernel.CHECK_ATOL,
            "the chain latency kernel disagrees with its plain version")
    require(chain["us_per_half_step"] > 0, "the chain's latency is not "
            "positive")
    bound_us = chain["us_per_half_step"]
    say(f"phase 19: the forms at reps 400 against the chain's dependent "
        f"sequence ({bound_us:.3f} us a half-step): " + ", ".join(
            f"{form} {res['us_per_half_step']:.3f} us, "
            f"{bound_us / res['us_per_half_step']:.2%} of the bound"
            for form, res in results.items()) + f" [{card}]")
    inputs = probe_nhc_kernel.probe_inputs(dev)
    same = {}
    for n in (probe_nhc_kernel.PARITY_REPS, 400):
        warp = probe_nhc_kernel.run_form(inputs, "warp", n)
        scalar = probe_nhc_kernel.run_form(inputs, "scalar", n)
        same[n] = all(torch.equal(a, b) for a, b in zip(warp, scalar))
    say(f"phase 19: the warp form's xi, vxi, g, product of the scales and "
        f"last ke2 equal the scalar form's bit for bit: " + ", ".join(
            f"reps {n} {ok}" for n, ok in same.items()))
    require(all(same.values()), "the warp form differs from the scalar "
            "form's bits")
    keys = ("xi", "vxi", "g", "ke2", "q", "kt", "ndf", "wdts")
    args = [inputs[k] for k in keys]
    reps = probe_nhc_kernel.PARITY_REPS

    def plain():
        return nhc.nhc_probe_reference(*args[:3], args[3].reshape(()),
                                       *args[4:], reps)

    ref = plain()
    plain_ms = time_ms(plain, reps=3)
    probe_bound = roofline(reps * (chain_ops(m, n_sub) + 2),
                           4 * (6 * m + m + n_sub + 1 + 2))
    probes = []
    for form, res in results.items():
        out = probe_nhc_kernel.run_form(inputs, form, reps)
        err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        ms = time_ms(lambda: probe_nhc_kernel.run_form(inputs, form, reps))
        say(f"phase 19: nhc_chain_probe {form} at reps {reps}: max |d| vs "
            f"plain {err:.3e}, {ms:.4f} ms/call, plain {plain_ms:.4f} "
            f"ms/call, bound {probe_bound[0]:.3e} ms ({probe_bound[1]}) "
            f"[{card}]")
        probes.append({
            "name": f"nhc_chain_probe:{form}", "route": "cuda",
            "source": "gamd_tpu_torch/csrc/nhc_chain.cu",
            "replaces": ("scripts/probe_nhc_kernel.py:77" if form == "scalar"
                         else "scripts/probe_nhc_kernel.py:112"),
            "launches_by_path": {"probe_nhc_kernel": probe_launches[form]},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": probe_bound[0], "bound_by": probe_bound[1],
            "library_ms": None, "reps": reps,
            "chain_bound_ms": reps * chain_ms,
            "us_per_half_step_reps_400": res["us_per_half_step"],
            "share_of_chain_bound": chain["us_per_half_step"]
            / res["us_per_half_step"],
            "parity_vs_probe_reference": res["parity_err"]})
    md_shape = shapes["N=258"]
    half_step = {"name": "nhc_half_step", "route": "cuda",
                 "source": "gamd_tpu_torch/csrc/nhc_chain.cu",
                 "replaces": "scripts/probe_nhc_kernel.py:77",
                 "launches_by_path": {}, "max_abs_err": err_max,
                 **md_shape, "library_ms": None, "shapes": shapes,
                 "chain_bound_ms": chain_ms, "chain_ns_per_step": chain["ns"]}
    return [half_step, *probes]


class RunSpy:
    """Records every Simulation.run_segmented call's (simulation, result)
    while it is entered, so that a CLI's final state can be checked."""

    def __enter__(self):
        self.calls = []
        self.original = original = Simulation.run_segmented

        def spy(sim, state, n_steps, segment=10000):
            result = original(sim, state, n_steps, segment)
            self.calls.append((sim, result))
            return result

        Simulation.run_segmented = spy
        return self

    def __exit__(self, *exc):
        Simulation.run_segmented = self.original


def count_launches():
    """The launch counts of every kernel that the integrators, the
    training loop and the CLIs can reach (rows 1-5 and the NHC step)."""
    fused = fused_conv_gather_message
    return {"mega_forward": mega_forward.launches,
            "mega_md_steps": mega_md_steps.launches,
            "edge_encoder": fused_edge_encoder.launches,
            "conv_msg_gather": fused.launches,
            "conv_msg_gather_bwd": fused.backward_launches,
            "nhc_half_step": nhc.nhc_half_step.launches}


def zero_launches():
    mega_forward.launches = mega_md_steps.launches = 0
    fused_edge_encoder.launches = nhc.nhc_half_step.launches = 0
    fused_conv_gather_message.launches = 0
    fused_conv_gather_message.backward_launches = 0


def integrator_phases(dev, card, traj, langevin_sps):
    """Phases 20-25 (module docstring). `traj` are phase 11's classical
    frames, `langevin_sps` phase 3's per-step Langevin steps/s. Returns
    the launches of every kernel by path."""
    launches = {}
    nhc_calls = nhc.nhc_half_step

    # -- phase 20: the NHC per-step path -------------------------------------
    system, model_cfg, md, state, pos = lj_slice(dev, seed=0)
    md_nhc = dataclasses.replace(md, integrator="nose_hoover")
    ff = GNNForceField(state, system, model_cfg, device=dev)
    sim = Simulation(ff.force_fn(megakernel=True), system, md_nhc,
                     k_model=K_MODEL, device=dev)
    zero_launches()
    st = sim.init_state(pos, rng=torch.Generator(dev).manual_seed(1))
    warm = sim.run(st, WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(warm.state, PER_STEP_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches["nhc_per_step"] = counts = count_launches()
    steps = WARMUP_STEPS + PER_STEP_STEPS
    temps = res.thermo.temperature
    sps = PER_STEP_STEPS / seconds
    require(bool(torch.isfinite(res.state.pos).all())
            and bool(torch.isfinite(temps).all()), "non-finite NHC state")
    require(not warm.overflow and not res.overflow,
            "neighbour overflow (NHC per-step)")
    require(counts["mega_forward"] == 1 + steps
            and counts["nhc_half_step"] == 2 * steps,
            f"launches {counts} for {steps} NHC steps")
    bath_ke, bath_pe = integ.nhc_bath_energies(
        res.state, md_nhc.temperature, sim.friction, sim.ndf)
    say(f"phase 20: NHC per-step path, {PER_STEP_STEPS} nose_hoover steps "
        f"(LJ-258, seeded GAMD-small, K={K_MODEL}, 100 K, 2 fs, 25/ps, "
        f"M={md_nhc.chain_length}, n_c={md_nhc.chain_mts}, "
        f"n_ys={md_nhc.chain_ys}) in {seconds:.4f} s = {sps:.1f} steps/s "
        f"(Langevin per-step, phase 3: {langevin_sps:.1f}); mean T "
        f"{float(temps.mean()):.2f} K (seeded weights: no band); bath KE "
        f"{float(bath_ke):.4f}, PE {float(bath_pe):.4f} kJ/mol; launches "
        f"{counts} for {steps} steps [{card}]")
    del sim, st, warm, res

    # -- phase 21: the NHC deployment ----------------------------------------
    state, model_cfg, system = load_self_describing(
        CKPT, use_pallas=True, use_pallas_encoder=True)
    with tempfile.TemporaryDirectory() as tmp:
        gt = os.path.join(tmp, "gt")
        os.mkdir(gt)
        for t, frame in enumerate(traj.cpu().numpy()):
            np.savez(os.path.join(gt, f"data_0_{200 + t}.npz"), pos=frame)
        report_path = os.path.join(tmp, "report.json")
        zero_launches()
        t0 = time.perf_counter()
        with RunSpy() as spy:
            report = analyze_rollout.main([
                "--ckpt", CKPT, "--data_dir", gt, "--megakernel", "--steps",
                str(NHC_ANALYZE_STEPS), "--classical_baseline", "--pe",
                "--json_out", report_path])
        seconds = time.perf_counter() - t0
        launches["analyze_rollout_nhc"] = counts = count_launches()
    (sim_gnn, res_gnn), (sim_cl, res_cl) = spy.calls
    n_equil = int(len(res_gnn.positions) * 0.3)
    r, g_cl = radial_distribution(res_cl.positions[n_equil:], system.box)
    peak_cl = float(r[g_cl.argmax()])
    bin_width = system.box / 2 / len(r)
    bath = integ.nhc_bath_energies(res_gnn.state, system.temperature,
                                   sim_gnn.friction, sim_gnn.ndf)
    keys = ("rdf_l2", "rdf_l2_vs_classical_rollout", "rdf_peak_pos_gnn",
            "rdf_peak_pos_gt", "rdf_peak_gnn", "rdf_peak_classical_rollout",
            "temperature_mean", "classical_temperature_mean",
            "pe_gnn_mean_kj_mol", "pe_classical_mean_kj_mol",
            "pe_gnn_drift_kj_mol_ps", "diffusion_m2_s",
            "classical_diffusion_m2_s", "rollout_steps_per_s_incl_compile")
    say(f"phase 21: analyze_rollout (default integrator "
        f"{sim_gnn.md.integrator}) --megakernel --steps {NHC_ANALYZE_STEPS} "
        f"--classical_baseline --pe on {CKPT} ({seconds:.1f} s; ground "
        f"truth: phase 11's {traj.shape[0]} classical frames): "
        + ", ".join(f"{key} {report.get(key)}" for key in keys)
        + f"; classical NHC rollout's RDF peak at {peak_cl:.4f} A; bath KE "
        f"{float(bath[0]):.4f}, PE {float(bath[1]):.4f} kJ/mol; launches "
        f"{counts} [{card}]")
    require(sim_gnn.md.integrator == sim_cl.md.integrator == "nose_hoover",
            "analyze_rollout's default integrator is not nose_hoover")
    require(all(math.isfinite(v) for v in report.values()
                if isinstance(v, float)), "non-finite report values")
    require(abs(report["temperature_mean"] - system.temperature) <= T_BAND,
            "the NHC rollout's mean temperature is outside the band")
    require(abs(report["rdf_peak_pos_gnn"] - peak_cl) <= bin_width * 1.001,
            "the GNN's RDF peak is more than one bin from the classical NHC "
            "baseline's")
    require(all(math.isfinite(float(b)) for b in bath),
            "non-finite bath energies")
    require(counts["mega_forward"] == 1 + NHC_ANALYZE_STEPS
            and counts["nhc_half_step"] == 4 * NHC_ANALYZE_STEPS,
            f"launches {counts}: want one forward a step and two chain "
            "half-steps a step of each rollout")
    del spy, sim_gnn, res_gnn, sim_cl, res_cl

    # -- phase 22: run_md under NHC on the eager kernel path -----------------
    steps = RUN_MD_STEPS["--use_pallas"]
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "run_md_nhc.txt")
        out = os.path.join(tmp, "run_md_nhc.npy")
        zero_launches()
        t0 = time.perf_counter()
        run_md.main(["--ckpt", CKPT, "--integrator", "nose_hoover",
                     "--use_pallas", "--steps", str(steps), "--log", log,
                     "--out_traj", out])
        seconds = time.perf_counter() - t0
        launches["run_md_nhc_use_pallas"] = counts = count_launches()
        lines = open(log).read().splitlines()
        final = np.load(out)
    temps = [float(line.split("\t")[3]) for line in lines[1:]]
    say(f"phase 22: run_md --ckpt {CKPT} --integrator nose_hoover "
        f"--use_pallas --steps {steps}: {seconds:.1f} s with the FIRE start; "
        f"{len(lines) - 1} thermo rows, mean T {np.mean(temps):.2f} K; "
        f"launches {counts} [{card}]")
    require(lines[0] == THERMO_HEADER and len(lines) == 1 + steps // 100,
            "thermo log format (nose_hoover)")
    require(all(math.isfinite(t) for t in temps)
            and final.shape == (system.n_atoms, 3)
            and np.isfinite(final).all(), "run_md output (nose_hoover)")
    require(counts["conv_msg_gather"] == model_cfg.conv_layers * (steps + 1)
            and counts["nhc_half_step"] == 2 * steps,
            f"launches {counts} (run_md nose_hoover)")

    # -- phase 23: Andersen on the checkpoint --------------------------------
    ff = GNNForceField(state, system, model_cfg, device=dev)
    md_and = MDConfig(integrator="andersen", temperature=system.temperature,
                      dt_fs=system.dt_fs, friction_per_ps=25.0,
                      rebuild_every=20)
    sim = Simulation(ff.force_fn(), system, md_and, device=dev)
    zero_launches()
    t0 = time.perf_counter()
    res = sim.run(sim.init_state(traj[-1],
                                 rng=torch.Generator(dev).manual_seed(23)),
                  ANDERSEN_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches["andersen_deploy_md"] = counts = count_launches()
    mean_t = float(res.thermo.temperature[ANDERSEN_STEPS // 2:].mean())
    say(f"phase 23: Andersen on the checkpoint (use_pallas_encoder), "
        f"{ANDERSEN_STEPS} steps at 25/ps in {seconds:.2f} s = "
        f"{ANDERSEN_STEPS / seconds:.1f} steps/s; mean T of the second half "
        f"{mean_t:.2f} K (band 100 +- {T_BAND} K); launches {counts} [{card}]")
    require(not res.overflow and bool(torch.isfinite(res.state.pos).all()),
            "Andersen run: overflow or non-finite state")
    require(abs(mean_t - system.temperature) <= T_BAND,
            f"Andersen mean temperature {mean_t} K outside the band")
    del sim, res

    # -- phase 24: NVE on the classical LJ forces ----------------------------
    # The LJ potential shifted to zero at the list's 7.5 A cutoff, so that
    # the forces the list sees are those of the energy measured.
    lj_cut = LJParams(cutoff=system.cutoff)
    md_nve = MDConfig(integrator="nve", temperature=system.temperature,
                      dt_fs=system.dt_fs, rebuild_every=20)
    sim = Simulation(lj_force_fn(system.box, lj_cut), system, md_nve,
                     device=dev)
    st = sim.init_state(traj[-1], rng=torch.Generator(dev).manual_seed(24))

    def total_energy(s):
        return float(integ.kinetic_energy(s.vel, sim.masses)) + float(
            lj_energy_dense(space.wrap(s.pos, system.box), system.box,
                            lj_cut))

    energies = [total_energy(st)]
    t0 = time.perf_counter()
    for _ in range(10):
        run = sim.run(st, NVE_STEPS // 10)
        require(not run.overflow, "neighbour overflow (NVE)")
        st = run.state
        energies.append(total_energy(st))
    seconds = time.perf_counter() - t0
    drift = (energies[-1] - energies[0]) / abs(energies[0])
    spread = (max(energies) - min(energies)) / abs(energies[0])
    say(f"phase 24: NVE, classical LJ-258 (shifted at {system.cutoff} A), "
        f"{NVE_STEPS} velocity-Verlet steps of 2 fs from phase 11's last "
        f"frame ({seconds:.2f} s): total energy "
        f"{energies[0]:.4f} -> {energies[-1]:.4f} kJ/mol, relative drift "
        f"{drift:.3e}, spread {spread:.3e} over 11 samples [{card}]")
    require(all(math.isfinite(e) for e in energies),
            "non-finite NVE total energy")

    # -- phase 25: run_recorded ----------------------------------------------
    md_rec = MDConfig(integrator="nose_hoover",
                      temperature=system.temperature, dt_fs=system.dt_fs,
                      friction_per_ps=25.0, rebuild_every=20)
    sim = Simulation(lj_force_fn(system.box), system, md_rec, device=dev)
    st = sim.init_state(traj[-1], rng=torch.Generator(dev).manual_seed(25))
    zero_launches()
    t0 = time.perf_counter()
    final, ovf, f_pos, f_vel, f_force, f_temp = sim.run_recorded(
        st, RECORD_FRAMES, RECORD_INTERVAL,
        lambda p: lj_forces_dense(p, system.box))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches["run_recorded_nhc"] = counts = count_launches()
    n = system.n_atoms
    say(f"phase 25: run_recorded, NHC classical LJ-258, {RECORD_FRAMES} "
        f"frames every {RECORD_INTERVAL} steps ({seconds:.2f} s): shapes "
        f"{tuple(f_pos.shape)} {tuple(f_vel.shape)} {tuple(f_force.shape)} "
        f"{tuple(f_temp.shape)}, frame 0 = start "
        f"{torch.equal(f_pos[0], space.wrap(st.pos, system.box))} / "
        f"{torch.equal(f_vel[0], st.vel)}, T "
        + " ".join(f"{float(t):.1f}" for t in f_temp)
        + f" K; launches {counts} [{card}]")
    require(f_pos.shape == f_vel.shape == f_force.shape
            == (RECORD_FRAMES, n, 3) and f_temp.shape == (RECORD_FRAMES,),
            "run_recorded shapes")
    require(torch.equal(f_pos[0], space.wrap(st.pos, system.box))
            and torch.equal(f_vel[0], st.vel),
            "run_recorded's frame 0 is not the initial state")
    require(not ovf and all(bool(torch.isfinite(t).all()) for t in (
        f_pos, f_vel, f_force, f_temp, final.pos)),
        "run_recorded: overflow or non-finite values")
    require(counts["nhc_half_step"] == 2 * RECORD_FRAMES * RECORD_INTERVAL,
            f"launches {counts} (run_recorded)")
    return launches


#: fp32 operations of theta_edge's epilogues a live edge and column as
#: row 9's tile kernel runs them: silu of the staged pre-activation (3),
#: the first product's bias and silu (4), the last bias, gated product and
#: sum (3).
THETA_EPILOGUE_OPS = 10


def theta_tc_ops(live_edges, width=128):
    """(tensor-core FLOP, fp32 FLOP) of one edge-MLP aggregate as row 9's
    live-edge tiles compute it: theta_edge's two products over the live
    edges as three bf16 passes each, the epilogues on the CUDA cores."""
    return (3.0 * 2 * 2 * width * width * live_edges,
            float(THETA_EPILOGUE_OPS * width * live_edges))


def op_bound(op, live, n, k, width=128):
    """(least ms, "operations" or "bytes", the fp32 CUDA-core basis's
    least ms, (tensor-core FLOP, fp32 FLOP)) of one op-library call on one
    graph. Bytes: each input read once (per-slot inputs and ids at the
    live slots only, the mask in full, the node arrays and weights) and
    the output written once. Operations: row 10 (gather_agg) runs fp32,
    priced at the fp32 peak (the bound is its own fp32 basis); rows 7-8
    (conv_layer, conv_msg) run the four edge products over the live edges
    as three bf16 passes on the tensor cores and the epilogues in fp32
    (conv_tc_ops, tc_conv_bound), conv_layer also its three node products
    in fp32; row 9 (edge_mlp_agg) theta_edge's two the same way
    (theta_tc_ops). The fp32 basis prices every product at the fp32 peak
    (2 per multiply-add)."""
    w = width
    slot, node = 4 * live * w, 4 * n * w
    mats = lambda count: 4 * count * (w * w + w)
    node_flops = 3 * 2.0 * n * w * w
    if op == "gather_agg":
        flops = 2.0 * live * w
        nbytes = slot + 4 * live + n * k + 2 * node
    elif op == "edge_mlp_agg":
        flops = live * (2.0 * 2 * w * w + 2 * w)
        nbytes = 2 * slot + n * k + mats(2) + node
    elif op == "conv_msg":
        flops = float(conv_flops(live, w))
        nbytes = 3 * slot + n * k + mats(4) + 2 * node
    else:
        flops = conv_flops(live, w) + node_flops
        nbytes = slot + 4 * live + n * k + mats(7) + 5 * node
    fp32_ms, fp32_by = roofline(flops, nbytes)
    if op == "gather_agg":
        return fp32_ms, fp32_by, fp32_ms, (0.0, flops)
    if op == "edge_mlp_agg":
        ops = theta_tc_ops(live, w)
    else:
        tc_flops, epilogue = conv_tc_ops(live, w)
        ops = (tc_flops,
               epilogue + (node_flops if op == "conv_layer" else 0.0))
    bound_ms, bound_by = tc_conv_bound(live, nbytes, lambda _: ops)
    return bound_ms, bound_by, fp32_ms, ops


def wild_ids(inputs, n):
    """conv_layer's inputs with ids out of range (negative, N and past it,
    far past either end) in every masked slot and in the live slots whose
    flat index is a multiple of 5, which JAX's rule reads as clamped
    rows."""
    idx, mask = inputs[1], inputs[2]
    dev = idx.device
    wild = torch.tensor([-1, -n, -n - 1, n, n + 7, 10 ** 6, -10 ** 6],
                        dtype=torch.int32, device=dev)
    flat = torch.arange(idx.numel(), device=dev).reshape(idx.shape)
    pick = ~mask | (flat % 5 == 0)
    fill = wild[torch.arange(int(pick.sum()), device=dev) % wild.numel()]
    return (inputs[0], idx.masked_scatter(pick, fill), *inputs[2:])


OP_ENTRIES = {"gather_agg": message.pallas_gather_multiply_aggregate,
              "edge_mlp_agg": message.fused_edge_mlp_aggregate,
              "conv_msg": message.fused_conv_message,
              "conv_layer": message.fused_conv_layer}
OP_SOURCES = {"gather_agg": ("gather_agg.cu", 49),
              "edge_mlp_agg": ("edge_mlp_agg.cu", 104),
              "conv_msg": ("conv_msg.cu", 212),
              "conv_layer": ("conv_layer.cu", 735)}


def device_us(fn, calls=20):
    """(device time of fn's kernels per call in us, {kernel: us per call})
    by torch.profiler over `calls` calls after one untraced call
    (profile_step.traced_spans), each kernel's exclusive time (what it
    adds to the busy time: a kernel that programmatic dependent launch
    starts early is not counted twice); (None, {}) where the profiler saw
    no device time."""
    kernels, _ = exclusive_times(traced_spans(fn, calls))
    times = {name: t["us"] / calls for name, t in kernels.items()}
    return (sum(times.values()) or None), times


def op_library_phases(dev, card):
    """Phases 26-29 (module docstring). Returns the four kernels' entries
    of the kernels line."""
    cases = conv_inputs(dev)
    sl = lj_train_slice(dev, use_pallas=False)
    plain_model = create_train_state(sl.model_cfg, sl.system, sl.train_cfg,
                                     1, seed=0, device=dev).model
    layers = sl.model_cfg.conv_layers

    # -- phase 26: the op-library path ---------------------------------------
    pos, mean, std = cases[1].frame
    idx, mask = cases[1].args[1][0], cases[1].args[2][0]
    box = sl.system.box
    with torch.no_grad():
        want = plain_model(pos, idx[None], mask[None], box, mean, std)[0]
    scale = float(want.std())
    for entry in OP_ENTRIES.values():
        entry.launches = 0
    path = {}
    for form in op_library.FORMS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = op_library.forward(plain_model, pos[0], idx, mask, box, mean,
                                 std, form)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        err = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()) and got.shape == want.shape,
                f"op library form {form}: non-finite or misshapen forces")
        say(f"phase 26: GAMD-small forward (LJ-258 frame 1, K={idx.shape[1]}"
            f", {layers} layers) with every conv layer through {form}: max "
            f"|dF| {err:.3e} against the model's plain forward, std(F) "
            f"{scale:.3e} (tolerance {OP_FORCE_RTOL} x std), "
            f"{seconds * 1e3:.3f} ms")
        require(err <= OP_FORCE_RTOL * scale,
                f"op library form {form} disagrees: {err} vs {scale}")
    launches = {name: entry.launches for name, entry in OP_ENTRIES.items()}
    say(f"phase 26: launches {launches} for one forward in each form "
        f"[{card}]")
    require(launches == {name: layers for name in OP_ENTRIES},
            f"launches {launches}: want {layers} of each kernel")

    # -- phase 27: each kernel against its plain version ---------------------
    errs = {name: 0.0 for name in OP_ENTRIES}
    for layer, case in enumerate(cases):
        ops = op_inputs(case)
        n, k = case.args[1].shape[1:]
        outs, refs = {}, {}
        for name, (inputs, kernel, plain) in ops.items():
            entry = OP_ENTRIES[name]
            before = entry.launches
            with torch.no_grad():
                out = kernel(*inputs)
                torch.cuda.synchronize()
                ref = plain(*inputs)
            require(entry.launches == before + 1, f"{name} did not launch")
            require(bool(torch.isfinite(out).all()), f"non-finite {name}")
            err = float((out - ref).abs().max())
            kind = "std" if name == "conv_layer" else "max |out|"
            scale = float(ref.std() if name == "conv_layer"
                          else ref.abs().max())
            rtol = GATHER_RTOL if name == "gather_agg" else CONV_RTOL
            say(f"phase 27: {name} vs plain at N={n} K={k} width 128, "
                f"layer {layer} ({case.live} live edges): max |d| "
                f"{err:.3e}, {kind} {scale:.3e} (tolerance {rtol} x "
                f"{kind})")
            require(err <= rtol * scale, f"{name} disagrees: {err} vs "
                    f"{scale}")
            errs[name] = max(errs[name], err)
            outs[name], refs[name] = out, ref
        layer_inputs, layer_kernel, layer_plain = ops["conv_layer"]
        wild = wild_ids(layer_inputs, n)
        with torch.no_grad():
            agg = fused_conv_gather_message(*case.args)[0]
            e, idx_l, mask_l, h, hn, src, dst = layer_inputs[:7]
            own = getattr(plain_model.graph_conv, f"conv_{layer}")(
                h[None], hn[None], e[None], idx_l[None], mask_l[None])[0]
            bf16 = (e.to(torch.bfloat16), *layer_inputs[1:])
            out_bf16 = layer_kernel(*bf16)
            ref_bf16 = layer_plain(*bf16)
            out_wild = layer_kernel(*wild)
            ref_wild = layer_plain(*wild)
        torch.cuda.synchronize()
        # Row 8 (conv_msg) runs row 3's live-edge tiles (conv_msg_gather)
        # on equal rows over the same layout: the same bits. The anchor of
        # the staged forms (row 9 on the same tiles, row 10 fp32 on the
        # CUDA cores) is conv_msg's plain version, fp32 on the card.
        same = torch.equal(outs["conv_msg"], agg)
        with torch.no_grad():
            mlp_again = ops["edge_mlp_agg"][1](*ops["edge_mlp_agg"][0])
        torch.cuda.synchronize()
        mlp_same = torch.equal(mlp_again, outs["edge_mlp_agg"])
        anchor = refs["conv_msg"]
        scale = float(anchor.abs().max())
        vs_agg = {name: float((outs[name] - anchor).abs().max())
                  for name in ("edge_mlp_agg", "gather_agg")}
        own_err = float((outs["conv_layer"] - own).abs().max())
        own_std = float(own.std())
        bf16_err = float((out_bf16 - ref_bf16).abs().max())
        wild_err = float((out_wild - ref_wild).abs().max())
        wild_std = float(ref_wild.std())
        say(f"phase 27: layer {layer}: conv_msg equals conv_msg_gather bit "
            f"for bit: {same}; edge_mlp_agg repeats bit for bit: "
            f"{mlp_same}; edge_mlp_agg(edge_pre) and gather_agg(hn, "
            f"theta(edge_pre)) against conv_msg's plain agg: max |d| "
            f"{vs_agg['edge_mlp_agg']:.3e} and {vs_agg['gather_agg']:.3e}, "
            f"max |agg| {scale:.3e} (tolerance {OP_AGG_RTOL} x max); "
            f"conv_layer against GAMDNet's own layer on the plain path: max "
            f"|d| {own_err:.3e}, std {own_std:.3e} (tolerance {CONV_RTOL} x "
            f"std); with a bf16 e against its plain version: max |d| "
            f"{bf16_err:.3e}; with ids out of range in "
            f"{int((wild[1] != idx_l)[mask_l].sum())} live and every masked "
            f"slot against its plain version: max |d| {wild_err:.3e}, std "
            f"{wild_std:.3e}")
        require(same, "conv_msg and conv_msg_gather differ")
        require(mlp_same, "edge_mlp_agg does not repeat bit for bit")
        require(max(vs_agg.values()) <= OP_AGG_RTOL * scale,
                f"the staged forms disagree with agg: {vs_agg}")
        require(own_err <= CONV_RTOL * own_std,
                "conv_layer disagrees with GAMDNet's layer")
        require(bf16_err <= CONV_RTOL * float(ref_bf16.std()),
                "conv_layer disagrees with its plain version on a bf16 e")
        require(bool(torch.isfinite(out_wild).all())
                and wild_err <= CONV_RTOL * wild_std,
                "conv_layer disagrees with its plain version on ids out of "
                "range")
    gather_cases = gather_agg_cases(op_inputs(cases[0])["gather_agg"][0])

    # -- phase 28: gradients through the three autograd Functions ------------
    for layer, case in enumerate(cases):
        ops = op_inputs(case)
        n = case.args[1].shape[1]
        g = torch.randn((n, 128), device=dev,
                        generator=torch.Generator(dev).manual_seed(28))
        for name in ("edge_mlp_agg", "conv_msg", "conv_layer"):
            inputs, kernel, plain = ops[name]
            grads = []
            for fn in (kernel, plain):
                leaves = [t.detach().clone().requires_grad_(
                    t.is_floating_point()) for t in inputs]
                out = fn(*leaves)
                grads.append(torch.autograd.grad(
                    out, [t for t in leaves if t.requires_grad], g))
            worst = max(float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(*grads))
            say(f"phase 28: layer {layer} {name}: {len(grads[0])} grads of "
                f"sum(out * g) against autograd through the plain version, "
                f"worst max |d| / max |grad| {worst:.3e} (tolerance "
                f"{OP_GRAD_RTOL})")
            require(all(bool(torch.isfinite(a).all()) for a in grads[0]),
                    f"non-finite {name} grads")
            require(worst <= OP_GRAD_RTOL, f"{name} grads disagree")
        table, gate, idx_g, mask_g = ops["gather_agg"][0]
        try:
            message.pallas_gather_multiply_aggregate(
                table.detach().clone().requires_grad_(), gate, idx_g, mask_g)
            refused = False
        except ValueError:
            refused = True
        require(refused, "gather_agg took an input that requires grad")
    say("phase 28: gather_agg refuses an input that requires grad, as JAX "
        "defines no VJP for it")

    # -- phase 29: times at layer 0's inputs ---------------------------------
    ops = op_inputs(cases[0])
    n, k = cases[0].args[1].shape[1:]
    live = cases[0].live
    kernels = []
    for name, (inputs, kernel, plain) in ops.items():
        with torch.no_grad():
            ms = time_ms(lambda: kernel(*inputs))
            plain_ms = time_ms(lambda: plain(*inputs))
            dev_us, by_kernel = device_us(lambda: kernel(*inputs))
        bound_ms, bound_by, fp32_ms, (tc_flops, fp32_flops) = op_bound(
            name, live, n, k)
        basis = (f"{fp32_flops / 1e9:.4f} GFLOP fp32" if not tc_flops else
                 f"{tc_flops / 1e9:.4f} GFLOP bf16x3 at 989 TFLOP/s + "
                 f"{fp32_flops / 1e9:.4f} fp32 at 67; fp32 CUDA-core basis "
                 f"{fp32_ms:.4f} ms")
        say(f"phase 29: {name} {ms:.4f} ms/call, plain {plain_ms:.4f} "
            f"ms/call, bound {bound_ms:.4f} ms ({bound_by}; {basis}; "
            f"{live} live edges), kernel at {bound_ms / ms:.2%} of it"
            + ("" if dev_us is None else
               f", device time at {bound_ms * 1e3 / dev_us:.2%}")
            + f"; CUDA events, median of 20 [{card}]")
        say(f"phase 29: {name} device time "
            + ("not measured (the profiler saw none)" if dev_us is None
               else f"{dev_us:.2f} us/call: " + ", ".join(
                   f"{kname} {us:.2f}" for kname, us in by_kernel.items()))
            + " (torch.profiler, 20 calls)")
        src, line = OP_SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gamd_tpu_torch/csrc/{src}",
            "replaces": f"gamd_tpu/ops/pallas_mp.py:{line}",
            "launches_by_path": {"op_library": launches[name]},
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_us": dev_us, "fp32_bound_ms": fp32_ms})
    kernels[0]["cases"] = gather_cases
    return kernels


def gather_agg_cases(inputs):
    """Phase 27's further cases of gather_agg on (h, gate, idx, mask) of
    layer 0: ids out of range (negative, N and past it, far past either
    end) in every masked slot and in the live slots whose flat index is a
    multiple of 5, with NaN in every masked gate; the last row all masked
    (exactly 0); widths GATHER_WIDTHS (the first channels of each); the
    table at an address off 16 bytes (one float a lane), bit for bit the
    aligned call; a repeat bit for bit. Each within GATHER_RTOL x max |out|
    of the plain version. Returns {case: max |d| / max |out|}."""
    h, gate, idx, mask = inputs
    n = h.shape[0]
    dev = h.device
    wild = torch.tensor([-1, -n, -n - 1, n, n + 7, 10 ** 6, -10 ** 6],
                        dtype=torch.int32, device=dev)
    flat = torch.arange(idx.numel(), device=dev).reshape(idx.shape)
    pick = ~mask | (flat % 5 == 0)
    fill = wild[torch.arange(int(pick.sum()), device=dev) % wild.numel()]
    empty = mask.clone()
    empty[-1] = False
    shifted = torch.empty(h.numel() + 1, device=dev)[1:].view(h.shape)
    shifted.copy_(h)
    cases = {
        "wild ids, NaN masked": (h, torch.where(mask[..., None], gate,
                                                float("nan")),
                                 idx.masked_scatter(pick, fill), mask),
        "last row masked": (h, gate, idx, empty),
        **{f"D={d}": (h[:, :d].contiguous(), gate[..., :d].contiguous(), idx,
                      mask) for d in GATHER_WIDTHS},
        "misaligned table": (shifted, gate, idx, mask)}
    kernel = message.pallas_gather_multiply_aggregate
    errs = {}
    with torch.no_grad():
        base = kernel(*inputs)
        again = kernel(*inputs)
        for name, args in cases.items():
            out = kernel(*args)
            ref = message.gather_multiply_aggregate(*args)
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            errs[name] = float((out - ref).abs().max()) / scale
            require(bool(torch.isfinite(out).all())
                    and out.shape == ref.shape
                    and errs[name] <= GATHER_RTOL,
                    f"gather_agg disagrees with its plain version ({name}): "
                    f"{errs[name]:.3e} of max |out|")
            if name == "last row masked":
                require(bool((out[-1] == 0).all()),
                        "gather_agg: an all-masked row is not 0")
            if name == "misaligned table":
                require(torch.equal(out, base), "gather_agg: the one-float "
                        "lanes differ from the float4 lanes")
    require(torch.equal(base, again), "gather_agg does not repeat bit for bit")
    say("phase 27: gather_agg on layer 0's inputs, max |d| / max |out| "
        "against its plain version: " + ", ".join(
            f"{name} {err:.3e}" for name, err in errs.items())
        + f" (tolerance {GATHER_RTOL}); the all-masked row exactly 0, the "
        "misaligned table the aligned bits, a repeat bit for bit")
    return errs


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


#: fp32 instructions a lane issues a second on the card: the fp32 peak
#: counts a multiply-add as 2 operations, and an add or a multiply takes
#: an issue slot of its own.
FP32_INSTR = FP32_FLOPS / 2
REPEAT_SLOPE_ITERS = (200, 2000)   # phase 31's collapse check


def repeat_bound(inputs, k, iters, chain_ns):
    """The repeat body's bound at `iters` iterations: {"ms", "by",
    "issue_ms", "chain_ms", "bytes_ms", "roofline_ms"}. Issue: the fp32
    instructions the function needs, a multiply and an add an output
    element and iteration, the broadcast value's two adds an element of
    dst and the keep-alive multiply a column (JAX's body sums on the
    [tile_n, 128] rows before the repeat), at one a lane a clock
    (FP32_INSTR); chain: iters times the measured latency of row 0's
    dependent multiply and three adds (chain_ns), which every iteration
    waits on; bytes: dst and the salt read once, the carry written once.
    The bound is the largest; roofline_ms is the first form's price, 4
    fp32 operations an output element at the fp32 peak."""
    dst, = inputs
    rows, width = dst.shape[0] * k, mxu_probe.WIDTH
    nbytes = tensor_bytes(dst) + 8 * 128 * 4 + rows * width * 4
    instr = iters * (2.0 * rows * width + 2.0 * dst.numel() + width)
    out = {"issue_ms": instr / FP32_INSTR * 1e3,
           "chain_ms": iters * chain_ns * 1e-6,
           "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "roofline_ms": roofline(iters * 4.0 * rows * width, nbytes)[0]}
    out["ms"] = max(out["issue_ms"], out["chain_ms"], out["bytes_ms"])
    out["by"] = "bytes" if out["ms"] == out["bytes_ms"] else "operations"
    return out


def mxu_bound(body, inputs, k, iters, chain_ns=None):
    """(least ms, bound_by) of one mxu_loop call of `iters` iterations: the
    products' FLOP at the dense bf16 rate, against the inputs and the salt
    read once and the carry written once (repeat: repeat_bound, with the
    chain's measured ns a step)."""
    if body == "repeat":
        b = repeat_bound(inputs, k, iters, chain_ns)
        return b["ms"], b["by"]
    rows = mxu_probe.output_rows(body, inputs, k)
    width = mxu_probe.PEAK_N if body == "peak" else mxu_probe.WIDTH
    nbytes = tensor_bytes(*inputs) + 8 * 128 * 4 + rows * width * 4
    n_pad = inputs[1].shape[0] if body.startswith("gather") else 0
    flops = iters * bench_mxu.flops_per_iter(body, rows, n_pad)
    return roofline(flops, nbytes, BF16_FLOPS)


def onehot_bound(form, x, iters):
    """(least ms, bound_by, GFLOP an iteration) of one onehot_gather call:
    the one-hot products (2 per multiply-add over rows x width x 256) at the
    dense bf16 rate, int8 x int8 at the int8 rate, against idx, the table
    (and starts) read once and the carry written once."""
    rows, n_pad = x["idx"].shape[0], x["tbl"].shape[0]
    width = gather_probe.band_of(form) or n_pad
    flops = 2.0 * rows * width * gather_probe.LANES
    rate = INT8_OPS if form == "int8_int8" else BF16_FLOPS
    inputs = [t for t in (x["idx"], x["tbl"], x["starts"]) if t is not None]
    return (*roofline(iters * flops, tensor_bytes(*inputs) + 8 * 128 * 4,
                      rate), flops / 1e9)


def mxu_probe_phases(dev, card):
    """Phases 30-31 (module docstring). Returns the kernels-line entries of
    mxu_loop's five bodies and the launches of mega_forward in
    bench_mxu's forward stage."""
    args = bench_mxu.parse_args([])
    iters = args.iters

    # -- phase 30: tools.bench_mxu at its defaults --------------------------
    mxu_probe.mxu_loop.launches = dict.fromkeys(mxu_probe.BODIES, 0)
    fwd_before = mega_forward.launches
    t0 = time.perf_counter()
    res = bench_mxu.main([])
    seconds = time.perf_counter() - t0
    launches = dict(mxu_probe.mxu_loop.launches)
    fwd_launches = mega_forward.launches - fwd_before
    cal = res["calibration"]
    say(f"phase 30: tools.bench_mxu in process at its defaults "
        f"({seconds:.1f} s): calibration per-iter(quarter)/per-iter(full) "
        f"{cal['ratio']:.4f}, peak {cal['peak_tflops']:.2f} TFLOP/s "
        f"[{cal['tag']}]; forward {res['forward']['us_per_call']:.2f} "
        f"us/call; launches {launches}, mega_forward {fwd_launches} "
        f"[{card}]")
    require(cal["tag"] == "OK", f"bench_mxu calibration: {cal}")
    require(all(launches[body] > 0 for body in mxu_probe.BODIES),
            f"a body did not launch: {launches}")
    require(fwd_launches > 0, "the forward stage did not launch")
    stages = bench_mxu.stage_inputs(args, dev)
    libs = {label: graph_ms(library_products(stages, label, args.k, dev),
                            iters)
            for label in stages}
    peak_flops = bench_mxu.flops_per_iter("peak", mxu_probe.PEAK_N, 0)
    peak = res["stages"]["peak"]
    say(f"phase 30: cuBLAS (torch.matmul, bf16) on the same four-product "
        f"chain: {libs['peak'] * 1e3 / iters:.2f} us/iter, "
        f"{peak_flops * iters / (libs['peak'] * 1e-3) / 1e12:.2f} TFLOP/s "
        f"(the kernel {peak['us_per_iter']:.2f} us/iter, "
        f"{peak['tflops']:.2f} TFLOP/s on {peak['ctas']} CTAs in clusters "
        f"of {peak['cluster']}); " + "; ".join(
            f"{label} {libs[label] * 1e3 / iters:.2f} us/iter (kernel "
            f"{res['stages'][label]['us_per_iter']:.2f} on "
            f"{res['stages'][label]['ctas']} CTAs in clusters of "
            f"{res['stages'][label]['cluster']})"
            for label in stages if label != "peak")
        + f" ({iters} calls replayed from a CUDA graph, CUDA events, median"
        f" of 3; repeat: repeat_interleave) [{card}]")

    # -- phase 31: each body's kernel against its plain version --------------
    salt = torch.randn((8, 128), device=dev,
                       generator=torch.Generator(dev).manual_seed(31))
    errs = dict.fromkeys(mxu_probe.BODIES, 0.0)
    for label, (body, inputs, k) in stages.items():
        out = mxu_probe.mxu_loop(body, inputs, salt, PROBE_CHECK_ITERS, k)
        again = mxu_probe.mxu_loop(body, inputs, salt, PROBE_CHECK_ITERS, k)
        torch.cuda.synchronize()
        ref = mxu_probe.mxu_loop_reference(body, inputs, salt,
                                           PROBE_CHECK_ITERS, k)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        say(f"phase 31: mxu_loop {label} ({body}, {tuple(out.shape)}) vs "
            f"plain at iters {PROBE_CHECK_ITERS}: max |d| {err:.3e}, max "
            f"|out| {scale:.3e} (tolerance {bench_mxu.KERNEL_RTOL[body]} x "
            f"max); repeat bit for bit {torch.equal(out, again)}")
        require(bool(torch.isfinite(out).all()) and out.shape == ref.shape,
                f"mxu_loop {label}: non-finite or misshapen carry")
        require(err <= bench_mxu.KERNEL_RTOL[body] * scale,
                f"mxu_loop {label} disagrees with its plain version")
        require(torch.equal(out, again), f"mxu_loop {label} does not repeat")
        errs[body] = max(errs[body], err)

    # Repeat at the tool's iters, bit for bit; its chain, bound and slope.
    _, rep_inputs, rep_k = stages["repeat"]
    out = mxu_probe.mxu_loop("repeat", rep_inputs, salt, iters, rep_k)
    torch.cuda.synchronize()
    ref = mxu_probe.repeat_reference(*rep_inputs, rep_k, salt, iters)
    require(torch.equal(out, ref), f"mxu_loop repeat at iters {iters} is "
            "not its plain version bit for bit")
    chain = bench_mxu.repeat_chain_bound(dev)
    require(chain["max_abs_err"] == 0.0,
            f"repeat_chain disagrees with its plain version: {chain}")
    rb = repeat_bound(rep_inputs, rep_k, iters, chain["ns"])
    slope_ms = {n: bench_mxu.time_stage("repeat", "repeat", rep_inputs,
                                        rep_k, n, dev)[1]
                for n in REPEAT_SLOPE_ITERS}
    lo, hi = REPEAT_SLOPE_ITERS
    slope_ns = (slope_ms[hi] - slope_ms[lo]) * 1e6 / (hi - lo)
    iter_bound_ns = max(rb["issue_ms"], rb["chain_ms"]) * 1e6 / iters
    say(f"phase 31: repeat at iters {iters} bit for bit its plain version; "
        f"row 0's chain (repeat_chain, one thread, {chain['reps']} and "
        f"{2 * chain['reps']} steps) {chain['ns']:.3f} ns a step, bit for "
        f"bit its plain version; bound {rb['ms']:.5f} ms ({rb['by']}: "
        f"issue {rb['issue_ms']:.5f}, chain {rb['chain_ms']:.5f}, bytes "
        f"{rb['bytes_ms']:.5f}; the first form's roofline "
        f"{rb['roofline_ms']:.5f}); collapse check: {slope_ms[lo]:.5f} ms "
        f"at iters {lo}, {slope_ms[hi]:.5f} at {hi}, {slope_ns:.3f} ns an "
        f"iteration between them against the bound's {iter_bound_ns:.3f} "
        f"[{card}]")
    require(slope_ns >= iter_bound_ns,
            f"repeat's loop collapsed: {slope_ns} ns an iteration under "
            f"its bound's {iter_bound_ns}")
    kernels = []
    body_lines = {"peak": 150, "gather_mm": 185, "gather_full": 215,
                  "edge_mlp": 247, "repeat": 264}
    for body in mxu_probe.BODIES:
        _, inputs, k = stages[body]
        stage = res["stages"][body]
        plain_ms = time_ms(lambda: mxu_probe.mxu_loop_reference(
            body, inputs, salt, iters, k), reps=3, warmup=1)
        bound_ms, bound_by = mxu_bound(body, inputs, k, iters, chain["ns"])
        say(f"phase 31: mxu_loop {body} {stage['ms']:.4f} ms/call at iters "
            f"{iters} ({stage['us_per_iter']:.3f} us/iter), plain "
            f"{plain_ms:.4f} ms/call (median of 3), bound {bound_ms:.4f} ms "
            f"({bound_by}), kernel at {bound_ms / stage['ms']:.2%} of it "
            f"[{card}]")
        kernels.append({
            "name": f"mxu_loop:{body}", "route": "cuda",
            "source": "gamd_tpu_torch/csrc/mxu_probe.cu",
            "replaces": "scripts/bench_mxu.py:91",
            "body": f"scripts/bench_mxu.py:{body_lines[body]}",
            "launches_by_path": {"bench_mxu": launches[body]},
            "max_abs_err": errs[body], "ms": stage["ms"],
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": libs.get(body),
            "iters": iters, "us_per_iter": stage["us_per_iter"],
            "tflops": stage["tflops"], "ctas": stage["ctas"],
            "cluster": stage["cluster"]})
        if body == "repeat":
            kernels[-1].update(
                issue_bound_ms=rb["issue_ms"], chain_bound_ms=rb["chain_ms"],
                chain_ns_per_iter=chain["ns"],
                roofline_bound_ms=rb["roofline_ms"],
                us_per_iter_slope=slope_ns / 1e3,
                slope_ms={str(n): t for n, t in slope_ms.items()})
    big = res["stages"]["gather_mm_8M"]
    kernels[1].update(us_per_iter_8M=big["us_per_iter"], ms_8M=big["ms"],
                      library_ms_8M=libs["gather_mm_8M"], ctas_8M=big["ctas"])
    return kernels, fwd_launches


def library_products(stages, label, k, dev):
    """One iteration's products of a bench_mxu stage as PyTorch calls, in
    the body's order (cuBLAS for the bf16 products; repeat_interleave for
    the broadcast): the library yardstick."""
    body, inputs, _ = stages[label]
    if body == "peak":
        a, w = inputs

        def chain():
            x = a
            for _ in range(4):
                x = torch.matmul(x, w)
            return x
        return chain
    if body == "gather_mm":
        oh, nh, nl = inputs
        return lambda: (torch.matmul(oh, nh), torch.matmul(oh, nl))
    if body == "gather_full":
        idx, nh, nl, ws = inputs
        oh = (torch.arange(nh.shape[0], device=dev)[None] == idx).to(
            torch.bfloat16)
        wsh = ws.to(torch.bfloat16)
        wsl = (ws - wsh.float()).to(torch.bfloat16)

        def gather_affine():
            gh, gl = torch.matmul(oh, nh), torch.matmul(oh, nl)
            return (torch.matmul(gh, wsh), torch.matmul(gh, wsl),
                    torch.matmul(gl, wsh))
        return gather_affine
    if body == "edge_mlp":
        e, w = inputs
        wb = w.to(torch.bfloat16)

        def mlp():
            x = e
            for _ in range(4):
                x = torch.matmul(x, wb)
            return x
        return mlp
    dst, = inputs
    return lambda: torch.repeat_interleave(dst, k, dim=0,
                                           output_size=dst.shape[0] * k)


def gather_probe_phases(dev, card):
    """Phases 32-33 (module docstring). Returns the kernels-line entries of
    onehot_gather's five forms."""
    iters = probe_gather.parse_args([]).iters

    # -- phase 32: tools.probe_gather at its defaults -----------------------
    gather_probe.onehot_gather.launches = dict.fromkeys(gather_probe.FORMS, 0)
    gather_probe.lane_gather.launches = dict.fromkeys(
        gather_probe.LANE_WIDTHS, 0)
    gather_probe.sublane_gather.launches = 0
    gather_probe.transpose_probe.launches = 0
    t0 = time.perf_counter()
    res = probe_gather.main([])
    seconds = time.perf_counter() - t0
    launches = dict(gather_probe.onehot_gather.launches)
    form_launches = {form: probe_gather.launches(form)
                     for form in probe_gather.GATHER_FORMS}
    all_lines = {form: res[key] for key, _, form in probe_gather.VARIANTS}
    lines = {form: all_lines[form] for form in gather_probe.FORMS}
    say(f"phase 32: tools.probe_gather in process at its defaults "
        f"({seconds:.1f} s): " + "; ".join(
            f"{form} {line['per_edge_stream_us']:.3f} us/iter, calib "
            f"{line['calib_ratio']:.3f} {line['status']}, parity "
            f"{line['parity']:.2e}" for form, line in lines.items())
        + f"; launches {launches} [{card}]")
    require(all(line["status"] == "OK" for line in lines.values()),
            "a one-hot variant's loop collapsed")
    require(all(line["parity"] <= PROBE_CARRY_RTOL
                for line in lines.values()),
            "a one-hot variant's carry is not iters sum T[idx]")
    require(all(launches[form] > 0 for form in gather_probe.FORMS),
            f"a form did not launch: {launches}")
    idx, tbl = probe_gather.probe_inputs()
    xs = {form: probe_gather.form_inputs(form, idx, tbl, dev)
          for form in gather_probe.FORMS}

    def onehot_of(x, form):
        """The one-hot products of one iteration as cuBLAS calls."""
        rows = x["idx"][:, 0].long()
        band = gather_probe.band_of(form)
        if band is None:
            oh = (torch.arange(x["tbl"].shape[0], device=dev)[None]
                  == rows[:, None]).to(x["tbl"].dtype)
            if form == "int8_int8":
                return lambda: torch._int_mm(oh, x["tbl"])
            return lambda: torch.matmul(oh, x["tbl"])
        n = x["starts"].shape[0]
        size = rows.shape[0] // n
        tiles = [((torch.arange(band, device=dev)[None]
                   == rows[t * size:(t + 1) * size, None] - s)
                  .to(torch.bfloat16), x["tbl"][s:s + band])
                 for t, s in enumerate(x["starts"].tolist())]
        return lambda: [torch.matmul(o, t) for o, t in tiles]

    libs = {}
    for form, x in xs.items():
        try:
            libs[form] = graph_ms(onehot_of(x, form), iters)
        except (RuntimeError, AttributeError) as exc:   # torch._int_mm
            libs[form] = None
            say(f"phase 32: {form}: no library time ({exc})")
    flat = xs["bf16"]["idx"][:, 0].long()
    index_ms = graph_ms(
        lambda: torch.index_select(xs["bf16"]["tbl"], 0, flat), iters)
    say(f"phase 32: the same products by cuBLAS (torch.matmul; int8 x int8 "
        f"by torch._int_mm): " + ", ".join(
            f"{form} {'none' if ms is None else f'{ms * 1e3 / iters:.3f}'}"
            f" us/iter" for form, ms in libs.items())
        + f"; torch.index_select(tbl, 0, idx) {index_ms * 1e3 / iters:.3f} "
        f"us/iter ({iters} calls replayed from a CUDA graph, CUDA events, "
        f"median of 3) [{card}]")

    # -- phase 33: each form against its plain version -----------------------
    kernels = []
    replaces = {"bf16": 66, "int8_bf16": 84, "int8_int8": 84,
                "band256": 113, "band208": 113}
    for form, x in xs.items():
        out, g = probe_gather.call(x, form, PROBE_CHECK_ITERS, product=True)
        again = probe_gather.call(x, form, PROBE_CHECK_ITERS)
        torch.cuda.synchronize()
        ref, g_ref = gather_probe.onehot_gather_reference(
            x["idx"], x["tbl"], PROBE_CHECK_ITERS, form, x["starts"],
            product=True)
        rows_equal = torch.equal(g, g_ref) and torch.equal(
            g, x["tbl"].float()[x["idx"][:, 0].long()])
        err = float((out - ref).abs().max())
        _, scale = probe_gather.gathered(x, form)
        tol = (0.0 if form == "int8_int8"
               else PROBE_CARRY_RTOL * PROBE_CHECK_ITERS * scale)
        say(f"phase 33: onehot_gather {form} vs plain at iters "
            f"{PROBE_CHECK_ITERS}: gathered rows [{g.shape[0]}, "
            f"{g.shape[1]}] bit for bit {rows_equal}; carry |d| {err:.3e} "
            f"(tolerance {tol:.3e}: {PROBE_CARRY_RTOL} x iters sum "
            f"|T[idx]|); repeat bit for bit {torch.equal(out, again)}")
        require(rows_equal, f"onehot_gather {form} gathered the wrong rows")
        require(err <= tol, f"onehot_gather {form} carry disagrees")
        require(torch.equal(out, again), f"onehot_gather {form} repeats not")
        line = lines[form]
        plain_ms = time_ms(lambda: gather_probe.onehot_gather_reference(
            x["idx"], x["tbl"], iters, form, x["starts"]), reps=1, warmup=1)
        bound_ms, bound_by, gflop = onehot_bound(form, x, iters)
        plan = gather_probe.launch_plan(form, x["idx"].shape[0],
                                        x["tbl"].shape[0],
                                        mxu_probe.sm_count(dev))
        say(f"phase 33: onehot_gather {form} {line['ms']:.4f} ms/call at "
            f"iters {iters} ({line['per_edge_stream_us']:.3f} us/iter) on "
            f"{plan.ctas} persistent CTAs, "
            f"plain {plain_ms:.4f} ms/call (one call), bound "
            f"{bound_ms:.4f} ms ({bound_by}; {gflop:.4f} GFLOP an "
            f"iteration), kernel at {bound_ms / line['ms']:.2%} of it "
            f"[{card}]")
        kernels.append({
            "name": f"onehot_gather:{form}", "route": "cuda",
            "source": "gamd_tpu_torch/csrc/onehot_gather.cu",
            "replaces": f"scripts/probe_gather.py:{replaces[form]}",
            "launches_by_path": {"probe_gather": launches[form]},
            "max_abs_err": err, "ms": line["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": libs[form], "index_select_ms": index_ms,
            "iters": iters, "us_per_iter": line["per_edge_stream_us"],
            "calib_ratio": line["calib_ratio"], "ctas": plan.ctas})
    return kernels, all_lines, form_launches


def form_bound(form, x, iters):
    """(least ms, bound_by) of one call of a lane, sublane or transpose
    form: one fp32 addition for each of the 256 x 13,056 values an
    iteration (the transpose: 34 x 256 x 384) at the fp32 rate, against
    the indices and the table read once and the carry written once."""
    values = probe_gather.N_BLOCKS * probe_gather.EB * probe_gather.LANES
    inputs = [t for t in (x["idx"], x["tbl"]) if t is not None]
    return roofline(iters * values, tensor_bytes(*inputs) + 8 * 128 * 4)


def data_bound(form, iters, dev):
    """(least ms of one call, what it counts) on the data a form moves
    through an SM, at tools.time_probes.smem_bound's rate.

    * The lane forms: each gathered value read once from shared memory.
    * The sublane form stages a slice of its table's lanes (every row)
      in shared memory once a call and reads its gathered values from
      there: each gathered value read once from shared memory, as the
      lane forms.
    * The transpose moves every value across lanes. On Hopper no
      instruction does that for 32-bit values outside shared memory
      (ldmatrix, stmatrix .trans and movmatrix take 16-bit elements; a
      shuffle transpose needs a rotation of registers by lane before and
      after each exchange), so each value is stored once and read once in
      shared memory: twice the read bound."""
    ms, _ = smem_bound(iters, dev)
    if form == "transpose":
        return 2 * ms, "each value stored and read once in shared memory"
    return ms, "the gathered values read once from shared memory"


def plain_call(x, form, iters, product=False):
    """The plain version of a lane, sublane or transpose form on x."""
    if form in probe_gather.LANE_FORMS:
        return gather_probe.lane_gather_reference(
            x["idx"], x["tbl"], iters, probe_gather.LANE_FORMS[form],
            product)
    if form == "sublane":
        return gather_probe.sublane_gather_reference(x["idx"], x["tbl"],
                                                     iters, product)
    return gather_probe.transpose_probe_reference(
        x["tbl"], iters, probe_gather.N_BLOCKS, product)


def gather_form_phase(dev, card, lines, launches):
    """Phase 34 (module docstring), on phase 32's tool lines and launches.
    Returns the kernels-line entries of the four forms."""
    idx, tbl = probe_gather.probe_inputs()
    replaces = {"lane384": 147, "lane128x3": 147, "sublane": 178,
                "transpose": 196}
    say(f"phase 34: tools.probe_gather's lane, sublane and transpose "
        f"forms: " + "; ".join(
            f"{form} {lines[form]['per_edge_stream_us']:.4f} us/iter, "
            f"calib {lines[form]['calib_ratio']:.3f} "
            f"{lines[form]['status']}, parity {lines[form]['parity']:.2e}, "
            f"library {lines[form]['library_us_per_iter']:.4f} us/iter"
            for form in probe_gather.GATHER_FORMS)
        + f"; launches {launches} [{card}]")
    require(all(lines[form]["status"] == "OK"
                for form in probe_gather.GATHER_FORMS),
            "a lane, sublane or transpose loop collapsed")
    require(all(lines[form]["parity"] <= PROBE_CARRY_RTOL
                for form in probe_gather.GATHER_FORMS),
            "a lane, sublane or transpose carry is not iters x its sum")
    require(all(launches[form] > 0 for form in probe_gather.GATHER_FORMS),
            f"a form did not launch: {launches}")
    kernels = []
    for form in probe_gather.GATHER_FORMS:
        x = probe_gather.form_inputs(form, idx, tbl, dev)
        out, g = probe_gather.call(x, form, PROBE_CHECK_ITERS, product=True)
        again = probe_gather.call(x, form, PROBE_CHECK_ITERS)
        torch.cuda.synchronize()
        ref, g_ref = plain_call(x, form, PROBE_CHECK_ITERS, product=True)
        torch.cuda.synchronize()
        same = torch.equal(g, g_ref)
        err = float((out - ref).abs().max())
        _, scale = probe_gather.gathered(x, form)
        tol = PROBE_CARRY_RTOL * PROBE_CHECK_ITERS * scale
        say(f"phase 34: {form} vs plain at iters {PROBE_CHECK_ITERS}: "
            f"result {list(g.shape)} bit for bit {same}; carry |d| "
            f"{err:.3e} (tolerance {tol:.3e}: {PROBE_CARRY_RTOL} x iters "
            f"x one iteration's sum of magnitudes); repeat bit for bit "
            f"{torch.equal(out, again)}")
        require(same, f"{form}: the result differs from its plain version")
        require(err <= tol, f"{form}: the carry disagrees")
        require(torch.equal(out, again), f"{form}: a repeat differs")
        line = lines[form]
        iters = line["iters"]
        plain_ms = time_ms(lambda: plain_call(x, form, iters), reps=1,
                           warmup=1)
        bound_ms, bound_by = form_bound(form, x, iters)
        _, smem_rate = smem_bound(iters, dev)
        smem_ms, moved = data_bound(form, iters, dev)
        smem = (f"; {moved} {smem_ms:.4f} ms ({smem_rate:.0f} GB/s), "
                f"kernel at {smem_ms / line['ms']:.2%} of it")
        if form == "sublane":
            plan = gather_probe.sublane_plan(
                probe_gather.ROWS, probe_gather.N_PAD,
                mxu_probe.sm_count(dev))
            say(f"phase 34: sublane_kernel at {smem_ms / line['ms']:.2%} "
                f"of its bound, {moved} ({smem_ms:.4f} ms against "
                f"{line['ms']:.4f}); plan {plan._asdict()} [{card}]")
        say(f"phase 34: {form} {line['ms']:.4f} ms/call at iters {iters} "
            f"({line['per_edge_stream_us']:.4f} us/iter, collapse ratio "
            f"{line['calib_ratio']:.3f}), plain {plain_ms:.4f} ms/call "
            f"(one call), library {line['library']} "
            f"{line['library_ms']:.4f} ms for the same work, bound "
            f"{bound_ms:.4f} ms ({bound_by}), kernel at "
            f"{bound_ms / line['ms']:.2%} of it{smem} [{card}]")
        kernels.append({
            "name": ("lane_gather:" + str(probe_gather.LANE_FORMS[form])
                     if form in probe_gather.LANE_FORMS
                     else {"sublane": "sublane_gather",
                           "transpose": "transpose_probe"}[form]),
            "route": "cuda",
            "source": "gamd_tpu_torch/csrc/gather_forms.cu",
            "replaces": f"scripts/probe_gather.py:{replaces[form]}",
            "launches_by_path": {"probe_gather": launches[form]},
            "max_abs_err": err, "ms": line["ms"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": line["library_ms"], "library": line["library"],
            "iters": iters, "us_per_iter": line["per_edge_stream_us"],
            "calib_ratio": line["calib_ratio"], "smem_bound_ms": smem_ms})
    return kernels


def replica_frames(pos, box, r):
    """r LJ-258 frames: the start frame and r - 1 copies of it displaced by
    a seeded 0.05 A jitter, wrapped, [r, N, 3]."""
    gen = np.random.default_rng(35)
    frames = [pos] + [space.wrap(pos + torch.as_tensor(
        gen.normal(0.0, 0.05, pos.shape).astype(np.float32),
        device=pos.device), box) for _ in range(r - 1)]
    return torch.stack(frames)


def replica_phases(dev, card, single_ms, single_window_ms):
    """Phases 35-38 (module docstring). `single_ms` and `single_window_ms`
    are phase 2's and 4's single-system times. Returns the R=8 figures of
    mega_forward and mega_md_steps and the launches of every kernel by
    path."""
    system, model_cfg, md, state, pos = lj_slice(dev, seed=0)
    n = system.n_atoms
    mp = pack_params(state.params, model_cfg, force_std=state.force_stat.std,
                     force_mean=state.force_stat.safe_mean,
                     unit=system.force_unit_to_internal, device=dev)
    h0 = torch.as_tensor(state.params["node_emb"], device=dev).expand(
        n, model_cfg.encoding_size).contiguous()
    frames = replica_frames(pos, system.box, REPLICAS)
    idx, mask, ovf = build_nbrs(frames, system, K_MODEL)
    require(not bool(ovf), "neighbour overflow in the replica frames")
    h0_r = h0.expand(REPLICAS, -1, -1).contiguous()
    scalars = (system.box, system.cutoff, state.length_stat.safe_mean,
               state.length_stat.std)
    args = (frames, idx, mask, h0_r, mp, *scalars)
    kw = dict(rbf_gap=model_cfg.rbf_gap)

    # -- phase 35: mega_forward at R=8 against 8 single calls -------------
    before = mega_forward.launches
    out = mega_forward(*args, **kw)
    torch.cuda.synchronize()
    require(mega_forward.launches == before + 1,
            "mega_forward at R=8 is not one launch")
    require(out.shape == frames.shape and bool(torch.isfinite(out).all()),
            f"R=8 forces of shape {tuple(out.shape)} or not finite")
    ref = reference_forward(*args, **kw)
    bitwise, errs = [], []
    for r in range(REPLICAS):
        one = mega_forward(frames[r], idx[r], mask[r], h0, mp, *scalars,
                           **kw)
        scale_r = float(ref[r].abs().std())
        bitwise.append(torch.equal(out[r], one))
        errs.append(max(float((out[r] - one).abs().max()),
                        float((out[r] - ref[r]).abs().max())) / scale_r)
    torch.cuda.synchronize()
    max_err = float((out - ref).abs().max())
    say(f"phase 35: mega_forward at R={REPLICAS} (LJ-258 frames, K="
        f"{K_MODEL}) in one launch vs {REPLICAS} single launches: bit for "
        f"bit {sum(bitwise)} of {REPLICAS}; max |dF| / std(F) against the "
        f"single calls and the plain version {max(errs):.3e} (tolerance "
        f"{TOLERANCE})")
    require(max(errs) < TOLERANCE,
            "an R=8 replica disagrees with its single call or plain version")
    live = [int(refresh_mask(frames[r], system.box, system.cutoff, idx[r],
                             mask[r]).sum()) for r in range(REPLICAS)]
    ops = forward_ops(sum(live), REPLICAS * n, model_cfg.n_rbf, model_cfg)
    r_ms = time_ms(lambda: mega_forward(*args, **kw))
    r_plain_ms = time_ms(lambda: reference_forward(*args, **kw), reps=5,
                         warmup=1)
    r_bound_ms, r_bound_by = tc_bound(ops, REPLICAS * n, K_MODEL, mp,
                                      model_cfg)
    say(f"phase 35: mega_forward at R={REPLICAS} {r_ms:.4f} ms/call "
        f"({r_ms / REPLICAS:.4f} ms a replica; single {single_ms:.4f}: "
        f"{REPLICAS * single_ms / r_ms:.2f}x the throughput), plain "
        f"{r_plain_ms:.4f} ms/call, bound {r_bound_ms:.4f} ms "
        f"({r_bound_by}; {ops[0] / 1e9:.4f} GFLOP bf16 x 3 and "
        f"{ops[1] / 1e9:.4f} GFLOP fp32 for {sum(live)} live edges), kernel "
        f"at {r_bound_ms / r_ms:.2%} of it; CUDA events [{card}]")
    forward_r8 = {"replicas": REPLICAS, "ms": r_ms, "plain_ms": r_plain_ms,
                  "bound_ms": r_bound_ms, "bound_by": r_bound_by,
                  "max_abs_err": max_err,
                  "bit_for_bit_replicas": sum(bitwise)}

    # -- phase 36: the R=8 window against its plain version ---------------
    sim = Simulation(lambda p, i, m: p, system, md, device=dev)
    c1, hdt, c2col = sim._baoab_constants()
    c2col = c2col.contiguous()
    vel = maxwell_boltzmann_velocities(torch.Generator(dev).manual_seed(36),
                                       sim.masses, md.temperature,
                                       n_replicas=REPLICAS)
    seed = torch.tensor([20261017], dtype=torch.int32, device=dev)
    n_win = md.rebuild_every
    wargs = (frames, vel, out, idx, mask, h0_r, mp, *scalars, sim.masses)
    results = {}
    for label, amp in (("noise off", torch.zeros_like(c2col)),
                       ("noise on", c2col)):
        wkw = dict(n_steps=n_win, c1=c1, hdt=hdt, c2col=amp, seed=seed,
                   **kw)
        before = mega_md_steps.launches
        w_out = mega_md_steps(*wargs, **wkw)
        torch.cuda.synchronize()
        require(mega_md_steps.launches == before + 1,
                f"the R=8 window is not one call ({label})")
        w_ref = md_steps_reference(*wargs, **wkw)
        one = mega_md_steps(frames[0], vel[0], out[0].contiguous(), idx[0],
                            mask[0], h0, mp, *scalars, sim.masses, **wkw)
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(t).all()) for t in w_out),
                f"non-finite R=8 window ({label})")
        require(w_out[3].shape == (REPLICAS, n_win),
                f"R=8 ke of shape {tuple(w_out[3].shape)}")
        dx = float((w_out[0] - w_ref[0]).abs().max())
        dv = float((w_out[1] - w_ref[1]).abs().max())
        dke = float(((w_out[3] - w_ref[3]).abs() / w_ref[3].abs()).max())
        same0 = all(torch.equal(a[0], b) for a, b in zip(w_out, one))
        say(f"phase 36: R={REPLICAS} window vs plain, {label}, {n_win} "
            f"steps: max |dx| {dx:.3e} A, max |dv| {dv:.3e} A/t0 "
            f"(tolerance {WINDOW_ATOL}), max ke rel {dke:.3e} (tolerance "
            f"{WINDOW_KE_RTOL}); replica 0 bit for bit the single-system "
            f"window: {same0}")
        require(dx <= WINDOW_ATOL and dv <= WINDOW_ATOL,
                f"the R=8 window disagrees with its plain version ({label})")
        require(dke <= WINDOW_KE_RTOL, f"R=8 window KE disagrees ({label})")
        require(same0, f"replica 0 of the R=8 window is not the single "
                f"window ({label})")
        results[label] = (w_out, max(dx, dv), wkw)
    apart = float((results["noise on"][0][0][0]
                   - results["noise on"][0][0][1]).abs().max())
    wkw = results["noise on"][2]
    w_ms = time_ms(lambda: mega_md_steps(*wargs, **wkw), reps=10)
    w_plain_ms = time_ms(lambda: md_steps_reference(*wargs, **wkw), reps=2,
                         warmup=1)
    w_bound_ms, w_bound_by = tc_bound((n_win * ops[0], n_win * ops[1]),
                                      REPLICAS * n, K_MODEL, mp, model_cfg,
                                      state_io=True)
    say(f"phase 36: mega_md_steps at R={REPLICAS} {w_ms:.4f} ms/window "
        f"({REPLICAS * n_win / w_ms * 1e3:.1f} replica-steps/s; single "
        f"window {single_window_ms:.4f} ms: "
        f"{REPLICAS * single_window_ms / w_ms:.2f}x the throughput), plain {w_plain_ms:.4f} ms/window, bound "
        f"{w_bound_ms:.4f} ms ({w_bound_by}), kernel at "
        f"{w_bound_ms / w_ms:.2%} of it; replicas 0 and 1 end "
        f"{apart:.3e} A apart [{card}]")
    window_r8 = {"replicas": REPLICAS, "ms": w_ms, "plain_ms": w_plain_ms,
                 "bound_ms": w_bound_ms, "bound_by": w_bound_by,
                 "max_abs_err": max(r[1] for r in results.values())}

    # -- phase 37: run_replicas, megastep Langevin and per-step NHC --------
    ff = GNNForceField(state, system, model_cfg, device=dev)
    launches = {}
    for path, integrator in (("replicas_megastep", "langevin"),
                             ("replicas_nhc", "nose_hoover")):
        md_r = dataclasses.replace(md, integrator=integrator)
        sim = Simulation(ff.force_fn(megakernel=True), system, md_r,
                         k_model=K_MODEL, device=dev,
                         megastep_fn=(ff.megastep_fn()
                                      if integrator == "langevin" else None))
        states = sim.init_replicas(pos, REPLICAS,
                                   rng=torch.Generator(dev).manual_seed(37))
        mega_forward.launches = mega_md_steps.launches = 0
        nhc.nhc_half_step.launches = 0
        warm = sim.run_replicas(states, WARMUP_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run_replicas(warm.state, REPLICA_STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {"mega_forward": mega_forward.launches,
                  "mega_md_steps": mega_md_steps.launches,
                  "nhc_half_step": nhc.nhc_half_step.launches}
        launches[path] = counts
        steps = WARMUP_STEPS + REPLICA_STEPS
        want = ({"mega_forward": 0, "mega_md_steps": steps // md.rebuild_every,
                 "nhc_half_step": 0} if integrator == "langevin" else
                {"mega_forward": steps, "mega_md_steps": 0,
                 "nhc_half_step": 2 * steps})
        temps = res.thermo.temperature
        mean_t = float(temps.mean())
        p = res.state.pos
        spread = min(float((p[r] - p[r + 1]).abs().max())
                     for r in range(REPLICAS - 1))
        say(f"phase 37: run_replicas {integrator} R={REPLICAS} "
            f"({'megastep' if integrator == 'langevin' else 'per step'}), "
            f"{REPLICA_STEPS} steps in {seconds:.4f} s = "
            f"{REPLICAS * REPLICA_STEPS / seconds:.1f} aggregate steps/s "
            f"({REPLICA_STEPS / seconds:.1f} a replica); mean T "
            f"{mean_t:.2f} K, per replica {float(temps.mean(1).min()):.2f}-"
            f"{float(temps.mean(1).max()):.2f} K; thermo "
            f"{list(temps.shape)}, positions {list(res.positions.shape)}; "
            f"replicas at least {spread:.3e} A apart; launches {counts} "
            f"[{card}]")
        require(counts == want, f"launches {counts}, want {want}")
        require(temps.shape == (REPLICAS, REPLICA_STEPS)
                and res.positions.shape[:2] == (REPLICAS, REPLICA_STEPS
                                                // md.rebuild_every),
                "run_replicas result shapes")
        require(bool(torch.isfinite(p).all())
                and bool(torch.isfinite(temps).all()),
                f"non-finite replica run ({integrator})")
        require(not warm.overflow and not res.overflow,
                f"neighbour overflow ({integrator} replicas)")
        require(spread > 1e-3, f"replicas did not diverge ({integrator})")
        if integrator == "langevin":
            require(abs(mean_t - md.temperature) <= T_BAND,
                    f"R=8 mean temperature {mean_t} K outside the band")

    # -- phase 38: tools.bench_replicas -------------------------------------
    argv = [str(REPLICAS), str(BENCH_REPLICAS_STEPS)]
    for integrator in ("langevin", "nose_hoover"):
        os.environ["GAMD_BENCH_INTEGRATOR"] = integrator
        mega_forward.launches = mega_md_steps.launches = 0
        nhc.nhc_half_step.launches = 0
        try:
            t0 = time.perf_counter()
            line = bench_replicas.main(argv)
        finally:
            del os.environ["GAMD_BENCH_INTEGRATOR"]
        counts = {"mega_forward": mega_forward.launches,
                  "mega_md_steps": mega_md_steps.launches,
                  "nhc_half_step": nhc.nhc_half_step.launches}
        launches[f"bench_replicas_{integrator}"] = counts
        say(f"phase 38: tools.bench_replicas {' '.join(argv)} "
            f"(GAMD_BENCH_INTEGRATOR={integrator}) in process "
            f"({time.perf_counter() - t0:.1f} s): {json.dumps(line)}; "
            f"launches {counts} [{card}]")
        require(line["value"] > 0 and line["per_replica"] > 0,
                "bench_replicas printed no rate")
        key = "mega_md_steps" if integrator == "langevin" else "mega_forward"
        require(counts[key] > 0, f"bench_replicas {integrator}: {key} did "
                "not launch")
    return forward_r8, window_r8, launches


def stage_profile(fn, calls):
    """{stage: device us a call} of the forward's kernels (profile_step.
    FORWARD_STAGES; exclusive times, since programmatic dependent launch
    overlaps a kernel's span with the one before it), their launches a
    call and their device us a call, from a torch.profiler run of `calls`
    calls of fn."""
    kernels, _ = exclusive_times(traced_spans(fn, calls))
    stages = forward_stages(kernels, calls)
    forward = [k for k in kernels if k in FORWARD_STAGES]
    require(stages, "torch.profiler saw no device time of the forward")
    return (stages, sum(kernels[k]["count"] for k in forward) / calls,
            sum(stages.values()))


def forward_stage_phases(dev, card):
    """Phases 39-40 (module docstring). Returns the stage breakdowns,
    {"R=1": {...}, "R=8": {...}}."""
    system, model_cfg, md, state, pos = lj_slice(dev, seed=0)
    n = system.n_atoms
    mp = pack_params(state.params, model_cfg, force_std=state.force_stat.std,
                     force_mean=state.force_stat.safe_mean,
                     unit=system.force_unit_to_internal, device=dev)
    h0 = torch.as_tensor(state.params["node_emb"], device=dev).expand(
        n, model_cfg.encoding_size).contiguous()
    scalars = (system.box, system.cutoff, state.length_stat.safe_mean,
               state.length_stat.std)
    cases = {}
    for r, p in ((1, pos), (REPLICAS, replica_frames(pos, system.box,
                                                      REPLICAS))):
        idx, mask, ovf = build_nbrs(p, system, K_MODEL)
        require(not bool(ovf), f"neighbour overflow at R={r}")
        cases[r] = (p, idx, mask,
                    h0 if r == 1 else h0.expand(r, -1, -1).contiguous())

    # -- phase 39: the live-edge layout against its plain version ---------
    for r, (p, idx, mask, _) in cases.items():
        before = mega_layout.launches
        got = mega_layout(p, idx, mask, system.box, system.cutoff)
        want = live_edge_layout(p, idx, mask, system.box, system.cutoff)
        torch.cuda.synchronize()
        require(mega_layout.launches == before + 1,
                "the layout kernel did not launch once")
        totals = want.total.tolist()
        same = (torch.equal(got.offset, want.offset)
                and torch.equal(got.count, want.count)
                and torch.equal(got.total, want.total)
                and all(torch.equal(got.slot[q, :t], want.slot[q, :t])
                        for q, t in enumerate(totals)))
        tiles = layout_tiles(want)
        say(f"phase 39: live-edge layout at R={r} (LJ-258, K={K_MODEL}): "
            f"the layout kernel equal to live_edge_layout: {same} "
            f"(offsets, counts, totals {totals}, compacted slots); "
            f"{sum(totals)} live of {r * n * K_MODEL} slots in {len(tiles)} "
            f"tiles of at most 64 rows, none across a replica")
        require(same, f"the device layout differs from the plain one at "
                f"R={r}")

    # -- phase 40: per-stage device time, launches a forward --------------
    sim = Simulation(lambda p, i, m: p, system, md, device=dev)
    c1, hdt, c2col = sim._baoab_constants()
    n_win = md.rebuild_every
    seed = torch.tensor([40], dtype=torch.int32, device=dev)
    stages = {}
    for r, (p, idx, mask, hh) in cases.items():
        args = (p, idx, mask, hh, mp, *scalars)
        kw = dict(rbf_gap=model_cfg.rbf_gap)
        f_stages, f_launches, f_us = stage_profile(
            lambda: mega_forward(*args, **kw), 10)
        vel = maxwell_boltzmann_velocities(
            torch.Generator(dev).manual_seed(40), sim.masses,
            md.temperature, n_replicas=None if r == 1 else r)
        force = mega_forward(*args, **kw)
        w_stages, w_launches, w_us = stage_profile(
            lambda: mega_md_steps(p, vel, force, idx, mask, hh, mp, *scalars,
                                  sim.masses, n_steps=n_win, c1=c1, hdt=hdt,
                                  c2col=c2col.contiguous(), seed=seed, **kw),
            1)
        w_stages = {k: v / n_win for k, v in w_stages.items()}
        stages[f"R={r}"] = {
            "forward_stage_us": f_stages, "forward_device_us": f_us,
            "forward_launches": f_launches,
            "window_stage_us_per_step": w_stages,
            "window_device_us_per_step": w_us / n_win,
            "window_forward_launches_per_step": w_launches / n_win}
        say(f"phase 40: forward at R={r}: {f_us:.2f} us of device time and "
            f"{f_launches:g} launches a mega_forward call, by stage "
            f"{json.dumps(f_stages)}; in a {n_win}-step mega_md_steps "
            f"window {w_us / n_win:.2f} us and {w_launches / n_win:g} "
            f"forward launches a step, by stage "
            f"{json.dumps({k: round(v, 3) for k, v in w_stages.items()})} "
            f"(torch.profiler) [{card}]")
    return stages


# -- water: tip3p_final on TIP3P-774 (phases 41-45) ---------------------------

WATER_CKPT = os.path.join("results", "ckpts", "tip3p_final.msgpack")
WATER_STEPS = 2000          # phase 43's rigid rollout
WATER_FRICTION = 25.0       # 1/ps: the water deployment's Langevin friction
                            # (scripts/session_r4h_queue.sh:30-33); at the
                            # preset's 1/ps the model's force noise heats it
WATER_MEGASTEP_STEPS = 100  # phase 45's unconstrained megastep run (it
                            # heats by thousands of K: no intramolecular
                            # force holds the molecules without SETTLE)
WATER_T_BAND = 20.0         # |mean T of the second half - 300 K|
WATER_RESIDUAL = 1e-5       # RigidWater.residual at the end (A)
WATER_OO_PEAK = (2.6, 3.0)  # the O-O RDF's first peak (A)
WATER_EAGER_RTOL = 1e-4     # use_pallas vs plain eager forces, / std(F)


def water_phases(dev, card):
    """Phases 41-45 (module docstring). Returns ({"mega_forward": {...},
    "mega_md_steps": {...}} the water shape's entries, {path: {kernel:
    launches}} of the water paths, the start's force field, frame, list
    and bond channel for phase 46)."""
    from gamd_tpu_torch.md.constraints import RigidWater
    from gamd_tpu_torch.neighbors.topology import neighbor_bond_channel

    state, model_cfg, system = load_self_describing(WATER_CKPT)
    n, k = system.n_atoms, system.nbr_capacity
    ff = GNNForceField(state, system, model_cfg, device=dev)
    cst = RigidWater(n // 3, system.box)
    t0 = time.perf_counter()
    start = cst.project_initial(run_md.water_start(system, dev))
    pos = space.wrap(start, system.box).contiguous()
    torch.cuda.synchronize()
    idx, mask, ovf = build_nbrs(pos, system)
    require(not bool(ovf), "neighbour overflow at the water start")
    bond = neighbor_bond_channel(idx)
    mp = ff._kernel_params("megakernel")
    args = (pos, idx, mask, ff._node_h0(), mp, system.box, system.cutoff,
            *ff._length_scale())
    live_edges = int(refresh_mask(pos, system.box, system.cutoff, idx,
                                  mask).sum())
    say(f"phase 41: water start (water_box, {run_md.WATER_FIRE_STEPS} FIRE "
        f"steps on the flexible TIP3P forces, project_initial) in "
        f"{time.perf_counter() - t0:.2f} s: residual "
        f"{float(cst.residual(pos)):.3e} A, {live_edges} live edges of "
        f"{n * k} slots (TIP3P-774, {system.cutoff} A, K={k}, "
        f"{int(bond.sum())} bond slots)")

    # -- phase 41: mega_forward with the bond channel ---------------------
    mega_forward.launches = 0
    f_kernel = mega_forward(*args, bond=bond)
    torch.cuda.synchronize()
    require(mega_forward.launches == 1, "mega_forward (bond) did not launch")
    f_plain = reference_forward(*args, bond=bond)
    scale = float(f_plain.abs().std())
    max_err = float((f_kernel - f_plain).abs().max())
    require(bool(torch.isfinite(f_kernel).all()),
            "non-finite water forces")
    require(max_err < TOLERANCE * scale,
            f"mega_forward with the bond disagrees: {max_err} vs {scale}")
    same_zero = torch.equal(mega_forward(*args, bond=torch.zeros_like(bond)),
                            mega_forward(*args))
    require(same_zero, "a bond of zeros does not give the bits of none")
    same_f32 = torch.equal(mega_forward(*args, bond=bond, f32_edges=True),
                           f_kernel)
    require(same_f32, "f32_edges changed the forward's bits")
    frames = torch.stack([pos, space.wrap(pos + 3.1, system.box)])
    idx2, mask2, ovf2 = build_nbrs(frames, system)
    require(not bool(ovf2), "neighbour overflow at the R=2 water frames")
    bond2 = neighbor_bond_channel(idx2)
    h02 = args[3].expand(2, -1, -1).contiguous()
    out2 = mega_forward(frames, idx2, mask2, h02, *args[4:], bond=bond2)
    same_r2 = all(torch.equal(out2[r], mega_forward(
        frames[r], idx2[r], mask2[r], args[3], *args[4:], bond=bond2[r]))
        for r in range(2))
    require(same_r2, "R=2 with the bond differs from its single calls")
    kernel_ms = time_ms(lambda: mega_forward(*args, bond=bond))
    plain_ms = time_ms(lambda: reference_forward(*args, bond=bond), reps=5)
    dev_us, _ = device_us(lambda: mega_forward(*args, bond=bond))
    ops = forward_ops(live_edges, n, model_cfg.n_rbf, model_cfg, bond=True)
    bound_ms, bound_by = tc_bound(ops, n, k, mp, model_cfg, bond=True)
    say(f"phase 41: mega_forward with the bond channel on TIP3P-774 "
        f"(tip3p_final, 4 x 128, K={k}, {live_edges} live edges): max |dF| "
        f"{max_err:.3e} vs std(F_plain) {scale:.3e}, max/std "
        f"{max_err / scale:.3e} (tolerance {TOLERANCE}, f32_edges and "
        f"edge_hilo the same bits: {same_f32}); bond zeros = no bond bit "
        f"for bit: {same_zero}; R=2 = its single calls bit for bit: "
        f"{same_r2}; {kernel_ms:.4f} ms/call (CUDA events, median of 20), "
        f"{dev_us:.2f} us of device time a call (torch.profiler), plain "
        f"version {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
        f"{ops[0] / 1e9:.4f} GFLOP bf16 x 3 and {ops[1] / 1e9:.4f} GFLOP "
        f"fp32), kernel at {bound_ms / kernel_ms:.2%} of it [{card}]")
    forward_entry = {"max_abs_err": max_err, "ms": kernel_ms,
                     "device_us": dev_us, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "live_edges": live_edges}

    # -- phase 42: mega_md_steps with the bond channel --------------------
    md = MDConfig(integrator="langevin", temperature=system.temperature,
                  friction_per_ps=system.friction_per_ps)
    sim = Simulation(lambda p, i, m: p, system, md, device=dev)
    c1, hdt, c2col = sim._baoab_constants()
    n_win = md.rebuild_every
    vel = maxwell_boltzmann_velocities(torch.Generator(dev).manual_seed(42),
                                       sim.masses, system.temperature)
    wkw = dict(n_steps=n_win, c1=c1, hdt=hdt,
               c2col=torch.zeros_like(c2col),
               seed=torch.tensor([42], dtype=torch.int32, device=dev),
               bond=bond)
    wargs = (pos, vel, f_kernel, idx, mask, *args[3:], sim.masses)
    mega_md_steps.launches = 0
    out = mega_md_steps(*wargs, **wkw)
    torch.cuda.synchronize()
    require(mega_md_steps.launches == 1, "mega_md_steps (bond) did not "
            "launch")
    ref = md_steps_reference(*wargs, **wkw)
    # The same plain window with its edge products in the kernels' bf16 x 3
    # arithmetic (ops.mega.split_bf16_matmul), as the CPU tests swap it in.
    plain_mm = mega_module._edge_mm
    mega_module._edge_mm = mega_module.split_bf16_matmul
    try:
        emu = md_steps_reference(*wargs, **wkw)
    finally:
        mega_module._edge_mm = plain_mm
    gap = lambda a, b, i: float((a[i] - b[i]).abs().max())
    dx, dv = gap(out, ref, 0), gap(out, ref, 1)
    dke = float(((out[3] - ref[3]).abs() / ref[3].abs()).max())
    spread = gap(emu, ref, 1)
    v_tol = max(WINDOW_ATOL, 2.0 * spread)
    require(all(bool(torch.isfinite(t).all()) for t in out),
            "non-finite water window")
    require(dx <= WINDOW_ATOL and dv <= v_tol,
            f"the water window disagrees: {dx}, {dv} (v tolerance {v_tol})")
    require(dke <= WINDOW_KE_RTOL, f"the water window's KE disagrees: {dke}")
    wkw["c2col"] = c2col.contiguous()
    window_ms = time_ms(lambda: mega_md_steps(*wargs, **wkw), reps=10)
    window_plain_ms = time_ms(lambda: md_steps_reference(*wargs, **wkw),
                              reps=3, warmup=1)
    window_bound_ms, window_bound_by = tc_bound(
        (n_win * ops[0], n_win * ops[1]), n, k, mp, model_cfg,
        state_io=True, bond=True)
    say(f"phase 42: mega_md_steps with the bond channel, one {n_win}-step "
        f"window at c2col = 0 on TIP3P-774, against the fp32 plain window: "
        f"max |dx| {dx:.3e} A (tolerance {WINDOW_ATOL}), max |dv| {dv:.3e} "
        f"A/t0 (tolerance {v_tol:.3e}: {WINDOW_ATOL} or twice the distance "
        f"of the plain window with the kernel's bf16 x 3 products from the "
        f"fp32 one, {spread:.3e}, the larger), max ke rel {dke:.3e} "
        f"(tolerance "
        f"{WINDOW_KE_RTOL}); against that bf16 x 3 plain window max |dx| "
        f"{gap(out, emu, 0):.3e}, |dv| {gap(out, emu, 1):.3e}; with noise "
        f"{window_ms:.4f} "
        f"ms/window ({window_ms / n_win:.4f} ms/step), plain version "
        f"{window_plain_ms:.4f} ms, bound {window_bound_ms:.4f} ms "
        f"({window_bound_by}; {n_win} x the start frame's work), kernel at "
        f"{window_bound_ms / window_ms:.2%} of it [{card}]")
    window_entry = {"max_abs_err": max(dx, dv), "ms": window_ms,
                    "plain_ms": window_plain_ms, "bound_ms": window_bound_ms,
                    "bound_by": window_bound_by}

    # -- phase 43: run_md --system tip3p --megakernel (rigid) -------------
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--system", "tip3p", "--ckpt", WATER_CKPT, "--megakernel",
                "--friction", str(WATER_FRICTION), "--steps",
                str(WATER_STEPS), "--log", os.path.join(tmp, "log.txt")]
        mega_forward.launches = mega_md_steps.launches = 0
        run = run_md.rollout(run_md.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        launches["water_megakernel"] = {
            "mega_forward": mega_forward.launches,
            "mega_md_steps": mega_md_steps.launches}
    res, rcst = run["result"], run["constraint"]
    temps = res.thermo.temperature
    second = float(temps[WATER_STEPS // 2:].mean())
    residual = float(rcst.residual(res.state.pos))
    frames = res.positions[res.positions.shape[0] // 2:]
    is_o = np.arange(n) % 3 == 0
    r_c, g = radial_distribution(frames, system.box, r_max=system.box / 2,
                                 n_bins=200, species_a=is_o, species_b=is_o)
    peak = float(r_c[int(np.argmax(g))])
    sps = WATER_STEPS / run["seconds"]
    say(f"phase 43: run_md --system tip3p --ckpt {WATER_CKPT} --megakernel "
        f"--friction {WATER_FRICTION:g} --steps {WATER_STEPS} (rigid: "
        f"SETTLE/RATTLE g-BAOAB, 300 K, 2 fs; K={k}, rebuilt every 20): "
        f"{sps:.1f} steps/s on the host "
        f"clock; mean T of the second half {second:.2f} K (band 300 +- "
        f"{WATER_T_BAND}), residual {residual:.3e} A (under "
        f"{WATER_RESIDUAL}), O-O RDF first peak {peak:.3f} A (band "
        f"{WATER_OO_PEAK}, {frames.shape[0]} frames), overflow "
        f"{res.overflow}; launches {launches['water_megakernel']} [{card}]")
    require(bool(torch.isfinite(res.state.force).all())
            and bool(torch.isfinite(res.state.pos).all())
            and bool(torch.isfinite(temps).all()), "non-finite water run")
    require(not res.overflow, "neighbour overflow in the water run")
    require(abs(second - 300.0) <= WATER_T_BAND,
            f"water mean T {second} K outside 300 +- {WATER_T_BAND} K")
    require(residual < WATER_RESIDUAL, f"constraint residual {residual}")
    require(WATER_OO_PEAK[0] <= peak <= WATER_OO_PEAK[1],
            f"O-O RDF peak at {peak} A")
    require(launches["water_megakernel"] == {"mega_forward": WATER_STEPS + 1,
                                             "mega_md_steps": 0},
            f"water launches {launches['water_megakernel']}")

    # -- phase 44: the eager water model, plain and use_pallas ------------
    live = refresh_mask(pos, system.box, system.cutoff, idx, mask)
    plain_f = ff.force_fn()(pos, idx, live)
    kernel_ff = GNNForceField(state, system, dataclasses.replace(
        model_cfg, use_pallas=True), device=dev)
    fused_conv_gather_message.launches = 0
    got_f = kernel_ff.force_fn()(pos, idx, live)
    torch.cuda.synchronize()
    launches["water_eager_use_pallas"] = {
        "conv_msg_gather": fused_conv_gather_message.launches}
    eager_err = float((got_f - plain_f).abs().max())
    eager_scale = float(plain_f.abs().std())
    say(f"phase 44: the eager water GAMDNet with use_pallas (conv_msg_gather "
        f"a layer, {fused_conv_gather_message.launches} launches) against "
        f"the plain model on the water start: max |dF| {eager_err:.3e}, "
        f"std(F) {eager_scale:.3e}, max/std {eager_err / eager_scale:.3e} "
        f"(tolerance {WATER_EAGER_RTOL})")
    require(fused_conv_gather_message.launches == model_cfg.conv_layers,
            "the eager water model did not launch conv_msg_gather a layer")
    require(eager_err <= WATER_EAGER_RTOL * eager_scale,
            "the eager water model's kernel path disagrees")

    # -- phase 45: run_md --megastep --no-rigid ---------------------------
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "start.npy")
        np.save(init, pos.cpu().numpy())
        argv = ["--system", "tip3p", "--ckpt", WATER_CKPT, "--megastep",
                "--no-rigid", "--init_pos", init, "--steps",
                str(WATER_MEGASTEP_STEPS), "--log",
                os.path.join(tmp, "log.txt")]
        mega_forward.launches = mega_md_steps.launches = 0
        run = run_md.rollout(run_md.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        launches["water_megastep"] = {
            "mega_forward": mega_forward.launches,
            "mega_md_steps": mega_md_steps.launches}
    res = run["result"]
    windows = WATER_MEGASTEP_STEPS // 20
    say(f"phase 45: run_md --system tip3p --megastep --no-rigid --steps "
        f"{WATER_MEGASTEP_STEPS}: {WATER_MEGASTEP_STEPS / run['seconds']:.1f}"
        f" steps/s on the host clock, mean T "
        f"{float(res.thermo.temperature.mean()):.2f} K (no band: the model "
        f"was trained on rigid water), launches {launches['water_megastep']}"
        f" [{card}]")
    require(bool(torch.isfinite(res.state.pos).all())
            and bool(torch.isfinite(res.state.vel).all())
            and bool(torch.isfinite(res.state.force).all()),
            "non-finite megastep water state")
    require(launches["water_megastep"] == {"mega_forward": 1,
                                           "mega_md_steps": windows},
            f"megastep water launches {launches['water_megastep']}")
    ctx = {"ff": ff, "pos": pos, "idx": idx, "mask": mask, "bond": bond}
    return ({"mega_forward": forward_entry, "mega_md_steps": window_entry},
            launches, ctx)


ABLATE_BENCH_ARGV = ["--steps", "400", "--reps", "1"]   # phase 47's pass
# ln's window (phase 47): LJ-64, K=16, two layers, 4 steps, where its
# plain windows with fp32 and bf16 x 3 products agree within 1.3e-7.
LN_WINDOW = dict(n=64, k=16, layers=2, steps=4, box=12.0)
ACT_PAIRS = (("silu", "gelu"), ("gelu", "gelu"), ("silu", "silu"),
             ("gelu", "silu"))           # phase 48's (conv, MLP) pairs
WINDOW_PAIR = ("gelu", "silu")           # phase 48's window


def banded_water_phase(dev, card, ctx):
    """Phase 46 (module docstring) on phase 41's start (ctx: water_phases'
    force field, start frame and list). Returns (row 5's fields, its
    launches and row 6's by path)."""
    from gamd_tpu_torch.neighbors.topology import water_bond_mask

    ff, pos, idx, mask = ctx["ff"], ctx["pos"], ctx["idx"], ctx["mask"]
    system, cfg = ff.system, ff.model_cfg
    n, k = idx.shape
    mp = ff._kernel_params("banded")
    length_mean, length_std = ff._length_scale()
    perm, inv, idx_s = banded.sort_by_x(pos, idx)
    pos_s, idx32 = pos[perm], idx_s.to(torch.int32)
    bond_s = water_bond_mask(perm[:, None], perm[idx_s])
    _, _, live = banded.banded_geometry(pos_s, idx_s, mask[perm],
                                        system.box, system.cutoff)
    layout = edge_tiles.mask_layout(live)
    kw = dict(rbf_gap=cfg.rbf_gap, flip_dir=cfg.flip_dir,
              mlp_act=cfg.mlp_activation)

    def encode(bond=bond_s):
        return live_edge_encoder(pos_s, idx32, layout, mp, system.box,
                                 length_mean, length_std, n_rbf=cfg.n_rbf,
                                 bond=bond, **kw)

    before = live_edge_encoder.launches
    e_bond = encode()
    e_zero, e_none = encode(torch.zeros_like(bond_s)), encode(None)
    torch.cuda.synchronize()
    require(live_edge_encoder.launches == before + 3,
            "live_edge_encoder (bond) did not launch")
    ref = live_edge_encoder_reference(pos_s, idx32, layout, mp, system.box,
                                      length_mean, length_std, bond=bond_s,
                                      **kw)
    err = float((e_bond[live] - ref[live]).abs().max())
    scale = float(ref[live].abs().max())
    same_zero = torch.equal(e_zero[live], e_none[live])
    moved = float((e_bond[live] - e_none[live]).abs().max())
    n_live = int(live.sum())
    say(f"phase 46: live_edge_encoder with the sorted frame's bond channel "
        f"(BOND form) vs plain on TIP3P-774's {n_live} live slots of "
        f"{n * k} ({int(bond_s[live].sum())} bonds): max |de| {err:.3e}, "
        f"max |e| {scale:.3e} (tolerance {ENCODER_RTOL} x max); a bond of "
        f"zeros the bits of none {same_zero}; the bond moves e by "
        f"{moved:.3e}")
    require(bool(torch.isfinite(e_bond[live]).all()),
            "non-finite live rows with the bond")
    require(err <= ENCODER_RTOL * scale,
            "live_edge_encoder with the bond disagrees")
    require(same_zero, "a bond of zeros does not give the bits of none")
    require(moved > 1e-3 * scale, "the bond channel does not reach e")

    fn = ff.banded_force_fn()
    live_edge_encoder.launches = banded.banded_conv_message.launches = 0
    f_band = fn(pos, idx, mask)
    torch.cuda.synchronize()
    per_call = {"edge_encoder": live_edge_encoder.launches,
                "banded_msg": banded.banded_conv_message.launches}
    f_mega = mega_forward(pos, idx, mask, ff._node_h0(),
                          ff._kernel_params("megakernel"), system.box,
                          system.cutoff, length_mean, length_std,
                          bond=ctx["bond"], rbf_gap=cfg.rbf_gap,
                          flip_dir=cfg.flip_dir, use_ln=cfg.use_layer_norm,
                          conv_act=cfg.conv_activation,
                          mlp_act=cfg.mlp_activation)
    f_err = float((f_band - f_mega).abs().max())
    f_scale = float(f_mega.abs().std())
    say(f"phase 46: banded_force_fn with the bond (band {fn.banded_band}) "
        f"vs mega_forward with the bond on the water start: max |dF| "
        f"{f_err:.3e}, std(F) {f_scale:.3e}, max/std {f_err / f_scale:.3e} "
        f"(tolerance {TOLERANCE}); launches a call {per_call}")
    require(bool(torch.isfinite(f_band).all()),
            "non-finite banded water forces")
    require(f_err < TOLERANCE * f_scale,
            "the banded water forces disagree with mega_forward's")
    require(per_call == {"edge_encoder": 1,
                         "banded_msg": cfg.conv_layers},
            f"banded water launches a call {per_call}")

    with torch.no_grad():
        ms = time_ms(encode)
        plain_ms = time_ms(lambda: live_edge_encoder_reference(
            pos_s, idx32, layout, mp, system.box, length_mean, length_std,
            bond=bond_s, **kw))
        dev_us, dev_kernels = device_us(encode)
    # The bond adds a slot's 4 bytes and one rank-1 term (2 operations a
    # column) a live row to the LJ encoder's count.
    nbytes = live_encoder_bytes(n, n_live, cfg.n_rbf) + 4 * n_live
    tc_flops, ep_flops = encoder_tc_ops(n_live, cfg.n_rbf)
    ep_flops += 2.0 * 128 * n_live
    t_ops = (tc_flops / BF16_FLOPS + ep_flops / FP32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes \
        else (t_bytes, "bytes")
    say(f"phase 46: live_edge_encoder with the bond {ms:.4f} ms/call, "
        f"{dev_us:.2f} us of device time a call "
        f"{json.dumps({key: round(v, 2) for key, v in dev_kernels.items()})}"
        f", plain {plain_ms:.4f} ms/call; bound {bound_ms:.4f} ms "
        f"({bound_by}; {tc_flops / 1e9:.4f} GFLOP bf16 x 3 and "
        f"{ep_flops / 1e9:.4f} GFLOP fp32, {nbytes / 1e6:.2f} MB), device "
        f"time at {bound_ms * 1e3 / dev_us:.2%} of it [{card}]")

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--system", "tip3p", "--ckpt", WATER_CKPT, "--banded",
                "--friction", str(WATER_FRICTION), "--steps",
                str(WATER_STEPS), "--log", os.path.join(tmp, "log.txt")]
        live_edge_encoder.launches = banded.banded_conv_message.launches = 0
        mega_forward.launches = 0
        run = run_md.rollout(run_md.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        launches["water_banded"] = {
            "edge_encoder": live_edge_encoder.launches,
            "banded_msg": banded.banded_conv_message.launches,
            "mega_forward": mega_forward.launches}
    res, rcst = run["result"], run["constraint"]
    temps = res.thermo.temperature
    second = float(temps[WATER_STEPS // 2:].mean())
    residual = float(rcst.residual(res.state.pos))
    frames = res.positions[res.positions.shape[0] // 2:]
    is_o = np.arange(n) % 3 == 0
    r_c, g = radial_distribution(frames, system.box, r_max=system.box / 2,
                                 n_bins=200, species_a=is_o, species_b=is_o)
    peak = float(r_c[int(np.argmax(g))])
    sps = WATER_STEPS / run["seconds"]
    calls = WATER_STEPS + 1
    say(f"phase 46: run_md --system tip3p --ckpt {WATER_CKPT} --banded "
        f"--friction {WATER_FRICTION:g} --steps {WATER_STEPS} (rigid, dense "
        f"list K={k}, band {run['sim'].force_fn.banded_band}): {sps:.1f} "
        f"steps/s on the host clock; mean T of the second half "
        f"{second:.2f} K (band 300 +- {WATER_T_BAND}), residual "
        f"{residual:.3e} A, O-O RDF first peak {peak:.3f} A, overflow "
        f"{res.overflow}; launches {launches['water_banded']} for {calls} "
        f"force calls ({launches['water_banded']['edge_encoder'] / calls:g}"
        f" live_edge_encoder and "
        f"{launches['water_banded']['banded_msg'] / calls:g} banded_msg a "
        f"call) [{card}]")
    require(bool(torch.isfinite(res.state.force).all())
            and bool(torch.isfinite(res.state.pos).all())
            and bool(torch.isfinite(temps).all()),
            "non-finite banded water run")
    require(not res.overflow, "neighbour overflow in the banded water run")
    require(abs(second - 300.0) <= WATER_T_BAND,
            f"banded water mean T {second} K outside 300 +- {WATER_T_BAND}")
    require(residual < WATER_RESIDUAL, f"constraint residual {residual}")
    require(WATER_OO_PEAK[0] <= peak <= WATER_OO_PEAK[1],
            f"banded water O-O RDF peak at {peak} A")
    require(launches["water_banded"] == {
        "edge_encoder": calls, "banded_msg": cfg.conv_layers * calls,
        "mega_forward": 0}, f"banded water launches "
        f"{launches['water_banded']}")
    del launches["water_banded"]["mega_forward"]
    entry = {"water_live_slots": {
        "n": n, "k": k, "live": n_live, "bond": True, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "device_us": dev_us,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "banded_force_rel_err": f_err / f_scale, "steps_per_s": sps}}
    return entry, launches


def ln_window(dev):
    """ln's ablated window on LN_WINDOW's case: (kernel window, plain
    window, the plain windows' fp32 to bf16 x 3 spread) at c2col = 0."""
    n, k, box = LN_WINDOW["n"], LN_WINDOW["k"], LN_WINDOW["box"]
    cfg = ModelConfig(conv_layers=LN_WINDOW["layers"])
    system = get_preset("lj", n_atoms=n, box=box, cutoff=4.2,
                        nbr_capacity=k, skin=0.8)
    state = init_params(cfg, system, seed=0)
    mp = pack_params(state.params, cfg, batch_stats=state.batch_stats,
                     force_std=2.0, force_mean=0.1, unit=0.1, device=dev)
    pos = torch.as_tensor(np.random.default_rng(1).uniform(
        0, box, (n, 3)).astype(np.float32), device=dev)
    idx, mask, _ = dense_neighbor_list(pos, box, 5.0, k)
    h0 = torch.as_tensor(state.params["node_emb"], device=dev).expand(
        n, cfg.encoding_size).contiguous()
    args = (pos, idx, mask, h0, mp, box, 4.2, 4.0, 1.2)
    vel = 0.1 * torch.randn((n, 3), device=dev,
                            generator=torch.Generator(dev).manual_seed(3))
    sim = Simulation(lambda p, i, m: p, system,
                     MDConfig(integrator="langevin", temperature=100.0),
                     device=dev)
    c1, hdt, c2col = sim._baoab_constants()
    wargs = (pos, vel, reference_forward(*args).contiguous(), idx, mask,
             h0, mp, box, 4.2, 4.0, 1.2, sim.masses)
    kw = dict(n_steps=LN_WINDOW["steps"], c1=c1, hdt=hdt,
              c2col=torch.zeros_like(c2col),
              seed=torch.tensor([7], dtype=torch.int32, device=dev))
    out = mega_md_steps(*wargs, **kw, ablate=("ln",))
    ref = md_steps_reference(*wargs, **kw, ablate=("ln",))
    return out, ref, bf16_spread(wargs, kw, "ln", ref)


def bf16_spread(wargs, kw, name, ref):
    """max |x|, |v| gap of the plain ablated window with the kernel's bf16
    x 3 edge products from the fp32 one (`ref`)."""
    plain_mm = mega_module._edge_mm
    mega_module._edge_mm = mega_module.split_bf16_matmul
    try:
        emu = md_steps_reference(*wargs, **kw, ablate=(name,))
    finally:
        mega_module._edge_mm = plain_mm
    return max(float((emu[i] - ref[i]).abs().max()) for i in (0, 1))


def ablate_phase(dev, card, window_args, wkw):
    """Phase 47 (module docstring) on phase 4's window inputs. Returns
    ({stage: its check's fields}, mega_md_steps's launches by path)."""
    from gamd_tpu_torch.tools import bench_ablate

    wkw = dict(wkw, c2col=torch.zeros_like(wkw["c2col"]))
    full = mega_md_steps(*window_args, **wkw)
    checks = {}
    gap = lambda a, b, i: float((a[i] - b[i]).abs().max())
    for name in mega_module.ABLATE_STAGES:
        before = mega_md_steps.launches
        out = mega_md_steps(*window_args, **wkw, ablate=(name,))
        torch.cuda.synchronize()
        require(mega_md_steps.launches == before + 1,
                f"mega_md_steps ({name}) did not launch")
        ref = md_steps_reference(*window_args, **wkw, ablate=(name,))
        dx, dv = gap(out, ref, 0), gap(out, ref, 1)
        unlike = not torch.equal(out[2], full[2])
        # One step: the forces at the same first positions, whatever the
        # form's dynamics do after them.
        one = dict(wkw, n_steps=1)
        f_one = mega_md_steps(*window_args, **one, ablate=(name,))[2]
        f_ref = md_steps_reference(*window_args, **one, ablate=(name,))[2]
        f_err = float((f_one - f_ref).abs().max())
        f_scale = float(f_ref.abs().std())
        check = {"dx": dx, "dv": dv, "one_step_rel_err": f_err / f_scale}
        if name == "ln":
            # Without the LayerNorms the seeded model's forces blow the
            # window up from its first step, so this window is reported
            # and ln's is held on LN_WINDOW's case.
            spread = bf16_spread(window_args, wkw, name, ref)
            ln_out, ln_ref, ln_spread = ln_window(dev)
            ln_dx, ln_dv = gap(ln_out, ln_ref, 0), gap(ln_out, ln_ref, 1)
            held = (f"reported: its plain windows with fp32 and bf16 x 3 "
                    f"products are {spread:.3e} apart; on LJ-{LN_WINDOW['n']}"
                    f" ({LN_WINDOW['layers']} layers, {LN_WINDOW['steps']} "
                    f"steps) max |dx| {ln_dx:.3e} A, max |dv| {ln_dv:.3e} "
                    f"A/t0, its plain windows {ln_spread:.3e} apart, held "
                    f"to {WINDOW_ATOL}")
            require(all(bool(torch.isfinite(t).all()) for t in ln_out),
                    "non-finite ablated window (ln, LJ-64)")
            require(ln_dx <= WINDOW_ATOL and ln_dv <= WINDOW_ATOL,
                    f"the ablated window (ln, LJ-64) disagrees: {ln_dx}, "
                    f"{ln_dv}")
            check.update(plain_spread=spread, small_dx=ln_dx,
                         small_dv=ln_dv, small_plain_spread=ln_spread)
        else:
            held = f"held to {WINDOW_ATOL}"
            require(dx <= WINDOW_ATOL and dv <= WINDOW_ATOL,
                    f"the ablated window ({name}) disagrees: {dx}, {dv}")
        say(f"phase 47: mega_md_steps ablate=({name!r},) vs its plain window"
            f" ({wkw['n_steps']} steps, c2col = 0): max |dx| {dx:.3e} A, "
            f"max |dv| {dv:.3e} A/t0, max |v| "
            f"{float(ref[1].abs().max()):.3e}, {held}; after one step max "
            f"|dF|/std(F) {f_err / f_scale:.3e} (tolerance {TOLERANCE}); "
            f"forces unlike the full window's {unlike}")
        require(all(bool(torch.isfinite(t).all()) for t in out),
                f"non-finite ablated window ({name})")
        require(f_err <= TOLERANCE * f_scale,
                f"the ablated forces ({name}) disagree after one step")
        require(unlike or name == "noise",
                f"ablate=({name!r},) left the forces unchanged")
        checks[name] = check
    noisy = dict(wkw, c2col=window_args[-1].new_full(
        wkw["c2col"].shape, 0.1))
    same_noise = torch.equal(
        mega_md_steps(*window_args, **noisy, ablate=("noise",))[0], full[0])
    say(f"phase 47: noise ablated at a real amplitude = the full window at "
        f"c2col 0, bit for bit: {same_noise}")
    require(same_noise, "the noise form still draws")

    mega_md_steps.launches = 0
    results = bench_ablate.main(ABLATE_BENCH_ARGV)
    launches = {"bench_ablate": {"mega_md_steps": mega_md_steps.launches}}
    require(set(results) == {name for name, _, _ in bench_ablate.STAGES},
            f"bench_ablate ran {sorted(results)}")
    require(all(math.isfinite(v) and v > 0 for v in results.values()),
            "bench_ablate's times")
    say(f"phase 47: tools.bench_ablate {' '.join(ABLATE_BENCH_ARGV)}: "
        f"{len(results)} stages, {mega_md_steps.launches} mega_md_steps "
        f"launches [{card}]")
    checks["bench_ablate_us"] = results
    return checks, launches


def activation_phase(dev, card, args, kw, window_args, wkw):
    """Phase 48 (module docstring) on phase 2's frame and phase 4's window
    inputs. Returns ({"forward": {pair: fields}, "window": fields},
    launches by path)."""
    default = mega_forward(*args, **kw)
    mega_forward.launches = mega_md_steps.launches = 0
    fields = {}
    for conv_act, mlp_act in ACT_PAIRS:
        akw = dict(kw, conv_act=conv_act, mlp_act=mlp_act)
        got = mega_forward(*args, **akw)
        ref = reference_forward(*args, **akw)
        err = float((got - ref).abs().max())
        scale = float(ref.abs().std())
        dev_us, _ = device_us(lambda: mega_forward(*args, **akw))
        say(f"phase 48: mega_forward conv {conv_act} / MLP {mlp_act} vs "
            f"plain: max |dF| {err:.3e}, std(F) {scale:.3e}, max/std "
            f"{err / scale:.3e} (tolerance {TOLERANCE}); {dev_us:.2f} us of "
            f"device time a call [{card}]")
        require(bool(torch.isfinite(got).all()),
                f"non-finite forces ({conv_act}/{mlp_act})")
        require(err < TOLERANCE * scale,
                f"mega_forward ({conv_act}/{mlp_act}) disagrees")
        if (conv_act, mlp_act) == ("silu", "gelu"):
            require(torch.equal(got, default),
                    "silu/gelu is not the default call's bits")
        else:
            require(float((got - default).abs().max()) > 1e-3 * scale,
                    f"{conv_act}/{mlp_act} gives the default forces")
        fields[f"{conv_act}/{mlp_act}"] = {"rel_err": err / scale,
                                           "device_us": dev_us}
    conv_act, mlp_act = WINDOW_PAIR
    akw = dict(wkw, c2col=torch.zeros_like(wkw["c2col"]), conv_act=conv_act,
               mlp_act=mlp_act)
    out = mega_md_steps(*window_args, **akw)
    ref = md_steps_reference(*window_args, **akw)
    dx = float((out[0] - ref[0]).abs().max())
    dv = float((out[1] - ref[1]).abs().max())
    say(f"phase 48: mega_md_steps conv {conv_act} / MLP {mlp_act}, one "
        f"{akw['n_steps']}-step window at c2col = 0 vs plain: max |dx| "
        f"{dx:.3e} A, max |dv| {dv:.3e} A/t0 (tolerance {WINDOW_ATOL})")
    require(dx <= WINDOW_ATOL and dv <= WINDOW_ATOL,
            f"the {conv_act}/{mlp_act} window disagrees")
    launches = {"activation_pairs": {
        "mega_forward": mega_forward.launches,
        "mega_md_steps": mega_md_steps.launches}}
    return {"forward": fields, "window": {"pair": f"{conv_act}/{mlp_act}",
                                          "dx": dx, "dv": dv}}, launches


def generation_phase(dev, card, root):
    """Phase 49 (module docstring): the set goes to root/lj_data, which
    phase 50 trains on. Returns the launches of its path."""
    from gamd_tpu_torch.physics.generate import (generate_lj_dataset,
                                                 lj_protocol, lj_start)
    from gamd_tpu_torch.train import native_io
    from gamd_tpu_torch.train.data import TrajectoryDataset, pack_numpy

    out = os.path.join(root, "lj_data")
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate_lj_dataset(out, seeds=1, frames_per_seed=GEN_FRAMES,
                        record_interval=GEN_INTERVAL,
                        minimize_steps=GEN_FIRE, log_every_frames=0,
                        device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = count_launches()
    names = sorted(os.listdir(out))
    require(names == sorted(f"data_0_{t}.npz" for t in range(GEN_FRAMES)),
            f"generate_lj_dataset wrote {names}")
    proto = lj_protocol(device=dev)
    start = torch.as_tensor(lj_start(0, proto.lattice, proto.box),
                            device=dev)
    t0 = time.perf_counter()
    fire_minimize(proto.record_force, start, n_steps=GEN_FIRE)
    torch.cuda.synchronize()
    fire_s = time.perf_counter() - t0
    n = proto.sim.system.n_atoms
    masses = proto.sim.masses
    temps, force_err, mean_f = [], 0.0, []
    for name in names:
        with np.load(os.path.join(out, name)) as z:
            require(sorted(z) == ["forces", "pos", "vel"]
                    and all(z[k].dtype == np.float32
                            and z[k].shape == (n, 3)
                            and np.isfinite(z[k]).all() for k in z),
                    f"{name}: keys, dtypes, shapes or values wrong")
            pos = torch.as_tensor(z["pos"], device=dev)
            want = proto.record_force(pos) / units.KJ_MOL_NM_TO_INTERNAL
            got = torch.as_tensor(z["forces"], device=dev)
            force_err = max(force_err, float((got - want).abs().max())
                            / float(want.abs().max()))
            mean_f.append(float(got.norm(dim=-1).mean()))
            vel = torch.as_tensor(z["vel"], device=dev) \
                * units.M_PER_S_TO_INTERNAL
            ke2 = float((masses[:, None] * vel * vel).sum())
            temps.append(ke2 / (3 * n * units.KB))
    mean_t = sum(temps) / len(temps)
    cache = os.path.join(out, "pack.npz")
    train = TrajectoryDataset(out, sample_num=GEN_FRAMES, seed_num=1,
                              pack_cache=cache)
    test = TrajectoryDataset(out, sample_num=GEN_FRAMES, seed_num=1,
                             mode="test", pack_cache=cache)
    plain = pack_numpy(TrajectoryDataset(out, sample_num=GEN_FRAMES,
                                         seed_num=1), GEN_FRAMES)
    native_ok = native_io.available()
    native = (native_io.pack_trajectory(out, 1, GEN_FRAMES, n)
              if native_ok else None)
    with np.load(cache) as z:
        cached = (z["pos"], z["forces"])
    same = native_ok and all(
        np.array_equal(a, b) and np.array_equal(a, c)
        for a, b, c in zip(native, plain, cached))
    os.remove(cache)
    say(f"phase 49: generate_lj_dataset on the card, 1 seed, {GEN_FIRE} "
        f"FIRE steps, {GEN_FRAMES} frames every {GEN_INTERVAL} NHC steps "
        f"(chain 10/5/5, 100 K): {seconds:.2f} s from the lattice to the "
        f"last file, {GEN_FRAMES / seconds:.2f} frames/s; FIRE alone, timed "
        f"again on the same start, {fire_s:.2f} s "
        f"({fire_s / GEN_FIRE * 1e3:.3f} ms a step), so the NHC frames and "
        f"files {seconds - fire_s:.2f} s "
        f"({GEN_FRAMES * GEN_INTERVAL / (seconds - fire_s):.1f} MD steps/s "
        f"with the recording) [{card}]")
    say(f"phase 49: {len(names)} files (pos, vel, forces float32 [{n}, 3]); "
        f"recorded forces against lj_forces_dense of each frame's pos on the "
        f"card: max |d| / max |F| {force_err:.3e} (tolerance "
        f"{GEN_FORCE_RTOL}); mean |F| {sum(mean_f) / len(mean_f):.2f} "
        f"kJ/mol/nm; T of the frames {min(temps):.1f}-{max(temps):.1f} K, "
        f"mean {mean_t:.2f} K (band 100 +- {GEN_T_BAND} K); launches "
        f"{counts}; native packer built {native_ok}, its pack, the numpy "
        f"pack and the cache bit for bit: {same}; split {len(train)} train "
        f"/ {len(test)} test")
    require(force_err <= GEN_FORCE_RTOL, "recorded forces disagree")
    require(abs(mean_t - 100.0) <= GEN_T_BAND,
            f"mean T of the frames {mean_t:.2f} K")
    require(counts == {**{k: 0 for k in counts},
                       "nhc_half_step": 2 * GEN_FRAMES * GEN_INTERVAL},
            f"launches {counts}: want two nhc_half_step a step and nothing "
            "else")
    require(same, "the native pack differs from the numpy pack")
    require((len(train), len(test)) == (GEN_FRAMES * 9 // 10,
                                        GEN_FRAMES - GEN_FRAMES * 9 // 10),
            "the 90/10 split")
    return {"generate_lj": counts}


# -- the verify loop and water training (phases 50-51) ------------------------

VERIFY_EPOCHS, VERIFY_BATCH = 3, 2      # phase 50's run: 18 frames, 9 steps
VERIFY_MD_STEPS = 200                   # phase 50's run_md --megakernel
WATER_TRAIN_FRAMES = 6                  # phase 51: the start and 5 copies
WATER_TRAIN_SIGMA = 0.01                # their displacement (A)
WATER_TRAIN_EPOCHS = 2
WATER_TRAIN_MD_STEPS = 100
RELOAD_RTOL = 1e-4        # reloaded force field vs the trained module,
                          # / max |F|: row 3's bar (1e-4 max |agg|)


def run_path(label, runs, fn):
    """fn() with every kernel's count set to 0 just before and read just
    after into runs[label]; returns fn's result."""
    zero_launches()
    out = fn()
    torch.cuda.synchronize()
    runs[label] = count_launches()
    return out


def epoch_losses(history):
    return [r["loss"] for r in history]


def verify_loop_phase(dev, card, root):
    """Phase 50 (module docstring). Returns {path: {kernel: launches}}."""
    from gamd_tpu_torch.models.normalizer import denormalize
    from gamd_tpu_torch.tools import evaluate, train_gamd
    from gamd_tpu_torch.train.data import TrajectoryDataset

    ck, ck2 = os.path.join(root, "ck"), os.path.join(root, "ck_resume")
    flags = ["--system", "lj", "--data_dir", root, "--sample_num",
             str(GEN_FRAMES), "--seed_num", "1", "--max_epoch",
             str(VERIFY_EPOCHS), "--batch_size", str(VERIFY_BATCH),
             "--use_pallas", "--use_layer_norm", "--relabel",
             "--checkpoint_every", "1"]
    runs, logs, history = {}, [], []
    t0 = time.perf_counter()
    state = run_path("verify_train", runs, lambda: train_gamd.main(
        flags + ["--num_device", "1", "--cp_dir", ck], log_fn=logs.append,
        history=history))
    train_s = time.perf_counter() - t0
    names = sorted(os.listdir(ck))
    want_names = sorted(
        ["best.msgpack", "best_val.txt", "scaler_best.npz"]
        + [f"checkpoint_{e}.msgpack" for e in range(VERIFY_EPOCHS)]
        + [f"scaler_{e}.npz" for e in range(VERIFY_EPOCHS)])
    losses = epoch_losses(history)
    n_train = GEN_FRAMES * 9 // 10
    steps = n_train // VERIFY_BATCH
    step_ms = [r["seconds"] * 1e3 / steps for r in history]
    layers = state.model.cfg.conv_layers
    n_val_batches = (GEN_FRAMES - n_train) // VERIFY_BATCH
    want_train = {"conv_msg_gather": layers * VERIFY_EPOCHS
                  * (steps + n_val_batches),
                  "conv_msg_gather_bwd": layers * VERIFY_EPOCHS * steps}
    say(f"phase 50: train_gamd --system lj --use_pallas --use_layer_norm "
        f"--relabel on phase 49's {GEN_FRAMES} frames ({n_train} train, "
        f"{GEN_FRAMES - n_train} test; GAMD-small 128/128/128, 4 layers, "
        f"K=96), {VERIFY_EPOCHS} epochs of {steps} steps at batch "
        f"{VERIFY_BATCH}: {train_s:.2f} s in all (datasets, packing, "
        f"evaluation, checkpoints); the epoch loop "
        f"{', '.join(f'{x:.3f}' for x in step_ms)} ms a step by epoch "
        f"(epoch 0 with the first calls' set-up); epoch losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}; launches "
        f"{runs['verify_train']} [{card}]")
    say("phase 50: " + " | ".join(logs))
    require(len(losses) == VERIFY_EPOCHS and all(
        np.isfinite(v) for r in history for k, v in r.items()),
        "non-finite epoch metrics")
    require(names == want_names, f"checkpoint files {names}")
    require(all(runs["verify_train"][k] == v for k, v in want_train.items()),
            f"launches {runs['verify_train']}: want {want_train}")

    # The force field reloaded from the last checkpoint against the
    # trained module's eval forces.
    path = os.path.join(ck, f"checkpoint_{VERIFY_EPOCHS - 1}.msgpack")
    ff_state, cfg, system = load_self_describing(path, use_pallas=True)
    ff = GNNForceField(ff_state, system, cfg, device=dev)
    test = TrajectoryDataset(os.path.join(root, "lj_data"), mode="test",
                             sample_num=GEN_FRAMES, seed_num=1)
    pos = space.wrap(torch.as_tensor(test[0]["pos"], device=dev),
                     system.box)
    idx, mask, _ = dense_neighbor_list(pos, system.box, system.cutoff,
                                       system.nbr_capacity)
    got = ff.force_fn()(pos, idx, mask)
    with torch.no_grad():
        pred = state.model(pos[None], idx[None], mask[None], system.box,
                           state.length_stat.safe_mean,
                           state.length_stat.std)[0]
    want = denormalize(pred, state.force_stat) \
        * system.force_unit_to_internal
    reload_err = float((got - want).abs().max()) / float(want.abs().max())
    say(f"phase 50: {os.path.basename(path)} reloaded (load_self_describing,"
        f" GNNForceField use_pallas) against the trained module's eval "
        f"forces on a test frame: max |dF| / max |F| {reload_err:.3e} "
        f"(tolerance {RELOAD_RTOL})")
    require(reload_err <= RELOAD_RTOL, "the reloaded force field disagrees")

    # Resume from checkpoint_1: epoch 2 bit for bit.
    resumed = []
    run_path("verify_resume", runs, lambda: train_gamd.main(
        flags + ["--num_device", "1", "--cp_dir", ck2, "--state_ckpt_dir",
                 os.path.join(ck, "checkpoint_1.msgpack"), "--start_epoch",
                 str(VERIFY_EPOCHS - 1)],
        log_fn=lambda _: None, history=resumed))
    last = f"checkpoint_{VERIFY_EPOCHS - 1}.msgpack"
    with open(os.path.join(ck, last), "rb") as f:
        straight_bytes = f.read()
    with open(os.path.join(ck2, last), "rb") as f:
        same_file = f.read() == straight_bytes
    strip = lambda r: {k: v for k, v in r.items() if k != "seconds"}
    same_metrics = len(resumed) == 1 and strip(resumed[0]) == strip(
        history[-1])
    say(f"phase 50: resumed from checkpoint_1 at --start_epoch "
        f"{VERIFY_EPOCHS - 1}: epoch loss {resumed[0]['loss']!r} against "
        f"the straight run's {history[-1]['loss']!r}, every epoch metric "
        f"bit for bit {same_metrics}, {last} (weights, Adam moments and "
        f"counts, scalers, step) byte for byte {same_file}; launches "
        f"{runs['verify_resume']}")
    require(same_metrics and same_file, "the resumed run differs")

    # evaluate --use_pallas, then run_md --megakernel on the checkpoint.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        metrics = run_path("verify_evaluate", runs, lambda: evaluate.main([
            "--system", "lj", "--ckpt", path, "--data_dir",
            os.path.join(root, "lj_data"), "--sample_num", str(GEN_FRAMES),
            "--seed_num", "1", "--use_pallas", "--json_out",
            os.path.join(tmp, "m.json")]))
        eval_s = time.perf_counter() - t0
        argv = ["--system", "lj", "--ckpt", path, "--megakernel", "--steps",
                str(VERIFY_MD_STEPS), "--log", os.path.join(tmp, "log.txt")]
        run = run_path("verify_run_md", runs, lambda: run_md.rollout(
            run_md.build_parser().parse_args(argv)))
    scalars = {k: v for k, v in metrics.items() if not isinstance(v, list)}
    temps = run["result"].thermo.temperature
    finite = all(np.isfinite(np.asarray(v)).all() for v in metrics.values())
    say(f"phase 50: evaluate --use_pallas in {eval_s:.2f} s: "
        f"{json.dumps(scalars)}; launches {runs['verify_evaluate']}")
    say(f"phase 50: run_md --megakernel --steps {VERIFY_MD_STEPS} on it: "
        f"{VERIFY_MD_STEPS / run['seconds']:.1f} steps/s, mean T "
        f"{float(temps.mean()):.2f} K (a 3-epoch model: no band); launches "
        f"{runs['verify_run_md']} [{card}]")
    require(finite and metrics["frames"] == GEN_FRAMES - n_train,
            "evaluate's metrics")
    require(runs["verify_evaluate"]["conv_msg_gather"] == layers,
            f"evaluate launches {runs['verify_evaluate']}")
    require(bool(torch.isfinite(temps).all())
            and bool(torch.isfinite(run["result"].state.pos).all()),
            "non-finite run_md on the trained checkpoint")
    require(runs["verify_run_md"]["mega_forward"] == VERIFY_MD_STEPS + 1,
            f"run_md launches {runs['verify_run_md']}")
    return runs


def cli_step_agreement(dev, flags):
    """One training step of train_gamd's configuration for `flags` (water
    or DFT) on the first frame of its training set (with --longrange its
    labels less the k-space term, with --relabel the CLI's oracle; a DFT
    frame with its own box), on the kernel pair (--use_pallas, one forward
    and one backward launch a conv layer, required) against the plain
    path, both from create_train_state at the train seed: step_agreement's
    line."""
    from gamd_tpu_torch.tools import train_gamd
    from gamd_tpu_torch.train.loop import stack_boxes, stack_dataset

    pairs = {}
    for use_pallas in (True, False):
        args = train_gamd.build_parser().parse_args(
            flags + (["--use_pallas"] if use_pallas else []))
        system, model_cfg, train_cfg = train_gamd.configs(args)
        train_data, _ = train_gamd.datasets(args)
        if args.longrange:
            train_gamd.subtract_longrange(system, (train_data,), dev)
        relabel_fn = (train_gamd.make_relabel_fn(system, args.longrange)
                      if args.relabel else None)
        pos, forces, feat = stack_dataset(train_data, dev)
        batch = {"pos": pos[:1], "forces": forces[:1], "feat": feat[:1]}
        boxes = stack_boxes(train_data, dev)
        if boxes is not None:
            batch["box_size"] = boxes[:1]
        state = create_train_state(model_cfg, system, train_cfg,
                                   len(train_data), device=dev)
        step = make_train_step(state.model, system, train_cfg,
                               relabel_fn=relabel_fn)
        zero_launches()
        pairs[use_pallas] = step(state, batch)
        torch.cuda.synchronize()
        counts = count_launches()
        layers = model_cfg.conv_layers if use_pallas else 0
        require(counts["conv_msg_gather"] == counts["conv_msg_gather_bwd"]
                == layers, f"launches {counts}: want {layers} of each of "
                "the conv pair")
    return step_agreement(pairs[True], pairs[False], train_cfg.lr)


def water_training_phase(dev, card, ctx):
    """Phase 51 (module docstring). Returns {path: {kernel: launches}}."""
    from gamd_tpu_torch.md.constraints import RigidWater
    from gamd_tpu_torch.physics import water as w
    from gamd_tpu_torch.tools import train_gamd

    system = get_preset("tip3p")
    start = ctx["pos"]
    params = w.TIP3PParams(cutoff=min(9.0, system.box / 2 - 0.01))
    gen = torch.Generator(device=dev).manual_seed(51)
    root = tempfile.mkdtemp(prefix="gamd_water_train_")
    runs, logs, history = {}, [], []
    try:
        out = os.path.join(root, "water_data")
        os.makedirs(out)
        for t in range(WATER_TRAIN_FRAMES):
            noise = torch.randn(start.shape, generator=gen, device=dev)
            pos = space.wrap(start + (WATER_TRAIN_SIGMA * noise if t else 0),
                             system.box)
            forces = w.tip3p_forces(pos, system.box, params) \
                / units.KJ_MOL_NM_TO_INTERNAL
            np.savez(os.path.join(out, f"data_0_{t}.npz"),
                     pos=pos.cpu().numpy(),
                     vel=np.zeros((system.n_atoms, 3), np.float32),
                     forces=forces.detach().cpu().numpy())
        flags = ["--system", "tip3p", "--data_dir", root, "--sample_num",
                 str(WATER_TRAIN_FRAMES), "--seed_num", "1", "--max_epoch",
                 str(WATER_TRAIN_EPOCHS), "--use_layer_norm", "--drop_edge"]
        say("phase 51: one training step of the CLI's TIP3P-774 "
            "configuration on its first training frame (4.2 A, K=96, 4 x "
            "128, the bond channel, edge dropout, rotation and jitter), "
            "kernel pair vs plain path, same seed: "
            + cli_step_agreement(dev, flags) + f" [{card}]")
        ck = os.path.join(root, "ck")
        t0 = time.perf_counter()
        run_path("water_train", runs, lambda: train_gamd.main(
            flags + ["--use_pallas", "--num_device", "1", "--cp_dir", ck],
            log_fn=logs.append, history=history))
        train_s = time.perf_counter() - t0
        init = os.path.join(root, "start.npy")
        np.save(init, start.cpu().numpy())
        path = os.path.join(ck, f"checkpoint_{WATER_TRAIN_EPOCHS - 1}"
                            ".msgpack")
        argv = ["--system", "tip3p", "--ckpt", path, "--megakernel",
                "--friction", str(WATER_FRICTION), "--init_pos", init,
                "--steps", str(WATER_TRAIN_MD_STEPS), "--log",
                os.path.join(root, "log.txt")]
        run = run_path("water_train_run_md", runs, lambda: run_md.rollout(
            run_md.build_parser().parse_args(argv)))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_train = WATER_TRAIN_FRAMES * 9 // 10
    steps = n_train           # batch 1
    losses = epoch_losses(history)
    step_ms = [r["seconds"] * 1e3 / steps for r in history]
    res = run["result"]
    temps = res.thermo.temperature
    residual = float(RigidWater(system.n_atoms // 3, system.box).residual(
        res.state.pos))
    layers = 4
    want_train = {"conv_msg_gather": layers * WATER_TRAIN_EPOCHS
                  * (steps + WATER_TRAIN_FRAMES - n_train),
                  "conv_msg_gather_bwd": layers * WATER_TRAIN_EPOCHS * steps}
    say(f"phase 51: train_gamd --system tip3p --use_pallas --use_layer_norm "
        f"--drop_edge on {WATER_TRAIN_FRAMES} TIP3P-774 frames (water_box's "
        f"relaxed start and copies displaced by {WATER_TRAIN_SIGMA} A, "
        f"labelled by the flexible TIP3P forces; 4.2 A, K=96, 4 x 128, the "
        f"bond channel), {WATER_TRAIN_EPOCHS} epochs of {steps} steps: "
        f"{train_s:.2f} s in all; the epoch loop "
        f"{', '.join(f'{x:.3f}' for x in step_ms)} ms a step by epoch; "
        f"epoch losses {', '.join(f'{x:.6f}' for x in losses)}; launches "
        f"{runs['water_train']} [{card}]")
    say("phase 51: " + " | ".join(logs))
    say(f"phase 51: run_md --system tip3p --megakernel --friction "
        f"{WATER_FRICTION:g} --steps {WATER_TRAIN_MD_STEPS} on the result "
        f"(rigid, from phase 41's start): "
        f"{WATER_TRAIN_MD_STEPS / run['seconds']:.1f} steps/s, mean T "
        f"{float(temps.mean()):.2f} K (a 2-epoch model: no band), residual "
        f"{residual:.3e} A (under {WATER_RESIDUAL}); launches "
        f"{runs['water_train_run_md']} [{card}]")
    require(len(losses) == WATER_TRAIN_EPOCHS
            and all(np.isfinite(x) for x in losses), "non-finite losses")
    require(all(runs["water_train"][k] == v for k, v in want_train.items()),
            f"launches {runs['water_train']}: want {want_train}")
    require(bool(torch.isfinite(temps).all())
            and bool(torch.isfinite(res.state.pos).all()),
            "non-finite water run on the trained model")
    require(residual < WATER_RESIDUAL, f"constraint residual {residual}")
    require(runs["water_train_run_md"]["mega_forward"]
            == WATER_TRAIN_MD_STEPS + 1,
            f"run_md launches {runs['water_train_run_md']}")
    return runs


# -- reference-protocol water (phases 52-55) ----------------------------------

EWALD_E_RTOL = 1e-5       # |E_fp32 card - E_fp64 CPU| / |E_fp64|
EWALD_F_RTOL = 1e-4       # max |F_fp32 card - F_fp64 CPU| / max |F_fp64|
WGEN_SEEDS, WGEN_FRAMES, WGEN_INTERVAL = 2, 6, 20   # phase 53's set
WGEN_FIRE = 300           # FIRE steps a start (the generator's 3,000 cut)
WGEN_STEP_TIMED = 100     # replica steps timed after the generation
WTRAIN_EPOCHS = 2         # phase 54
RJ_CKPT = os.path.join("results", "ckpts", "tip3p_rj_best.msgpack")
RJ_MD_STEPS = 200         # phase 55's run_md
RJ_ANALYZE_STEPS = 400    # phase 55's analyze_rollout (NHC, the default)
TERM_RTOL = 1e-6          # the long-range term of row 1's path against
                          # make_longrange_force_fn, / max |F|


def ewald_phase(dev, card):
    """Phase 52 (module docstring)."""
    from gamd_tpu_torch.physics import ewald
    from gamd_tpu_torch.physics import water as w
    from gamd_tpu_torch.train.forcefield import make_longrange_force_fn

    for model, n_mol in (("tip3p", 258), ("tip4p", 251)):
        tip4p = model == "tip4p"
        system = get_preset(model)
        box = system.box
        params = w.TIP4PEwParams() if tip4p else w.TIP3PParams()
        monomer = w.TIP3PParams(r_oh=params.r_oh, theta0=params.theta0)
        start = w.water_box(n_mol, box, monomer, seed=52)
        rng = np.random.RandomState(52)
        start = np.mod(start + rng.normal(0.0, 0.05, start.shape),
                       box).astype(np.float32)
        ew = ewald.make_ewald_params(box)
        energy = (w.tip4pew_energy_rigid_ewald if tip4p
                  else w.tip3p_energy_rigid_ewald)
        lr = make_longrange_force_fn(system)
        force = lambda p: ewald.neg_grad(energy, p, box, ew)
        p64 = torch.as_tensor(start, dtype=torch.float64)
        e64, f64, lr64 = float(energy(p64, box, ew)), force(p64), lr(p64)
        pos = torch.as_tensor(start, device=dev)
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            e32, f32, lr32 = float(energy(pos, box, ew)), force(pos), lr(pos)
            force_ms = time_ms(lambda: force(pos))
            lr_ms = time_ms(lambda: lr(pos))
            # The same phases k . r as one matmul under the same setting:
            # TF32 was live, and would have rounded them.
            kv = torch.as_tensor(ew.kvecs, dtype=torch.float32, device=dev)
            tf32_phase = (kv @ pos.T).double().cpu()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        exact_phase = torch.as_tensor(ew.kvecs) @ p64.T
        phase_err = float((tf32_phase - exact_phase).abs().max())
        rel = lambda a, b: float((a.double().cpu() - b).abs().max()
                                 / b.abs().max())
        e_err, f_err, lr_err = (abs(e32 - e64) / abs(e64), rel(f32, f64),
                                rel(lr32, lr64))
        say(f"phase 52: {model.upper()}-{3 * n_mol} rigid Ewald energy and "
            f"forces (box {box} A, cutoff 10 A, {len(ew.kfac)} k-vectors) "
            f"in float32 on the card with TF32 switched on globally, against "
            f"the same functions in float64 on the CPU: energy {e32:.4f} vs "
            f"{e64:.4f} kJ/mol (rel {e_err:.3e}, tolerance {EWALD_E_RTOL}), "
            f"forces max |d| / max |F| {f_err:.3e}, the k-space force "
            f"(make_longrange_force_fn) {lr_err:.3e} (tolerance "
            f"{EWALD_F_RTOL}); the phases k.r as one TF32 matmul would be "
            f"off by {phase_err:.3e} rad; the Ewald force call "
            f"{force_ms:.4f} ms, the k-space force alone {lr_ms:.4f} ms "
            f"(CUDA events, median of 20) [{card}]")
        require(e_err <= EWALD_E_RTOL and f_err <= EWALD_F_RTOL
                and lr_err <= EWALD_F_RTOL,
                f"{model} Ewald on the card disagrees with float64")
        require(phase_err > 1e-3, "TF32 was not live for the control matmul")


def frame_temperature(vel_m_s, masses, n_constraints):
    ke2 = float((masses[:, None] * (vel_m_s * units.M_PER_S_TO_INTERNAL)
                 ** 2).sum())
    return ke2 / ((3 * masses.shape[0] - n_constraints) * units.KB)


def water_generation_phase(dev, card, root):
    """Phase 53 (module docstring): the TIP3P set goes to
    root/water_data. Returns {path: launches}. TIP4P's
    generation (the same protocol, 1 seed, about 90 s on the card) runs in
    tests/test_torch_cuda.py::test_tip4p_generation_on_the_card, to keep
    phases 52-55 near 120 s."""
    from gamd_tpu_torch.md.constraints import RigidWater
    from gamd_tpu_torch.md.simulate import stack_states
    from gamd_tpu_torch.physics import ewald
    from gamd_tpu_torch.physics import water as w
    from gamd_tpu_torch.physics.generate import water_protocol
    from gamd_tpu_torch.tools import generate_data

    runs = {}
    out = os.path.join(root, "water_data")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_path("generate_tip3p", runs, lambda: generate_data.main(
        ["--system", "tip3p", "--seeds", str(WGEN_SEEDS), "--out", out,
         "--frames", str(WGEN_FRAMES), "--interval", str(WGEN_INTERVAL),
         "--minimize_steps", str(WGEN_FIRE), "--dispatch_frames",
         str(WGEN_FRAMES)]))
    seconds = time.perf_counter() - t0
    names = sorted(os.listdir(out))
    require(names == sorted(f"data_{s}_{t}.npz" for s in range(WGEN_SEEDS)
                            for t in range(WGEN_FRAMES)),
            f"generate_data --system tip3p wrote {names}")
    system = get_preset("tip3p")
    box, n = system.box, system.n_atoms
    cst = RigidWater(n // 3, box)
    masses = torch.as_tensor(system.atom_masses(), device=dev)
    ew = ewald.make_ewald_params(box)
    temps, residual, f_err = [], 0.0, 0.0
    for name in names:
        with np.load(os.path.join(out, name)) as z:
            arrays = {k: torch.as_tensor(z[k], device=dev)
                      for k in ("pos", "vel", "forces")}
        require(all(a.dtype == torch.float32 and a.shape == (n, 3)
                    and bool(torch.isfinite(a).all())
                    for a in arrays.values()),
                f"{name}: dtypes, shapes or values wrong")
        pos = arrays["pos"]
        want = ewald.neg_grad(w.tip3p_energy_rigid_ewald, pos, box, ew) \
            / units.KJ_MOL_NM_TO_INTERNAL
        f_err = max(f_err, float((arrays["forces"] - want).abs().max())
                    / float(want.abs().max()))
        residual = max(residual, float(cst.residual(pos)))
        temps.append(frame_temperature(arrays["vel"], masses,
                                       cst.n_constraints))
    mean_t = sum(temps) / len(temps)
    frames = WGEN_SEEDS * WGEN_FRAMES
    say(f"phase 53: generate_data --system tip3p on the card, {WGEN_SEEDS} "
        f"seeds as constrained replicas of one Langevin run (rigid, Ewald, "
        f"300 K, 2/ps, dt 2 fs), {WGEN_FIRE} FIRE steps a start, 5,000 "
        f"thermalisation steps, {WGEN_FRAMES} frames every {WGEN_INTERVAL} "
        f"steps: {seconds:.2f} s, {frames / seconds:.3f} frames/s; T of the "
        f"frames {min(temps):.1f}-{max(temps):.1f} K, mean {mean_t:.2f} K "
        f"(band 300 +- {WATER_T_BAND}); SETTLE residual {residual:.3e} A "
        f"(under {WATER_RESIDUAL}); recorded forces against the rigid Ewald "
        f"forces of each frame's pos {f_err:.3e} of max |F| (tolerance "
        f"{GEN_FORCE_RTOL}); launches {runs['generate_tip3p']} [{card}]")
    require(abs(mean_t - 300.0) <= WATER_T_BAND,
            f"mean T of the frames {mean_t:.2f} K")
    require(residual < WATER_RESIDUAL, f"residual {residual}")
    require(f_err <= GEN_FORCE_RTOL, "recorded forces disagree")
    require(not any(runs["generate_tip3p"].values()),
            "a kernel launched on the generation path")

    # The lockstep step of two replicas alone, from two recorded frames.
    proto = water_protocol("tip3p", 258, device=dev)
    starts = []
    for s in range(WGEN_SEEDS):
        with np.load(os.path.join(root, "water_data",
                                  f"data_{s}_{WGEN_FRAMES - 1}.npz")) as z:
            starts.append(proto.sim.init_state(
                z["pos"], vel=z["vel"] * units.M_PER_S_TO_INTERNAL,
                rng=torch.Generator(dev).manual_seed(s)))
    states = stack_states(starts)
    proto.sim.run(states, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proto.sim.run(states, WGEN_STEP_TIMED)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / WGEN_STEP_TIMED
    say(f"phase 53: the generator's Langevin step of {WGEN_SEEDS} rigid "
        f"TIP3P-774 Ewald replicas in lockstep, timed alone: {step_ms:.3f} ms "
        f"a step on the host clock ({WGEN_STEP_TIMED} steps) [{card}]")
    return runs


def water_lr_training_phase(dev, card, root):
    """Phase 54 (module docstring). Returns {path: launches}."""
    from gamd_tpu_torch.tools import train_gamd

    flags = ["--system", "tip3p", "--data_dir", root, "--sample_num",
             str(WGEN_FRAMES), "--seed_num", str(WGEN_SEEDS), "--max_epoch",
             str(WTRAIN_EPOCHS), "--use_layer_norm", "--longrange",
             "--relabel", "--rigid_jitter"]
    say("phase 54: one training step of train_gamd --system tip3p "
        "--longrange --relabel --rigid_jitter --use_layer_norm on its first "
        "training frame (TIP3P-774, 4.2 A, K=96, 4 x 128, the bond channel; "
        "the labels less the k-space term, relabelled by the rigid Ewald "
        "oracle at the rigidly jittered positions), kernel pair vs plain "
        "path, same seed: " + cli_step_agreement(dev, flags)
        + f" [{card}]")
    runs, logs, history = {}, [], []
    ck = os.path.join(root, "ck_lr")
    t0 = time.perf_counter()
    run_path("water_lr_train", runs, lambda: train_gamd.main(
        flags + ["--use_pallas", "--num_device", "1", "--cp_dir", ck],
        log_fn=logs.append, history=history))
    train_s = time.perf_counter() - t0
    args = train_gamd.build_parser().parse_args(flags)
    train_data, val_data = train_gamd.datasets(args)
    steps, n_val = len(train_data), len(val_data)
    losses = epoch_losses(history)
    step_ms = [r["seconds"] * 1e3 / steps for r in history]
    want = {"conv_msg_gather": 4 * WTRAIN_EPOCHS * (steps + n_val),
            "conv_msg_gather_bwd": 4 * WTRAIN_EPOCHS * steps}
    _, cfg, _ = load_self_describing(os.path.join(
        ck, f"checkpoint_{WTRAIN_EPOCHS - 1}.msgpack"))
    say(f"phase 54: train_gamd --system tip3p --longrange --relabel "
        f"--rigid_jitter --use_pallas --use_layer_norm on phase 53's "
        f"{steps + n_val} frames ({steps} train, {n_val} test), "
        f"{WTRAIN_EPOCHS} epochs of {steps} steps at batch 1: {train_s:.2f} s "
        f"in all; the epoch loop {', '.join(f'{x:.3f}' for x in step_ms)} ms "
        f"a step by epoch (epoch 0 with the first calls' set-up); epoch "
        f"losses {', '.join(f'{x:.6f}' for x in losses)}; the checkpoint's "
        f"longrange {cfg.longrange!r}; launches {runs['water_lr_train']} "
        f"[{card}]")
    say("phase 54: " + " | ".join(logs))
    require(len(losses) == WTRAIN_EPOCHS and all(
        np.isfinite(x) for x in losses), "non-finite losses")
    require(cfg.longrange == "ewald_recip", "the checkpoint lost longrange")
    require(all(runs["water_lr_train"][k] == v for k, v in want.items()),
            f"launches {runs['water_lr_train']}: want {want}")
    return runs


def mega_plain(ff, pos, idx, mask):
    """The plain version of ff.force_fn(megakernel=True) without the
    long-range term: reference_forward with the path's arguments."""
    cfg, system = ff.model_cfg, ff.system
    return reference_forward(
        pos, idx, mask, ff._node_h0(), ff._kernel_params("megakernel"),
        system.box, system.cutoff, *ff._length_scale(), bond=ff._bond(idx),
        rbf_gap=cfg.rbf_gap, flip_dir=cfg.flip_dir, use_ln=cfg.use_layer_norm,
        conv_act=cfg.conv_activation, mlp_act=cfg.mlp_activation)


def rj_deployment_phase(dev, card, root):
    """Phase 55 (module docstring). Returns {path: launches}."""
    from gamd_tpu_torch.md.constraints import RigidWater
    from gamd_tpu_torch.train.forcefield import make_longrange_force_fn

    state, cfg, system = load_self_describing(RJ_CKPT)
    require(cfg.longrange == "ewald_recip", "tip3p_rj_best without longrange")
    ff = GNNForceField(state, system, cfg, device=dev)
    ff_short = GNNForceField(state, system,
                             dataclasses.replace(cfg, longrange=""),
                             device=dev)
    ff_pallas = GNNForceField(state, system,
                              dataclasses.replace(cfg, use_pallas=True),
                              device=dev)
    water = os.path.join(root, "water_data")
    with np.load(os.path.join(water, f"data_0_{WGEN_FRAMES - 1}.npz")) as z:
        frame = z["pos"]
    pos = space.wrap(torch.as_tensor(frame, device=dev), system.box)
    idx, mask, ovf = build_nbrs(pos, system)
    require(not bool(ovf), "neighbour overflow at the generated frame")
    live = refresh_mask(pos, system.box, system.cutoff, idx, mask)
    lr = make_longrange_force_fn(system)
    f_lr = lr(pos)
    runs = {}
    fn_mk = ff.force_fn(megakernel=True)
    require(fn_mk.handles_refresh, "the long-range megakernel closure lost "
            "handles_refresh")
    f_mk = run_path("rj_force_megakernel", runs,
                    lambda: fn_mk(pos, idx, mask))
    f_mk_plain = mega_plain(ff, pos, idx, mask) + f_lr
    mk_err = float((f_mk - f_mk_plain).abs().max())
    scale = float(f_mk_plain.std())
    term = f_mk - ff_short.force_fn(megakernel=True)(pos, idx, mask)
    term_err = float((term - f_lr).abs().max()) / float(f_mk.abs().max())
    f_pl = run_path("rj_force_use_pallas", runs,
                    lambda: ff_pallas.force_fn()(pos, idx, live))
    f_plain = ff.force_fn()(pos, idx, live)
    pl_err = float((f_pl - f_plain).abs().max()) / float(f_plain.std())
    gap = float((f_mk - f_plain).abs().max()) / float(f_plain.std())
    mk_ms = time_ms(lambda: fn_mk(pos, idx, mask))
    short_ms = time_ms(lambda: ff_short.force_fn(megakernel=True)(
        pos, idx, mask))
    lr_ms = time_ms(lambda: lr(pos))
    say(f"phase 55: tip3p_rj_best (4 x 128, LayerNorm, the bond channel, "
        f"longrange 'ewald_recip') on a phase-53 frame: force_fn(megakernel"
        f"=True), row 1 plus the k-space term, against its plain version "
        f"(reference_forward plus the term) max |dF| / std(F) "
        f"{mk_err / scale:.3e} (tolerance {TOLERANCE}); its long-range term "
        f"alone (less the same weights' closure without the channel) "
        f"against make_longrange_force_fn {term_err:.3e} of max |F| "
        f"(tolerance {TERM_RTOL}); the use_pallas force_fn (row 3) against "
        f"the plain force_fn {pl_err:.3e} std(F) (tolerance "
        f"{WATER_EAGER_RTOL}); row 1's path against the plain eager model "
        f"{gap:.3e} std(F) (two functions: tanh- against erf-gelu; no bar); "
        f"the force call {mk_ms:.4f} ms, without the term {short_ms:.4f}, "
        f"the term alone {lr_ms:.4f} ms (CUDA events, median of 20); "
        f"launches {runs['rj_force_megakernel']}, "
        f"{runs['rj_force_use_pallas']} [{card}]")
    require(bool(torch.isfinite(f_mk).all()), "non-finite rj_best forces")
    require(mk_err < TOLERANCE * scale, "row 1's long-range path disagrees")
    require(term_err <= TERM_RTOL, "the long-range term is not the channel's")
    require(pl_err <= WATER_EAGER_RTOL, "the use_pallas path disagrees")
    require(runs["rj_force_megakernel"]["mega_forward"] == 1
            and runs["rj_force_use_pallas"]["conv_msg_gather"] == 4,
            "row 1 or row 3 did not launch on the long-range paths")

    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "start.npy")
        np.save(init, frame)
        argv = ["--system", "tip3p", "--ckpt", RJ_CKPT, "--megakernel",
                "--friction", str(WATER_FRICTION), "--init_pos", init,
                "--steps", str(RJ_MD_STEPS), "--log",
                os.path.join(tmp, "log.txt")]
        run = run_path("rj_run_md", runs, lambda: run_md.rollout(
            run_md.build_parser().parse_args(argv)))
        t0 = time.perf_counter()
        report = run_path("rj_analyze_rollout", runs,
                          lambda: analyze_rollout.main([
                              "--system", "tip3p", "--ckpt", RJ_CKPT,
                              "--data_dir", water, "--megakernel",
                              "--steps", str(RJ_ANALYZE_STEPS),
                              "--classical_baseline", "--pe", "--json_out",
                              os.path.join(tmp, "r.json")]))
        analyze_s = time.perf_counter() - t0
    res = run["result"]
    temps = res.thermo.temperature
    mean_t = float(temps[RJ_MD_STEPS // 2:].mean())
    residual = float(RigidWater(system.n_atoms // 3, system.box).residual(
        res.state.pos))
    sps = RJ_MD_STEPS / run["seconds"]
    share = lr_ms / (1e3 / sps)
    say(f"phase 55: run_md --system tip3p --ckpt tip3p_rj_best --megakernel "
        f"--friction {WATER_FRICTION:g} --steps {RJ_MD_STEPS} (rigid, from "
        f"the phase-53 frame): {sps:.1f} steps/s, the k-space term "
        f"{share:.2%} of a step by its events time; mean T of the second "
        f"half {mean_t:.2f} K (band 300 +- {WATER_T_BAND}), residual "
        f"{residual:.3e} A (under {WATER_RESIDUAL}); launches "
        f"{runs['rj_run_md']} [{card}]")
    scalars = {k: v for k, v in report.items() if not isinstance(v, list)}
    say(f"phase 55: analyze_rollout --system tip3p --ckpt tip3p_rj_best "
        f"--megakernel --classical_baseline --pe (NHC, rigid, "
        f"{RJ_ANALYZE_STEPS} steps, the Ewald classical rollout, phase 53's "
        f"{WGEN_SEEDS * WGEN_FRAMES} frames as ground truth) in "
        f"{analyze_s:.2f} s: {json.dumps(scalars)}; launches "
        f"{runs['rj_analyze_rollout']} [{card}]")
    require(bool(torch.isfinite(temps).all())
            and bool(torch.isfinite(res.state.pos).all()),
            "non-finite rj_best rollout")
    require(abs(mean_t - 300.0) <= WATER_T_BAND,
            f"rj_best rollout mean T {mean_t:.2f} K")
    require(residual < WATER_RESIDUAL, f"rj_best residual {residual}")
    require(runs["rj_run_md"]["mega_forward"] == RJ_MD_STEPS + 1,
            f"run_md launches {runs['rj_run_md']}")
    require(all(np.isfinite(v) for v in scalars.values()
                if isinstance(v, float)), "non-finite analyze_rollout report")
    require(runs["rj_analyze_rollout"]["mega_forward"]
            == RJ_ANALYZE_STEPS + 1
            and runs["rj_analyze_rollout"]["nhc_half_step"]
            == 4 * RJ_ANALYZE_STEPS,
            f"analyze_rollout launches {runs['rj_analyze_rollout']}")
    return runs


def water_protocol_phases(dev, card):
    """Phases 52-55 in a temporary directory. Returns {path: launches}."""
    ewald_phase(dev, card)
    root = tempfile.mkdtemp(prefix="gamd_water_protocol_")
    try:
        runs = water_generation_phase(dev, card, root)
        runs.update(water_lr_training_phase(dev, card, root))
        runs.update(rj_deployment_phase(dev, card, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs


# -- the DFT system (phases 56-58) ---------------------------------------------

RPBE = os.path.join("md_dataset", "RPBE-surrogate.npz")
DFT_CKPT = os.path.join("results", "ckpts", "dftlarge_final.msgpack")
DFT_JAX_EVAL = os.path.join("results", "dftlarge_eval_r4.json")
DFT_FLAGS = ["--system", "dft", "--cutoff", "9.5", "--conv_layer", "5",
             "--encoding_size", "256", "--edge_embedding_dim", "256",
             "--use_layer_norm"]     # train_gamd's DFT run (hidden 128)
DFT_CUT = (24, 8)         # phase 57's training and test frames
DFT_EPOCHS = 2
DFT_MD_STEPS = 100        # phase 57's run_md on the trained model
DFT_DEPLOY_STEPS = 200    # phase 58's run_md on dftlarge_final
DFT_CPU_FRAMES = 4        # phase 58's CPU control frames
DFT_CPU_RTOL = 1e-4       # the card's forces vs the port's CPU, / std(F)


def wide_conv_ops(live_edges, e_w, d_w, backward=False):
    """(tensor-core FLOP, fp32 FLOP) of rows 3 (or 4) at e width e_w and
    message width d_w (hidden 128), as the tiles run them: the split
    table's e_w/128 + 2 + d_w/128 blocks of 128 x 128 a live edge (once
    forward; the recompute, the sweep and the weight gradients backward)
    as three bf16 passes each; the epilogues as at width 128 with the last
    layer's columns at d_w (conv_tc_ops, conv_bwd_tc_ops at 128)."""
    blocks = e_w // 128 + 2 + d_w // 128
    if backward:
        return (3.0 * 3 * blocks * 2 * 128 * 128 * live_edges,
                float((BWD_EPILOGUE_OPS - 6) * 128 + 6 * d_w) * live_edges)
    return (3.0 * blocks * 2 * 128 * 128 * live_edges,
            float((EPILOGUE_OPS - 3) * 128 + 3 * d_w) * live_edges)


def wide_conv_bytes(n, k, live_edges, e_w, d_w, backward=False):
    """Bytes rows 3 (or 4) must move at e width e_w and message width d_w
    (hidden 128): e's live rows, the ids at the live slots and the whole
    mask, hn, src, dst and the weights in, agg out; the backward also the
    cotangent in, ge at every slot, the node grads and the weight grads
    out (conv_bytes with live_rows_only at 128)."""
    weights = 4 * (e_w * 128 + 2 * 128 * 128 + 128 * d_w + 3 * 128 + d_w)
    nodes = 4 * n * (d_w + 2 * 128)
    io = 4 * live_edges * e_w + 4 * live_edges + n * k + nodes + weights \
        + 4 * n * d_w
    if backward:
        return io + 4 * n * d_w + 4 * n * k * e_w + nodes + weights
    return io


def wide_bound(live_edges, n, k, e_w, d_w, backward=False):
    """(least ms, "operations" or "bytes") of rows 3 or 4 at the widths:
    wide_conv_ops against the bf16 tensor and fp32 peaks (their times
    add), wide_conv_bytes against HBM; the larger."""
    tc, fp = wide_conv_ops(live_edges, e_w, d_w, backward)
    t_ops = (tc / BF16_FLOPS + fp / FP32_FLOPS) * 1e3
    t_bytes = wide_conv_bytes(n, k, live_edges, e_w, d_w, backward) \
        / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def dft_kernel_phase(dev, card):
    """Phase 56 (module docstring). Returns {"conv_msg_gather": fields,
    "conv_msg_gather_bwd": fields} at the DFT widths."""
    from gamd_tpu_torch.tools.time_conv import dft_inputs

    fused = fused_conv_gather_message
    fields = {"conv_msg_gather": {}, "conv_msg_gather_bwd": {}}
    for b in (1, 4):
        args, live = dft_inputs(dev, b)
        n, k = args[1].shape[1] * b, args[1].shape[2]
        e_w, d_w = args[0].shape[-1], args[3].shape[-1]
        with torch.no_grad():
            before = fused.launches
            agg = fused(*args)
            torch.cuda.synchronize()
            require(fused.launches == before + 1,
                    "conv_msg_gather did not launch at the DFT widths")
            ref = batched_reference(*args)
            same = torch.equal(agg, fused(*args))
        err, scale = float((agg - ref).abs().max()), float(ref.abs().max())
        require(bool(torch.isfinite(agg).all()) and agg.shape == ref.shape
                == (b, n // b, d_w), "non-finite or misshapen DFT agg")
        require(err <= CONV_RTOL * scale,
                f"conv_msg_gather disagrees at the DFT widths: {err} vs "
                f"{scale}")
        require(same, "conv_msg_gather differs from run to run (DFT)")
        g = torch.randn(agg.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(56))
        before = fused.backward_launches
        out_k, leaves_k, grads_k = grads_of(fused, args, g)
        torch.cuda.synchronize()
        require(fused.backward_launches == before + 1,
                "conv_msg_gather_bwd did not launch at the DFT widths")
        out_p, leaves_p, grads_p = grads_of(batched_reference, args, g)
        worst, gerr = None, 0.0
        for name, a, r in zip(GRAD_NAMES, grads_k, grads_p):
            e_, mx = float((a - r).abs().max()), float(r.abs().max())
            require(bool(torch.isfinite(a).all()) and a.shape == r.shape,
                    f"non-finite or misshapen DFT grad {name}")
            require(e_ <= CONV_GRAD_RTOL * mx,
                    f"conv_msg_gather_bwd disagrees on {name} at the DFT "
                    f"widths: {e_} vs {mx}")
            if mx and e_ / mx >= gerr:
                gerr, worst = e_ / mx, name
        with torch.no_grad():
            fwd_ms = time_ms(lambda: fused(*args))
            fwd_plain_ms = time_ms(lambda: batched_reference(*args))
            fwd_us, fwd_kernels = device_us(lambda: fused(*args))
        bwd_call = lambda: torch.autograd.grad(out_k, leaves_k, g,
                                               retain_graph=True)
        bwd_ms = time_ms(bwd_call)
        bwd_plain_ms = time_ms(lambda: torch.autograd.grad(
            out_p, leaves_p, g, retain_graph=True))
        bwd_us, bwd_kernels = device_us(bwd_call)
        fb, fby = wide_bound(live, n, k, e_w, d_w)
        bb, bby = wide_bound(live, n, k, e_w, d_w, backward=True)
        f_tc, f_fp = wide_conv_ops(live, e_w, d_w)
        b_tc, b_fp = wide_conv_ops(live, e_w, d_w, backward=True)
        say(f"phase 56: rows 3-4 at E={e_w}, H=128, D={d_w} on {b} RPBE "
            f"training frame(s) (layer 0 of the seeded DFT model, 192 atoms "
            f"a frame, K={k} at 9.5 bohr, {live} live edges of {n * k} "
            f"slots): forward max |d agg| {err:.3e} of max {scale:.3e} "
            f"(tolerance {CONV_RTOL} x max), two calls bit for bit {same}; "
            f"backward worst grad {gerr:.3e} of its max ({worst}; tolerance "
            f"{CONV_GRAD_RTOL}) [{card}]")
        say(f"phase 56: conv_msg_gather B={b} {fwd_ms:.4f} ms/call, "
            f"{fwd_us:.2f} us of device time "
            f"{json.dumps({key: round(v, 2) for key, v in fwd_kernels.items()})}"
            f", plain {fwd_plain_ms:.4f} ms; bound {fb:.5f} ms ({fby}; "
            f"{f_tc / 1e9:.4f} GFLOP bf16 x 3 of six 128 x 128 blocks an "
            f"edge at {BF16_FLOPS / 1e12:.0f} TFLOP/s, {f_fp / 1e9:.4f} GFLOP "
            f"fp32 at {FP32_FLOPS / 1e12:.0f}), device time at "
            f"{fb * 1e3 / fwd_us:.2%} of it; conv_msg_gather_bwd "
            f"{bwd_ms:.4f} ms/call, {bwd_us:.2f} us of device time "
            f"{json.dumps({key: round(v, 2) for key, v in bwd_kernels.items()})}"
            f", plain autograd {bwd_plain_ms:.4f} ms; bound {bb:.5f} ms ({bby}; "
            f"{b_tc / 1e9:.4f} GFLOP bf16 x 3, {b_fp / 1e9:.4f} GFLOP fp32), "
            f"device time at {bb * 1e3 / bwd_us:.2%} of it; CUDA events, "
            f"median of 20 [{card}]")
        for name, vals in (("conv_msg_gather", dict(
                max_abs_err=err, ms=fwd_ms, plain_ms=fwd_plain_ms,
                device_us=fwd_us, bound_ms=fb, bound_by=fby)),
                ("conv_msg_gather_bwd", dict(
                    max_abs_err=gerr, ms=bwd_ms, plain_ms=bwd_plain_ms,
                    device_us=bwd_us, bound_ms=bb, bound_by=bby))):
            fields[name][f"dft_b{b}"] = {"live": live, "widths": [e_w, 128,
                                                                  d_w],
                                         **vals}
        del out_k, out_p, leaves_k, leaves_p, grads_k, grads_p

    # Width 128 inside the wide kernels: zero second blocks give the 128
    # call's bits (tests/test_torch_cuda.py has the gradients too).
    (case, *_), _ = conv_inputs(dev)
    e, idx, mask, hn, src, dst, *ws = case
    pad = lambda t, dim: torch.nn.functional.pad(
        t, [0, 0] * (t.ndim - 1 - dim) + [0, 128])
    with torch.no_grad():
        narrow = fused(*case)
        wide = fused(pad(e, 3), idx, mask, pad(hn, 2), src, dst,
                     pad(ws[0], 0), *ws[1:6], pad(ws[6], 1), pad(ws[7], 0))
        torch.cuda.synchronize()
    padded_same = torch.equal(wide[..., :128], narrow) \
        and not bool(wide[..., 128:].any())
    say(f"phase 56: the LJ training slice's layer 0 at width 128 through "
        f"the 256 / 128 / 256 instance with zero second blocks: the first "
        f"128 columns bit for bit the 128-wide call's {padded_same} (the "
        f"parent tree's bits: tools/time_conv.py --save on both trees)")
    require(padded_same, "the wide kernel's first block differs from the "
            "128-wide call")
    return fields


def dft_rollout_line(label, run, steps, card):
    """Checks of a run_md --system dft rollout (finite, the constraint
    residual under WATER_RESIDUAL) and its line: steps/s, mean T of the
    second half, residual. Returns (line, mean T)."""
    from gamd_tpu_torch.md.constraints import RigidWater

    res, system = run["result"], run["system"]
    temps = res.thermo.temperature
    mean_t = float(temps[steps // 2:].mean())
    residual = float(RigidWater(system.n_atoms // 3, system.box).residual(
        res.state.pos))
    require(bool(torch.isfinite(temps).all())
            and bool(torch.isfinite(res.state.pos).all()),
            f"non-finite {label} rollout")
    require(residual < WATER_RESIDUAL, f"{label} residual {residual}")
    return (f"{steps / run['seconds']:.1f} steps/s, mean T of the second "
            f"half {mean_t:.2f} K, residual {residual:.3e} A (under "
            f"{WATER_RESIDUAL}) [{card}]"), mean_t


def dft_start(dev, root):
    """run_md --system dft's start (water_start: water_box relaxed by FIRE
    on the flexible TIP3P forces, 774 atoms in the 20 A box) saved as an
    .npy under root for --init_pos, and the MD system; phases 57 and 58
    share it."""
    args = run_md.build_parser().parse_args(["--system", "dft"])
    _, _, md_system = run_md.load_force_field(args, dev)
    pos = run_md.water_start(md_system, dev)
    path = os.path.join(root, "dft_start.npy")
    np.save(path, pos.cpu().numpy())
    return path, pos, md_system


def dft_training_phase(dev, card, root, start):
    """Phase 57 (module docstring). Returns {path: launches}."""
    from gamd_tpu_torch.tools import train_gamd

    with np.load(RPBE) as z:
        train_idx, test_idx = z["train_idx"], z["test_idx"]
        picks = np.concatenate([train_idx[:DFT_CUT[0]],
                                test_idx[:DFT_CUT[1]]])
        cut = {k: z[k][picks] for k in ("pos", "force", "box", "atom_type")}
    npz = os.path.join(root, "rpbe_cut.npz")
    np.savez(npz, **cut, train_idx=np.arange(DFT_CUT[0]),
             test_idx=np.arange(DFT_CUT[0], sum(DFT_CUT)))
    flags = DFT_FLAGS + ["--data_dir", npz]
    say("phase 57: one training step of train_gamd --system dft "
        "--use_layer_norm's configuration (256 / 128 / 256, 5 layers, "
        "flip_dir, edge dropout 0.1, rotation with the frame's box, jitter "
        "0.00025 bohr) on its first training frame at its own box, kernel "
        "pair vs plain path, same seed: " + cli_step_agreement(dev, flags)
        + f" [{card}]")
    runs, logs, history = {}, [], []
    ck = os.path.join(root, "dft_ck")
    t0 = time.perf_counter()
    run_path("dft_train", runs, lambda: train_gamd.main(
        flags + ["--use_pallas", "--max_epoch", str(DFT_EPOCHS),
                 "--num_device", "1", "--cp_dir", ck], log_fn=logs.append,
        history=history))
    train_s = time.perf_counter() - t0
    losses = epoch_losses(history)
    step_ms = [r["seconds"] * 1e3 / DFT_CUT[0] for r in history]
    layers = 5
    want = {"conv_msg_gather": layers * DFT_EPOCHS * sum(DFT_CUT),
            "conv_msg_gather_bwd": layers * DFT_EPOCHS * DFT_CUT[0]}
    say(f"phase 57: train_gamd --system dft --use_pallas --use_layer_norm "
        f"(256 / 128 / 256, 5 layers) on {DFT_CUT[0]} training and "
        f"{DFT_CUT[1]} test frames of the surrogate (an npz of its layout "
        f"in a temporary directory), {DFT_EPOCHS} epochs at batch 1: "
        f"{train_s:.2f} s in all; the epoch loop "
        f"{', '.join(f'{x:.3f}' for x in step_ms)} ms a step by epoch; "
        f"epoch losses {', '.join(f'{x:.6f}' for x in losses)}; launches "
        f"{runs['dft_train']} [{card}]")
    say("phase 57: " + " | ".join(logs))
    require(len(losses) == DFT_EPOCHS and all(np.isfinite(x) for x in losses),
            "non-finite DFT losses")
    require(all(runs["dft_train"][k] == v for k, v in want.items()),
            f"launches {runs['dft_train']}: want {want}")
    path = os.path.join(ck, f"checkpoint_{DFT_EPOCHS - 1}.msgpack")
    _, cfg, system = load_self_describing(path)
    require(system.box is None and cfg.flip_dir and not cfg.update_edge,
            "the DFT checkpoint does not describe the DFT system")
    init, pos, md_system = start
    idx, mask, _ = dense_neighbor_list(pos, md_system.box, md_system.cutoff,
                                       md_system.nbr_capacity)
    forces = {}
    for use_pallas in (True, False):
        args = run_md.build_parser().parse_args(["--system", "dft", "--ckpt",
                                                 path])
        _, fn, _ = run_md.load_force_field(args, dev, use_pallas=use_pallas)
        forces[use_pallas] = fn(pos, idx, mask)
    closure_err = float((forces[True] - forces[False]).abs().max()
                        / forces[False].std())
    argv = ["--system", "dft", "--ckpt", path, "--use_pallas", "--init_pos",
            init, "--steps", str(DFT_MD_STEPS), "--log",
            os.path.join(root, "dft_md.txt")]
    run = run_path("dft_run_md", runs, lambda: run_md.rollout(
        run_md.build_parser().parse_args(argv)))
    line, _ = dft_rollout_line("DFT trained", run, DFT_MD_STEPS, card)
    say(f"phase 57: run_md's DFT closure on the result at the start, "
        f"--use_pallas (rows 3-4 at 256 / 128 / 256) against the plain "
        f"path: max |dF| / std(F) {closure_err:.3e} (tolerance "
        f"{DFT_CPU_RTOL}); run_md --system dft --use_pallas --steps "
        f"{DFT_MD_STEPS} on it from the shared FIRE start (774 rigid atoms "
        f"in the 20 A box, the model in bohr, K=128; a 2-epoch model: no "
        f"band on T): {line}; launches {runs['dft_run_md']}")
    require(closure_err <= DFT_CPU_RTOL, "the DFT closure's use_pallas "
            "forces disagree with the plain ones")
    require(runs["dft_run_md"]["conv_msg_gather"]
            == layers * (DFT_MD_STEPS + 1),
            f"run_md launches {runs['dft_run_md']}")
    return runs


def dft_deployment_phase(dev, card, init):
    """Phase 58 (module docstring). Returns {path: launches}."""
    from gamd_tpu_torch.tools import evaluate
    from gamd_tpu_torch.train.data import RealLargeDataset

    runs = {}
    t0 = time.perf_counter()
    metrics = run_path("dft_evaluate", runs, lambda: evaluate.main([
        "--system", "dft", "--ckpt", DFT_CKPT, "--data_dir", RPBE]))
    eval_s = time.perf_counter() - t0
    with open(DFT_JAX_EVAL) as f:
        jax_eval = json.load(f)
    keys = ("force_cosine_similarity", "force_mae_ev_a", "force_rmse_ev_a")
    say(f"phase 58: evaluate --system dft on dftlarge_final, all "
        f"{metrics['frames']} test frames (each predicted alone at its own "
        f"box; update_edge: the plain edge pipeline, as in JAX) in "
        f"{eval_s:.2f} s: " + ", ".join(
            f"{key} {metrics[key]:.5f} (JAX on a TPU: {jax_eval[key]:.5f})"
            for key in keys) + f"; launches {runs['dft_evaluate']} [{card}]")
    require(metrics["frames"] == 300
            and all(np.isfinite(metrics[key]) for key in keys),
            "evaluate --system dft failed")
    state, cfg, system = load_self_describing(DFT_CKPT)
    ff = GNNForceField(state, system, cfg, device=dev)
    ff_cpu = GNNForceField(state, system, cfg, device="cpu")
    items = [RealLargeDataset(RPBE, mode="test")[i]
             for i in range(DFT_CPU_FRAMES)]
    worst = 0.0
    t0 = time.perf_counter()
    for it in items:
        got = ff.predict(it["pos"], box=it["box_size"]).cpu()
        want = ff_cpu.predict(it["pos"], box=it["box_size"])
        worst = max(worst, float((got - want).abs().max() / want.std()))
    cpu_s = time.perf_counter() - t0
    say(f"phase 58: the card's predict against the port's plain path on the "
        f"CPU at {DFT_CPU_FRAMES} test frames: max |dF| / std(F) "
        f"{worst:.3e} (tolerance {DFT_CPU_RTOL}; {cpu_s:.2f} s)")
    require(worst <= DFT_CPU_RTOL, "the card's DFT forces disagree with "
            "the CPU's")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--system", "dft", "--ckpt", DFT_CKPT, "--init_pos", init,
                "--steps", str(DFT_DEPLOY_STEPS), "--log",
                os.path.join(tmp, "log.txt")]
        run = run_path("dft_deploy_run_md", runs, lambda: run_md.rollout(
            run_md.build_parser().parse_args(argv)))
    line, _ = dft_rollout_line("dftlarge_final", run, DFT_DEPLOY_STEPS,
                               card)
    say(f"phase 58: run_md --system dft on dftlarge_final --steps "
        f"{DFT_DEPLOY_STEPS} (774 rigid atoms, 20 A box, 25/ps, from the "
        f"shared FIRE start; the mean T reported, no band): {line}; "
        f"launches {runs['dft_deploy_run_md']}")
    return runs


def dft_phases(dev, card):
    """Phases 56-58, each one's seconds printed. Returns (row 3 and 4's
    DFT fields, {path: launches})."""
    t0 = time.perf_counter()
    fields = dft_kernel_phase(dev, card)
    t1 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gamd_dft_")
    try:
        start = dft_start(dev, root)
        t2 = time.perf_counter()
        runs = dft_training_phase(dev, card, root, start)
        t3 = time.perf_counter()
        runs.update(dft_deployment_phase(dev, card, start[0]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say(f"phases 56-58: {t1 - t0:.1f}, {t3 - t2:.1f} and "
        f"{time.perf_counter() - t3:.1f} s, the shared start {t2 - t1:.1f} s")
    return fields, runs


# -- phases 59-62: data-parallel training and the item 8 tools ------------

DP_RANKS = 2              # phase 59's gloo ranks, both on cuda:0
DP_STEPS = 3              # its checked steps
DP_TIMED_STEPS = 10       # and the steps timed after them
DP_LOSS_RTOL = 1e-5       # rank 0's loss each step vs one process
DP_PARAM_RTOL = 1e-5      # its parameters after, / max |p|
TRACE_CALLS = 200         # phase 60's force calls (trace_force's default)
PROFILE_MD_ARGV = ["float32", "--steps", "500", "--reps", "1"]   # phase 61
DISTILL_SEEDS, DISTILL_FRAMES = 2, 4                              # phase 62
DISTILL_ARGV = ["--system", "lj", "--seeds", str(DISTILL_SEEDS),
                "--frames", str(DISTILL_FRAMES), "--interval", "10",
                "--thermalize", "20"]
DISTILL_CKPT = os.path.join("results", "ckpts", "lj_distill_best.msgpack")
DISTILL_LABEL_RTOL = 1e-5  # written labels vs lj_forces_dense, / max |F|


def dp_batches(dev):
    """(training slice, its 4 frames as 2 batches of 2): phase 59's data."""
    sl = lj_train_slice(dev, use_pallas=True)
    frames = sl.batches
    return sl, [{k: torch.cat([frames[i][k], frames[i + 1][k]])
                 for k in ("pos", "forces")} for i in (0, 2)]


def dp_steps(step, state, batches, n, shard=lambda x: x):
    """n steps cycling over the batches (each cut by shard); returns
    (state, [loss a step])."""
    losses = []
    for i in range(n):
        b = batches[i % len(batches)]
        state, m = step(state, {k: shard(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return state, losses


def flat_params(model):
    return torch.cat([p.detach().reshape(-1).cpu() for _, p in
                      sorted(model.named_parameters())])


def dp_rank(rank, world, init_method, out_dir):
    """One gloo rank of phase 59 on cuda:0: the training slice at batch 2
    from create_train_state(seed=0), replicated from rank 0, DP_STEPS
    steps on its share with rows 3-4's counts set to 0 just before and
    read just after, then DP_TIMED_STEPS steps timed with the host time
    inside all_reduce summed; saves its results to out_dir/rank{rank}.pt."""
    import torch.distributed as dist
    from gamd_tpu_torch.parallel.mesh import (dp_sharding, init_rank,
                                              make_mesh, replicated)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    init_rank(rank, world, "gloo", init_method)
    try:
        mesh = make_mesh(device=dev)
        sl, batches = dp_batches(dev)
        state = create_train_state(sl.model_cfg, sl.system, sl.train_cfg,
                                   len(batches), seed=0, device=dev)
        replicated(mesh)(state)
        step = make_train_step(state.model, sl.system, sl.train_cfg,
                               relabel_fn=sl.relabel_fn, mesh=mesh)
        shard = dp_sharding(mesh)
        fused = fused_conv_gather_message
        fused.launches = fused.backward_launches = 0
        state, losses = dp_steps(step, state, batches, DP_STEPS, shard)
        torch.cuda.synchronize()
        launches = {"conv_msg_gather": fused.launches,
                    "conv_msg_gather_bwd": fused.backward_launches}
        params = flat_params(state.model)

        inside = [0.0, 0]
        all_reduce = dist.all_reduce

        def timed_all_reduce(*args, **kwargs):
            t = time.perf_counter()
            out = all_reduce(*args, **kwargs)
            inside[0] += time.perf_counter() - t
            inside[1] += 1
            return out
        dist.barrier()
        torch.cuda.synchronize()
        dist.all_reduce = timed_all_reduce
        t0 = time.perf_counter()
        try:
            state, _ = dp_steps(step, state, batches, DP_TIMED_STEPS, shard)
            torch.cuda.synchronize()
        finally:
            dist.all_reduce = all_reduce
        wall = time.perf_counter() - t0
        torch.save({"losses": losses, "params": params,
                    "launches": launches,
                    "ms_per_step": wall * 1e3 / DP_TIMED_STEPS,
                    "all_reduce_share": inside[0] / wall,
                    "all_reduces_per_step": inside[1] / DP_TIMED_STEPS},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def data_parallel_phase(dev, card):
    """Phase 59 (module docstring). Returns {path: {kernel: launches}}."""
    import torch.multiprocessing as mp

    sl, batches = dp_batches(dev)
    state = create_train_state(sl.model_cfg, sl.system, sl.train_cfg,
                               len(batches), seed=0, device=dev)
    step = make_train_step(state.model, sl.system, sl.train_cfg,
                           relabel_fn=sl.relabel_fn)
    state, want = dp_steps(step, state, batches, DP_STEPS)
    params = flat_params(state.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = dp_steps(step, state, batches, DP_TIMED_STEPS)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3 / DP_TIMED_STEPS

    root = tempfile.mkdtemp(prefix="gamd_dp_")
    try:
        t0 = time.perf_counter()
        mp.spawn(dp_rank, nprocs=DP_RANKS, join=True,
                 args=(DP_RANKS, f"file://{os.path.join(root, 'pg')}",
                       root))
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_RANKS)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    got = ranks[0]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want))
    scale = float(params.abs().max())
    param_err = float((got["params"] - params).abs().max())
    say(f"phase 59: two gloo ranks on cuda:0, LJ-258 GAMD-small "
        f"(128/128/128, 4 layers, LayerNorm, use_pallas), batch 2 (a frame "
        f"a rank), {DP_STEPS} steps from one seeded state: losses "
        f"{got['losses']} against one process's {want} (max rel "
        f"{loss_err:.3e}, tolerance {DP_LOSS_RTOL}); parameters max |d| "
        f"{param_err:.3e} of max |p| {scale:.3e} (tolerance "
        f"{DP_PARAM_RTOL} x max |p|); ranks' parameters equal bit for bit: "
        f"{bool(torch.equal(got['params'], ranks[1]['params']))}; rows 3-4 "
        f"launches by rank {[r['launches'] for r in ranks]}")
    require(loss_err <= DP_LOSS_RTOL,
            "two-rank losses disagree with one process")
    require(param_err <= DP_PARAM_RTOL * scale,
            "two-rank parameters disagree with one process")
    require(all(torch.equal(r["params"], got["params"]) for r in ranks),
            "the ranks' parameters differ")
    require(all(n > 0 for r in ranks for n in r["launches"].values()),
            "a rank did not launch rows 3-4")
    say(f"phase 59: ms a step (host clock, {DP_TIMED_STEPS} steps after the "
        f"checked ones): one process at batch 2 {one_ms:.2f}, two ranks "
        f"(rank 0) {got['ms_per_step']:.2f} (rank 1 "
        f"{ranks[1]['ms_per_step']:.2f}); host time inside all_reduce "
        f"{got['all_reduce_share']:.2%} of rank 0's step "
        f"({got['all_reduces_per_step']:.0f} calls a step; gloo copies "
        f"through the host, and a call waits for the device work before "
        f"it and for the other rank); spawning and running the ranks "
        f"{spawn_s:.1f} s [{card}]")
    runs = {}
    for r, res in enumerate(ranks):
        runs[f"data_parallel_rank{r}"] = res["launches"]
    return runs


def item8_phases(dev, card):
    """Phases 60-62 (module docstring). Returns {path: {kernel:
    launches}}."""
    from gamd_tpu_torch.tools import distill_rollout, profile_md, trace_force

    runs = {}
    t0 = time.perf_counter()
    logdir = tempfile.mkdtemp(prefix="gamd_trace_")
    try:
        traced = run_path("trace_force", runs, lambda: trace_force.main(
            ["float32", "pallas", "--calls", str(TRACE_CALLS), "--logdir",
             logdir]))
        trace_bytes = os.path.getsize(os.path.join(logdir, "trace.json"))
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    row3 = [k for k in traced["kernels"] if k.startswith("conv_tile_kernel")]
    say(f"phase 60: trace_force float32 pallas, {TRACE_CALLS} force calls: "
        f"{traced['us_per_step']:.1f} us of device time a step over "
        f"{len(traced['kernels'])} kernels listed, row 3's {row3}; "
        f"conv_msg_gather launches {runs['trace_force']['conv_msg_gather']};"
        f" Chrome trace {trace_bytes} bytes [{card}]")
    require(traced["where"] == "device" and row3,
            "trace_force lists no row 3 kernel")
    require(runs["trace_force"]["conv_msg_gather"] > 0,
            "trace_force did not launch row 3")
    t1 = time.perf_counter()

    profiled = profile_md.main(PROFILE_MD_ARGV)
    say(f"phase 61: profile_md {' '.join(PROFILE_MD_ARGV)}: "
        f"{json.dumps({k: round(v, 1) for k, v in profiled.items()})} us a "
        f"step (host clock) [{card}]")
    require(len(profiled) == 6 and all(math.isfinite(v) and v > 0
                                       for v in profiled.values()),
            "profile_md did not time its six bodies")
    t2 = time.perf_counter()

    out = tempfile.mkdtemp(prefix="gamd_distill_")
    try:
        seeds = run_path("distill_rollout", runs,
                         lambda: distill_rollout.main(
                             DISTILL_ARGV + ["--ckpt", DISTILL_CKPT,
                                             "--out", out]))
        params = LJParams()
        box, _ = lj_fluid_box(258, 0.5, params)
        worst, n_files = 0.0, 0
        for seed in seeds:
            for t in range(DISTILL_FRAMES):
                f = np.load(os.path.join(out, f"data_{seed}_{t}.npz"))
                n_files += 1
                require(all(np.isfinite(f[k]).all() for k in f.files),
                        f"non-finite distilled frame {seed}/{t}")
                want = (lj_forces_dense(torch.as_tensor(f["pos"],
                                                        device=dev),
                                        box, params)
                        / units.KJ_MOL_NM_TO_INTERNAL).cpu().numpy()
                worst = max(worst, float(np.abs(f["forces"] - want).max()
                                         / np.abs(want).max()))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    _, ckpt_cfg, _ = load_self_describing(DISTILL_CKPT)
    counts = runs["distill_rollout"]
    say(f"phase 62: distill_rollout {' '.join(DISTILL_ARGV)} on "
        f"{DISTILL_CKPT}: {n_files} frames, labels vs lj_forces_dense of "
        f"the written positions max |d| / max |F| {worst:.3e} (tolerance "
        f"{DISTILL_LABEL_RTOL}); launches {counts} (use_pallas "
        f"{ckpt_cfg.use_pallas}) [{card}]")
    require(n_files == DISTILL_SEEDS * DISTILL_FRAMES
            and worst <= DISTILL_LABEL_RTOL,
            "distilled labels disagree with the LJ oracle")
    require(counts["nhc_half_step"] > 0, "distill_rollout did not launch "
            "row 18")
    if ckpt_cfg.use_pallas:
        require(counts["conv_msg_gather"] > 0,
                "distill_rollout did not launch row 3")
    say(f"phases 60-62: {t1 - t0:.1f}, {t2 - t1:.1f} and "
        f"{time.perf_counter() - t2:.1f} s")
    return runs


def merge_launches(entries, runs):
    """Adds each run's non-zero counts ({path: {kernel name: count}}) to
    the entries' launches_by_path, keeping a path an entry already has,
    and sets each entry's launches to the sum over its paths."""
    by_name = {entry["name"]: entry for entry in entries}
    for path, counts in runs.items():
        for name, count in counts.items():
            if count and name in by_name:
                by_name[name]["launches_by_path"].setdefault(path, count)
    for entry in entries:
        entry["launches"] = sum(entry["launches_by_path"].values())


def main():
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    say("phase 0: card (nvidia-smi name, power.limit):")
    card = card_line()
    say(card)
    say(f"phase 0: torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)}, capability "
        f"{torch.cuda.get_device_capability(0)}; nvcc: {nvcc_release()}")

    info = build.build()
    by_source = {k: round(v, 2) for k, v in info["source_seconds"].items()}
    say(f"phase 1: kernels {'built' if info['built'] else 'reused'} in "
        f"{info['seconds']:.1f} s -> {info['path']}; each source's nvcc "
        f"(s from the start, all started together): "
        f"{json.dumps(by_source)}")
    for line in info["log"].splitlines():
        if "entry function" in line or "registers" in line \
                or "spill" in line:
            say(f"phase 1: ptxas: {line.strip()}")
    build.load_library()

    # -- phase 2: kernel against its plain version, full width ------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    system, model_cfg, md, state, pos = lj_slice(dev, seed=0)
    idx, mask, ovf = build_nbrs(pos, system, K_MODEL)
    require(not bool(ovf),
            "neighbour capacity overflow at the start frame")
    require(idx.shape == (system.n_atoms, K_MODEL),
            f"neighbour list of shape {tuple(idx.shape)}")

    unit = system.force_unit_to_internal
    mp = pack_params(state.params, model_cfg, force_std=state.force_stat.std,
                     force_mean=state.force_stat.safe_mean, unit=unit,
                     device=dev)
    h0 = torch.as_tensor(state.params["node_emb"], device=dev).expand(
        system.n_atoms, model_cfg.encoding_size).contiguous()
    args = (pos, idx, mask, h0, mp, system.box, system.cutoff,
            state.length_stat.safe_mean, state.length_stat.std)
    kw = dict(rbf_gap=model_cfg.rbf_gap)

    def kernel():
        return mega_forward(*args, **kw)

    def plain():
        return reference_forward(*args, **kw)

    before = mega_forward.launches
    f_kernel = kernel()
    torch.cuda.synchronize()
    require(mega_forward.launches == before + 1,
            "mega_forward did not launch")
    f_plain = plain()
    torch.cuda.synchronize()
    require(f_kernel.shape == f_plain.shape == (system.n_atoms, 3),
            f"forces of shape {tuple(f_kernel.shape)}")
    require(bool(torch.isfinite(f_kernel).all()),
            "non-finite kernel forces")
    err = (f_kernel - f_plain).abs()
    scale = float(f_plain.abs().std())
    max_err, mean_err = float(err.max()), float(err.mean())
    live_edges = int(refresh_mask(pos, system.box, system.cutoff, idx,
                                  mask).sum())
    say(f"phase 2: kernel vs plain at N={system.n_atoms} K={K_MODEL} "
        f"width {model_cfg.hidden_dim} L={model_cfg.conv_layers} "
        f"({live_edges} live edges): max |dF| {max_err:.3e}, mean "
        f"{mean_err:.3e}, std(F_plain) {scale:.3e}, max/std "
        f"{max_err / scale:.3e} (tolerance {TOLERANCE})")
    require(scale > 0 and max_err < TOLERANCE * scale,
            f"kernel disagrees with its plain version: {max_err} vs {scale}")
    kernel_ms = time_ms(kernel)
    plain_ms = time_ms(plain)
    # Both bounds count the work the forces need: live edges only (dead
    # slots are masked out of every sum) over the n_rbf live RBF rows. The
    # kernel's bound counts its edge products as the three bf16 passes it
    # runs on the tensor cores; the fp32 one, the same function on the
    # CUDA cores (the route of the fp32 kernel it replaced), is printed
    # beside it.
    needed = forward_flops(live_edges, system.n_atoms, model_cfg.n_rbf,
                           model_cfg)
    ops = forward_ops(live_edges, system.n_atoms, model_cfg.n_rbf,
                      model_cfg)
    bound_ms, bound_by = tc_bound(ops, system.n_atoms, K_MODEL, mp,
                                  model_cfg)
    fp32_ms, _ = bound(needed, system.n_atoms, K_MODEL, mp, model_cfg)
    say(f"phase 2: mega_forward {kernel_ms:.4f} ms/call, plain version "
        f"{plain_ms:.4f} ms/call, bound {bound_ms:.4f} ms ({bound_by}; "
        f"{ops[0] / 1e9:.4f} GFLOP of bf16 x 3 edge products at "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s and {ops[1] / 1e9:.4f} GFLOP fp32 "
        f"at {FP32_FLOPS / 1e12:.0f}, for {live_edges} live edges), kernel "
        f"at {bound_ms / kernel_ms:.2%} of it; fp32 CUDA-core bound of the "
        f"same function {fp32_ms:.4f} ms ({needed / 1e9:.4f} GFLOP); CUDA "
        f"events, median of 20 [{card}]")

    # -- phase 3: the per-step path ---------------------------------------
    ff = GNNForceField(state, system, model_cfg)
    sim = Simulation(ff.force_fn(megakernel=True), system, md,
                     k_model=K_MODEL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    mega_forward.launches = mega_md_steps.launches = 0
    st = sim.init_state(pos, rng=gen)
    warm = sim.run(st, WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(warm.state, PER_STEP_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    per_step_sps = PER_STEP_STEPS / seconds
    per_step_launches = {"mega_forward": mega_forward.launches,
                         "mega_md_steps": mega_md_steps.launches}
    force_calls = 1 + WARMUP_STEPS + PER_STEP_STEPS
    temps = res.thermo.temperature
    require(res.state.pos.shape == (system.n_atoms, 3),
            f"positions of shape {tuple(res.state.pos.shape)}")
    require(bool(torch.isfinite(res.state.pos).all()),
            "non-finite positions")
    require(bool(torch.isfinite(temps).all()),
            "non-finite temperature")
    require(not warm.overflow and not res.overflow,
            "neighbour overflow")
    require(per_step_launches == {"mega_forward": force_calls,
                                  "mega_md_steps": 0},
            f"launches {per_step_launches} for {force_calls} force calls")
    say(f"phase 3: per-step path, {PER_STEP_STEPS} Langevin steps (LJ-258, "
        f"GAMD-small, K={K_MODEL}, rebuild every {md.rebuild_every}) in "
        f"{seconds:.4f} s = {PER_STEP_STEPS / seconds:.1f} steps/s; mean T "
        f"{float(temps.mean()):.2f} K (untrained weights: no band); "
        f"launches {per_step_launches} for {force_calls} force calls "
        f"[{card}]")

    # The kernel still agrees with its plain version where MD took it.
    posw = space.wrap(res.state.pos, system.box)
    idx2, mask2, _ = build_nbrs(posw, system, K_MODEL)
    end_args = (posw, idx2, mask2) + args[3:]
    f_plain = reference_forward(*end_args, **kw)
    end_err = float((mega_forward(*end_args, **kw) - f_plain).abs().max())
    end_scale = float(f_plain.abs().std())
    require(end_err < TOLERANCE * end_scale,
            "disagreement at the end frame")
    say(f"phase 3: kernel vs plain at the last frame: max |dF|/std "
        f"{end_err / end_scale:.3e}")

    # -- phase 4: the window kernel against its plain version -------------
    sim_mega = Simulation(ff.force_fn(megakernel=True), system, md,
                          k_model=K_MODEL, megastep_fn=ff.megastep_fn())
    c1, hdt, c2col = sim_mega._baoab_constants()
    c2col = c2col.contiguous()
    masses = sim_mega.masses
    vel0 = maxwell_boltzmann_velocities(
        torch.Generator(dev).manual_seed(2), masses, md.temperature)
    seed = torch.tensor([20261017], dtype=torch.int32, device=dev)
    n_win = md.rebuild_every
    window_args = (pos, vel0, f_kernel, idx, mask, h0, mp, system.box,
                   system.cutoff, state.length_stat.safe_mean,
                   state.length_stat.std, masses)
    windows = {}
    for label, amp in (("noise off", torch.zeros_like(c2col)),
                       ("noise on", c2col)):
        wkw = dict(n_steps=n_win, c1=c1, hdt=hdt, c2col=amp, seed=seed,
                   rbf_gap=model_cfg.rbf_gap)
        before = mega_md_steps.launches
        out = mega_md_steps(*window_args, **wkw)
        torch.cuda.synchronize()
        require(mega_md_steps.launches == before + 1,
                f"mega_md_steps did not launch ({label})")
        ref = md_steps_reference(*window_args, **wkw)
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(t).all()) for t in out),
                f"non-finite window output ({label})")
        dx = float((out[0] - ref[0]).abs().max())
        dv = float((out[1] - ref[1]).abs().max())
        dke = float(((out[3] - ref[3]).abs() / ref[3].abs()).max())
        say(f"phase 4: window kernel vs plain, {label}, {n_win} steps at "
            f"N={system.n_atoms} K={K_MODEL}: max |dx| {dx:.3e} A, max "
            f"|dv| {dv:.3e} A/t0 (tolerance {WINDOW_ATOL}), max ke rel "
            f"{dke:.3e} (tolerance {WINDOW_KE_RTOL})")
        require(dx <= WINDOW_ATOL and dv <= WINDOW_ATOL,
                f"window disagrees with its plain version ({label})")
        require(dke <= WINDOW_KE_RTOL, f"window KE disagrees ({label})")
        windows[label] = (out, max(dx, dv), wkw)
    spread = float((windows["noise on"][0][0]
                    - windows["noise off"][0][0]).abs().max())
    say(f"phase 4: noise on vs off, max |dx| {spread:.3e} A (must exceed "
        "1e-3: the noise is live)")
    require(spread > 1e-3, "the window's noise is not live")
    window_err = max(w[1] for w in windows.values())
    wkw = windows["noise on"][2]
    window_ms = time_ms(lambda: mega_md_steps(*window_args, **wkw), reps=10)
    window_plain_ms = time_ms(
        lambda: md_steps_reference(*window_args, **wkw), reps=10)
    window_bound_ms, window_bound_by = tc_bound(
        (n_win * ops[0], n_win * ops[1]), system.n_atoms, K_MODEL, mp,
        model_cfg, state_io=True)
    window_fp32_ms, _ = bound(n_win * needed, system.n_atoms, K_MODEL, mp,
                              model_cfg, state_io=True)
    say(f"phase 4: mega_md_steps {window_ms:.4f} ms/window ("
        f"{window_ms / n_win:.4f} ms/step), plain version "
        f"{window_plain_ms:.4f} ms/window, bound {window_bound_ms:.4f} ms "
        f"({window_bound_by}; {n_win} x the start frame's {ops[0] / 1e9:.4f}"
        f" GFLOP bf16 x 3 and {ops[1] / 1e9:.4f} GFLOP fp32), kernel at "
        f"{window_bound_ms / window_ms:.2%} of it; fp32 CUDA-core bound "
        f"{window_fp32_ms:.4f} ms; CUDA events, median of 10 [{card}]")

    # -- phase 5: the megastep path --------------------------------------
    gen.manual_seed(1)
    mega_forward.launches = mega_md_steps.launches = 0
    st = sim_mega.init_state(pos, rng=gen)
    warm = sim_mega.run(st, WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim_mega.run(warm.state, MEGASTEP_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    mega_launches = {"mega_forward": mega_forward.launches,
                     "mega_md_steps": mega_md_steps.launches}
    n_windows = (WARMUP_STEPS + MEGASTEP_STEPS) // md.rebuild_every
    temps = res.thermo.temperature
    mean_t = float(temps.mean())
    require(res.state.pos.shape == (system.n_atoms, 3),
            f"positions of shape {tuple(res.state.pos.shape)}")
    require(bool(torch.isfinite(res.state.pos).all()),
            "non-finite positions (megastep)")
    require(bool(torch.isfinite(temps).all()),
            "non-finite temperature (megastep)")
    require(temps.shape == (MEGASTEP_STEPS,),
            f"thermo of shape {tuple(temps.shape)}")
    require(not warm.overflow and not res.overflow,
            "neighbour overflow (megastep)")
    require(mega_launches == {"mega_forward": 1,
                              "mega_md_steps": n_windows},
            f"launches {mega_launches}: want 1 mega_forward (the initial "
            f"force) and {n_windows} mega_md_steps (one per window)")
    say(f"phase 5: megastep path, {MEGASTEP_STEPS} Langevin steps in "
        f"{seconds:.4f} s = {MEGASTEP_STEPS / seconds:.1f} steps/s; mean T "
        f"{mean_t:.2f} K (band 100 +- {T_BAND} K); launches "
        f"{mega_launches} for {n_windows} windows [{card}]")
    require(abs(mean_t - md.temperature) <= T_BAND,
            f"mean temperature {mean_t} K outside 100 +- {T_BAND} K")

    conv_kernels = training_phases(dev, card)
    encoder_kernel, deploy_launches, traj = deployment_phases(dev, card)
    banded_kernel, live_launches, live_entry = large_n_phases(dev, card)
    encoder_kernel["launches_by_path"].update(live_launches)
    encoder_kernel.update(live_entry)
    nhc_kernels = nhc_kernel_phases(dev, card)
    integrator_launches = integrator_phases(dev, card, traj, per_step_sps)
    op_kernels = op_library_phases(dev, card)
    mxu_kernels, bench_mxu_forwards = mxu_probe_phases(dev, card)
    gather_kernels, probe_lines, form_launches = gather_probe_phases(dev,
                                                                     card)
    form_kernels = gather_form_phase(dev, card, probe_lines, form_launches)
    forward_r8, window_r8, replica_launches = replica_phases(
        dev, card, kernel_ms, window_ms)
    stages = forward_stage_phases(dev, card)
    water_entries, water_launches, water_ctx = water_phases(dev, card)
    water_banded, banded_launches = banded_water_phase(dev, card, water_ctx)
    encoder_kernel.update(water_banded)
    ablate_checks, ablate_launches = ablate_phase(
        dev, card, window_args, windows["noise off"][2])
    act_fields, act_launches = activation_phase(
        dev, card, args, kw, window_args, windows["noise off"][2])

    root = tempfile.mkdtemp(prefix="gamd_verify_")
    try:
        gen_launches = generation_phase(dev, card, root)
        verify_launches = verify_loop_phase(dev, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    water_train_launches = water_training_phase(dev, card, water_ctx)
    protocol_launches = water_protocol_phases(dev, card)
    dft_fields, dft_launches = dft_phases(dev, card)
    t_dp = time.perf_counter()
    dp_launches = data_parallel_phase(dev, card)
    item8_launches = item8_phases(dev, card)
    say(f"phases 59-62: {time.perf_counter() - t_dp:.1f} s")

    # -- the kernels line, the result line ---------------------------------
    by_path = {name: {"per_step": per_step_launches[name],
                      "megastep": mega_launches[name]}
               for name in per_step_launches}
    by_path["mega_forward"]["bench_mxu"] = bench_mxu_forwards
    kernels = [{
        "name": "mega_forward",
        "route": "cuda",
        "source": "gamd_tpu_torch/csrc/mega_forward.cu",
        "replaces": "gamd_tpu/ops/pallas_model.py:677",
        "launches_by_path": by_path["mega_forward"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "r8": forward_r8,
        "stages": stages,
    }, {
        "name": "mega_md_steps",
        "route": "cuda",
        "source": "gamd_tpu_torch/csrc/mega_md_steps.cu",
        "replaces": "gamd_tpu/ops/pallas_model.py:707",
        "launches_by_path": by_path["mega_md_steps"],
        "max_abs_err": window_err,
        "ms": window_ms,
        "plain_ms": window_plain_ms,
        "bound_ms": window_bound_ms,
        "bound_by": window_bound_by,
        "library_ms": None,
        "r8": window_r8,
    }, *conv_kernels, encoder_kernel, banded_kernel, *nhc_kernels,
        *op_kernels, *mxu_kernels, *gather_kernels, *form_kernels]
    for entry in kernels[:2]:
        entry["water"] = water_entries[entry["name"]]
    for entry in conv_kernels:
        entry["dft"] = dft_fields[entry["name"]]
    kernels[0]["activations"] = act_fields["forward"]
    kernels[1]["activations"] = act_fields["window"]
    kernels[1]["ablate"] = ablate_checks
    merge_launches(kernels, {**deploy_launches, **integrator_launches,
                             **replica_launches, **water_launches,
                             **banded_launches, **ablate_launches,
                             **act_launches, **gen_launches,
                             **verify_launches, **water_train_launches,
                             **protocol_launches, **dft_launches,
                             **dp_launches, **item8_launches})
    say("kernels: " + json.dumps([k["name"] for k in kernels]))
    say(json.dumps({"kernels": kernels}))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
