"""Smoke run of the PyTorch/CUDA port (gamd_tpu_torch) on one NVIDIA H100.

Drives the port's two paths of GNN-driven BAOAB Langevin MD of the
258-atom LJ fluid with the full-width GAMD-small model (seeded, untrained
weights): per step, every force call through the hand-written CUDA kernel
mega_forward; megastep, every 20-step window through the hand-written CUDA
kernel mega_md_steps (Philox noise and the forward inside). Then its
training path: LJ-258 training steps of GAMD-small (use_pallas, as
`train_gamd.py --system lj --use_pallas --use_layer_norm --relabel`), every
conv layer's edge pipeline through the hand-written CUDA kernel pair
conv_msg_gather (forward) and conv_msg_gather_bwd (backward). Phases, one
flushed line or more each:

  0. card (nvidia-smi name and power limit), torch and nvcc versions;
  1. build the CUDA sources with nvcc (or reuse the hashed library);
  2. mega_forward against its plain PyTorch version at full width;
  3. the per-step path: Simulation(GNNForceField.force_fn(megakernel=True)),
     20 warm-up and 200 timed steps, with the kernels' launch counts;
  4. mega_md_steps against its plain version: one 20-step window from the
     start frame, noise off and on;
  5. the megastep path: Simulation(..., megastep_fn=ff.megastep_fn()),
     20 warm-up and 400 timed steps, with the kernels' launch counts;
  6. conv_msg_gather against its plain version on layer 0's real inputs
     (start frame) and layer 1's (a displaced frame, after one conv layer,
     whose rows differ) at the training slice's shapes (N=258, K=96,
     widths 128), timed on layer 0's;
  7. conv_msg_gather_bwd against autograd through the plain version on
     the same two inputs, with a seeded cotangent, all 12 grads;
  8. one training step, kernel path against plain path, from the same
     seeded state and generator: the same augmented positions, loss,
     grads and parameters after Adam;
  9. the training path: 30 steps on 4 relabelled frames through the
     kernel pair (and the plain path, for its time), with the launch
     counts, the loss of each step and the loss falling;
 10. the kernels line (JSON), then the result line (JSON) last.

Run from the repository root: `python3 chip_smoke.py`. It needs one CUDA
card; without one it exits non-zero and prints no result. Any failed check
raises, and a hang ends with a traceback at the deadline.
"""

import faulthandler
import json
import subprocess
import sys
import time

import numpy as np
import torch

from gamd_tpu_torch.core import space
from gamd_tpu_torch.core.device import card_line
from gamd_tpu_torch.md.integrators import maxwell_boltzmann_velocities
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.models.normalizer import init_stat, update_stat
from gamd_tpu_torch.neighbors.dense import build_nbrs, refresh_mask
from gamd_tpu_torch.ops import build
from gamd_tpu_torch.ops.conv_gather import (batched_reference,
                                            fused_conv_gather_message)
from gamd_tpu_torch.ops.mega import (md_steps_reference, mega_forward,
                                     mega_md_steps, pack_params,
                                     reference_forward)
from gamd_tpu_torch.tools.lj_slice import K_MODEL, lj_slice
from gamd_tpu_torch.tools.lj_train_slice import lj_train_slice
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.loop import (edge_distances, make_train_step,
                                       search_batch)
from gamd_tpu_torch.train.state import create_train_state

DEADLINE_S = 600          # the whole script, build included
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
# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


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


def time_ms(fn, reps=20):
    """Median of `reps` single-call device times (CUDA events), in ms, after
    3 untimed calls."""
    for _ in range(3):
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


def roofline(flops, nbytes):
    """(least ms, "operations" or "bytes"): `flops` against the fp32 peak,
    `nbytes` against HBM, the larger of the two."""
    t_ops = flops / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_flops(live_edges, width=128):
    """fp32 operations of one conv layer's edge pipeline over `live_edges`
    edges: four width x width products (2 per multiply-add) and the gated
    masked sum; activations not counted."""
    return live_edges * (4 * 2 * width * width + 2 * width)


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


def bound(flops, n, k, mp, model_cfg, state_io=False):
    """(least ms, "operations" or "bytes") of one forward, or with
    state_io of one MD window, on this card: `flops` against the fp32
    peak, and each input read once plus each output written once against
    HBM (a window also reads velocities, forces, masses, noise amplitudes
    and the seed, and writes positions, velocities, forces and the KE)."""
    weight_bytes = sum(t.numel() * t.element_size() for t in mp)
    io_bytes = n * 3 * 4 + n * k * (4 + 1) \
        + n * model_cfg.encoding_size * 4 + n * 3 * 4
    if state_io:
        io_bytes += 2 * n * 3 * 4 + 2 * n * 4 + 4 + 3 * n * 3 * 4
    return roofline(flops, weight_bytes + io_bytes)


def conv_inputs(dev):
    """The conv kernel pair's real inputs at the training slice, from
    init_params(seed=0) GAMD-small, the dense list at 7.5 A with K=96 and
    the edge-length scaler fitted on the frame: layer 0's on the start
    frame (the encoded edges, hn, src and dst codes; every row of hn is the
    node embedding) and layer 1's on frame 1 (the lattice displaced by
    0.1 A, after one conv layer, so that rows differ). Returns (args,
    live edges) for each."""
    sl = lj_train_slice(dev)
    system = sl.system
    model = create_train_state(sl.model_cfg, system, sl.train_cfg, 1,
                               seed=0, device=dev).model
    cases = []
    for frame, layer in ((0, 0), (1, 1)):
        pos = space.wrap(sl.batches[frame]["pos"], system.box)
        idx, mask, ovf = search_batch(pos, system.box, system.cutoff,
                                      system.nbr_capacity)
        require(not bool(ovf), "neighbour overflow at the training frame")
        stat = update_stat(init_stat(dev), edge_distances(pos, idx,
                                                          system.box),
                           mask=mask)
        block = model.graph_conv
        with torch.no_grad():
            e = model.encode_edges(pos, idx, system.box, stat.safe_mean,
                                   stat.std)
            h = model.node_emb.expand(1, system.n_atoms, -1)
            for below in range(layer):
                h = getattr(block, f"conv_{below}")(
                    h, getattr(block, f"norm_{below}")(h), e, idx, mask)
            conv = getattr(block, f"conv_{layer}")
            hn = getattr(block, f"norm_{layer}")(h)
            src, dst = conv.src_affine(hn), conv.dst_affine(hn)
        weights = [t.detach() for t in (
            conv.edge_affine_w1, conv.edge_affine_b1, conv.edge_affine_w2,
            conv.edge_affine_b2, conv.theta_edge_w1, conv.theta_edge_b1,
            conv.theta_edge_w2, conv.theta_edge_b2)]
        cases.append(((e, idx, mask, hn, src, dst, *weights),
                      int(mask.sum())))
    return cases


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


def training_phases(dev, card):
    """Phases 6-9 (module docstring). Returns the two kernels' entries of
    the kernels line."""
    fused = fused_conv_gather_message

    # -- phase 6: the forward kernel against its plain version ----------
    cases = conv_inputs(dev)
    fwd_err = 0.0
    for layer, (case, case_live) in enumerate(cases):
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
    (args, live), _ = cases
    n, k = args[1].shape[1:]
    with torch.no_grad():
        fwd_ms = time_ms(lambda: fused(*args))
        fwd_plain_ms = time_ms(lambda: batched_reference(*args))
    fwd_bound, fwd_by = roofline(conv_flops(live), conv_bytes(n, k))
    say(f"phase 6: conv_msg_gather {fwd_ms:.4f} ms/call, plain "
        f"{fwd_plain_ms:.4f} ms/call, bound {fwd_bound:.4f} ms ({fwd_by}; "
        f"{conv_flops(live) / 1e9:.4f} GFLOP for {live} live edges), "
        f"kernel at {fwd_bound / fwd_ms:.2%} of it; CUDA events, median of "
        f"20 [{card}]")

    # -- phase 7: the backward kernel against autograd through plain -----
    bwd_err = 0.0
    for layer, (case, _) in enumerate(cases):
        g = torch.randn((1, n, case[3].shape[-1]), device=dev,
                        generator=torch.Generator(dev).manual_seed(7))
        before = fused.backward_launches
        out_k, leaves_k, grads_k = grads_of(fused, case, g)
        torch.cuda.synchronize()
        require(fused.backward_launches == before + 1,
                "conv_msg_gather_bwd did not launch")
        out_p, leaves_p, grads_p = grads_of(batched_reference, case, g)
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
    bwd_ms = time_ms(lambda: torch.autograd.grad(out_k, leaves_k, g,
                                                 retain_graph=True))
    bwd_plain_ms = time_ms(lambda: torch.autograd.grad(out_p, leaves_p, g,
                                                       retain_graph=True))
    bwd_flops = 3 * conv_flops(live)
    bwd_bound, bwd_by = roofline(bwd_flops, conv_bytes(n, k, backward=True))
    say(f"phase 7: conv_msg_gather_bwd {bwd_ms:.4f} ms/call (with the "
        f"wrapper's source sort and weight transposes), plain autograd "
        f"{bwd_plain_ms:.4f} ms/call, bound {bwd_bound:.4f} ms ({bwd_by}; "
        f"{bwd_flops / 1e9:.4f} GFLOP: recompute, input and weight grads), "
        f"kernel at {bwd_bound / bwd_ms:.2%} of it (tolerance "
        f"{CONV_GRAD_RTOL} x max per grad); CUDA events, median of 20 "
        f"[{card}]")
    del out_k, out_p, leaves_k, leaves_p, grads_k, grads_p, timed

    # -- phase 8: one training step, kernel path against plain path ------
    runs = {flag: train_steps(dev, flag, 1) for flag in (True, False)}
    (sk, mk, _, sl), (sp, mp_, _, _) = runs[True], runs[False]
    mk, mp_ = mk[0], mp_[0]
    require(torch.equal(mk["pos"], mp_["pos"]),
            "the two paths drew different augmentations")
    loss_rel = abs(float(mk["loss"]) - float(mp_["loss"])) \
        / abs(float(mp_["loss"]))
    grad_rel = max(
        float((a.grad - b.grad).abs().max()) / float(b.grad.abs().max())
        for a, b in zip(sk.model.parameters(), sp.model.parameters()))
    diffs = torch.cat([(a - b).detach().abs().reshape(-1) for a, b in
                       zip(sk.model.parameters(), sp.model.parameters())])
    share = float((diffs <= PARAM_ATOL).float().mean())
    say(f"phase 8: one training step, kernel vs plain path, same seed: "
        f"augmented positions identical; loss {float(mk['loss']):.6f} vs "
        f"{float(mp_['loss']):.6f} (rel {loss_rel:.3e}); worst grad max |d| "
        f"/ max |grad| {grad_rel:.3e}; params after Adam: "
        f"{share:.5%} within {PARAM_ATOL}, max |d| "
        f"{float(diffs.max()):.3e} (bound 2 lr = {2 * sl.train_cfg.lr})")
    require(loss_rel <= 1e-4, "the two paths' losses disagree")
    require(grad_rel <= CONV_GRAD_RTOL, "the two paths' grads disagree")
    require(share >= PARAM_SHARE and float(diffs.max())
            <= 2 * sl.train_cfg.lr, "the two paths' parameters disagree")
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
        "bound_ms": fwd_bound, "bound_by": fwd_by,
    }, {
        "name": "conv_msg_gather_bwd", **common,
        "source": "gamd_tpu_torch/csrc/conv_msg_gather_bwd.cu",
        "replaces": "gamd_tpu/ops/pallas_mp.py:530",
        "launches": train_launches[1],
        "launches_by_path": {"train": train_launches[1]},
        "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound, "bound_by": bwd_by,
    }]


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
    say(f"phase 1: kernels {'built' if info['built'] else 'reused'} in "
        f"{info['seconds']:.1f} s -> {info['path']}")
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
    # The bound counts the work the forces need: live edges only (dead
    # slots are masked out of every sum) over the n_rbf live RBF rows. The
    # kernel computes every slot over the 128 zero-padded rows; that count
    # is printed beside it, as work a better kernel would skip.
    needed = forward_flops(live_edges, system.n_atoms, model_cfg.n_rbf,
                           model_cfg)
    padded = forward_flops(system.n_atoms * K_MODEL, system.n_atoms,
                           mp.w_rbf.shape[0], model_cfg)
    bound_ms, bound_by = bound(needed, system.n_atoms, K_MODEL, mp,
                               model_cfg)
    say(f"phase 2: mega_forward {kernel_ms:.4f} ms/call, plain version "
        f"{plain_ms:.4f} ms/call, bound {bound_ms:.4f} ms ({bound_by}; "
        f"{needed / 1e9:.4f} GFLOP needed for {live_edges} live edges, "
        f"kernel at {bound_ms / kernel_ms:.2%} of it; it computes "
        f"{padded / 1e9:.4f} GFLOP over all slots); CUDA events, "
        f"median of 20 [{card}]")

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
    window_bound_ms, window_bound_by = bound(n_win * needed, system.n_atoms,
                                             K_MODEL, mp, model_cfg,
                                             state_io=True)
    say(f"phase 4: mega_md_steps {window_ms:.4f} ms/window ("
        f"{window_ms / n_win:.4f} ms/step), plain version "
        f"{window_plain_ms:.4f} ms/window, bound {window_bound_ms:.4f} ms "
        f"({window_bound_by}; {n_win} x {needed / 1e9:.4f} GFLOP at the "
        f"start frame), kernel at {window_bound_ms / window_ms:.2%} of it; "
        f"CUDA events, median of 10 [{card}]")

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

    # -- phase 10: kernels line, result line ------------------------------
    by_path = {name: {"per_step": per_step_launches[name],
                      "megastep": mega_launches[name]}
               for name in per_step_launches}
    say('kernels: ["mega_forward", "mega_md_steps", "conv_msg_gather", '
        '"conv_msg_gather_bwd"]')
    say(json.dumps({"kernels": [{
        "name": "mega_forward",
        "route": "cuda",
        "source": "gamd_tpu_torch/csrc/mega_forward.cu",
        "replaces": "gamd_tpu/ops/pallas_model.py:677",
        "launches": sum(by_path["mega_forward"].values()),
        "launches_by_path": by_path["mega_forward"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "mega_md_steps",
        "route": "cuda",
        "source": "gamd_tpu_torch/csrc/mega_md_steps.cu",
        "replaces": "gamd_tpu/ops/pallas_model.py:707",
        "launches": sum(by_path["mega_md_steps"].values()),
        "launches_by_path": by_path["mega_md_steps"],
        "max_abs_err": window_err,
        "ms": window_ms,
        "plain_ms": window_plain_ms,
        "bound_ms": window_bound_ms,
        "bound_by": window_bound_by,
        "library_ms": None,
    }, *conv_kernels]}))
    say(f"phase 10: total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
