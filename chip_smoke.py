"""Smoke run of the PyTorch/CUDA port (gamd_tpu_torch) on one NVIDIA H100.

Drives the port's first slice, GNN-driven BAOAB Langevin MD of the
258-atom LJ fluid with the full-width GAMD-small model (seeded, untrained
weights), with every force call through the hand-written CUDA kernel
mega_forward. Phases, one flushed line or more each:

  0. card (nvidia-smi name and power limit), torch and nvcc versions;
  1. build the CUDA sources with nvcc (or reuse the hashed library);
  2. the kernel against its plain PyTorch version at full width;
  3. the slice: Simulation(GNNForceField.force_fn(megakernel=True)),
     20 warm-up and 400 timed steps, with the kernel's launch count;
  4. the kernels line (JSON), then the result line (JSON) last.

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
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.neighbors.dense import build_nbrs, refresh_mask
from gamd_tpu_torch.ops import build
from gamd_tpu_torch.ops.mega import mega_forward, pack_params, \
    reference_forward
from gamd_tpu_torch.tools.lj_slice import K_MODEL, lj_slice
from gamd_tpu_torch.train.forcefield import GNNForceField

DEADLINE_S = 600          # the whole script, build included
WARMUP_STEPS, TIMED_STEPS = 20, 400
TOLERANCE = 5e-3          # max |F_kernel - F_plain| / std(F_plain)
# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def say(*parts):
    print(*parts, flush=True)


def require(ok, message):
    """A failed check of the run: raise (kept under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {message}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def nvcc_release():
    out = subprocess.run([build.find_nvcc(), "--version"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def time_ms(fn, reps=20):
    """Median of `reps` single-call device times (CUDA events), in ms."""
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


def bound(flops, n, k, mp, model_cfg):
    """(least ms, "operations" or "bytes") of one forward on this card:
    `flops` against the fp32 peak, and each input read once plus the
    output written once against HBM."""
    weight_bytes = sum(t.numel() * t.element_size() for t in mp)
    io_bytes = n * 3 * 4 + n * k * (4 + 1) \
        + n * model_cfg.encoding_size * 4 + n * 3 * 4
    t_ops = flops / FP32_FLOPS * 1e3
    t_bytes = (weight_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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

    # -- phase 3: the slice ----------------------------------------------
    mega_forward.launches = 0
    ff = GNNForceField(state, system, model_cfg)
    sim = Simulation(ff.force_fn(megakernel=True), system, md,
                     k_model=K_MODEL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    st = sim.init_state(pos, rng=gen)
    warm = sim.run(st, WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(warm.state, TIMED_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = mega_forward.launches
    force_calls = 1 + WARMUP_STEPS + TIMED_STEPS
    temps = res.thermo.temperature
    require(res.state.pos.shape == (system.n_atoms, 3),
            f"positions of shape {tuple(res.state.pos.shape)}")
    require(bool(torch.isfinite(res.state.pos).all()),
            "non-finite positions")
    require(bool(torch.isfinite(temps).all()),
            "non-finite temperature")
    require(not warm.overflow and not res.overflow,
            "neighbour overflow")
    require(launches == force_calls,
            f"{launches} kernel launches for {force_calls} force calls")
    say(f"phase 3: {TIMED_STEPS} Langevin steps (LJ-258, GAMD-small, "
        f"K={K_MODEL}, rebuild every {md.rebuild_every}) in {seconds:.4f} s"
        f" = {TIMED_STEPS / seconds:.1f} steps/s; mean T "
        f"{float(temps.mean()):.2f} K (untrained weights: no band); "
        f"mega_forward launches {launches} for {force_calls} force calls "
        f"[{card}]")

    # The kernel still agrees with its plain version where MD took it.
    posw = space.wrap(res.state.pos, system.box)
    idx2, mask2, _ = build_nbrs(posw, system, K_MODEL)
    args = (posw, idx2, mask2) + args[3:]
    f_plain = plain()
    end_err = float((kernel() - f_plain).abs().max())
    end_scale = float(f_plain.abs().std())
    require(end_err < TOLERANCE * end_scale,
            "disagreement at the end frame")
    say(f"phase 3: kernel vs plain at the last frame: max |dF|/std "
        f"{end_err / end_scale:.3e}")

    # -- phase 4: kernels line, result line ------------------------------
    say('kernels: ["mega_forward"]')
    say(json.dumps({"kernels": [{
        "name": "mega_forward",
        "route": "cuda",
        "source": "gamd_tpu_torch/csrc/mega_forward.cu",
        "replaces": "gamd_tpu/ops/pallas_model.py:677",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    say(f"phase 4: total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
