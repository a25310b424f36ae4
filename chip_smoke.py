"""Smoke run of the PyTorch/CUDA port (gamd_tpu_torch) on one NVIDIA H100.

Drives the port's two paths of GNN-driven BAOAB Langevin MD of the
258-atom LJ fluid with the full-width GAMD-small model (seeded, untrained
weights): per step, every force call through the hand-written CUDA kernel
mega_forward; megastep, every 20-step window through the hand-written CUDA
kernel mega_md_steps (Philox noise and the forward inside). Phases, one
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
  6. the kernels line (JSON), then the result line (JSON) last.

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
from gamd_tpu_torch.neighbors.dense import build_nbrs, refresh_mask
from gamd_tpu_torch.ops import build
from gamd_tpu_torch.ops.mega import (md_steps_reference, mega_forward,
                                     mega_md_steps, pack_params,
                                     reference_forward)
from gamd_tpu_torch.tools.lj_slice import K_MODEL, lj_slice
from gamd_tpu_torch.train.forcefield import GNNForceField

DEADLINE_S = 600          # the whole script, build included
WARMUP_STEPS = 20
PER_STEP_STEPS, MEGASTEP_STEPS = 200, 400     # timed steps of each path
TOLERANCE = 5e-3          # max |F_kernel - F_plain| / std(F_plain)
WINDOW_ATOL = 2e-4        # max |dx| (A) and |dv| (A/t0), kernel vs plain
WINDOW_KE_RTOL = 1e-4     # ke per step, kernel vs plain
T_BAND = 10.0             # |mean T - 100 K| of the megastep path
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

    # -- phase 6: kernels line, result line ------------------------------
    by_path = {name: {"per_step": per_step_launches[name],
                      "megastep": mega_launches[name]}
               for name in per_step_launches}
    say('kernels: ["mega_forward", "mega_md_steps"]')
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
    }]}))
    say(f"phase 6: total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
