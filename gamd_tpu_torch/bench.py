"""Headline benchmark of the port: fused GNN-MD throughput for 258-atom LJ
on one card, the workload of the JAX package's bench.py.

LJ-258 (cutoff 7.5 A + 0.5 A skin, K=64 built and sliced to the nearest
GAMD_BENCH_K_MODEL=48), GAMD-small with seeded untrained weights, BAOAB
Langevin at 100 K, 2 fs, 25/ps, rebuilt every 20 steps. With
GAMD_BENCH_MEGASTEP unset or 1 each 20-step window is one call of the CUDA
mega_md_steps; GAMD_BENCH_MEGASTEP=0 runs one mega_forward per step
instead. One warm-up run of 4,000 steps, then the median of 5 timed runs.

    python3 -m gamd_tpu_torch.bench

prints the card's name and power limit, then, last, bench.py's one JSON
line: {"metric", "value" (steps/s), "unit", "vs_baseline"}.
"""

import json
import os
import time

import numpy as np
import torch

from gamd_tpu_torch.core.config import MDConfig, get_preset, lj_model_config
from gamd_tpu_torch.core.device import card_line, resolve_device
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.physics.lennard_jones import lj_fluid_box
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.state import init_params

BASELINE_STEPS_PER_S = 1e5
METRIC = "fused GNN-MD steps/s (258-atom LJ, GAMD-small + BAOAB)"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(steps: int = 4000, reps: int = 5, device="cuda"):
    """Run the benchmark; returns the result dict it prints last."""
    dev = resolve_device(device)
    megastep = os.environ.get("GAMD_BENCH_MEGASTEP", "1") != "0"
    k_env = os.environ.get("GAMD_BENCH_K_MODEL", "48")
    k_model = int(k_env) if k_env else None
    print(card_line() if dev.type == "cuda" else
          f"device {dev.type}: plain PyTorch versions, not a card",
          flush=True)

    system = get_preset("lj", skin=0.5, nbr_capacity=64)
    model_cfg = lj_model_config()
    ff = GNNForceField(init_params(model_cfg, system, seed=0), system,
                       model_cfg, device=dev)
    md = MDConfig(integrator="langevin", temperature=system.temperature,
                  dt_fs=system.dt_fs, friction_per_ps=system.friction_per_ps,
                  rebuild_every=20)
    sim = Simulation(ff.force_fn(megakernel=True), system, md,
                     k_model=k_model,
                     megastep_fn=ff.megastep_fn() if megastep else None,
                     device=dev)
    _, pos0 = lj_fluid_box(system.n_atoms, 0.5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    st = sim.init_state(pos0, rng=gen)

    result = sim.run(st, steps)                  # warm-up
    _sync(dev)
    if result.overflow:
        raise RuntimeError("neighbour capacity overflow in bench")
    if not bool(torch.isfinite(result.state.pos).all()):
        raise RuntimeError("non-finite positions in bench")

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        result = sim.run(st, steps)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    steps_per_s = steps / float(np.median(times))
    out = {
        "metric": METRIC,
        "value": round(steps_per_s, 1),
        "unit": "steps/s",
        "vs_baseline": round(steps_per_s / BASELINE_STEPS_PER_S, 4),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
