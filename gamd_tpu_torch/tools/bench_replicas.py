"""Aggregate multi-replica GNN-MD throughput on one card: the port of
scripts/bench_replicas.py, the JAX package's secondary benchmark.

One 258-atom chain cannot fill the card; R independent replicas stepped in
lockstep measure its aggregate MD capacity, the number that matters for
sampling (R trajectories for RDF statistics, replica exchange). LJ-258
(cutoff 7.5 A + 0.5 A skin, K=64 built and sliced to the nearest
GAMD_BENCH_K_MODEL=48; 0 keeps all 64), GAMD-small with seeded untrained
weights (init_params seed 0), rebuilt every 20 steps, the FCC start of
lj_fluid_box. GAMD_BENCH_INTEGRATOR=langevin (the default) runs every
20-step window of all replicas as one call of the CUDA mega_md_steps;
GAMD_BENCH_INTEGRATOR=nose_hoover runs NHC per step, every force call one
mega_forward over all replicas and every chain half-step one
nhc_half_step. One untimed run, then the mean of 3 timed runs of n_steps.

    python3 -m gamd_tpu_torch.tools.bench_replicas [n_replicas] [n_steps]

(defaults 8 and 500) prints the card's name and power limit, then one JSON
line: {"metric", "value" (aggregate steps/s), "unit", "per_replica"}.
Needs a CUDA card; `--cpu` runs the plain versions on the CPU (slow at
full width).
"""

import argparse
import json
import os
import time

import torch

from gamd_tpu_torch.core.config import MDConfig, get_preset, lj_model_config
from gamd_tpu_torch.core.device import card_line, resolve_device
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.physics.lennard_jones import lj_fluid_box
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.state import init_params

REPS = 3


def parse_args(argv=None):
    """The script's positional n_replicas (8) and n_steps (500), and
    --cpu."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_replicas", type=int, nargs="?", default=8)
    ap.add_argument("n_steps", type=int, nargs="?", default=500)
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions on the CPU")
    return ap.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Runs the benchmark; returns the JSON line's dict."""
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(card_line() if dev.type == "cuda" else
          f"device {dev.type}: plain PyTorch versions, not a card",
          flush=True)
    system = get_preset("lj", skin=0.5, nbr_capacity=64)
    model_cfg = lj_model_config()
    ff = GNNForceField(init_params(model_cfg, system, seed=0), system,
                       model_cfg, device=dev)
    integrator = os.environ.get("GAMD_BENCH_INTEGRATOR", "langevin")
    md = MDConfig(integrator=integrator, temperature=system.temperature,
                  friction_per_ps=25.0, rebuild_every=20)
    k_model = int(os.environ.get("GAMD_BENCH_K_MODEL", "48")) or None
    sim = Simulation(ff.force_fn(megakernel=True), system, md,
                     k_model=k_model,
                     megastep_fn=(ff.megastep_fn()
                                  if integrator == "langevin" else None),
                     device=dev)
    _, pos0 = lj_fluid_box(system.n_atoms, 0.5)
    states = sim.init_replicas(pos0, args.n_replicas,
                               rng=torch.Generator(dev).manual_seed(1))

    result = sim.run_replicas(states, args.n_steps)        # warm-up
    _sync(dev)
    if result.overflow:
        raise RuntimeError("neighbour capacity overflow in bench_replicas")
    if not bool(torch.isfinite(result.state.pos).all()):
        raise RuntimeError("non-finite positions in bench_replicas")
    t0 = time.perf_counter()
    for _ in range(REPS):
        result = sim.run_replicas(states, args.n_steps)
        _sync(dev)
    seconds = (time.perf_counter() - t0) / REPS
    out = {
        "metric": f"aggregate GNN-MD steps/s ({args.n_replicas} replicas x "
                  f"{system.n_atoms}-atom LJ)",
        "value": round(args.n_replicas * args.n_steps / seconds, 1),
        "unit": "steps/s",
        "per_replica": round(args.n_steps / seconds, 1),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
