"""Megastep stage decomposition by ablation: the port of
scripts/bench_ablate.py, with its flags less the TPU-only --tile_n.

It runs the port's bench workload (gamd_tpu_torch/bench.py: LJ-258,
GAMD-small with seeded weights, BAOAB Langevin at 100 K, 2 fs, 25/ps, the
megastep at K=48, 20-step windows) once per stage, with that stage of the
window kernel switched off (ops/mega.py::ABLATE_STAGES through
GNNForceField.megastep_fn(ablate=...), so csrc/mega_md_steps.cu runs each
ablated form), and prices the stage as an end-to-end delta:

    stage cost = t_full - t_ablated   (us a step)

Numerics under any switch are meant to be wrong (a stage becomes a cheap
stand-in of the same shape); no physics is checked. Each stage's floor is
priced on the card's basis from tools/bounds.py, the counts chip_smoke.py
prices the forward with: the stage's live-edge products as bf16 x 3 at the
dense bf16 tensor rate, its node products in fp32, the gathers on the bytes
they must read once; the activations, norms, repeat, sum and noise have no
floor of their own (0, bound_by null).

    python3 -m gamd_tpu_torch.tools.bench_ablate [--steps 4000] [--reps 3]
        [--k_model 48] [--only full,theta,...] [--cpu]

prints the card line, then one JSON line a stage: us_per_step (host wall
clock over Simulation.run, synchronised, median of the reps), the device
us a step (CUDA events around the same runs; null on the CPU), the full
kernels' us a step measured just before the stage (full_us_per_step),
delta_us, floor_us, bound_by and floor_share (floor / delta); then a
summary line.
--cpu runs the plain versions on the CPU (their times are the CPU's). On
the card the ablated forms run where the forward picks two weight buffers
a tile block and 4 atoms a node block, its choices at LJ-258; a --k_model
past 65 on an H100 (132 SMs) makes it pick one buffer, and the window
raises NotImplementedError rather than price a stage together with a
launch change.
"""

import argparse
import json
import time

import numpy as np
import torch

from gamd_tpu_torch.core import space
from gamd_tpu_torch.core.config import MDConfig, get_preset, lj_model_config
from gamd_tpu_torch.core.device import card_line, resolve_device
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.physics.lennard_jones import lj_fluid_box
from gamd_tpu_torch.tools import bounds
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.state import init_params

# (name, ablate tuple, what the switch takes away on the port's stages)
STAGES = [
    ("full", (), "production kernels (reference point)"),
    ("gather_pos", ("gather_pos",),
     "encoder's neighbour-position reads (atom 0's instead)"),
    ("gather_conv", ("gather_conv",),
     "per-layer source rows src[j], hn[j] (atom 0's instead)"),
    ("srcaff", ("srcaff",), "source affine (node product and its read)"),
    ("emlp", ("emlp",), "edge MLP W_e1, W_e2 products and epilogues"),
    ("theta", ("theta",), "theta MLP W_t1, W_t2 products and epilogues"),
    ("rbf", ("rbf",), "RBF exponentials and the RBF product"),
    ("encmlp", ("encmlp",), "encoder MLP w1, w2 products and epilogues"),
    ("acts", ("acts",), "every silu/gelu (0.5 x instead)"),
    ("ln", ("ln",), "edge and node LayerNorm reductions"),
    ("repeat", ("repeat",), "per-edge dst[i] reads (atom 0's instead)"),
    ("agg", ("agg",), "the sum of an atom's messages (its first only)"),
    ("nodeops", ("nodeops",), "node dst and update products (fp32)"),
    ("decoder", ("decoder",), "decoder MLP"),
    ("noise", ("noise",), "Philox draws and Box-Muller"),
]


def live_edges(pos, box, cutoff):
    """Ordered pairs within the cutoff (the live edges of a list that holds
    them all; K=48 does at LJ-258's density)."""
    rel = space.min_image(pos[None, :, :] - pos[:, None, :], box)
    d2 = torch.sum(rel * rel, dim=-1)
    d2.fill_diagonal_(float("inf"))
    return int((d2 < cutoff * cutoff).sum())


def stage_floors(edges, n, n_rbf, model_cfg):
    """{stage: (floor us a step, "operations" | "bytes" | None)}: the
    products of tools/bounds.stage_ops at their peaks; the gathers' rows
    read once from HBM (positions; each layer's hn and src rows); 0 for
    the stages that own no product."""
    floors = {name: (0.0, None) for name, _, _ in STAGES}
    for name, (tc, fp32) in bounds.stage_ops(edges, n, n_rbf,
                                             model_cfg).items():
        floors[name] = (bounds.ops_ms(tc, fp32) * 1e3, "operations")
    width, layers = model_cfg.hidden_dim, model_cfg.conv_layers
    floors["gather_pos"] = (bounds.bytes_ms(n * 3 * 4) * 1e3, "bytes")
    floors["gather_conv"] = (
        bounds.bytes_ms(layers * n * 2 * width * 4) * 1e3, "bytes")
    return floors


def _timed_runs(sim, st, steps, reps, dev):
    """(median host us a step, median device us a step or None) of `reps`
    runs of `steps` from `st`, each synchronised."""
    host, device = [], []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        sim.run(st, steps)
        if dev.type == "cuda":
            end.record()
            torch.cuda.synchronize(dev)
            device.append(start.elapsed_time(end) * 1e3 / steps)
        host.append((time.perf_counter() - t0) * 1e6 / steps)
    return (float(np.median(host)),
            float(np.median(device)) if device else None)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--k_model", type=int, default=48)
    p.add_argument("--only", type=str, default=None,
                   help="comma-separated stage names to run")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the CPU")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    card = card_line() if dev.type == "cuda" else None
    print(card if card else
          f"device {dev.type}: plain PyTorch versions, not a card",
          flush=True)
    only = set(args.only.split(",")) if args.only else None
    names = [name for name, _, _ in STAGES]
    if only and not only <= set(names):
        raise SystemExit(f"--only: unknown stage(s) "
                         f"{sorted(only - set(names))}; the stages are "
                         f"{names}")

    system = get_preset("lj", skin=0.5, nbr_capacity=64)
    model_cfg = lj_model_config()
    ff = GNNForceField(init_params(model_cfg, system, seed=0), system,
                       model_cfg, device=dev)
    md = MDConfig(integrator="langevin", temperature=system.temperature,
                  dt_fs=system.dt_fs, friction_per_ps=system.friction_per_ps,
                  rebuild_every=20)
    _, pos0 = lj_fluid_box(system.n_atoms, 0.5)
    edges = live_edges(torch.as_tensor(pos0, dtype=torch.float32),
                       system.box, system.cutoff)
    floors = stage_floors(edges, system.n_atoms, model_cfg.n_rbf, model_cfg)

    def simulation(ablate):
        """The bench's Simulation with the window's stage switches, its
        start state and the seconds of one warm-up run."""
        sim = Simulation(ff.force_fn(megakernel=True), system, md,
                         k_model=args.k_model,
                         megastep_fn=ff.megastep_fn(ablate=ablate),
                         device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        st = sim.init_state(pos0, rng=gen)
        t0 = time.perf_counter()
        sim.run(st, args.steps)
        return sim, st, time.perf_counter() - t0

    # Each stage's delta is taken against a run of the full kernels made
    # just before it, so that a drift of the card's clocks over a long
    # run does not enter the deltas.
    full_sim, full_st, full_warmup_s = simulation(())
    results, fulls, deltas = {}, [], {}
    for name, ablate, desc in STAGES:
        if only and name not in only:
            continue
        if name == "full":
            sim, st, warmup_s = full_sim, full_st, full_warmup_s
        else:
            sim, st, warmup_s = simulation(ablate)
            full_us, _ = _timed_runs(full_sim, full_st, args.steps,
                                     args.reps, dev)
            fulls.append(full_us)
        us, device_us = _timed_runs(sim, st, args.steps, args.reps, dev)
        results[name] = us
        floor, bound_by = floors[name]
        row = {"stage": name, "us_per_step": us,
               "device_us_per_step": device_us, "desc": desc,
               "warmup_s": warmup_s, "floor_us": floor,
               "bound_by": bound_by}
        if name == "full":
            fulls.append(us)
        else:
            delta = deltas[name] = full_us - us
            row.update(full_us_per_step=full_us, delta_us=delta,
                       floor_share=floor / delta if floor > 0 and delta > 0
                       else None)
        print(json.dumps(row), flush=True)

    if fulls:
        full = float(np.median(fulls))
        explained = sum(d for d in deltas.values() if d > 0)
        print(json.dumps({
            "summary": "megastep decomposition",
            "full_us": full,
            "sum_of_deltas_us": explained,
            "deltas_share_of_full": explained / full,
            "sum_floor_us": sum(floors[k][0] for k in results
                                if k != "full"),
            "live_edges": edges, "card": card}), flush=True)
    return results


if __name__ == "__main__":
    main()
