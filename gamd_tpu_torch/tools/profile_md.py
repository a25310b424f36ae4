"""Bisection profile of the MD step on the port: where do the
microseconds go? (port of scripts/profile_md.py)

Times eager loops of increasingly complete step bodies on LJ-258 (K=64 at
7.5 + 0.5 A, GAMD-small with seeded weights), to separate the per-step
launch and host floor from compute: a trivial op, BAOAB with a constant
force, the neighbour mask refresh, the edge features (geometry and RBF),
the full GNN force (GNNForceField.force_fn, the eager model) and the full
MD step (Simulation, Langevin at 100 K, rebuilt every 20 steps). Each body
runs `--steps` steps after a warm-up, `--reps` times, the device
synchronised at the end of each run; one line a body with the host time a
step. The dtype argument is the model's compute dtype, as the JAX
script's (bfloat16 runs the plain path in bf16).

    python3 -m gamd_tpu_torch.tools.profile_md [float32|bfloat16]

It runs on the CUDA card (its name and power limit printed first);
`--cpu` runs the plain versions on the CPU.
"""

import argparse

import torch

WARMUP = 5


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dtype", nargs="?", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--cpu", action="store_true")
    return parser


def timed_loop(body, carry, dev, n, reps, label):
    """Host us a step of n steps of body, the mean of reps runs after a
    warm-up, each ended by a device sync; prints and returns it."""
    from gamd_tpu_torch.utils.profiling import Timer

    c = carry
    for _ in range(WARMUP):
        c = body(c)
    Timer().stop(c)
    t = Timer()
    for _ in range(reps):
        c = carry
        for _ in range(n):
            c = body(c)
        Timer().stop(c)
    dt = t.stop() / reps
    us = dt / n * 1e6
    print(f"{label:42s} {us:9.1f} us/step   ({n / dt:,.0f} steps/s)",
          flush=True)
    return us


def main(argv=None) -> dict:
    """Runs the six bodies; returns {label: us a step}."""
    args = build_parser().parse_args(argv)
    from gamd_tpu_torch.core import units
    from gamd_tpu_torch.core.config import (MDConfig, get_preset,
                                            lj_model_config)
    from gamd_tpu_torch.core.device import card_line, resolve_device
    from gamd_tpu_torch.md.integrators import baoab_langevin
    from gamd_tpu_torch.md.simulate import Simulation
    from gamd_tpu_torch.models.gnn import edge_geometry, rbf_expand
    from gamd_tpu_torch.neighbors.dense import (dense_neighbor_list,
                                                refresh_mask)
    from gamd_tpu_torch.physics import lennard_jones as lj
    from gamd_tpu_torch.tools.run_md import pin_fp32
    from gamd_tpu_torch.train.forcefield import GNNForceField
    from gamd_tpu_torch.train.state import init_params
    from gamd_tpu_torch.utils.profiling import Timer

    dev = resolve_device("cpu" if args.cpu else "cuda")
    pin_fp32()
    if dev.type == "cuda":
        print(card_line(), flush=True)
    system = get_preset("lj", skin=0.5, nbr_capacity=64)
    model_cfg = lj_model_config(compute_dtype=args.dtype)
    ff = GNNForceField(init_params(model_cfg, system, seed=0), system,
                       model_cfg, device=dev)
    _, pos0 = lj.lj_fluid_box(system.n_atoms, 0.5)
    pos = torch.as_tensor(pos0, device=dev)
    box = system.box
    idx, mask, _ = dense_neighbor_list(pos, box, system.cutoff + system.skin,
                                       system.nbr_capacity)
    print(f"LJ-{system.n_atoms}, K={system.nbr_capacity}, "
          f"dtype={args.dtype}, {dev.type}", flush=True)
    run = lambda body, carry, label: timed_loop(body, carry, dev, args.steps,
                                                args.reps, label)
    out = {}

    # 1. trivial op floor
    out["trivial"] = run(lambda x: x * 1.000001, pos, "trivial (x*c)")

    # 2. BAOAB integrator with a constant force
    masses = torch.as_tensor(system.atom_masses(), device=dev)
    f0 = torch.zeros_like(pos)
    init, step = baoab_langevin(lambda p: f0, units.FS * 2, masses, 100.0,
                                2.5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out["baoab"] = run(step, init(pos, torch.zeros_like(pos), gen),
                       "BAOAB only (const force)")

    # 3. mask refresh
    out["refresh"] = run(lambda p: p + 0.0 * refresh_mask(
        p, box, system.cutoff, idx, mask)[:, :1].to(p.dtype), pos,
        "mask refresh")

    # 4. edge features (geometry + rbf)
    def edge_feat(p):
        unit, dist = edge_geometry(p[None], idx[None], box)
        feats = torch.cat([unit, dist[..., None], rbf_expand(dist)], -1)
        return p + 0.0 * feats[0, :, 0, :3]
    out["edge_features"] = run(edge_feat, pos, "edge features")

    # 5. full GNN force eval
    force = ff.force_fn()
    out["gnn_force"] = run(lambda p: p + 1e-9 * force(p, idx, mask), pos,
                           "full GNN force")

    # 6. full MD step through the Simulation
    md = MDConfig(integrator="langevin", temperature=100.0,
                  rebuild_every=20)
    sim = Simulation(force, system, md, device=dev)
    gen.manual_seed(1)
    st = sim.init_state(pos, rng=gen)
    n = args.steps
    sim.run(st, WARMUP)
    t = Timer()
    for _ in range(args.reps):
        result = sim.run(st, n)
    dt = t.stop(result.state.pos) / args.reps
    out["md_step"] = dt / n * 1e6
    print(f"{'full MD step (incl rebuilds)':42s} {dt / n * 1e6:9.1f} "
          f"us/step   ({n / dt:,.0f} steps/s)", flush=True)
    return out


if __name__ == "__main__":
    main()
