"""On-policy rollout distillation, DAgger-style data augmentation (port of
scripts/distill_rollout.py).

Rolls out the GNN of a checkpoint, records frames along its own
trajectory, labels them with the classical oracle and writes them as
extra train-only trajectories, data_{seed}_{t}.npz (pos A, vel m/s,
forces kJ/mol/nm) at `--seed_start`, which train_gamd --extra_seeds picks
up while the canonical split and its held-out set stay as they are.

The protocol is the JAX script's: a classical start for each seed (LJ: the
lj_fluid_box lattice; tip3p: water_box(seed)), decorrelated by 0.02 A
normal noise and minimised by `--minimize_steps` FIRE steps (1,000, the
JAX script's count) on the oracle (tip3p:
projected onto the rigid constraints); velocities from a generator seeded
3000 + seed; every seed advanced in lockstep as one replica state
(md.simulate.stack_states), `--thermalize` steps, then `--frames` frames
every `--interval` steps (physics.generate._record_seeds_batched). The GNN
runs Nose-Hoover for LJ (each chain half-step one launch of the CUDA
kernel nhc_half_step) and Langevin for tip3p by default; a use_pallas
checkpoint's conv layers run through conv_msg_gather. The labels: the
dense LJ forces at lj_fluid_box's edge, or the rigid (with --no_rigid the
flexible) TIP3P forces with full Ewald electrostatics through autograd.
The draws come from torch generators, so the frames are not JAX's.

    python3 -m gamd_tpu_torch.tools.distill_rollout --system lj \\
        --ckpt results/ckpts/lj_distill_best.msgpack \\
        --out md_dataset/lj_data --seeds 2 --seed_start 20

It runs on the CUDA card; `--cpu` runs the plain versions on the CPU.
"""

import argparse
import os

import torch

def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--system", default="lj", choices=["lj", "tip3p"])
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--out", required=True,
                        help="dataset dir to write data_{seed}_{t}.npz into")
    parser.add_argument("--seeds", default=2, type=int,
                        help="number of GNN rollout trajectories")
    parser.add_argument("--seed_start", default=20, type=int,
                        help="first seed index (keep past the canonical "
                             "seeds so --extra_seeds picks the frames up)")
    parser.add_argument("--frames", default=1000, type=int)
    parser.add_argument("--interval", default=50, type=int,
                        help="MD steps between recorded frames")
    parser.add_argument("--integrator", default=None,
                        choices=[None, "langevin", "nose_hoover"],
                        help="default: nose_hoover (lj) / langevin (tip3p)")
    parser.add_argument("--friction", default=None, type=float)
    parser.add_argument("--thermalize", default=2000, type=int,
                        help="equilibration steps before recording")
    parser.add_argument("--dispatch_frames", default=50, type=int)
    parser.add_argument("--minimize_steps", default=1000, type=int,
                        help="FIRE steps of each start")
    parser.add_argument("--no_rigid", dest="rigid", default=True,
                        action="store_false")
    parser.add_argument("--cpu", action="store_true")
    return parser


def oracle(system_name, system, rigid):
    """(record_force, minimize_force, start(seed) -> [N, 3] numpy): the
    classical labels and start of the system, forces in kJ/mol/A; the
    record force takes one frame [N, 3] or the seeds' stack [R, N, 3]."""
    if system_name == "lj":
        from gamd_tpu_torch.physics import lennard_jones as lj
        params = lj.LJParams()
        gen_box, base_pos = lj.lj_fluid_box(system.n_atoms, 0.5, params)
        force = lambda p: lj.lj_forces_dense(p, gen_box, params)
        return force, force, lambda seed: base_pos

    from gamd_tpu_torch.physics import ewald
    from gamd_tpu_torch.physics import water as w
    params = w.TIP3PParams()
    box = system.box
    ew = ewald.make_ewald_params(box)
    rec_energy = (w.tip3p_energy_rigid_ewald if rigid
                  else w.tip3p_energy_ewald)

    def record_force(p):
        if p.ndim == 3:
            return torch.stack([record_force(x) for x in p])
        return ewald.neg_grad(rec_energy, p, box, ew, params)

    def minimize_force(p):
        return ewald.neg_grad(w.tip3p_energy_ewald, p, box, ew, params)
    return (record_force, minimize_force,
            lambda seed: w.water_box(system.n_atoms // 3, box, params,
                                     seed=seed))


def main(argv=None) -> list:
    """Writes the frames; returns the seeds written."""
    args = build_parser().parse_args(argv)
    from gamd_tpu_torch.core.config import MDConfig, get_preset
    from gamd_tpu_torch.core.device import resolve_device
    from gamd_tpu_torch.md.constraints import RigidWater
    from gamd_tpu_torch.md.simulate import Simulation, stack_states
    from gamd_tpu_torch.physics.generate import _record_seeds_batched
    from gamd_tpu_torch.physics.minimize import fire_minimize
    from gamd_tpu_torch.tools.run_md import pin_fp32
    from gamd_tpu_torch.train.checkpoint import load_self_describing
    from gamd_tpu_torch.train.forcefield import GNNForceField

    dev = resolve_device("cpu" if args.cpu else "cuda")
    pin_fp32()
    state, model_cfg, system = load_self_describing(
        args.ckpt, fallback_system=get_preset(args.system))
    ff = GNNForceField(state, system, model_cfg, device=dev)
    print(f"Loaded {args.ckpt} (longrange={model_cfg.longrange!r})",
          flush=True)

    constraint = None
    if args.system == "tip3p" and args.rigid:
        constraint = RigidWater(system.n_atoms // 3, system.box)
    integ = args.integrator or ("nose_hoover" if args.system == "lj"
                                else "langevin")
    md = MDConfig(integrator=integ, temperature=system.temperature,
                  dt_fs=system.dt_fs,
                  friction_per_ps=args.friction or system.friction_per_ps,
                  rebuild_every=10)
    sim = Simulation(ff.force_fn(), system, md, constraint=constraint,
                     device=dev)
    record_force, minimize_force, start = oracle(args.system, system,
                                                 args.rigid)

    os.makedirs(args.out, exist_ok=True)
    seeds = list(range(args.seed_start, args.seed_start + args.seeds))
    states = []
    for seed in seeds:
        pos = torch.as_tensor(start(seed), dtype=torch.float32, device=dev)
        # Decorrelate identical lattice starts (LJ) before minimising.
        noise = torch.Generator(device=dev)
        noise.manual_seed(seed)
        pos = pos + 0.02 * torch.randn(pos.shape, generator=noise,
                                       device=dev)
        pos, _ = fire_minimize(minimize_force, pos,
                               n_steps=args.minimize_steps, max_step=0.05)
        if constraint is not None:
            pos = constraint.project_initial(pos)
        rng = torch.Generator(device=dev)
        rng.manual_seed(3000 + seed)
        states.append(sim.init_state(pos, rng=rng))
    states = stack_states(states)
    if args.thermalize:
        states = sim.run_replicas(states, args.thermalize).state
    _record_seeds_batched(sim, states, args.out, seeds, args.frames,
                          args.interval, record_force, args.dispatch_frames,
                          log_every_frames=args.dispatch_frames * 2)
    print(f"{args.seeds} x {args.frames} GNN-rollout frames "
          f"oracle-labeled -> {args.out}", flush=True)
    return seeds


if __name__ == "__main__":
    main()
