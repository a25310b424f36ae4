"""Rigid TIP3P NVE energy-drift ladder (port of scripts/nve_drift_probe.py).

For each size (molecules; the box scaled from 258 molecules in 20 A) and
each constraint method (SHAKE, SETTLE): water_box, FIRE on the flexible
TIP3P forces, the start projected onto the constraints, `--thermalize`
Langevin steps at 300 K (1 fs, 5/ps), then `--steps` NVE steps of `--dt`
fs with the rigid TIP3P forces; one line a leg with the total-energy drift
(kinetic plus rigid potential energy, end less start) in kJ/mol and
kJ/mol/ps, the constraint residual at the end and the wall time of the
NVE run. `--force_probe` also prints the rigid forces' rms and mean |F| at
the minimised start of each size, for comparison across runs.

    python3 -m gamd_tpu_torch.tools.nve_drift_probe --steps 4000 \\
        --sizes 27 258

It runs on the CUDA card; `--cpu` runs it on the CPU.
"""

import argparse

import torch


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--dt", type=float, default=2.0)
    parser.add_argument("--sizes", type=int, nargs="*", default=[27, 258])
    parser.add_argument("--methods", nargs="*", default=["shake", "settle"])
    parser.add_argument("--thermalize", type=int, default=1000,
                        help="Langevin steps before the NVE run")
    parser.add_argument("--minimize_steps", type=int, default=800)
    parser.add_argument("--force_probe", action="store_true",
                        help="also print the rigid forces' rms and mean |F|")
    return parser


def main(argv=None) -> list:
    """Runs the ladder; returns one dict a leg (n_mol, method, de_kj_mol,
    drift_kj_mol_ps, residual_a, wall_s)."""
    args = build_parser().parse_args(argv)
    from gamd_tpu_torch.core import space
    from gamd_tpu_torch.core.config import MDConfig, get_preset
    from gamd_tpu_torch.core.device import resolve_device
    from gamd_tpu_torch.md import integrators as integ
    from gamd_tpu_torch.md.constraints import RigidWater, tip3p_rigid_params
    from gamd_tpu_torch.md.simulate import Simulation
    from gamd_tpu_torch.physics import water as w
    from gamd_tpu_torch.physics.minimize import fire_minimize
    from gamd_tpu_torch.tools.run_md import pin_fp32
    from gamd_tpu_torch.utils.profiling import Timer

    dev = resolve_device("cpu" if args.cpu else "cuda")
    pin_fp32()
    print(f"backend: {dev.type}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""), flush=True)
    legs = []
    for n_mol in args.sizes:
        # The preset's density: 258 molecules in 20 A.
        box = 20.0 * (n_mol / 258.0) ** (1.0 / 3.0)
        cutoff = min(4.2, box / 2 - 0.01)
        system = get_preset("tip3p", n_atoms=3 * n_mol, box=box,
                            cutoff=cutoff, nbr_capacity=96)
        params = w.TIP3PParams(cutoff=cutoff)
        masses = torch.as_tensor(system.atom_masses(), device=dev)
        pos = torch.as_tensor(w.water_box(n_mol, box, params, seed=1),
                              device=dev)
        pos, _ = fire_minimize(lambda p: w.tip3p_forces(p, box, params),
                               pos, n_steps=args.minimize_steps,
                               max_step=0.05)
        for method in args.methods:
            constraint = RigidWater(n_mol, box,
                                    tip3p_rigid_params(params.r_oh,
                                                       params.theta0),
                                    method=method)
            p0 = constraint.project_initial(pos)
            force = w.tip3p_force_fn(box, params, rigid=True)
            # Thermalise at 300 K with Langevin, then measure NVE drift.
            md0 = MDConfig(integrator="langevin", temperature=300.0,
                           dt_fs=1.0, friction_per_ps=5.0, rebuild_every=10)
            sim0 = Simulation(force, system, md0, constraint=constraint,
                              device=dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(2)
            st0 = sim0.init_state(p0, rng=gen)
            if args.thermalize:
                st0 = sim0.run(st0, args.thermalize).state
            md = MDConfig(integrator="nve", dt_fs=args.dt, rebuild_every=10)
            sim = Simulation(force, system, md, constraint=constraint,
                             device=dev)
            st = sim.init_state(st0.pos, vel=st0.vel)

            def etot(s):
                return (float(integ.kinetic_energy(s.vel, masses))
                        + float(w.tip3p_energy_rigid(space.wrap(s.pos, box),
                                                     box, params)))

            e0 = etot(st)
            t = Timer()
            r = sim.run(st, args.steps)
            wall = t.stop(r.state.pos)
            e1 = etot(r.state)
            ps = args.steps * args.dt / 1000.0
            res = float(constraint.residual(r.state.pos))
            print(f"n_mol={n_mol:4d} method={method:7s} "
                  f"dE={e1 - e0:+10.3f} kJ/mol over {ps:.1f} ps "
                  f"({(e1 - e0) / ps:+8.3f} kJ/mol/ps)  "
                  f"residual={res:.2e} A  wall={wall:.1f}s", flush=True)
            legs.append({"n_mol": n_mol, "method": method,
                         "de_kj_mol": e1 - e0,
                         "drift_kj_mol_ps": (e1 - e0) / ps,
                         "residual_a": res, "wall_s": wall})
        if args.force_probe:
            f = w.tip3p_forces_rigid(space.wrap(pos, box), box, params)
            print(f"n_mol={n_mol:4d} force rms={float(torch.std(f)):.6f} "
                  f"mean_abs={float(torch.mean(torch.abs(f))):.6f} "
                  "kJ/mol/A", flush=True)
    return legs


if __name__ == "__main__":
    main()
