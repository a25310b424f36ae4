"""Classical ground-truth training data: the port of
scripts/generate_data.py, with the same flags and defaults.

`--system lj` runs physics.generate.generate_lj_dataset: per seed the
rotated, jittered FCC lattice relaxed by 2,000 FIRE steps on the dense LJ
forces, then Nose-Hoover chain MD at 100 K (or `--temperature`), one
data_{seed}_{t}.npz frame (pos A, vel m/s, forces kJ/mol/nm) every
`--interval` steps, `--dispatch_frames` frames a run_recorded call. On the
card every chain half-step is one launch of the CUDA kernel
nhc_half_step.

`--system tip3p` (`--particles` molecules, default 258) and `tip4p` (251
molecules, as the JAX CLI) run physics.generate.generate_water_dataset and
generate_tip4p_dataset: rigid water (`--flexible` for harmonic monomers at
0.5 fs) under full Ewald electrostatics (`--electrostatics dsf` for the
damped-shifted-force cutoff), all seeds advancing in lockstep as
constrained replicas of one Langevin run; TIP4P frames hold O, H, H, M
rows. `--minimize_steps` and `--thermalize_steps` cut the start's FIRE
and the thermalisation (default: the generators' own, 2,000 LJ and 3,000
water FIRE steps, 5,000 water steps); the JAX CLI has neither. `--system
rpbe` runs physics.generate.generate_rpbe_surrogate, the DFT system's
data: `--frames` frames a box every `--interval` steps in three boxes of
64 rigid molecules (`--flexible` unconstrained at 0.5 fs), written as one
npz at `--out` in bohr and Ha/bohr (train.data.RealLargeDataset's
layout); `--minimize_steps` and `--thermalize_steps` cut its FIRE and its
equilibration (2,000 steps each by default).

It runs on the CUDA card; `--cpu` runs the plain PyTorch versions on the
CPU instead. Example (the verify loop's step 1):

    python3 -m gamd_tpu_torch.tools.generate_data --out /tmp/vds/lj_data \\
        --seeds 1 --frames 60 --interval 10
    python3 -m gamd_tpu_torch.tools.generate_data --system tip3p \\
        --out /tmp/wds/water_data --seeds 2 --frames 100
    python3 -m gamd_tpu_torch.tools.generate_data --system rpbe \\
        --out /tmp/rpbe.npz --frames 100
"""

import argparse
import time

from gamd_tpu_torch.core.device import resolve_device
from gamd_tpu_torch.physics import generate
from gamd_tpu_torch.tools.run_md import pin_fp32, synchronize


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--system", default="lj",
                        choices=["lj", "tip3p", "tip4p", "rpbe"])
    parser.add_argument("--out", default="./md_dataset/lj_data")
    parser.add_argument("--seeds", default=10, type=int)
    parser.add_argument("--temperature", default=None, type=float,
                        help="LJ generation temperature override (K)")
    parser.add_argument("--seed_start", default=0, type=int,
                        help="first trajectory seed index")
    parser.add_argument("--frames", default=1000, type=int)
    parser.add_argument("--interval", default=50, type=int)
    parser.add_argument("--particles", default=258, type=int)
    parser.add_argument("--flexible", action="store_true",
                        help="water only: flexible harmonic monomers at "
                             "dt 0.5 fs instead of rigid SETTLE at 2 fs")
    parser.add_argument("--dispatch_frames", default=250, type=int,
                        help="frames recorded per run_recorded call")
    parser.add_argument("--electrostatics", default="ewald",
                        choices=["ewald", "dsf"],
                        help="water Coulomb treatment: the full Ewald sum "
                             "(the reference's PME protocol, default) or "
                             "the damped-shifted-force cutoff")
    parser.add_argument("--minimize_steps", default=None, type=int,
                        help="FIRE steps of each start (default: the "
                             "generator's, 2000 LJ, 3000 water)")
    parser.add_argument("--thermalize_steps", default=None, type=int,
                        help="water: steps before the first frame "
                             "(default 5000; rpbe 2000)")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch versions on the CPU")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    pin_fp32()
    if args.system == "rpbe":
        return rpbe(args, device)
    common = dict(seeds=args.seeds, frames_per_seed=args.frames,
                  record_interval=args.interval,
                  frames_per_dispatch=args.dispatch_frames,
                  seed_start=args.seed_start, device=device)
    if args.minimize_steps is not None:
        common["minimize_steps"] = args.minimize_steps
    if args.system != "lj":
        common.update(rigid=not args.flexible,
                      electrostatics=args.electrostatics)
        if args.thermalize_steps is not None:
            common["thermalize_steps"] = args.thermalize_steps
    t0 = time.perf_counter()
    if args.system == "lj":
        generate.generate_lj_dataset(args.out, n_particles=args.particles,
                                     temperature=args.temperature, **common)
    elif args.system == "tip4p":
        generate.generate_tip4p_dataset(args.out, **common)
    else:
        generate.generate_water_dataset(args.out,
                                        n_molecules=args.particles, **common)
    synchronize(device)
    seconds = time.perf_counter() - t0
    frames = args.seeds * args.frames
    print(f"Wrote {frames} frames to {args.out} in {seconds:.2f} s "
          f"({frames / seconds:.2f} frames/s)")


def rpbe(args, device):
    """--system rpbe: the surrogate npz at --out (scripts/generate_data.py
    :50-52), timed."""
    cuts = {}
    if args.minimize_steps is not None:
        cuts["minimize_steps"] = args.minimize_steps
    if args.thermalize_steps is not None:
        cuts["equil_steps"] = args.thermalize_steps
    t0 = time.perf_counter()
    generate.generate_rpbe_surrogate(
        args.out, frames_per_box=args.frames, record_interval=args.interval,
        rigid=not args.flexible, frames_per_dispatch=args.dispatch_frames,
        device=device, **cuts)
    synchronize(device)
    seconds = time.perf_counter() - t0
    print(f"Wrote RPBE surrogate npz to {args.out} in {seconds:.2f} s")


if __name__ == "__main__":
    main()
