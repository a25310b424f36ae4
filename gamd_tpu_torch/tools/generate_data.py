"""Classical ground-truth training data: the port of
scripts/generate_data.py, with the same flags and defaults.

`--system lj` runs physics.generate.generate_lj_dataset: per seed the
rotated, jittered FCC lattice relaxed by 2,000 FIRE steps on the dense LJ
forces, then Nose-Hoover chain MD at 100 K (or `--temperature`), one
data_{seed}_{t}.npz frame (pos A, vel m/s, forces kJ/mol/nm) every
`--interval` steps, `--dispatch_frames` frames a run_recorded call. On the
card every chain half-step is one launch of the CUDA kernel
nhc_half_step. `--system tip3p`, `tip4p` and `rpbe` raise
NotImplementedError before any work (ROADMAP Queue 1 item 5); the
water-only flags `--flexible` and `--electrostatics` are read and unused.

It runs on the CUDA card; `--cpu` runs the plain PyTorch versions on the
CPU instead. Example (the verify loop's step 1):

    python3 -m gamd_tpu_torch.tools.generate_data --out /tmp/vds/lj_data \\
        --seeds 1 --frames 60 --interval 10
"""

import argparse
import time

from gamd_tpu_torch.core.device import resolve_device
from gamd_tpu_torch.physics.generate import UNPORTED, generate_lj_dataset
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
                        help="water only (not ported)")
    parser.add_argument("--dispatch_frames", default=250, type=int,
                        help="frames recorded per run_recorded call")
    parser.add_argument("--electrostatics", default="ewald",
                        choices=["ewald", "dsf"],
                        help="water only (not ported)")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch versions on the CPU")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.system != "lj":
        raise NotImplementedError(f"--system {args.system}: comes with "
                                  f"{UNPORTED}")
    device = resolve_device("cpu" if args.cpu else "cuda")
    pin_fp32()
    t0 = time.perf_counter()
    generate_lj_dataset(args.out, seeds=args.seeds,
                        frames_per_seed=args.frames,
                        record_interval=args.interval,
                        n_particles=args.particles,
                        frames_per_dispatch=args.dispatch_frames,
                        seed_start=args.seed_start,
                        temperature=args.temperature, device=device)
    synchronize(device)
    seconds = time.perf_counter() - t0
    frames = args.seeds * args.frames
    print(f"Wrote {frames} frames to {args.out} in {seconds:.2f} s "
          f"({frames / seconds:.2f} frames/s)")


if __name__ == "__main__":
    main()
