"""GNN-driven NVT molecular dynamics rollout: the port of scripts/run_md.py,
with the same flags and defaults.

The port runs the LJ system and rigid TIP3P / TIP4P water with any of the
four integrators (langevin, nose_hoover, nve, andersen), from a
checkpoint (self-describing envelope, or a legacy one with the
architecture flags) or from seeded weights, on the eager force path,
`--use_pallas` (every conv layer through the CUDA conv-message kernel),
`--megakernel` (mega_forward per force call), `--megastep` (one
mega_md_steps call per neighbour-reuse window) or `--banded` (the large-N
path: x-sorted frames, every conv layer through the CUDA banded_msg
kernel, the cell-list search above 1,024 atoms); `--megastep` takes
langevin only. Under nose_hoover every chain half-step goes through the
CUDA nhc_half_step kernel. Water (`--system tip3p` or `tip4p`) starts from
physics.water.water_box relaxed by 1,500 FIRE steps on the flexible TIP3P
forces and snapped onto the constraints, and runs rigid by default
(SETTLE and RATTLE, md.constraints.RigidWater, in the integrator;
`--no-rigid` runs it unconstrained, which `--megastep` needs); its model
takes the O-H bond channel on every force path, `--banded` included. DFT
(`--system dft`) and an envelope with a long-range channel raise
NotImplementedError naming the slice of the port that brings them.

It runs on the CUDA card; `--cpu` runs the plain PyTorch versions on the
CPU instead. Example:

    python3 -m gamd_tpu_torch.tools.run_md --system lj \\
        --ckpt results/ckpts/lj_relabel_latest.msgpack --megastep \\
        --steps 25000 --log log_nvt_gnn_langevin_lj.txt
    python3 -m gamd_tpu_torch.tools.run_md --system tip3p \\
        --ckpt results/ckpts/tip3p_final.msgpack --megakernel \\
        --steps 25000 --log log_nvt_gnn_langevin_tip3p.txt
    python3 -m gamd_tpu_torch.tools.run_md --system tip3p \\
        --ckpt results/ckpts/tip3p_final.msgpack --banded --friction 25 \\
        --steps 2000 --log log_nvt_gnn_banded_tip3p.txt
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

#: The refusal names the ROADMAP item (Queue 1) of the slice that ports it.
DFT = "the DFT deployment (ROADMAP Queue 1 item 5)"
WATER = ("tip3p", "tip4p")
#: FIRE of the water start (scripts/run_md.py:158-161).
WATER_FIRE_STEPS, WATER_FIRE_MAX_STEP = 1500, 0.05


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--system", default="lj",
                        choices=["lj", "tip3p", "tip4p", "dft"])
    parser.add_argument("--n_atoms", default=None, type=int,
                        help="dft rollout: atoms in the fixed-volume water "
                             "box (default 774, the reference's 2 nm box)")
    parser.add_argument("--ckpt", required=False, default=None,
                        help="msgpack checkpoint (seeded weights if omitted)")
    parser.add_argument("--init_pos", default=None,
                        help=".npy initial positions (angstrom); "
                             "default: the FIRE-minimised lattice")
    parser.add_argument("--integrator", default="langevin",
                        choices=["langevin", "nose_hoover", "nve", "andersen"])
    parser.add_argument("--steps", default=25000, type=int)
    parser.add_argument("--temperature", default=None, type=float)
    parser.add_argument("--friction", default=None, type=float,
                        help="1/ps collision rate")
    parser.add_argument("--dt", default=2.0, type=float, help="fs")
    parser.add_argument("--rebuild_every", default=20, type=int)
    parser.add_argument("--report_every", default=100, type=int)
    parser.add_argument("--log", default="log_nvt_gnn.txt")
    parser.add_argument("--out_traj", default=None,
                        help="optional .npy to save final positions")
    # Architecture fallbacks for LEGACY checkpoints (envelope checkpoints
    # embed their config and ignore these).
    parser.add_argument("--encoding_size", default=128, type=int)
    parser.add_argument("--hidden_dim", default=128, type=int)
    parser.add_argument("--edge_embedding_dim", default=128, type=int)
    parser.add_argument("--conv_layer", default=4, type=int)
    parser.add_argument("--use_layer_norm", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="legacy-checkpoint fallback: LayerNorm (default)"
                             " vs BatchNorm (--no-use_layer_norm)")
    parser.add_argument("--use_pallas", action="store_true",
                        help="every conv layer through the CUDA "
                             "conv-message kernel")
    parser.add_argument("--megakernel", action="store_true",
                        help="whole-model CUDA forward per force call")
    parser.add_argument("--megastep", action="store_true",
                        help="whole neighbour-reuse window per CUDA call"
                             " (fastest path; langevin only)")
    parser.add_argument("--banded", action="store_true",
                        help="x-sorted banded-gather force path for large N "
                             "(ops/banded.py; fixed scalar box; uses the "
                             "cell-list neighbour search above 1,024 atoms)")
    parser.add_argument("--k_model", default=None, type=int,
                        help="slice the distance-sorted neighbour list to "
                             "this K for the force model (overflow-guarded)")
    parser.add_argument("--rigid", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="water systems: SETTLE rigid-monomer rollout "
                             "(the reference protocol); --no-rigid for "
                             "unconstrained dynamics")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch versions on the CPU")
    return parser


def refuse_unported(system):
    """NotImplementedError for what the port does not run yet."""
    if system not in ("lj",) + WATER:
        raise NotImplementedError(f"--system {system}: comes with {DFT}")


def load_force_field(args, device, **model_overrides):
    """(GNNForceField, SystemConfig) from --ckpt, or seeded weights
    (init_params(seed=0)) with the fallback architecture on the LJ preset;
    `model_overrides` (runtime switches such as use_pallas) apply to both."""
    from gamd_tpu_torch.core.config import ModelConfig, get_preset
    from gamd_tpu_torch.train.checkpoint import load_self_describing
    from gamd_tpu_torch.train.forcefield import GNNForceField
    from gamd_tpu_torch.train.state import init_params

    fallback_cfg = ModelConfig(
        encoding_size=args.encoding_size, hidden_dim=args.hidden_dim,
        edge_embedding_dim=args.edge_embedding_dim,
        conv_layers=args.conv_layer, use_layer_norm=args.use_layer_norm)
    if args.ckpt:
        state, model_cfg, system = load_self_describing(
            args.ckpt, fallback_model_cfg=fallback_cfg,
            fallback_system=get_preset(args.system), **model_overrides)
        print(f"Loaded {args.ckpt}")
    else:
        system = get_preset(args.system)
        model_cfg = dataclasses.replace(fallback_cfg, **model_overrides)
        state = init_params(model_cfg, system, seed=0)
    return GNNForceField(state, system, model_cfg, device=device), system


def pin_fp32():
    """fp32 products on the card: no TF32 (the physics must not round to
    three digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def water_start(system, device, seed=0):
    """The water start of the JAX CLI: physics.water.water_box (seeded),
    relaxed by 1,500 FIRE steps (trust radius 0.05 A) on the flexible
    TIP3P forces at a cutoff within half the box."""
    from gamd_tpu_torch.physics import water as w
    from gamd_tpu_torch.physics.minimize import fire_minimize

    pos = w.water_box(system.n_atoms // 3, system.box, seed=seed)
    params = w.TIP3PParams(cutoff=min(9.0, system.box / 2 - 0.01))
    pos, _ = fire_minimize(lambda p: w.tip3p_forces(p, system.box, params),
                           torch.as_tensor(pos, device=device),
                           n_steps=WATER_FIRE_STEPS,
                           max_step=WATER_FIRE_MAX_STEP)
    return pos


def rollout(args, parser=None):
    """The run of parsed `args`: the force field, the start, the
    Simulation and args.steps steps of run_segmented. Returns a dict with
    the Simulation `sim`, the `system`, the `constraint` (None unless
    rigid water), the RunResult `result` and the `seconds` the steps took
    on the host clock (synchronised). Refusals raise before any work."""
    parser = build_parser() if parser is None else parser
    refuse_unported(args.system)
    if args.banded and (args.megakernel or args.megastep):
        parser.error("--banded is an alternative force path to "
                     "--megakernel/--megastep")
    rigid = args.system in WATER and args.rigid
    if args.megastep and (args.integrator != "langevin" or rigid):
        parser.error("--megastep requires --integrator langevin and an "
                     "unconstrained system (use --no-rigid for water)")

    from gamd_tpu_torch.core.config import MDConfig
    from gamd_tpu_torch.core.device import resolve_device
    from gamd_tpu_torch.md.constraints import RigidWater
    from gamd_tpu_torch.md.simulate import Simulation
    from gamd_tpu_torch.physics import lennard_jones as lj
    from gamd_tpu_torch.physics.minimize import fire_minimize

    device = resolve_device("cpu" if args.cpu else "cuda")
    pin_fp32()
    ff, system = load_force_field(args, device, use_pallas=args.use_pallas)
    megastep_fn = ff.megastep_fn() if args.megastep else None
    nbr_method = "dense"
    if args.banded:
        if system.nbr_capacity < 96:
            # Thermal LJ at rho* = 0.5 peaks near 66 in-radius neighbours
            # at the preset skin: 64 saturates.
            system = dataclasses.replace(system, nbr_capacity=96)
        force_fn = ff.banded_force_fn()
        # The cell list only where the box is at least 4 cells wide; dense
        # top-K is the right search at small N anyway.
        nbr_method = "cell" if system.n_atoms > 1024 else "dense"
    else:
        force_fn = ff.force_fn(megakernel=args.megakernel or args.megastep)
    constraint = RigidWater(system.n_atoms // 3, system.box) if rigid \
        else None

    if args.init_pos:
        pos = torch.as_tensor(np.load(args.init_pos).astype(np.float32),
                              device=device)
    elif args.system in WATER:
        pos = water_start(system, device, args.seed)
    else:
        _, lattice = lj.lj_fluid_box(system.n_atoms, 0.5)
        pos, _ = fire_minimize(lambda p: lj.lj_forces_dense(p, system.box),
                               torch.as_tensor(lattice, device=device),
                               n_steps=1000)
    if constraint is not None:
        pos = constraint.project_initial(pos)

    md = MDConfig(
        integrator=args.integrator, n_steps=args.steps,
        temperature=args.temperature or system.temperature,
        dt_fs=args.dt,
        friction_per_ps=args.friction or system.friction_per_ps,
        rebuild_every=args.rebuild_every, report_every=args.report_every,
        seed=args.seed)
    sim = Simulation(force_fn, system, md, nbr_method=nbr_method,
                     k_model=args.k_model, megastep_fn=megastep_fn,
                     device=device, constraint=constraint)
    rng = torch.Generator(device=device)
    rng.manual_seed(args.seed)
    st = sim.init_state(pos, rng=rng)

    print(f"Simulating {system.n_atoms} atoms, {args.steps} steps "
          f"({args.integrator}, T={md.temperature} K"
          f"{', rigid water' if rigid else ''}) on {device}")
    t0 = time.perf_counter()
    result = sim.run_segmented(st, args.steps)
    synchronize(device)
    wall = time.perf_counter() - t0
    return dict(sim=sim, system=system, constraint=constraint,
                result=result, seconds=wall)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    from gamd_tpu_torch.md.reporters import StateReporter

    run = rollout(args, parser)
    result, wall = run["result"], run["seconds"]
    print(f"{args.steps} steps in {wall:.2f} s "
          f"({args.steps / wall:.0f} steps/s)")
    if run["constraint"] is not None:
        print(f"constraint residual "
              f"{float(run['constraint'].residual(result.state.pos)):.3e} A")
    if result.overflow:
        print("WARNING: neighbor capacity overflow — increase nbr_capacity")

    StateReporter(args.log, report_interval=args.report_every,
                  dt_fs=args.dt).write(result.thermo)
    print(f"Thermo log: {args.log}")
    if args.out_traj:
        np.save(args.out_traj, result.state.pos.cpu().numpy())


if __name__ == "__main__":
    main()
