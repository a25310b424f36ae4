"""Physics check of a GNN-driven rollout against ground-truth frames: the
port of scripts/analyze_rollout.py, with the same flags, defaults, JSON
report keys and PE TSV.

It runs an NVT rollout with the checkpoint's force field from the last
ground-truth frame and compares the radial distribution function,
temperature, self-diffusion and (with --pe) the classical potential
energy along the trajectory with the ground truth and, with
--classical_baseline, with a classical rollout of the same length from the
same start (the port's LJ forces, or the TIP3P / TIP4P-Ew force closure
with `--electrostatics`, the full Ewald sum by default). It runs LJ and
water with any integrator (the default, as the JAX CLI's, is nose_hoover,
whose chain half-steps go through the CUDA nhc_half_step kernel) on the
eager, `--use_pallas` and `--megakernel` force paths, and with
`--integrator langevin` on `--megastep` (unconstrained only). Water
(`--system tip3p`, `tip4p`) rolls out rigid by default (SETTLE and RATTLE;
`--no-rigid` unconstrained) from the last ground-truth frame snapped onto
the constraints, compares the O-O RDF and the oxygens' diffusion, and its
`--pe` oracle is the rigid nonbonded energy (Ewald or DSF as
`--electrostatics`); TIP4P frames are read without their M rows. A
checkpoint with the long-range channel adds the k-space term on every
force path.

It runs on the CUDA card; `--cpu` runs the plain PyTorch versions on the
CPU instead. Example:

    python3 -m gamd_tpu_torch.tools.analyze_rollout --system lj \\
        --ckpt results/ckpts/lj_relabel_latest.msgpack \\
        --data_dir md_dataset/lj_data --megakernel --steps 10000 \\
        --classical_baseline --pe \\
        --json_out rdf_report.json
    python3 -m gamd_tpu_torch.tools.analyze_rollout --system tip3p \\
        --ckpt results/ckpts/tip3p_rj_best.msgpack \\
        --data_dir /tmp/wds/water_data --megakernel --integrator langevin \\
        --friction 25 --steps 4000 --classical_baseline --pe
"""

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from gamd_tpu_torch.tools.run_md import pin_fp32, synchronize


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--system", default="lj", choices=["lj", "tip3p",
                                                           "tip4p"])
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--data_dir", required=True,
                        help="ground-truth data_{seed}_{t}.npz directory")
    parser.add_argument("--steps", default=10000, type=int)
    parser.add_argument("--integrator", default="nose_hoover")
    parser.add_argument("--friction", default=None, type=float,
                        help="Langevin collision rate (1/ps). Default: the "
                             "system preset's value; the reference's "
                             "rollout scripts use 25/ps")
    parser.add_argument("--equil_fraction", default=0.3, type=float)
    parser.add_argument("--n_bins", default=100, type=int)
    parser.add_argument("--max_gt_frames", default=200, type=int)
    parser.add_argument("--gt_max_seed", default=9, type=int,
                        help="highest trajectory seed counted as ground "
                             "truth (extra or distilled seeds are "
                             "train-only and stay out of the GT RDF)")
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
                             " (langevin only)")
    parser.add_argument("--rigid", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="water: SETTLE-constrained rollout (the "
                             "reference protocol)")
    parser.add_argument("--classical_baseline", action="store_true",
                        help="also run a classical rollout of the same "
                             "length from the same start")
    parser.add_argument("--electrostatics", default="ewald",
                        choices=["ewald", "dsf"],
                        help="water classical-baseline and PE Coulomb "
                             "treatment; must match how the dataset was "
                             "generated")
    parser.add_argument("--pe", action="store_true",
                        help="the classical potential energy along the GNN "
                             "trajectory (and the classical baseline's), "
                             "written as a TSV next to --json_out")
    parser.add_argument("--pe_out", default=None,
                        help="PE TSV path (default: <json_out>_pe.tsv)")
    parser.add_argument("--json_out", default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch versions on the CPU")
    return parser


def ground_truth_frames(data_dir, gt_max_seed, max_frames, system="lj"):
    """[T, N, 3] float32 frames sampled evenly over the seeds <= gt_max_seed
    and the equilibrated times (t >= 200, when there are any) of the
    data_{seed}_{t}.npz files in data_dir; tip4p frames without their M
    rows (every 4th)."""
    files = sorted(glob.glob(os.path.join(data_dir, "data_*.npz")))
    if not files:
        raise SystemExit(f"no frames in {data_dir}")

    def field(path, i):                          # data_{seed}_{t}
        return int(os.path.basename(path)[:-4].split("_")[i])

    files = [f for f in files if field(f, 1) <= gt_max_seed]
    if not files:
        raise SystemExit(f"no frames with seed <= {gt_max_seed} "
                         f"in {data_dir}")
    equilibrated = [f for f in files if field(f, 2) >= 200] or files
    sel = np.round(np.linspace(0, len(equilibrated) - 1,
                               min(max_frames, len(equilibrated)))).astype(int)
    frames = []
    for f in [equilibrated[i] for i in sel][:max_frames]:
        with np.load(f) as z:
            pos = z["pos"].astype(np.float32)
        if system == "tip4p":
            pos = pos[np.mod(np.arange(pos.shape[0]), 4) < 3]
        frames.append(pos)
    return np.stack(frames)


def classical_force_fn(args, box):
    """The classical baseline's force closure of --system."""
    from gamd_tpu_torch.physics import lennard_jones as lj
    from gamd_tpu_torch.physics import water as w

    if args.system == "lj":
        return lj.lj_force_fn(box)
    make = w.tip3p_force_fn if args.system == "tip3p" else w.tip4pew_force_fn
    return make(box, rigid=args.rigid, electrostatics=args.electrostatics)


def pe_function(args, box):
    """The --pe oracle, positions [N, 3] -> energy (kJ/mol): the LJ energy,
    or the rigid water energy with the Ewald sum or the DSF cutoff."""
    from gamd_tpu_torch.physics import ewald
    from gamd_tpu_torch.physics import lennard_jones as lj
    from gamd_tpu_torch.physics import water as w

    if args.system == "lj":
        return lambda p: lj.lj_energy_dense(p, box)
    tip3p = args.system == "tip3p"
    if args.electrostatics == "ewald":
        ew = ewald.make_ewald_params(box)
        energy = (w.tip3p_energy_rigid_ewald if tip3p
                  else w.tip4pew_energy_rigid_ewald)
        return lambda p: energy(p, box, ew)
    energy = w.tip3p_energy_rigid if tip3p else w.tip4pew_energy_rigid
    return lambda p: energy(p, box)


def write_pe_tsv(path, pe_gnn, pe_cl, n_equil, sample_ps):
    """The PE series as the JAX CLI writes it."""
    with open(path, "w") as f:
        cols = ['#"Frame"', '"Time (ps)"',
                '"Classical PE on GNN traj (kJ/mole)"']
        if pe_cl is not None:
            cols.append('"Classical PE on classical traj (kJ/mole)"')
        f.write("\t".join(cols) + "\n")
        for i in range(len(pe_gnn)):
            row = [str(i), f"{(n_equil + i) * sample_ps:.4f}",
                   f"{pe_gnn[i]:.4f}"]
            if pe_cl is not None and i < len(pe_cl):
                row.append(f"{pe_cl[i]:.4f}")
            f.write("\t".join(row) + "\n")


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    water = args.system in ("tip3p", "tip4p")
    if args.megastep and (args.integrator != "langevin"
                          or (water and args.rigid)):
        parser.error("--megastep requires --integrator langevin and an "
                     "unconstrained system")

    from gamd_tpu_torch.core.config import MDConfig
    from gamd_tpu_torch.core.device import resolve_device
    from gamd_tpu_torch.md.constraints import RigidWater
    from gamd_tpu_torch.md.simulate import Simulation
    from gamd_tpu_torch.physics.rdf import (diffusion_coefficient,
                                            mean_squared_displacement,
                                            radial_distribution, rdf_l2)
    from gamd_tpu_torch.tools.run_md import load_force_field

    device = resolve_device("cpu" if args.cpu else "cuda")
    pin_fp32()
    ff, force_fn, system = load_force_field(args, device,
                                            use_pallas=args.use_pallas)
    gt_frames = ground_truth_frames(args.data_dir, args.gt_max_seed,
                                    args.max_gt_frames, args.system)
    constraint = (RigidWater(system.n_atoms // 3, system.box)
                  if water and args.rigid else None)

    # GNN rollout from the last ground-truth frame.
    md = MDConfig(integrator=args.integrator, n_steps=args.steps,
                  temperature=system.temperature, dt_fs=system.dt_fs,
                  friction_per_ps=args.friction or system.friction_per_ps,
                  rebuild_every=20)
    megastep_fn = ff.megastep_fn() if args.megastep else None
    sim = Simulation(force_fn, system, md, megastep_fn=megastep_fn,
                     device=device, constraint=constraint)
    start_pos = torch.as_tensor(gt_frames[-1], device=device)
    if constraint is not None:
        start_pos = constraint.project_initial(start_pos)

    def generator(seed):
        rng = torch.Generator(device=device)
        rng.manual_seed(seed)
        return rng

    st = sim.init_state(start_pos, rng=generator(0))
    t0 = time.perf_counter()
    result = sim.run_segmented(st, args.steps)
    synchronize(device)
    rollout_s = time.perf_counter() - t0
    print(f"GNN rollout: {args.steps} steps in {rollout_s:.1f} s "
          f"({args.steps / rollout_s:.1f} steps/s; "
          f"integrator={args.integrator}, rigid={constraint is not None}, "
          f"on {device})")
    if result.overflow:
        print("WARNING: neighbor overflow during rollout")

    n_equil = int(len(result.positions) * args.equil_fraction)
    frames = result.positions[n_equil:]
    gt = torch.as_tensor(gt_frames, device=device)
    species = (np.arange(system.n_atoms) % 3 == 0) if water else None
    rdf = lambda x: radial_distribution(x, system.box, n_bins=args.n_bins,
                                        species_a=species, species_b=species)
    r, g_gnn = rdf(frames)
    _, g_gt = rdf(gt)
    extra = {}
    frames_cl = None
    if args.classical_baseline:
        sim_cl = Simulation(classical_force_fn(args, system.box), system, md,
                            device=device, constraint=constraint)
        res_cl = sim_cl.run_segmented(
            sim_cl.init_state(start_pos, rng=generator(1)), args.steps)
        frames_cl = res_cl.positions[n_equil:]
        _, g_cl = rdf(frames_cl)
        temps_cl = res_cl.thermo.temperature.cpu().numpy()
        extra = {
            "rdf_l2_vs_classical_rollout": rdf_l2(g_gnn, g_cl),
            "rdf_peak_classical_rollout": float(g_cl.max()),
            "classical_temperature_mean": float(
                temps_cl[args.steps // 2:].mean()),
        }

    # Transport: self-diffusion from the MSD linear regime, with the
    # classical rollout under the same protocol as its oracle.
    dt_sample_ps = md.rebuild_every * md.dt_fs * 1e-3
    if frames.shape[0] >= 20:
        t_ps, msd = mean_squared_displacement(frames, system.box,
                                              dt_sample_ps, species=species)
        extra["diffusion_m2_s"] = diffusion_coefficient(t_ps, msd)
        if frames_cl is not None and frames_cl.shape[0] >= 20:
            t_cl, msd_cl = mean_squared_displacement(
                frames_cl, system.box, dt_sample_ps, species=species)
            extra["classical_diffusion_m2_s"] = diffusion_coefficient(
                t_cl, msd_cl)

    if args.pe:
        # The classical potential energy along the GNN trajectory (and the
        # classical one): a drifting or heating rollout shows as a PE
        # offset or trend.
        pe_fn = pe_function(args, system.box)

        def pe_series(traj):
            with torch.no_grad():
                return np.array([float(pe_fn(p)) for p in traj])

        pe_gnn = pe_series(frames)
        pe_cl = pe_series(frames_cl) if frames_cl is not None else None
        pe_path = args.pe_out or ((args.json_out or "rollout") + "_pe.tsv")
        write_pe_tsv(pe_path, pe_gnn, pe_cl, n_equil, dt_sample_ps)
        print(f"PE series written to {pe_path}")
        extra["pe_gnn_mean_kj_mol"] = float(pe_gnn.mean())
        extra["pe_gnn_std_kj_mol"] = float(pe_gnn.std())
        tt = np.arange(len(pe_gnn)) * dt_sample_ps
        extra["pe_gnn_drift_kj_mol_ps"] = float(
            np.polyfit(tt, pe_gnn, 1)[0]) if len(pe_gnn) > 2 else 0.0
        if pe_cl is not None:
            extra["pe_classical_mean_kj_mol"] = float(pe_cl.mean())
            extra["pe_classical_std_kj_mol"] = float(pe_cl.std())

    temps = result.thermo.temperature.cpu().numpy()
    report = {
        **extra,
        "rdf_l2": rdf_l2(g_gnn, g_gt),
        "rdf_peak_gnn": float(g_gnn.max()),
        "rdf_peak_gt": float(g_gt.max()),
        "rdf_peak_pos_gnn": float(r[g_gnn.argmax()]),
        "rdf_peak_pos_gt": float(r[g_gt.argmax()]),
        "temperature_mean": float(temps[len(temps) // 2:].mean()),
        "temperature_target": system.temperature,
        "n_rollout_frames": int(frames.shape[0]),
        "n_gt_frames": int(gt_frames.shape[0]),
        "steps": args.steps,
        "rollout_steps_per_s_incl_compile": float(args.steps / rollout_s),
    }
    for k, v in report.items():
        print(f"{k}: {v}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({**report, "r": r.tolist(), "g_gnn": g_gnn.tolist(),
                       "g_gt": g_gt.tolist()}, f)
    return report


if __name__ == "__main__":
    main()
