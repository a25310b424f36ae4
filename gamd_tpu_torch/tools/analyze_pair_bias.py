"""Pair-distance-resolved force-bias analysis, the LJ RDF-gate diagnosis
(port of scripts/analyze_pair_bias.py: the same arguments and JSON
output).

On held-out test frames, each atom's force error is projected onto each of
its pair directions and binned by pair distance,

    b(r) = E[ (F_pred_i - F_gt_i) . rhat_ij | |r_ij| = r ],

rhat_ij the unit vector from j to i (b > 0: excess repulsion), by
physics.pair_bias.pair_projection_profile on the device; the same
projection of the labels against the analytic LJ pair force calibrates
the estimator, and -b integrated inward from the cutoff is the effective
pair-potential bias du(r). The checkpoint is read by the port's
load_self_describing and the frames by train.data.TrajectoryDataset (the
test split; `--sample_num` and `--seed_num`, the JAX defaults 1000 and
10, describe the set).

    python3 -m gamd_tpu_torch.tools.analyze_pair_bias \\
        --ckpt results/ckpts/lj_distill_best.msgpack \\
        --data_dir md_dataset/lj_data --json_out /tmp/bias.json

It runs on the CUDA card; `--cpu` runs the plain versions on the CPU.
"""

import argparse
import json

import numpy as np
import torch


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--max_frames", default=200, type=int)
    parser.add_argument("--n_bins", default=45, type=int)
    parser.add_argument("--r_min", default=3.0, type=float)
    parser.add_argument("--json_out", default=None)
    parser.add_argument("--sample_num", default=1000, type=int,
                        help="frames per seed in the dataset")
    parser.add_argument("--seed_num", default=10, type=int,
                        help="generation seeds in the dataset")
    parser.add_argument("--cpu", action="store_true")
    return parser


def main(argv=None) -> dict:
    """Prints the report; returns the JSON output as a dict."""
    args = build_parser().parse_args(argv)
    from gamd_tpu_torch.core import units
    from gamd_tpu_torch.core.config import ModelConfig, get_preset
    from gamd_tpu_torch.core.device import resolve_device
    from gamd_tpu_torch.physics.lennard_jones import LJParams
    from gamd_tpu_torch.physics.pair_bias import pair_projection_profile
    from gamd_tpu_torch.tools.run_md import pin_fp32
    from gamd_tpu_torch.train.checkpoint import load_self_describing
    from gamd_tpu_torch.train.data import TrajectoryDataset
    from gamd_tpu_torch.train.forcefield import GNNForceField

    dev = resolve_device("cpu" if args.cpu else "cuda")
    pin_fp32()
    state, model_cfg, system = load_self_describing(
        args.ckpt, fallback_model_cfg=ModelConfig(),
        fallback_system=get_preset("lj"))
    ff = GNNForceField(state, system, model_cfg, device=dev)
    box, cutoff = float(system.box), float(system.cutoff)

    ds = TrajectoryDataset(args.data_dir, sample_num=args.sample_num,
                           seed_num=args.seed_num, mode="test",
                           data_type="lj")
    n = min(len(ds), args.max_frames)
    items = [ds[i] for i in range(n)]
    to_ev_a = units.KJ_MOL_NM_TO_EV_A
    gt = torch.as_tensor(np.stack([it["forces"] for it in items]),
                         device=dev).double() * to_ev_a        # [M, N, 3]
    pos = torch.as_tensor(np.stack([it["pos"] for it in items]),
                          device=dev).double()
    pred = ff.predict_batch(pos.float()).double() * to_ev_a
    err = pred - gt

    edges = np.linspace(args.r_min, cutoff, args.n_bins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    bias, cnt = pair_projection_profile(pos, err, box, edges)
    gt_proj, _ = pair_projection_profile(pos, gt, box, edges)
    # The analytic (shifted-potential) LJ pair force along rhat:
    # f(r) = 24 eps (2 (sigma/r)^12 - (sigma/r)^6) / r [kJ/mol/A] -> eV/A
    lj = LJParams()
    s6 = (lj.sigma / centers) ** 6
    f_lj = 24.0 * lj.epsilon * (2 * s6 * s6 - s6) / centers * (
        units.KJ_MOL_NM_TO_EV_A * 10.0)
    # The bias force is -d(du)/dr, so du(r) = + integral_r^cutoff b(s) ds.
    w = np.diff(edges)
    du = np.cumsum((bias * w)[::-1])[::-1]
    out = {
        "frames": int(n),
        "r_bins_a": centers.tolist(),
        "pair_force_bias_ev_a": bias.tolist(),
        "pair_count": cnt.tolist(),
        "gt_pair_projection_ev_a": gt_proj.tolist(),
        "analytic_lj_pair_force_ev_a": f_lj.tolist(),
        "effective_pair_potential_bias_ev": du.tolist(),
        "du_at_min_ev": float(du[np.argmin(np.abs(centers - 3.816))]),
        "bias_rms_ev_a": float(np.sqrt((bias**2).mean())),
        "estimator_calibration_rms_ev_a": float(
            np.sqrt(((gt_proj - f_lj) ** 2).mean())),
    }
    for k in ("frames", "du_at_min_ev", "bias_rms_ev_a",
              "estimator_calibration_rms_ev_a"):
        print(f"{k}: {out[k]}")
    print("r(A)   bias(eV/A)   gt_proj     f_lj        du(eV)      count")
    for i in range(args.n_bins):
        print(f"{centers[i]:6.3f} {bias[i]:+.5e} {gt_proj[i]:+.5e} "
              f"{f_lj[i]:+.5e} {du[i]:+.5e} {cnt[i]}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
