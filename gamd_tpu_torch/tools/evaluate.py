"""Offline force accuracy on the held-out test split: the port of
scripts/evaluate.py, with the same flags and metrics.

The checkpoint (self-describing envelope, or a legacy one with the
architecture flags) is loaded by train.checkpoint.load_self_describing
into a GNNForceField; every test frame of the data_{seed}_{t}.npz set in
`--data_dir` (the 90/10 split of `--seed_num` x `--sample_num` frames) is
predicted by GNNForceField.predict_batch, and force_metrics compares the
predictions with the labels in eV/A: cosine similarity, MAE, RMSE,
relative MAE (by the mean label norm, and by the mean |component|), the
outlier ratio, the per-sample MAE's spread, and the cosine and MAE by
decile of the label's magnitude. `--use_pallas` runs every conv layer
through the CUDA kernel conv_msg_gather. `--system lj|tip3p|tip4p`; a
checkpoint with the long-range channel predicts the model's short-range
part plus the analytic k-space Ewald force, so it is scored against the
full labels. `--system dft` scores the RPBE set's test frames
(train.data.RealLargeDataset of the npz `--data_dir`), each predicted
alone at its own box by GNNForceField.predict, from Ha/bohr into eV/A
(scripts/evaluate.py:75-91).

It runs on the CUDA card; `--cpu` runs the plain PyTorch versions on the
CPU instead. Example (the verify loop's step 3):

    python3 -m gamd_tpu_torch.tools.evaluate --system lj \\
        --ckpt /tmp/vck/checkpoint_2.msgpack --data_dir /tmp/vds/lj_data \\
        --sample_num 60 --seed_num 1 --use_pallas
    python3 -m gamd_tpu_torch.tools.evaluate --system dft \\
        --ckpt results/ckpts/dftlarge_final.msgpack \\
        --data_dir md_dataset/RPBE-surrogate.npz
"""

import argparse
import json

import numpy as np

def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--system", default="lj",
                        choices=["lj", "tip3p", "tip4p", "dft"])
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--data_dir", required=True)
    # Architecture fallbacks for LEGACY checkpoints only: envelope
    # checkpoints embed their ModelConfig/SystemConfig and ignore these.
    parser.add_argument("--encoding_size", default=128, type=int)
    parser.add_argument("--hidden_dim", default=128, type=int)
    parser.add_argument("--edge_embedding_dim", default=128, type=int)
    parser.add_argument("--conv_layer", default=4, type=int)
    parser.add_argument("--use_layer_norm", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="legacy-checkpoint fallback: LayerNorm (default)"
                             " vs BatchNorm (--no-use_layer_norm)")
    parser.add_argument("--use_pallas", action="store_true",
                        help="every conv layer through the CUDA kernel "
                             "conv_msg_gather")
    parser.add_argument("--max_frames", default=None, type=int)
    parser.add_argument("--sample_num", default=1000, type=int)
    parser.add_argument("--seed_num", default=10, type=int)
    parser.add_argument("--json_out", default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch versions on the CPU")
    return parser


def force_metrics(pred, gt):
    """scripts/evaluate.py's metrics of predicted and label forces [M, N, 3]
    (numpy, eV/A)."""
    flat_p = pred.reshape(-1, 3)
    flat_g = gt.reshape(-1, 3)
    cos = np.sum(flat_p * flat_g, axis=1) / (
        np.linalg.norm(flat_p, axis=1) * np.linalg.norm(flat_g, axis=1)
        + 1e-12)
    err = flat_p - flat_g
    mae = np.abs(err).mean()
    ratio = np.abs(err.reshape(-1)) / (np.abs(flat_p.reshape(-1)) + 1e-8)
    gnorm = np.linalg.norm(flat_g, axis=1)
    deciles = np.quantile(gnorm, np.linspace(0, 1, 11))
    cos_by_decile, mae_by_decile, edge_lo = [], [], []
    for d in range(10):
        lo, hi = deciles[d], deciles[d + 1]
        sel = (gnorm >= lo) & (gnorm <= hi if d == 9 else gnorm < hi)
        cos_by_decile.append(float(cos[sel].mean()))
        mae_by_decile.append(float(np.abs(err[sel]).mean()))
        edge_lo.append(float(lo))
    return {
        "frames": int(pred.shape[0]),
        "force_cosine_similarity": float(cos.mean()),
        "force_mae_ev_a": float(mae),
        "force_rmse_ev_a": float(np.sqrt((err ** 2).mean())),
        "relative_mae": float(mae / gnorm.mean()),
        "relative_mae_component": float(mae / np.abs(flat_g).mean()),
        "outlier_ratio": float((ratio > 10.0).mean()),
        "per_sample_mae_std": float(
            np.abs(pred - gt).mean(axis=(1, 2)).std()),
        "cosine_by_gt_magnitude_decile": cos_by_decile,
        "mae_by_gt_magnitude_decile": mae_by_decile,
        "gt_magnitude_decile_edges_ev_a": edge_lo,
        "gt_force_norm_median_ev_a": float(np.median(gnorm)),
    }


def main(argv=None):
    """Evaluate as the flags say; prints the metrics and returns them."""
    args = build_parser().parse_args(argv)

    from gamd_tpu_torch.core import units
    from gamd_tpu_torch.core.config import ModelConfig, get_preset
    from gamd_tpu_torch.core.device import resolve_device
    from gamd_tpu_torch.tools.run_md import pin_fp32
    from gamd_tpu_torch.train.checkpoint import load_self_describing
    from gamd_tpu_torch.train.data import RealLargeDataset, TrajectoryDataset
    from gamd_tpu_torch.train.forcefield import GNNForceField

    device = resolve_device("cpu" if args.cpu else "cuda")
    pin_fp32()
    fallback_cfg = ModelConfig(
        encoding_size=args.encoding_size, hidden_dim=args.hidden_dim,
        edge_embedding_dim=args.edge_embedding_dim,
        conv_layers=args.conv_layer, use_layer_norm=args.use_layer_norm,
        flip_dir=args.system == "dft")
    state, model_cfg, system = load_self_describing(
        args.ckpt, fallback_model_cfg=fallback_cfg,
        fallback_system=get_preset(args.system), use_pallas=args.use_pallas)
    ff = GNNForceField(state, system, model_cfg, device=device)

    dft = args.system == "dft"
    if dft:
        ds = RealLargeDataset(args.data_dir, mode="test")
        to_ev_a = units.HARTREE_TO_KJ_MOL / units.BOHR_TO_ANGSTROM \
            * units.KJ_MOL_NM_TO_EV_A * 10.0     # Ha/bohr -> eV/A
    else:
        ds = TrajectoryDataset(args.data_dir, mode="test",
                               data_type=args.system,
                               sample_num=args.sample_num,
                               seed_num=args.seed_num)
        to_ev_a = units.KJ_MOL_NM_TO_EV_A
    n = len(ds) if args.max_frames is None else min(len(ds),
                                                     args.max_frames)
    items = [ds[i] for i in range(n)]
    gt = np.stack([it["forces"] for it in items]) * to_ev_a
    if dft:      # a box a frame: one frame a prediction
        pred = np.stack([ff.predict(it["pos"], box=it["box_size"])
                         .cpu().numpy() for it in items]) * to_ev_a
    else:
        pos_all = np.stack([it["pos"] for it in items])
        pred = ff.predict_batch(pos_all).cpu().numpy() * to_ev_a
    metrics = force_metrics(pred, gt)
    for k, v in metrics.items():
        print(f"{k}: {v}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
