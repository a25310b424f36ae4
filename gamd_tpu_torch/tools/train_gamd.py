"""Train a GAMD GNN force field: the port of scripts/train_gamd.py, with
the same flags and defaults.

`--system lj|tip3p|tip4p` trains on the data_{seed}_{t}.npz frames under
`--data_dir` (its `lj_data`, `water_data` or `tip4p_data`, or the directory
itself when it has that name), split 90/10 as the reference, through
train.loop.train: checkpoint_{epoch}.msgpack and scaler_{epoch}.npz every
`--checkpoint_every` epochs and at the last, best.msgpack, scaler_best.npz
and best_val.txt whenever the validation MAE improves, all under
`--cp_dir`, in the JAX package's checkpoint layout (either package reads
them). `--use_pallas` runs every conv layer's edge pipeline through the
CUDA kernel pair conv_msg_gather (forward) and conv_msg_gather_bwd
(backward). `--relabel` (LJ) recomputes the labels at the augmented
positions with the classical LJ forces. `--state_ckpt_dir` (a checkpoint
file) with `--start_epoch` resumes a run: the resumed epochs equal the
straight run's bit for bit.

Refused with NotImplementedError before any work, naming the ROADMAP item
(Queue 1) that brings it: `--system dft`, `--relabel` on water (Ewald),
`--longrange`, `--rigid_jitter`, `--update_edge`, `--disable_expand_edge`
and `--num_device` above 1. The port always trains in fp32 with TF32 off;
`--matmul_precision` is read so that JAX command lines run unchanged.

It runs on the CUDA card; `--cpu` runs the plain PyTorch versions on the
CPU instead. Example (the verify loop's step 2):

    python3 -m gamd_tpu_torch.tools.train_gamd --system lj \\
        --data_dir /tmp/vds --sample_num 60 --seed_num 1 --max_epoch 3 \\
        --batch_size 6 --use_layer_norm --use_pallas --cp_dir /tmp/vck
"""

import argparse
import os

WATER_ITEM = "the water slice of the port (ROADMAP Queue 1 item 5)"
DFT_ITEM = "the DFT slice of the port (ROADMAP Queue 1 item 5)"
MULTI_DEVICE = "multi-device training (ROADMAP Queue 1 item 7)"
#: --system -> the dataset's subdirectory (scripts/train_gamd.py).
SUBDIRS = {"lj": "lj_data", "tip3p": "water_data", "tip4p": "tip4p_data"}


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--system", default="lj",
                        choices=["lj", "tip3p", "tip4p", "dft"])
    parser.add_argument("--min_epoch", default=30, type=int)
    parser.add_argument("--max_epoch", default=30, type=int)
    parser.add_argument("--lr", default=3e-4, type=float)
    parser.add_argument("--lr_decay", default=0.001, type=float,
                        help="total LR decay over the run (StepLR gamma = "
                             "decay**(5/epochs)); 1.0 = constant LR")
    parser.add_argument("--cp_dir", default="./model_ckpt")
    parser.add_argument("--state_ckpt_dir", default=None, type=str,
                        help="checkpoint file to resume from")
    parser.add_argument("--start_epoch", default=0, type=int,
                        help="resume: first epoch index to run (use with "
                        "--state_ckpt_dir; LR continues from opt_state)")
    parser.add_argument("--batch_size", default=1, type=int)
    parser.add_argument("--encoding_size", default=128, type=int)
    parser.add_argument("--hidden_dim", default=128, type=int)
    parser.add_argument("--edge_embedding_dim", default=128, type=int)
    parser.add_argument("--conv_layer", default=4, type=int)
    parser.add_argument("--cutoff", default=None, type=float)
    parser.add_argument("--drop_edge", action="store_true")
    parser.add_argument("--use_layer_norm", action="store_true")
    parser.add_argument("--update_edge", action="store_true",
                        help="not ported (DFT slice)")
    parser.add_argument("--use_pallas", action="store_true",
                        help="every conv layer through the CUDA kernel pair "
                             "conv_msg_gather (forward and backward)")
    parser.add_argument("--disable_expand_edge", dest="expand_edge",
                        default=True, action="store_false",
                        help="not ported (DFT slice)")
    parser.add_argument("--disable_rotate_aug", dest="rotate_aug",
                        default=True, action="store_false")
    parser.add_argument("--use_part", action="store_true",
                        help="dft only (not ported)")
    parser.add_argument("--data_dir", default="./md_dataset")
    parser.add_argument("--sample_num", default=1000, type=int,
                        help="frames per seed in the dataset")
    parser.add_argument("--extra_seeds", default=0, type=int,
                        help="extra train-only trajectory seeds appended "
                             "beyond --seed_num (the canonical 90/10 split "
                             "and its held-out eval set are unchanged)")
    parser.add_argument("--seed_num", default=10, type=int,
                        help="number of generation seeds in the dataset")
    parser.add_argument("--precompute_nbrs", action="store_true",
                        help="build per-frame neighbor lists once instead "
                             "of per step (exact: search precedes jitter; "
                             "rotation aug preserves distances)")
    parser.add_argument("--no_pack", action="store_true",
                        help="disable the packed-dataset cache")
    parser.add_argument("--loss", default="mae",
                        choices=["mae", "mse", "relmae"])
    parser.add_argument("--checkpoint_every", default=None, type=int,
                        help="override checkpoint cadence (default: preset "
                             "5, or 50 for the dft system)")
    parser.add_argument("--lambda_cosine", default=0.0, type=float,
                        help="weight of the 1-cos angular fine-tune term "
                             "(0 = exact reference loss)")
    parser.add_argument("--num_device", default=-1, type=int,
                        help="devices for data parallelism (-1 = all); the "
                             "port trains on one")
    parser.add_argument("--relabel", action="store_true",
                        help="lj: recompute the labels at the augmented "
                             "positions with the classical LJ forces each "
                             "step (water's Ewald oracle is not ported)")
    parser.add_argument("--jitter_sigma", default=None, type=float,
                        help="override position-jitter sigma (A)")
    parser.add_argument("--rigid_jitter", action="store_true",
                        help="not ported (water slice)")
    parser.add_argument("--longrange", action="store_true",
                        help="not ported (water slice: physics/ewald.py)")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch versions on the CPU")
    parser.add_argument("--matmul_precision", default="high",
                        choices=["default", "high", "highest"],
                        help="read and unused: the port always trains in "
                             "fp32 with TF32 off (the JAX package's TPU "
                             "matmul precision)")
    return parser


def refuse_unported(args):
    """NotImplementedError for what the port does not train yet."""
    if args.system == "dft":
        raise NotImplementedError(f"--system dft: comes with {DFT_ITEM}")
    if args.relabel and args.system != "lj":
        raise NotImplementedError(
            f"--relabel on {args.system} (the rigid Ewald oracle, "
            f"physics/ewald.py): comes with {WATER_ITEM}")
    for flag, on, item in (("--longrange", args.longrange, WATER_ITEM),
                           ("--rigid_jitter", args.rigid_jitter, WATER_ITEM),
                           ("--update_edge", args.update_edge, DFT_ITEM),
                           ("--disable_expand_edge", not args.expand_edge,
                            DFT_ITEM)):
        if on:
            raise NotImplementedError(f"{flag}: comes with {item}")
    if args.num_device > 1:
        raise NotImplementedError(f"--num_device {args.num_device}: comes "
                                  f"with {MULTI_DEVICE}")


def configs(args):
    """(system, model_cfg, train_cfg) of the CLI's flags."""
    from gamd_tpu_torch.core.config import (ModelConfig, TrainConfig,
                                            get_preset)

    system = get_preset(args.system)
    if args.cutoff is not None:
        system = get_preset(args.system, cutoff=args.cutoff)
    model_cfg = ModelConfig(
        encoding_size=args.encoding_size, hidden_dim=args.hidden_dim,
        edge_embedding_dim=args.edge_embedding_dim,
        conv_layers=args.conv_layer, drop_edge=args.drop_edge,
        use_layer_norm=args.use_layer_norm, update_edge=args.update_edge,
        expand_edge=args.expand_edge, flip_dir=False,
        use_pallas=args.use_pallas, longrange="")
    train_cfg = TrainConfig(
        lr=args.lr, min_epoch=args.min_epoch, max_epoch=args.max_epoch,
        lr_total_decay=args.lr_decay, batch_size=args.batch_size,
        loss=args.loss, lambda_net_force=1e-3,
        lambda_cosine=args.lambda_cosine, rotate_aug=args.rotate_aug,
        jitter_sigma=(args.jitter_sigma if args.jitter_sigma is not None
                      else 0.005),
        rigid_jitter=False,
        checkpoint_every=(args.checkpoint_every
                          if args.checkpoint_every is not None else 5),
        precompute_nbrs=args.precompute_nbrs, start_epoch=args.start_epoch)
    return system, model_cfg, train_cfg


def datasets(args):
    """(train, test) TrajectoryDatasets of the CLI's flags, with the pack
    cache under the data directory unless --no_pack."""
    from gamd_tpu_torch.train.data import TrajectoryDataset

    sub = SUBDIRS[args.system]
    path = (args.data_dir if os.path.basename(args.data_dir) == sub
            else os.path.join(args.data_dir, sub))
    cache = None
    if not args.no_pack:
        name = ("_packed_cache.npz" if not args.extra_seeds else
                f"_packed_cache_s{args.seed_num + args.extra_seeds}.npz")
        cache = os.path.join(path, name)
    return tuple(TrajectoryDataset(
        path, mode=mode, data_type=args.system, sample_num=args.sample_num,
        seed_num=args.seed_num, extra_seed_num=args.extra_seeds,
        pack_cache=cache) for mode in ("train", "test"))


def main(argv=None, log_fn=print, history=None):
    """Train as the flags say; returns the final TrainState. log_fn gets
    every line the run logs; `history`, if given, each epoch's record
    (train.loop.train)."""
    args = build_parser().parse_args(argv)
    refuse_unported(args)

    from gamd_tpu_torch.core.device import resolve_device
    from gamd_tpu_torch.tools.run_md import pin_fp32
    from gamd_tpu_torch.train.checkpoint import load_checkpoint
    from gamd_tpu_torch.train.loop import train
    from gamd_tpu_torch.train.state import create_train_state

    device = resolve_device("cpu" if args.cpu else "cuda")
    pin_fp32()
    system, model_cfg, train_cfg = configs(args)
    train_data, val_data = datasets(args)
    state = None
    if args.state_ckpt_dir:
        template = create_train_state(
            model_cfg, system, train_cfg,
            max(len(train_data) // args.batch_size, 1), device=device)
        state = load_checkpoint(args.state_ckpt_dir, template)
        log_fn(f"Resumed from {args.state_ckpt_dir}")

    relabel_fn = None
    if args.relabel:
        from gamd_tpu_torch.tools.lj_train_slice import lj_relabel_fn
        relabel_fn = lj_relabel_fn(system.n_atoms)
        log_fn("Exact-relabel augmentation: classical oracle labels at "
               f"jittered positions (sigma={train_cfg.jitter_sigma} A)")

    return train(system, model_cfg, train_cfg, train_data, val_data,
                 ckpt_dir=args.cp_dir, log_fn=log_fn, state=state,
                 relabel_fn=relabel_fn, device=device, history=history)


if __name__ == "__main__":
    main()
