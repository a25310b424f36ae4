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
(backward). `--relabel` recomputes the labels at the augmented positions
with the classical oracle: the LJ forces, or for tip3p the rigid TIP3P
forces with full Ewald electrostatics (the set must be Ewald-generated).
`--rigid_jitter` (water, with `--relabel`) moves each molecule rigidly in
place of the per-atom jitter. `--longrange` (tip3p, tip4p) trains the
model on the short-range residual: the analytic k-space Ewald force
(train.forcefield.make_longrange_force_fn) is subtracted from the packed
labels and from the relabelled forces, and the checkpoint records
longrange="ewald_recip", so every deployment adds it back.
`--state_ckpt_dir` (a checkpoint file) with `--start_epoch` resumes a run:
the resumed epochs equal the straight run's bit for bit.

`--system dft` trains the dynamic-box model on the RPBE set: `--data_dir`
is the npz itself (md_dataset/RPBE-surrogate.npz, train.data.
RealLargeDataset; `--use_part` its first 1,500 training frames), each
frame with its own box, flip_dir, lambda_net_force 0.5e-2, jitter 0.00025
bohr and a checkpoint every 50 epochs by default, as the JAX CLI
(scripts/train_gamd.py:133-176); `--update_edge` (each conv layer's
normalised edge embedding feeds the next; its conv layers run the plain
edge pipeline under `--use_pallas`, as JAX's) and `--disable_expand_edge`
(no RBF channel) are the DFT model's switches and train on any system.
At the DFT widths (`--encoding_size 256 --edge_embedding_dim 256`, hidden
128) `--use_pallas` runs the conv kernel pair at E = D = 256.

`--num_device N` above 1 trains data-parallel over N ranks
(parallel.mesh): N processes spawned with torch.multiprocessing, one card
each with the nccl backend, or with `--cpu` N CPU processes with gloo;
each rank takes a contiguous share of every batch and rank 0 logs and
writes the checkpoints (main then returns None: the state lives in the
ranks). The default, -1, is every visible card (one process with
`--cpu`). As the JAX CLI (scripts/train_gamd.py:204-207), an N that does
not divide `--batch_size` trains in one process, and says so; an N above
the visible cards raises before any work (JAX would run on the devices it
has). The port always trains in fp32 with TF32 off; `--matmul_precision`
is read so that JAX command lines run unchanged.

It runs on the CUDA card; `--cpu` runs the plain PyTorch versions on the
CPU instead. Example (the verify loop's step 2):

    python3 -m gamd_tpu_torch.tools.train_gamd --system lj \\
        --data_dir /tmp/vds --sample_num 60 --seed_num 1 --max_epoch 3 \\
        --batch_size 6 --use_layer_norm --use_pallas --cp_dir /tmp/vck
    python3 -m gamd_tpu_torch.tools.train_gamd --system tip3p \\
        --data_dir /tmp/wds --longrange --relabel --rigid_jitter \\
        --use_pallas --use_layer_norm --cp_dir /tmp/wck
    python3 -m gamd_tpu_torch.tools.train_gamd --system dft \\
        --data_dir md_dataset/RPBE-surrogate.npz --cutoff 9.5 \\
        --conv_layer 5 --encoding_size 256 --edge_embedding_dim 256 \\
        --use_layer_norm --use_pallas --cp_dir /tmp/dck
    python3 -m gamd_tpu_torch.tools.train_gamd --system lj \\
        --data_dir /tmp/vds --batch_size 4 --num_device 2 --cpu \\
        --cp_dir /tmp/vck2
"""

import argparse
import os
import tempfile

import torch

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
                        help="each conv layer's normalised edge embedding "
                             "is the next layer's edges (DFT model)")
    parser.add_argument("--use_pallas", action="store_true",
                        help="every conv layer through the CUDA kernel pair "
                             "conv_msg_gather (forward and backward)")
    parser.add_argument("--disable_expand_edge", dest="expand_edge",
                        default=True, action="store_false",
                        help="no RBF expansion of the edge length")
    parser.add_argument("--disable_rotate_aug", dest="rotate_aug",
                        default=True, action="store_false")
    parser.add_argument("--use_part", action="store_true",
                        help="dft: the first 1,500 training frames")
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
                        help="ranks for data parallelism (-1 = every "
                             "visible card; one process with --cpu)")
    parser.add_argument("--relabel", action="store_true",
                        help="recompute the labels at the augmented "
                             "positions with the classical oracle each step "
                             "(lj: dense LJ; tip3p: rigid Ewald, the "
                             "dataset must be Ewald-generated)")
    parser.add_argument("--jitter_sigma", default=None, type=float,
                        help="override position-jitter sigma (A)")
    parser.add_argument("--rigid_jitter", action="store_true",
                        help="rigid per-molecule jitter (translation and a "
                             "small rotation about each molecule's "
                             "centroid) in place of per-atom noise; "
                             "requires --relabel")
    parser.add_argument("--longrange", action="store_true",
                        help="tip3p/tip4p: train on the short-range "
                             "residual (labels less the analytic k-space "
                             "Ewald force); the checkpoint records it and "
                             "every deployment adds it back")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch versions on the CPU")
    parser.add_argument("--matmul_precision", default="high",
                        choices=["default", "high", "highest"],
                        help="read and unused: the port always trains in "
                             "fp32 with TF32 off (the JAX package's TPU "
                             "matmul precision)")
    return parser


def n_ranks(args, log_fn=print) -> int:
    """The data-parallel ranks of --num_device: -1 is every visible card
    (1 with --cpu); 1 where the count does not divide --batch_size (as the
    JAX CLI, said in the log); a count above 1 and above the visible cards
    raises RuntimeError (without --cpu)."""
    cards = torch.cuda.device_count()
    n = args.num_device
    if n == -1:
        n = 1 if args.cpu else max(cards, 1)
    if not args.cpu and n > 1 and n > cards:
        raise RuntimeError(f"--num_device {n} asks for {n} cards; torch "
                           f"finds {cards} (add --cpu for CPU ranks)")
    if n > 1 and args.batch_size % n:
        log_fn(f"--num_device {n} does not divide --batch_size "
               f"{args.batch_size}: training in one process")
        return 1
    return max(n, 1)


def check_flags(parser, args):
    """The JAX CLI's parser errors on the water flags
    (scripts/train_gamd.py:147-156 and its --relabel branch)."""
    water = args.system in ("tip3p", "tip4p")
    if args.longrange and not water:
        parser.error("--longrange supports tip3p and tip4p (fixed-box "
                     "water presets) only")
    if args.longrange and args.no_pack:
        parser.error("--longrange requires the packed dataset cache")
    if args.rigid_jitter and not args.relabel:
        parser.error("--rigid_jitter requires --relabel (stored labels are "
                     "wrong at rigidly displaced positions)")
    if args.rigid_jitter and not water:
        parser.error("--rigid_jitter supports rigid-water systems only")
    if args.relabel and args.system not in ("lj", "tip3p"):
        parser.error("--relabel supports lj and tip3p only")


def make_relabel_fn(system, longrange: bool):
    """The --relabel oracle, pos [B, N, 3] -> forces [B, N, 3] in the
    dataset's kJ/mol/nm: the LJ forces at the generation box, or the rigid
    TIP3P forces with full Ewald electrostatics at the preset's box
    (make_ewald_params(box): cutoff 10 A); with longrange, less the
    analytic k-space force (the labels' own subtraction)."""
    from gamd_tpu_torch.core import units
    from gamd_tpu_torch.physics import ewald, water
    from gamd_tpu_torch.tools.lj_train_slice import lj_relabel_fn
    from gamd_tpu_torch.train.forcefield import make_longrange_force_fn

    if system.name == "lj":
        return lj_relabel_fn(system.n_atoms)
    to_ds = 1.0 / units.KJ_MOL_NM_TO_INTERNAL
    box = system.box
    ew = ewald.make_ewald_params(box)
    params = water.TIP3PParams()
    lr = make_longrange_force_fn(system) if longrange else None

    def relabel(pos):
        f = ewald.neg_grad(water.tip3p_energy_rigid_ewald, pos, box, ew,
                           params)
        return (f if lr is None else f - lr(pos)) * to_ds
    return relabel


def subtract_longrange(system, datasets, device, chunk=8):
    """Each dataset's packed labels less the analytic k-space force of its
    positions in kJ/mol/nm, `chunk` frames a call on `device`."""
    from gamd_tpu_torch.core import units
    from gamd_tpu_torch.train.forcefield import make_longrange_force_fn

    lr = make_longrange_force_fn(system)
    to_ds = 1.0 / units.KJ_MOL_NM_TO_INTERNAL

    def offset(pos):
        p = torch.as_tensor(pos, dtype=torch.float32, device=device)
        return (lr(p) * to_ds).cpu().numpy()
    for ds in datasets:
        ds.subtract_from_labels(offset, chunk=chunk)


def configs(args):
    """(system, model_cfg, train_cfg) of the CLI's flags."""
    from gamd_tpu_torch.core.config import (ModelConfig, TrainConfig,
                                            get_preset)

    system = get_preset(args.system)
    if args.cutoff is not None:
        system = get_preset(args.system, cutoff=args.cutoff)
    dft = args.system == "dft"
    model_cfg = ModelConfig(
        encoding_size=args.encoding_size, hidden_dim=args.hidden_dim,
        edge_embedding_dim=args.edge_embedding_dim,
        conv_layers=args.conv_layer, drop_edge=args.drop_edge,
        use_layer_norm=args.use_layer_norm, update_edge=args.update_edge,
        expand_edge=args.expand_edge, flip_dir=dft,
        use_pallas=args.use_pallas,
        longrange="ewald_recip" if args.longrange else "")
    # The DFT run's LAMBDA2, jitter (bohr) and cadence
    # (scripts/train_gamd.py:162-176).
    train_cfg = TrainConfig(
        lr=args.lr, min_epoch=args.min_epoch, max_epoch=args.max_epoch,
        lr_total_decay=args.lr_decay, batch_size=args.batch_size,
        loss=args.loss, lambda_net_force=0.5e-2 if dft else 1e-3,
        lambda_cosine=args.lambda_cosine, rotate_aug=args.rotate_aug,
        jitter_sigma=(args.jitter_sigma if args.jitter_sigma is not None
                      else 0.00025 if dft else 0.005),
        rigid_jitter=args.rigid_jitter,
        checkpoint_every=(args.checkpoint_every
                          if args.checkpoint_every is not None
                          else 50 if dft else 5),
        precompute_nbrs=args.precompute_nbrs, start_epoch=args.start_epoch)
    return system, model_cfg, train_cfg


def datasets(args):
    """(train, test) datasets of the CLI's flags: for dft RealLargeDataset
    of the npz --data_dir (--use_part on the training one), else
    TrajectoryDatasets with the pack cache under the data directory unless
    --no_pack."""
    from gamd_tpu_torch.train.data import RealLargeDataset, TrajectoryDataset

    if args.system == "dft":
        return (RealLargeDataset(args.data_dir, mode="train",
                                 use_part=args.use_part),
                RealLargeDataset(args.data_dir, mode="test"))

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
    """Train as the flags say; returns the final TrainState, or None after
    a data-parallel run (--num_device above 1: the ranks print the log and
    write the checkpoints). log_fn gets every line the run logs; `history`,
    if given, each epoch's record (train.loop.train); both serve the
    one-process run only."""
    parser = build_parser()
    args = parser.parse_args(argv)
    check_flags(parser, args)
    n = n_ranks(args, log_fn)
    if n == 1:
        return run(args, log_fn, history)
    datasets(args)       # read (and pack) once, before the ranks start
    backend = "gloo" if args.cpu else "nccl"
    log_fn(f"Data-parallel over {n} ranks ({backend})")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            rank_main, nprocs=n, join=True,
            args=(n, args, backend, f"file://{os.path.join(tmp, 'pg')}"))
    return None


def rank_main(rank, n, args, backend, init_method):
    """One rank of a data-parallel run: join the group, take card `rank`
    (nccl) or the CPU, and train on this rank's shares; rank 0 prints."""
    from gamd_tpu_torch.parallel.mesh import init_rank, make_mesh

    device = "cpu"
    if args.cpu:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    else:
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    init_rank(rank, n, backend, init_method)
    try:
        log_fn = (lambda line: print(line, flush=True)) if rank == 0 \
            else (lambda line: None)
        run(args, log_fn, None, make_mesh(device=device))
    finally:
        torch.distributed.destroy_process_group()


def run(args, log_fn=print, history=None, mesh=None):
    """The training of parsed flags in this process: alone, or as one rank
    of `mesh` (parallel.mesh.Mesh) on its device."""
    from gamd_tpu_torch.core.device import resolve_device
    from gamd_tpu_torch.tools.run_md import pin_fp32
    from gamd_tpu_torch.train.checkpoint import load_checkpoint
    from gamd_tpu_torch.train.loop import train
    from gamd_tpu_torch.train.state import create_train_state

    device = (mesh.device if mesh is not None
              else resolve_device("cpu" if args.cpu else "cuda"))
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
        relabel_fn = make_relabel_fn(system, args.longrange)
        log_fn("Exact-relabel augmentation: classical oracle labels at "
               f"jittered positions (sigma={train_cfg.jitter_sigma} A)")
    if args.longrange:
        log_fn("Long-range split: subtracting the analytic k-space Ewald "
               "force from the labels (GNN learns the short-range residual; "
               "deployment adds the analytic term back)")
        subtract_longrange(system, (train_data, val_data), device)

    return train(system, model_cfg, train_cfg, train_data, val_data,
                 ckpt_dir=args.cp_dir, mesh=mesh, log_fn=log_fn, state=state,
                 relabel_fn=relabel_fn, device=device, history=history)


if __name__ == "__main__":
    main()
