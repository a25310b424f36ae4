"""Large-N scaling benchmark: the port of scripts/bench_large.py, with the
same flags and the same JSON line per configuration.

LJ fluid at reduced density 0.5 (lj_fluid_box), K = --k_max at cutoff
7.5 A + 0.5 A skin through the cell-list search, BAOAB Langevin at 100 K,
2 fs, 25/ps, rebuilt every 20 steps:

* "classical-LJ cell-list N=..." rows: the classical LJ force, --steps
  steps;
* "GNN-MD cell-list N=..." (--gnn_size): GAMD-small (seeded weights) on
  the eager force path, max(--steps // 4, 20) steps;
* "GNN-MD banded N=... band=..." rows (--gnn_banded_sizes): the same
  model on the banded force path (every conv layer through the CUDA
  banded_msg kernel), max(--steps // 4, 20) steps.

Each row is the median of 3 timed runs from the same state after a warm
run. A row whose warm run overflowed the neighbour list, or whose state
went non-finite (a band overflow poisons the forces with NaN), prints
{"config": ..., "error": ...} instead. It runs on the CUDA card; --cpu
runs the plain PyTorch versions on the CPU. Example:

    python3 -m gamd_tpu_torch.tools.bench_large --sizes 10000 \\
        --gnn_size 4096 --gnn_banded_sizes 4096 10000 --steps 200
"""

import argparse
import json
import time

import torch

from gamd_tpu_torch.core.config import MDConfig, get_preset, lj_model_config
from gamd_tpu_torch.core.device import resolve_device
from gamd_tpu_torch.md.simulate import Simulation
from gamd_tpu_torch.ops import banded
from gamd_tpu_torch.physics import lennard_jones as lj
from gamd_tpu_torch.train.forcefield import GNNForceField
from gamd_tpu_torch.train.state import init_params

#: The benchmark's MD settings.
LARGE_MD = MDConfig(integrator="langevin", temperature=100.0, dt_fs=2.0,
                    friction_per_ps=25.0, rebuild_every=20)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", nargs="+", type=int,
                        default=[10_000, 100_000])
    parser.add_argument("--gnn_size", type=int, default=4096,
                        help="atoms for the GNN-MD large config (0 = skip)")
    parser.add_argument("--gnn_banded_sizes", nargs="*", type=int,
                        default=[4096, 10_000],
                        help="atoms for the banded-gather GNN-MD configs")
    parser.add_argument("--banded_tile", type=int, default=64)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--k_max", type=int, default=96)
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch versions on the CPU")
    return parser


def lj_large(n, k_max, device):
    """(system, start positions) of the benchmark's LJ fluid of n atoms:
    the box of reduced density 0.5, K = k_max, skin 0.5 A, the FCC start
    lattice on `device`."""
    box, pos = lj.lj_fluid_box(n, 0.5)
    system = get_preset("lj", n_atoms=n, box=float(box), nbr_capacity=k_max,
                        skin=0.5)
    return system, torch.as_tensor(pos, device=device)


def seeded_force_field(system, device) -> GNNForceField:
    """GAMD-small with init_params(seed=0) weights (identity scalers) on
    `system`."""
    model_cfg = lj_model_config()
    return GNNForceField(init_params(model_cfg, system, seed=0), system,
                         model_cfg, device=device)


def banded_layer_inputs(ff: GNNForceField, pos, idx, mask, layer,
                        band=None, tile_n=64):
    """The arguments of layer `layer`'s banded_conv_message call in
    ff.banded_force_fn(band, tile_n) on the frame (pos, idx, mask), the
    layers below run through the plain version: (e, idx_loc, mask, lo,
    nodes, dst_code, layer, mp, band, tile_n)."""
    system, cfg = ff.system, ff.model_cfg
    mp = ff._kernel_params("banded")
    if band is None:
        band = banded.auto_band(system.n_atoms, system.box, system.cutoff,
                                tile_n)
    band = min(band, -(-system.n_atoms // 16) * 16)
    perm, _, idx_s = banded.sort_by_x(pos, idx)
    length_mean, length_std = ff._length_scale()
    e, idx_loc, mask_s, lo, _, _ = banded.banded_edges(
        pos[perm], idx_s, mask[perm], mp, system.box, system.cutoff,
        length_mean, length_std, band, tile_n, rbf_gap=cfg.rbf_gap,
        flip_dir=cfg.flip_dir, mlp_act=cfg.mlp_activation)
    h = ff._node_h0()[perm]
    for below in range(layer + 1):
        hn, nodes, dst_code = banded.band_nodes(mp, below, h, band,
                                                cfg.use_layer_norm)
        if below < layer:
            agg = banded.banded_msg_reference(
                e, idx_loc, mask_s, lo, nodes, dst_code,
                *banded.layer_weights(mp, below), tile_n=tile_n)
            h = banded.node_update(mp, below, h, hn, agg)
    return e, idx_loc, mask_s, lo, nodes, dst_code, layer, mp, band, tile_n


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(sim, pos, steps, label, n, device) -> dict:
    """One configuration's row: a warm run, then the median of 3 timed runs
    of `steps` steps from the same state (generator seeded with 1)."""
    rng = torch.Generator(device=device)
    rng.manual_seed(1)
    st = sim.init_state(pos, rng=rng)
    r = sim.run(st, steps)
    _sync(device)
    if r.overflow:
        return {"config": label, "error": "nbr overflow"}
    if not bool(torch.isfinite(r.state.pos).all()):
        return {"config": label, "error": "non-finite state (band overflow "
                                          "poisons the forces)"}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = sim.run(st, steps)
        _sync(device)
        times.append(time.perf_counter() - t0)
    median = sorted(times)[1]
    sps = steps / median
    return {"config": label, "atoms": n, "steps_per_s": round(sps, 2),
            "atom_steps_per_s": round(sps * n, 0),
            "ms_per_step": round(1000 * median / steps, 3)}


def main(argv=None):
    """Print one JSON line per configuration; returns the rows."""
    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gnn_steps = max(args.steps // 4, 20)
    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    for n in args.sizes:
        system, pos = lj_large(n, args.k_max, device)
        sim = Simulation(lj.lj_force_fn(system.box), system, LARGE_MD,
                         nbr_method="cell", device=device)
        emit(bench(sim, pos, args.steps, f"classical-LJ cell-list N={n}", n,
                   device))

    if args.gnn_size:
        n = args.gnn_size
        system, pos = lj_large(n, args.k_max, device)
        ff = seeded_force_field(system, device)
        sim = Simulation(ff.force_fn(), system, LARGE_MD, nbr_method="cell",
                         device=device)
        emit(bench(sim, pos, gnn_steps, f"GNN-MD cell-list N={n}", n,
                   device))

    for n in args.gnn_banded_sizes:
        system, pos = lj_large(n, args.k_max, device)
        bfn = seeded_force_field(system, device).banded_force_fn(
            tile_n=args.banded_tile)
        sim = Simulation(bfn, system, LARGE_MD, nbr_method="cell",
                         device=device)
        emit(bench(sim, pos, gnn_steps,
                   f"GNN-MD banded N={n} band={bfn.banded_band}", n, device))
    return rows


if __name__ == "__main__":
    main()
