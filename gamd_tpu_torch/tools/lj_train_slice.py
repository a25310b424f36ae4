"""The configuration the port's training slice runs on the card: what
`scripts/train_gamd.py --system lj --use_pallas --use_layer_norm --relabel`
builds, cut to a few frames.

LJ-258 (box 27.27 A, cutoff 7.5 A, K=96, no skin or slice in training),
GAMD-small with the conv-message kernel pair (lj_model_config(use_pallas=
True): widths 128, 4 conv layers, LayerNorm, 40 RBF centres, edge dropout
0.1), TrainConfig() (lr 3e-4, batch 1, MAE, net-force 1e-3, rotation p 0.3,
jitter 0.005 A, staircase decay), labels recomputed at the augmented
positions by the classical LJ forces in the dataset's kJ/mol/nm, as the
CLI's --relabel. The frames are lj_fluid_box's start lattice and seeded
0.1 A Gaussian displacements of it. Shared by chip_smoke.py and
tools/profile_train.py.
"""

from typing import Callable, List, NamedTuple

import numpy as np
import torch

from gamd_tpu_torch.core import units
from gamd_tpu_torch.core.config import (ModelConfig, SystemConfig,
                                        TrainConfig, get_preset,
                                        lj_model_config)
from gamd_tpu_torch.physics.lennard_jones import (LJParams, lj_fluid_box,
                                                  lj_forces_dense)


N_FRAMES = 4      # the start lattice and three displaced copies
SEED = 0          # of the displacements


class LJTrainSlice(NamedTuple):
    system: SystemConfig
    model_cfg: ModelConfig
    train_cfg: TrainConfig
    relabel_fn: Callable        # pos [B, N, 3] -> forces [B, N, 3], kJ/mol/nm
    batches: List[dict]         # {"pos", "forces"} [1, N, 3] per frame


def lj_relabel_fn(n_atoms: int):
    """The CLI's LJ oracle: forces at the generation box (lj_fluid_box's
    27.27065 A, not the preset's rounded 27.27) in kJ/mol/nm."""
    params = LJParams()
    box, _ = lj_fluid_box(n_atoms, 0.5, params)
    to_dataset = 1.0 / units.KJ_MOL_NM_TO_INTERNAL

    def relabel(pos):
        return lj_forces_dense(pos, box, params) * to_dataset
    return relabel


def lj_train_slice(device, use_pallas: bool = True) -> LJTrainSlice:
    """The slice on `device` with N_FRAMES frames: the start lattice, then
    the lattice plus N(0, 0.1 A) displacements drawn with SEED, each
    labelled by the oracle."""
    system = get_preset("lj")
    model_cfg = lj_model_config(use_pallas=use_pallas)
    _, lattice = lj_fluid_box(system.n_atoms, 0.5)
    rng = np.random.default_rng(SEED)
    frames = [lattice] + [lattice + rng.normal(0.0, 0.1, lattice.shape)
                          for _ in range(N_FRAMES - 1)]
    pos = torch.as_tensor(np.mod(np.stack(frames), system.box).astype(
        np.float32), device=device)
    relabel = lj_relabel_fn(system.n_atoms)
    forces = relabel(pos)
    batches = [{"pos": pos[i:i + 1].contiguous(),
                "forces": forces[i:i + 1].contiguous()}
               for i in range(N_FRAMES)]
    return LJTrainSlice(system, model_cfg, TrainConfig(), relabel, batches)
