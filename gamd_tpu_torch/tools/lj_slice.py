"""The configuration the port's first slice runs on the card: LJ-258 with
GAMD-small, bench.py's workload with one force kernel per step.

Shared by chip_smoke.py and tools/profile_step.py so both drive the same
system, model, MD settings, weights and start frame.
"""

from typing import NamedTuple

import numpy as np
import torch

from gamd_tpu_torch.core import space
from gamd_tpu_torch.core.config import (MDConfig, ModelConfig, SystemConfig,
                                        get_preset, lj_model_config)
from gamd_tpu_torch.models.normalizer import RunningStat
from gamd_tpu_torch.neighbors.dense import build_nbrs, refresh_mask
from gamd_tpu_torch.physics.lennard_jones import lj_fluid_box
from gamd_tpu_torch.train.state import ForceFieldState, init_params

#: Nearest neighbours kept of the K=64 build list (bench.py's k_model).
K_MODEL = 48


class LJSlice(NamedTuple):
    system: SystemConfig
    model_cfg: ModelConfig
    md: MDConfig
    state: ForceFieldState
    pos: torch.Tensor          # [N, 3] wrapped start frame on the device


def edge_length_stat(pos, idx, mask, box, cutoff) -> RunningStat:
    """Edge-length scaler fitted on one frame's live edges, as training
    fits it, so the RBF channel sees realistic standardised distances."""
    live = refresh_mask(pos, box, cutoff, idx, mask)
    rel = space.min_image(pos[idx.long()] - pos[:, None, :], box)
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1))[live].double()
    mean = float(dist.mean())
    return RunningStat(count=float(dist.numel()), mean=mean,
                       m2=float(((dist - mean) ** 2).sum()))


def lj_slice(device, seed: int = 0) -> LJSlice:
    """LJ-258 (cutoff 7.5 A + 0.5 A skin, K=64), GAMD-small weights from
    init_params(seed), Langevin at 100 K, 2 fs, 25/ps, rebuild every 20
    steps, the FCC start lattice with a seeded 0.05 A jitter. The force
    scaler is the identity; the edge-length scaler is fitted on the start
    frame."""
    system = get_preset("lj", skin=0.5, nbr_capacity=64)
    model_cfg = lj_model_config()
    md = MDConfig(integrator="langevin", temperature=system.temperature,
                  dt_fs=system.dt_fs, friction_per_ps=system.friction_per_ps,
                  rebuild_every=20)
    _, lattice = lj_fluid_box(system.n_atoms, 0.5)
    jitter = np.random.default_rng(seed).normal(0.0, 0.05, lattice.shape)
    pos = space.wrap(torch.as_tensor((lattice + jitter).astype(np.float32),
                                     device=device), system.box)
    idx, mask, _ = build_nbrs(pos, system, K_MODEL)
    state = init_params(model_cfg, system, seed=seed)._replace(
        length_stat=edge_length_stat(pos, idx, mask, system.box,
                                     system.cutoff))
    return LJSlice(system, model_cfg, md, state, pos)
