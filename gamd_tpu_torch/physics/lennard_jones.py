"""Classical Lennard-Jones potential and fluid set-up (port of
gamd_tpu/physics/lennard_jones.py: LJParams, ARGON_MASS, _pair_energy,
lj_energy_dense, lj_forces_dense, lj_energy_neighbors, lj_force_fn,
lj_fluid_box).

openmmtools' LJ fluid is argon: sigma = 3.4 A, epsilon = 0.238 kcal/mol,
mass 39.948 amu, cutoff 3*sigma, shifted to zero at the cutoff. Reduced
density 0.5 with N = 258 gives the reference's box edge 27.27 A. Energies
kJ/mol, forces kJ/mol/A; forces are -grad E by autograd, so they are
exactly consistent with the energy. These give the training labels (the
repo ships no LJ dataset).
"""

from typing import NamedTuple

import numpy as np
import torch

from gamd_tpu_torch.core import space, units


class LJParams(NamedTuple):
    sigma: float = 3.4                         # A
    epsilon: float = 0.238 * units.KCAL_TO_KJ  # kJ/mol
    cutoff: float = 3.0 * 3.4                  # A
    shift: bool = True


ARGON_MASS = 39.948


def _pair_energy(r2, p: LJParams):
    """Pair energy from squared distance; shifted, and 0 beyond cutoff."""
    inv_r2 = p.sigma * p.sigma / torch.clamp(r2, min=1e-12)
    inv_r6 = inv_r2 * inv_r2 * inv_r2
    e = 4.0 * p.epsilon * (inv_r6 * inv_r6 - inv_r6)
    if p.shift:
        s6 = (p.sigma / p.cutoff) ** 6
        e = e - 4.0 * p.epsilon * (s6 * s6 - s6)
    return torch.where(r2 < p.cutoff * p.cutoff, e, 0.0)


def lj_energy_dense(pos, box, params: LJParams = LJParams()):
    """Total potential energy via the dense pair matrix (small N); pos
    [N, 3], or [B, N, 3] for the sum over a batch of frames."""
    n = pos.shape[-2]
    dr = space.min_image(pos[..., None, :, :] - pos[..., :, None, :], box)
    d2 = torch.sum(dr * dr, dim=-1)
    d2 = d2 + torch.eye(n, dtype=pos.dtype, device=pos.device) * 1e10
    return 0.5 * torch.sum(_pair_energy(d2, params))


def _neg_grad(energy_fn, pos, *args):
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(energy_fn(p, *args), p)
    return -grad


def lj_forces_dense(pos, box, params: LJParams = LJParams()):
    """Forces -grad E of lj_energy_dense, per frame ([N, 3] or
    [B, N, 3]); no graph is kept."""
    return _neg_grad(lj_energy_dense, pos, box, params)


def lj_energy_neighbors(pos, idx, mask, box, params: LJParams = LJParams()):
    """Total energy over a padded [N, K] neighbour list (each pair counted
    twice across rows, hence the 0.5).

    Padded slots are self-references with r = 0; the double-where guard
    keeps the 1/r^12 singularity (inf in fp32) out of both the primal and
    the backward pass (inf * 0 = nan would otherwise poison the forces).
    """
    dr = space.min_image(pos[idx.long()] - pos[:, None, :], box)
    r2 = torch.sum(dr * dr, dim=-1)
    r2_safe = torch.where(mask, r2, params.sigma ** 2)
    e = torch.where(mask, _pair_energy(r2_safe, params), 0.0)
    return 0.5 * torch.sum(e)


def lj_force_fn(box, params: LJParams = LJParams()):
    """force_fn(pos, idx, mask) -> -grad lj_energy_neighbors, for
    md.simulate.Simulation."""
    def force(pos, idx, mask):
        return _neg_grad(lj_energy_neighbors, pos, idx, mask, box, params)
    return force


def lj_fluid_box(n_particles: int = 258, reduced_density: float = 0.5,
                 params: LJParams = LJParams()):
    """Box edge (A) and initial FCC-lattice positions [N, 3] float32 (numpy)
    for an LJ fluid at reduced density rho* = rho sigma^3."""
    volume = n_particles * params.sigma**3 / reduced_density
    box = float(volume ** (1.0 / 3.0))

    # Smallest FCC supercell holding n_particles.
    cells = 1
    while 4 * cells**3 < n_particles:
        cells += 1
    a = box / cells
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    sites = []
    for i in range(cells):
        for j in range(cells):
            for k in range(cells):
                sites.append((base + np.array([i, j, k])) * a)
    all_sites = np.concatenate(sites, axis=0)
    # An evenly spread subset: the first n sites would fill an x-slab at
    # double density (neighbour-capacity overflow at the start).
    sel = np.round(np.linspace(0, len(all_sites) - 1,
                               n_particles)).astype(int)
    pos = all_sites[sel].astype(np.float32)
    return box, pos
