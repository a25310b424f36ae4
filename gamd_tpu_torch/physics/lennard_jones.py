"""Lennard-Jones fluid set-up (port of gamd_tpu/physics/lennard_jones.py:
LJParams, ARGON_MASS, lj_fluid_box).

openmmtools' LJ fluid is argon: sigma = 3.4 A, epsilon = 0.238 kcal/mol,
mass 39.948 amu, cutoff 3*sigma. Reduced density 0.5 with N = 258 gives the
reference's box edge 27.27 A.
"""

from typing import NamedTuple

import numpy as np

from gamd_tpu_torch.core import units


class LJParams(NamedTuple):
    sigma: float = 3.4                         # A
    epsilon: float = 0.238 * units.KCAL_TO_KJ  # kJ/mol
    cutoff: float = 3.0 * 3.4                  # A
    shift: bool = True


ARGON_MASS = 39.948


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
