"""BAOAB Langevin integrator and thermodynamic helpers on torch tensors
(port of gamd_tpu/md/integrators.py: LangevinState, kinetic_energy,
temperature, maxwell_boltzmann_velocities, baoab_langevin).

Units: angstrom, amu, kJ/mol, t0 = 0.1 ps (see core.units); dt is in t0.
Random numbers come from an explicit torch.Generator on the state's device.
"""

import math
from typing import Callable, NamedTuple

import torch

from gamd_tpu_torch.core import units


class LangevinState(NamedTuple):
    pos: torch.Tensor       # [N, 3]
    vel: torch.Tensor       # [N, 3]
    force: torch.Tensor     # [N, 3]
    rng: torch.Generator    # noise stream, on the state's device


def kinetic_energy(vel, masses):
    """0.5 * sum m v^2 in kJ/mol (0-d tensor)."""
    return 0.5 * torch.sum(masses[:, None] * vel * vel)


def temperature(vel, masses, ndf=None):
    """Instantaneous temperature (K): 2 KE / (ndf kB)."""
    if ndf is None:
        ndf = vel.shape[0] * 3
    return 2.0 * kinetic_energy(vel, masses) / (ndf * units.KB)


def maxwell_boltzmann_velocities(rng: torch.Generator, masses, temp_k):
    """Velocities [N, 3] (A/t0) from the Maxwell-Boltzmann distribution."""
    sigma = torch.sqrt(units.KB * temp_k / masses)[:, None]
    return sigma * torch.randn((masses.shape[0], 3), generator=rng,
                               device=masses.device, dtype=masses.dtype)


def baoab_langevin(force_fn: Callable, dt: float, masses, temp_k: float,
                   friction: float):
    """BAOAB splitting of Langevin dynamics: (init_fn, step_fn).

    init_fn(pos, vel, rng) evaluates the first force. step_fn(state,
    noise=None) is one B A O A (force) B step; `noise` [N, 3] may be
    pre-drawn (Simulation draws a chunk's noise at once), else it is drawn
    from state.rng. friction is the collision rate in 1/t0.
    """
    m = masses[:, None]
    a = math.exp(-friction * dt)
    b = math.sqrt(1.0 - math.exp(-2.0 * friction * dt))
    sigma = torch.sqrt(units.KB * temp_k / masses)[:, None]
    hdt = 0.5 * dt

    def init_fn(pos, vel, rng):
        return LangevinState(pos=pos, vel=vel, force=force_fn(pos), rng=rng)

    def step_fn(state: LangevinState, noise=None) -> LangevinState:
        if noise is None:
            noise = torch.randn(state.vel.shape, generator=state.rng,
                                device=state.vel.device,
                                dtype=state.vel.dtype)
        v = state.vel + hdt * state.force / m                  # B
        x = state.pos + hdt * v                                # A
        v = a * v + b * sigma * noise                          # O
        x = x + hdt * v                                        # A
        f = force_fn(x)
        v = v + hdt * f / m                                    # B
        return LangevinState(pos=x, vel=v, force=f, rng=state.rng)

    return init_fn, step_fn
