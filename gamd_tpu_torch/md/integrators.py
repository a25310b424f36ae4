"""NVE and NVT integrators and thermodynamic helpers on torch tensors
(port of gamd_tpu/md/integrators.py: the states, kinetic_energy,
temperature, maxwell_boltzmann_velocities, velocity_verlet,
baoab_langevin, the Nose-Hoover chain (_nhc_propagate,
nose_hoover_chain, nhc_bath_energies) and andersen).

Units: angstrom, amu, kJ/mol, t0 = 0.1 ps (see core.units); dt is in t0.
Random numbers come from an explicit torch.Generator on the state's device.
Every factory returns (init_fn, step_fn); step_fn(state) is one full MD
step. Every factory takes an optional `constraint` (md.constraints.
RigidWater: positions(x_ref, x_new) and velocities(x, v) projections): the
drift is followed by the position projection, whose correction the
velocity absorbs, and each kick by the velocity projection (RATTLE); BAOAB
projects after every A and O sub-step (g-BAOAB, Leimkuhler and Matthews).
With no constraint the steps are unchanged. The unconstrained step
functions are elementwise in atoms, so a state with a leading replica axis
([R, N, 3]; NHC chains [R, M]) advances R replicas in lockstep, as the
JAX package's run_replicas does. The NHC half-step
runs through ops.nhc.nhc_half_step: the CUDA kernel on a CUDA tensor,
its plain version on the CPU.
"""

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from gamd_tpu_torch.core import units
from gamd_tpu_torch.ops.nhc import nhc_half_step, nhc_half_step_reference


class NVEState(NamedTuple):
    pos: torch.Tensor       # [N, 3]
    vel: torch.Tensor       # [N, 3]
    force: torch.Tensor     # [N, 3]


class LangevinState(NamedTuple):
    pos: torch.Tensor       # [N, 3]
    vel: torch.Tensor       # [N, 3]
    force: torch.Tensor     # [N, 3]
    rng: torch.Generator    # noise stream, on the state's device


class NoseHooverState(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    force: torch.Tensor
    xi: torch.Tensor        # [M] thermostat positions
    vxi: torch.Tensor       # [M] thermostat velocities (1/t0)
    g: torch.Tensor         # [M] thermostat forces (1/t0^2)


class AndersenState(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    force: torch.Tensor
    rng: torch.Generator


def kinetic_energy(vel, masses):
    """0.5 * sum m v^2 in kJ/mol over the atoms: 0-d for vel [N, 3], [R]
    for replicas [R, N, 3] (the sum over axes (1, 2) of JAX's run)."""
    return 0.5 * torch.sum(masses[:, None] * vel * vel, dim=(-2, -1))


def temperature(vel, masses, ndf=None):
    """Instantaneous temperature (K): 2 KE / (ndf kB), per replica."""
    if ndf is None:
        ndf = vel.shape[-2] * 3
    return 2.0 * kinetic_energy(vel, masses) / (ndf * units.KB)


def maxwell_boltzmann_velocities(rng: torch.Generator, masses, temp_k,
                                 n_replicas=None):
    """Velocities [N, 3] (A/t0) from the Maxwell-Boltzmann distribution;
    [n_replicas, N, 3] in one draw when n_replicas is given."""
    sigma = torch.sqrt(units.KB * temp_k / masses)[:, None]
    lead = () if n_replicas is None else (int(n_replicas),)
    return sigma * torch.randn((*lead, masses.shape[0], 3), generator=rng,
                               device=masses.device, dtype=masses.dtype)


def _drift_project(constraint, x0, v, dt):
    """Drift x0 + dt v, then the position projection; the velocity absorbs
    the correction (x_c - x_free) / dt (the RATTLE convention)."""
    x_free = x0 + dt * v
    if constraint is None:
        return x_free, v
    x_c = constraint.positions(x0, x_free)
    return x_c, v + (x_c - x_free) / dt


def _project_vel(constraint, x, v):
    return v if constraint is None else constraint.velocities(x, v)


def baoab_langevin(force_fn: Callable, dt: float, masses, temp_k: float,
                   friction: float, constraint=None):
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
        return LangevinState(pos=pos, vel=_project_vel(constraint, pos, vel),
                             force=force_fn(pos), rng=rng)

    def step_fn(state: LangevinState, noise=None) -> LangevinState:
        if noise is None:
            noise = torch.randn(state.vel.shape, generator=state.rng,
                                device=state.vel.device,
                                dtype=state.vel.dtype)
        v = state.vel + hdt * state.force / m                  # B
        v = _project_vel(constraint, state.pos, v)
        x, v = _drift_project(constraint, state.pos, v, hdt)   # A
        v = a * v + b * sigma * noise                          # O
        v = _project_vel(constraint, x, v)
        x, v = _drift_project(constraint, x, v, hdt)           # A
        f = force_fn(x)
        v = v + hdt * f / m                                    # B
        v = _project_vel(constraint, x, v)
        return LangevinState(pos=x, vel=v, force=f, rng=state.rng)

    return init_fn, step_fn


# --------------------------------------------------------------------------
# Velocity Verlet (NVE)
# --------------------------------------------------------------------------

def velocity_verlet(force_fn: Callable, dt: float, masses, constraint=None):
    """Plain velocity Verlet: (init_fn(pos, vel), step_fn(state))."""
    m = masses[:, None]
    hdt = 0.5 * dt

    def init_fn(pos, vel):
        return NVEState(pos=pos, vel=_project_vel(constraint, pos, vel),
                        force=force_fn(pos))

    def step_fn(state: NVEState) -> NVEState:
        v = state.vel + hdt * state.force / m
        x, v = _drift_project(constraint, state.pos, v, dt)
        f = force_fn(x)
        v = v + hdt * f / m
        v = _project_vel(constraint, x, v)
        return NVEState(pos=x, vel=v, force=f)

    return init_fn, step_fn


# --------------------------------------------------------------------------
# Nose-Hoover chain velocity Verlet
# --------------------------------------------------------------------------

_YS_WEIGHTS = {
    1: [1.0],
    3: [0.8289815435887510, -0.6579630871775020, 0.8289815435887510],
    5: [0.2967324292201065, 0.2967324292201065, -0.1869297168804260,
        0.2967324292201065, 0.2967324292201065],
}


def nhc_schedule(dt, n_c, ys_weights, device=None):
    """The [n_c * n_ys] float32 weighted substeps of a half-step, in
    _nhc_propagate's order: the tiled weights cast to float32, then times
    dt and over n_c in float32 (gamd_tpu/md/integrators.py:231-232)."""
    w = np.tile(np.asarray(ys_weights, np.float64), n_c).astype(np.float32)
    wdts = w * np.float32(dt) / np.float32(n_c)
    return torch.as_tensor(wdts, device=device)


def nhc_masses(kt, frequency, chain_length, ndf, device=None):
    """The [M] float32 chain masses [ndf kT / f^2, kT / f^2, ...]."""
    q_single = kt / frequency**2
    q = [ndf * q_single] + [q_single] * (chain_length - 1)
    return torch.tensor(q, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=16)
def _chain_constants(kt, frequency, chain_length, ndf, dt, n_c, n_ys, device):
    """(q, wdts) on `device`, made once per set of constants and only read
    after: Simulation rebuilds its step functions every neighbour chunk,
    and a fresh host-to-device copy there would make the host wait for the
    device."""
    return (nhc_masses(kt, frequency, chain_length, ndf, device),
            nhc_schedule(dt, n_c, _YS_WEIGHTS[n_ys], device))


def _nhc_propagate(vel, xi, vxi, g, masses, kt, ndf, q, dt, n_c, ys_weights,
                   ke2=None):
    """Half-step Nose-Hoover chain propagation (MTK, Yoshida-Suzuki + MTS),
    in the JAX function's arguments: (vel * scale, xi, vxi, g).

    The plain version of ops.nhc.nhc_half_step on the schedule
    nhc_schedule(dt, n_c, ys_weights). Batch-polymorphic: vel [..., N, 3]
    with chains [..., M]; ke2, if given, is the [...] 2 KE to use instead
    of sum m v^2.
    """
    wdts = nhc_schedule(dt, n_c, ys_weights, vel.device)
    return nhc_half_step_reference(vel, xi, vxi, g, masses, kt, ndf, q, wdts,
                                   ke2)


def nose_hoover_chain(force_fn: Callable, dt: float, masses, temp_k: float,
                      frequency: float, chain_length: int = 10, n_c: int = 5,
                      n_ys: int = 5, ndf: int = None, constraint=None):
    """Nose-Hoover chain velocity Verlet: (init_fn(pos, vel),
    step_fn(state)).

    A step is the chain's half-step, a kick, a drift, the force, a kick and
    the chain's half-step again; each half-step is one nhc_half_step call.

    Args:
        frequency: thermostat collision frequency in 1/t0.
        ndf: degrees of freedom (default 3N less the constraint's
            n_constraints).
    """
    if n_ys not in _YS_WEIGHTS:
        raise ValueError(f"n_ys must be one of {sorted(_YS_WEIGHTS)}")
    m = masses[:, None]
    if ndf is None:
        ndf = 3 * masses.shape[0] - (constraint.n_constraints
                                     if constraint is not None else 0)
    kt = units.KB * temp_k
    q, wdts = _chain_constants(kt, frequency, chain_length, ndf, dt, n_c,
                               n_ys, masses.device)
    hdt = 0.5 * dt

    def half_step(v, xi, vxi, g):
        return nhc_half_step(v, xi, vxi, g, masses, kt, ndf, q, wdts)

    def init_fn(pos, vel):
        dev = pos.device
        return NoseHooverState(
            pos=pos, vel=_project_vel(constraint, pos, vel),
            force=force_fn(pos),
            xi=torch.zeros(chain_length, device=dev),
            vxi=torch.zeros(chain_length, device=dev),
            # G starts at -frequency^2, as the JAX package's.
            g=torch.full((chain_length,), -frequency**2, device=dev))

    def step_fn(state: NoseHooverState) -> NoseHooverState:
        v, xi, vxi, g = half_step(state.vel, state.xi, state.vxi, state.g)
        v = v + hdt * state.force / m
        x, v = _drift_project(constraint, state.pos, v, dt)
        f = force_fn(x)
        v = v + hdt * f / m
        v = _project_vel(constraint, x, v)
        v, xi, vxi, g = half_step(v, xi, vxi, g)
        return NoseHooverState(pos=x, vel=v, force=f, xi=xi, vxi=vxi, g=g)

    return init_fn, step_fn


def nhc_bath_energies(state: NoseHooverState, temp_k, frequency, ndf):
    """Heat-bath (KE, PE) of the chain in kJ/mol; [..., M] chain state
    gives [...] energies."""
    kt = units.KB * temp_k
    q = nhc_masses(kt, frequency, state.xi.shape[-1], ndf, state.xi.device)
    bath_ke = 0.5 * torch.sum(q * state.vxi**2, dim=-1)
    bath_pe = kt * (ndf * state.xi[..., 0]
                    + torch.sum(state.xi[..., 1:], dim=-1))
    return bath_ke, bath_pe


# --------------------------------------------------------------------------
# Andersen thermostat velocity Verlet
# --------------------------------------------------------------------------

def andersen(force_fn: Callable, dt: float, masses, temp_k: float,
             collision_rate: float, constraint=None):
    """Velocity Verlet with per-DoF Andersen collisions: a DoF whose
    uniform draw is below dt * collision_rate is redrawn from
    Maxwell-Boltzmann before the step. (init_fn(pos, vel, rng),
    step_fn(state, noise=None)); `noise`, if given, is a pre-drawn
    (uniform [N, 3], normal [N, 3]) pair, else both are drawn from
    state.rng."""
    m = masses[:, None]
    p_collision = dt * collision_rate
    sigma = torch.sqrt(units.KB * temp_k / masses)[:, None]
    hdt = 0.5 * dt

    def init_fn(pos, vel, rng):
        return AndersenState(pos=pos, vel=_project_vel(constraint, pos, vel),
                             force=force_fn(pos), rng=rng)

    def step_fn(state: AndersenState, noise=None) -> AndersenState:
        if noise is None:
            shape, dev = state.vel.shape, state.vel.device
            u = torch.rand(shape, generator=state.rng, device=dev)
            xi = torch.randn(shape, generator=state.rng, device=dev)
        else:
            u, xi = noise
        v = torch.where(u < p_collision, sigma * xi, state.vel)
        v = _project_vel(constraint, state.pos, v)
        v = v + hdt * state.force / m
        x, v = _drift_project(constraint, state.pos, v, dt)
        f = force_fn(x)
        v = v + hdt * f / m
        v = _project_vel(constraint, x, v)
        return AndersenState(pos=x, vel=v, force=f, rng=state.rng)

    return init_fn, step_fn
