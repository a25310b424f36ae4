"""Classical TIP3P water (port of the TIP3P part of
gamd_tpu/physics/water.py: TIP3PParams, WATER_MASSES, atom_charges,
_tip3p_intra_energy, tip3p_energy, tip3p_energy_rigid, tip3p_forces,
tip3p_forces_rigid, tip3p_force_fn with the damped-shifted-force
electrostatics, and water_box).

Two variants, atoms ordered O, H, H per molecule:
* RIGID (tip3p_energy_rigid): nonbonded terms only, LJ on O-O pairs and
  Coulomb between atoms of different molecules with the damped-shifted-
  force cutoff (alpha = 0), continuous in energy and force at the cutoff.
  The monomer geometry is held by md.constraints (SETTLE, RATTLE).
* FLEXIBLE (tip3p_energy): adds harmonic O-H bonds and the H-O-H angle; a
  plain differentiable potential (run_md's FIRE start minimises it).

Energies kJ/mol, forces kJ/mol/A, lengths angstrom. Forces are -grad E by
torch.autograd, where the JAX package takes jax.grad: the same function,
summed in another order. Full Ewald electrostatics and TIP4P-Ew come with
the next water slice.
"""

from typing import NamedTuple

import numpy as np
import torch

from gamd_tpu_torch.core import space, units


class TIP3PParams(NamedTuple):
    r_oh: float = 0.9572
    k_bond: float = 450.0 * units.KCAL_TO_KJ          # kJ/mol/A^2
    theta0: float = 104.52 * np.pi / 180.0
    k_angle: float = 55.0 * units.KCAL_TO_KJ          # kJ/mol/rad^2
    sigma_o: float = 3.15061
    eps_o: float = 0.1521 * units.KCAL_TO_KJ
    q_o: float = -0.834
    q_h: float = 0.417
    cutoff: float = 9.0
    coulomb_k: float = 332.0637128 * units.KCAL_TO_KJ  # kJ mol^-1 A e^-2


WATER_MASSES = (15.9994, 1.008, 1.008)

#: The refusal of what the next water slice brings.
NEXT_WATER_SLICE = ("full Ewald electrostatics come with the next water "
                    "slice of the port (ROADMAP Queue 1 item 5: "
                    "physics/ewald.py)")


def atom_charges(n_molecules, p: TIP3PParams, device=None):
    """Charges [3 M] float32: q_o, q_h, q_h per molecule."""
    q = torch.tensor([p.q_o, p.q_h, p.q_h], dtype=torch.float32,
                     device=device)
    return q.repeat(n_molecules)


def _tip3p_intra_energy(pos, box, params: TIP3PParams):
    """Harmonic bond and angle energy (the flexible variant's terms)."""
    p = params
    o, h1, h2 = pos[0::3], pos[1::3], pos[2::3]
    v1 = space.min_image(h1 - o, box)
    v2 = space.min_image(h2 - o, box)
    d1 = torch.sqrt(torch.sum(v1 ** 2, -1) + 1e-12)
    d2 = torch.sqrt(torch.sum(v2 ** 2, -1) + 1e-12)
    e_bond = torch.sum(p.k_bond * ((d1 - p.r_oh) ** 2 + (d2 - p.r_oh) ** 2))
    cos_t = torch.sum(v1 * v2, -1) / torch.clamp(
        torch.linalg.vector_norm(v1, dim=-1)
        * torch.linalg.vector_norm(v2, dim=-1), min=1e-8)
    theta = torch.arccos(torch.clamp(cos_t, -1 + 1e-7, 1 - 1e-7))
    e_angle = torch.sum(p.k_angle * (theta - p.theta0) ** 2)
    return e_bond + e_angle


def tip3p_energy(pos, box, params: TIP3PParams = TIP3PParams()):
    """FLEXIBLE potential energy of an N = 3M atom box [kJ/mol]."""
    return _tip3p_intra_energy(pos, box, params) \
        + tip3p_energy_rigid(pos, box, params)


def tip3p_energy_rigid(pos, box, params: TIP3PParams = TIP3PParams()):
    """Nonbonded TIP3P energy [kJ/mol], the potential of rigid water: all
    pairs within the cutoff, same-molecule pairs excluded."""
    n = pos.shape[0]
    if n % 3:
        raise ValueError(f"water takes 3 atoms a molecule, not N={n}")
    p = params
    dev = pos.device
    mol = torch.arange(n, device=dev) // 3
    same_mol = mol[:, None] == mol[None, :]
    eye = torch.eye(n, dtype=pos.dtype, device=dev)
    d2_all = space.pairwise_distance2(pos, box) + eye * 1e9
    pair_ok = (~same_mol) & (d2_all < p.cutoff ** 2)
    r2 = torch.where(pair_ok, d2_all, p.cutoff ** 2)   # no NaN in the grad
    r = torch.sqrt(r2)

    is_o = torch.remainder(torch.arange(n, device=dev), 3) == 0
    oo = is_o[:, None] & is_o[None, :]
    inv6 = (p.sigma_o ** 2 / r2) ** 3
    s6 = (p.sigma_o / p.cutoff) ** 6
    e_lj_pair = 4 * p.eps_o * (inv6 ** 2 - inv6) - 4 * p.eps_o * (s6 ** 2 - s6)
    e_lj = 0.5 * torch.sum(torch.where(pair_ok & oo, e_lj_pair, 0.0))

    q = atom_charges(n // 3, p, dev)
    qq = q[:, None] * q[None, :]
    rc = p.cutoff
    e_c_pair = p.coulomb_k * qq * (1.0 / r - 1.0 / rc + (r - rc) / rc ** 2)
    e_coul = 0.5 * torch.sum(torch.where(pair_ok, e_c_pair, 0.0))
    return e_lj + e_coul


def _neg_grad(energy, pos, *args):
    with torch.enable_grad():
        x = pos.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(energy(x, *args), x)
    return -g


def tip3p_forces(pos, box, params: TIP3PParams = TIP3PParams()):
    """Forces [N, 3] of the flexible potential, -grad E by autograd."""
    return _neg_grad(tip3p_energy, pos, box, params)


def tip3p_forces_rigid(pos, box, params: TIP3PParams = TIP3PParams()):
    """Forces [N, 3] of the rigid (nonbonded) potential."""
    return _neg_grad(tip3p_energy_rigid, pos, box, params)


def tip3p_force_fn(box, params: TIP3PParams = TIP3PParams(),
                   rigid: bool = False, electrostatics: str = "dsf"):
    """Dense force closure (pos, idx, mask) -> [N, 3] for md.simulate.
    Simulation; the list is ignored (at N <= 774 the dense pair matrix is
    the whole work). electrostatics="ewald" raises NotImplementedError."""
    if electrostatics == "ewald":
        raise NotImplementedError(NEXT_WATER_SLICE)
    if electrostatics != "dsf":
        raise ValueError(f"unknown electrostatics {electrostatics!r}")
    fwd = tip3p_forces_rigid if rigid else tip3p_forces

    def force(pos, idx, mask):
        del idx, mask
        return fwd(pos, box, params)
    return force


def water_box(n_molecules: int = 258, box: float = 20.0,
              params: TIP3PParams = TIP3PParams(), seed: int = 0):
    """Start configuration [3 M, 3] float32 numpy: molecules on a cubic
    grid with random orientations from np.random.RandomState(seed), wrapped
    into the box (the JAX package's numpy code, so the two give the same
    bits)."""
    rng = np.random.RandomState(seed)
    per_dim = 1
    while per_dim ** 3 < n_molecules:
        per_dim += 1
    spacing = box / per_dim
    sites = np.array([(i, j, k) for i in range(per_dim)
                      for j in range(per_dim) for k in range(per_dim)],
                     np.float32)
    sel = np.round(np.linspace(0, len(sites) - 1, n_molecules)).astype(int)
    centers = (sites[sel] + 0.5) * spacing

    t0 = params.theta0
    local = np.array([
        [0.0, 0.0, 0.0],
        [params.r_oh * np.sin(t0 / 2), params.r_oh * np.cos(t0 / 2), 0.0],
        [-params.r_oh * np.sin(t0 / 2), params.r_oh * np.cos(t0 / 2), 0.0],
    ], np.float32)

    frames = []
    for c in centers:
        a, b, g = rng.uniform(0, 2 * np.pi, 3)
        ca, sa, cb, sb, cg, sg = (np.cos(a), np.sin(a), np.cos(b),
                                  np.sin(b), np.cos(g), np.sin(g))
        rz = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
        ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
        rz2 = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]])
        rot = (rz @ ry @ rz2).astype(np.float32)
        frames.append(local @ rot.T + c)
    pos = np.concatenate(frames, axis=0)
    return np.mod(pos, box).astype(np.float32)
